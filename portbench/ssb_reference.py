"""What the Star Schema Benchmark's plain references
(``reference/ssb_q*.py``, which holds one module per query shape) share:
a fact row's dimension row, dictionary tests, and the grouped or keyless
sums of the rows that reach the aggregation.

Every sum is exact (``_common.group_sums``, ``exact_sum``); the control
(``control=True``) sums in float32, the precision below the exact
integers the configuration states, and rounds to an integer.  Imports
torch only: nothing of the system under test.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from .reference._common import exact_sum, group_sums, sort_rows


def dim_rows(t, key: str, fact_key: str, ok: Optional[torch.Tensor]) -> torch.Tensor:
    """Each fact row's row of the dimension whose unique key ``key`` it
    names in ``fact_key``, -1 where none has it or ``ok`` (None: every
    row passes) is False there."""
    keys = t[key]
    order = torch.argsort(keys)
    sk = keys[order]
    fk = t[fact_key]
    pos = torch.searchsorted(sk, fk).clamp(max=len(sk) - 1)
    row = order[pos]
    found = sk[pos] == fk
    if ok is not None:
        found &= ok[row]
    return torch.where(found, row, torch.full_like(row, -1))


def words(t, name: str, test: Callable[[str], bool]) -> torch.Tensor:
    """Rows of dictionary column ``name`` whose string passes ``test``."""
    allowed = torch.tensor([test(s) for s in t.dict(name)], dtype=torch.bool,
                           device=t.device)
    return allowed[t[name]]


def is_(t, name: str, *values: str) -> torch.Tensor:
    return words(t, name, lambda s: s in values)


def within(col: torch.Tensor, lo, hi) -> torch.Tensor:
    return (col >= lo) & (col <= hi)


def star(t, fact: Optional[torch.Tensor], dims: Sequence) -> Dict[str, torch.Tensor]:
    """The fact rows that pass ``fact`` (None: every row) and find a
    passing row in every dimension: ``dims`` holds (key, fact key, mask
    over the dimension's rows or None); returns each dimension's rows
    over the live fact rows, by key, and the mask under ``"live"``."""
    rows = {key: dim_rows(t, key, fk, ok) for key, fk, ok in dims}
    live = next(iter(rows.values())) >= 0 if fact is None else fact.clone()
    for r in rows.values():
        live &= r >= 0
    out = {key: r[live] for key, r in rows.items()}
    out["live"] = live
    return out


def keyless_sum(vals: torch.Tensor, name: str, control: bool) -> Dict[str, List]:
    """SUM over the live rows: NULL over none."""
    if len(vals) == 0:
        return {name: [None]}
    if control:
        return {name: [round(float(vals.float().sum()))]}
    return {name: [exact_sum(vals)]}


def grouped_sum(t, keys: Sequence, vals: torch.Tensor, name: str,
                order: Sequence, control: bool) -> Dict[str, List]:
    """SUM(vals) per group of ``keys``, (output name, codes or numbers over
    the live rows, dictionary column or None) each, ordered by ``order``:
    (output name, descending) pairs."""
    if len(vals) == 0:
        return {k: [] for k, _, _ in keys} | {name: []}
    composite = torch.zeros_like(vals)
    for _, v, _ in keys:
        lo = int(v.min())
        composite = composite * (int(v.max()) - lo + 1) + (v - lo)
    uniq, inv = torch.unique(composite, return_inverse=True)
    n = len(uniq)
    first = torch.full((n,), len(vals), dtype=torch.int64, device=vals.device)
    first = first.scatter_reduce(0, inv, torch.arange(len(vals), device=vals.device), "amin")
    if control:
        sums = torch.zeros(n, dtype=torch.float32, device=vals.device).index_add_(
            0, inv, vals.float())
        sums = [round(float(s)) for s in sums.tolist()]
    else:
        sums = group_sums(inv, vals, n)
    cols = {k: v[first] for k, v, _ in keys}
    cols[name] = torch.tensor(sums, dtype=torch.int64, device=vals.device)
    perm = sort_rows([(cols[k], desc) for k, desc in order]).tolist()
    out = {}
    for k, _, dic in keys:
        got = cols[k][perm]
        out[k] = t.names(dic, got) if dic else got.tolist()
    out[name] = [sums[i] for i in perm]
    return out
