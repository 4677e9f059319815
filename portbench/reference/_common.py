"""What the plain references share: the generated columns on a device, and
exact arithmetic in plain torch.

Every answer is exact: DECIMAL values are int64 mantissas, and sums go
through two 32-bit limbs (``exact_sum``, ``group_sums``) into Python
ints, so no sum can wrap at any scale factor.  A division rounds half up,
as the SQL layer's decimal division does.

Imports torch and numpy only: nothing of the system under test.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

EPOCH = datetime.date(1970, 1, 1)


def days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - EPOCH).days


def half_up_div(num: int, den: int) -> int:
    q, r = divmod(abs(num), abs(den))
    q += 2 * r >= abs(den)
    return q if (num >= 0) == (den > 0) else -q


class Tables:
    """The benchmark's arrays (a configuration's generated tables), copied
    to ``device`` on first use.  A column is named ``<table>.<column>``,
    and by its bare name where no other table has a column of that name
    (as every TPC-H column)."""

    def __init__(self, tables: Dict, device):
        self.device = torch.device(device)
        self.host: Dict[str, np.ndarray] = {}
        self._dicts = {}
        names = [name for t in tables.values() for name in t.columns]
        self._shared = {name for name in names if names.count(name) > 1}
        for tname, t in tables.items():
            for name, col in t.columns.items():
                for key in [f"{tname}.{name}"] + ([] if name in self._shared else [name]):
                    self.host[key] = col.data
                    if col.dictionary is not None:
                        self._dicts[key] = col.dictionary
        self._dev: Dict[str, torch.Tensor] = {}
        self._years = None

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self._dev.get(name)
        if t is None:
            if name in self._shared:
                raise KeyError(f"{name!r} is a column of more than one table: "
                               f"name it as <table>.{name}")
            t = self._dev[name] = torch.from_numpy(
                np.ascontiguousarray(self.host[name])).to(self.device).long()
        return t

    def dict(self, name: str) -> Tuple[str, ...]:
        return self._dicts[name]

    def code(self, name: str, value: str) -> int:
        return self._dicts[name].index(value)

    def names(self, name: str, codes: torch.Tensor) -> List[str]:
        d = self._dicts[name]
        return [d[c] for c in codes.tolist()]

    def year(self, day: torch.Tensor) -> torch.Tensor:
        """Calendar year of each day number, by a table made with
        ``datetime`` over 1970..2100."""
        if self._years is None:
            n = (datetime.date(2101, 1, 1) - EPOCH).days
            self._years = torch.tensor(
                [(EPOCH + datetime.timedelta(days=d)).year for d in range(n)],
                dtype=torch.int64, device=self.device)
        return self._years[day]

    def release(self) -> None:
        self._dev.clear()
        self._years = None


def key_table(keys: torch.Tensor, vals: torch.Tensor, fill: int = -1) -> torch.Tensor:
    """Dense table vals[key] for small non-negative integer keys."""
    size = int(keys.max()) + 2 if len(keys) else 1
    table = torch.full((size,), fill, dtype=torch.int64, device=keys.device)
    table[keys] = vals
    return table


def lookup(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """table[keys], -1 where a key is out of the table's range."""
    safe = keys.clamp(0, len(table) - 1)
    return torch.where((keys >= 0) & (keys < len(table)), table[safe],
                       torch.full_like(keys, -1))


def row_of(keys: torch.Tensor) -> torch.Tensor:
    """Row number by key, for a table's unique key column."""
    return key_table(keys, torch.arange(len(keys), device=keys.device))


def _limbs(vals: torch.Tensor):
    return vals & 0xFFFFFFFF, vals >> 32


def exact_sum(vals: torch.Tensor) -> int:
    """The exact sum of an int64 tensor, as a Python int."""
    lo, hi = _limbs(vals)
    return int(hi.sum()) * (1 << 32) + int(lo.sum())


def group_sums(inv: torch.Tensor, vals: torch.Tensor, n: int) -> List[int]:
    """Exact per-group sums of ``vals`` by group index ``inv``."""
    lo, hi = _limbs(vals)
    out_lo = torch.zeros(n, dtype=torch.int64, device=vals.device).index_add_(0, inv, lo)
    out_hi = torch.zeros(n, dtype=torch.int64, device=vals.device).index_add_(0, inv, hi)
    return [h * (1 << 32) + l for h, l in zip(out_hi.tolist(), out_lo.tolist())]


def group_counts(inv: torch.Tensor, n: int) -> List[int]:
    return torch.bincount(inv, minlength=n).tolist()


def sort_rows(keys: Sequence[Tuple[torch.Tensor, bool]]) -> torch.Tensor:
    """Row order by (key, descending) pairs, the first most significant;
    ties keep their row order."""
    n = len(keys[0][0])
    order = torch.arange(n, device=keys[0][0].device)
    for key, desc in reversed(keys):
        order = order[torch.sort(key[order], stable=True, descending=desc).indices]
    return order


def top_with_ties(keys: Sequence[Tuple[torch.Tensor, bool]], limit: int) -> torch.Tensor:
    """The first ``limit`` rows in ``sort_rows`` order and every further row
    that ties with the last of them on all keys: the rows any correct
    ORDER BY ... LIMIT may return."""
    order = sort_rows(keys)
    if len(order) <= limit:
        return order
    last = order[limit - 1]
    rest = order[limit:]
    tie = torch.ones(len(rest), dtype=torch.bool, device=rest.device)
    for key, _ in keys:
        tie &= key[rest] == key[last]
    n_tie = int(torch.cumprod(tie.long(), 0).sum()) if len(rest) else 0
    return order[:limit + n_tie]

