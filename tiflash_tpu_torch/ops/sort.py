"""Sort, Top-N and Limit.

Counterpart of ``tiflash_tpu/ops/sort.py``.  The reference sorts with one
``lax.sort(num_keys=k, is_stable=True)`` over (dead-last flag, key
operands..., row index).  ``torch.sort`` sorts on one key and is unstable
by default, so the port chains stable argsorts from the last key operand
to the first: each pass keeps the order of the passes before it among
ties, which gives the same lexicographic, stable order.

Descending order and NULL placement are key transforms, as in the
reference: integers flip bits (no INT_MIN negation overflow), floats
negate, bools become int8 first.  Top-N keeps the reference's order
contract, not its TPU tiling: the first ``limit`` rows of the stable
full sort, ties by original position.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..core.block import Block, Column
from ..core.dtypes import INT64


@dataclasses.dataclass(frozen=True)
class SortKey:
    """(column, direction, nulls).  MySQL/TiDB: NULL is smallest — first
    ascending, last descending; an explicit ``nulls_first`` overrides."""

    name: str
    desc: bool = False
    nulls_first: Optional[bool] = None

    @property
    def nulls_first_resolved(self) -> bool:
        return (not self.desc) if self.nulls_first is None else self.nulls_first


def _sort_operand(col: Column, desc: bool, nulls_first: bool) -> List[torch.Tensor]:
    """One column -> ascending-sortable operands (null rank, value')."""
    data = col.data
    if col.dtype.is_wide_decimal and data.ndim == 2:
        # multi-limb mantissa: value order == lexicographic limb order
        # because lower limbs are non-negative
        ops: List[torch.Tensor] = []
        if col.validity is not None:
            ops.append(_null_rank(col.validity, nulls_first))
        for i in range(data.shape[-1]):
            ops.extend(_sort_operand(Column(data[:, i], None, INT64), desc,
                                     nulls_first))
        return ops
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    if desc:
        data = -data if data.is_floating_point() else ~data
    ops = []
    if col.validity is not None:
        ops.append(_null_rank(col.validity, nulls_first))
    ops.append(data)
    return ops


def _null_rank(validity: torch.Tensor, nulls_first: bool) -> torch.Tensor:
    """Ascending sort puts rank 0 first."""
    valid_rank = 1 if nulls_first else 0
    return torch.where(validity, valid_rank, 1 - valid_rank).to(torch.int8)


def lexsort_stable(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation that sorts rows by ``operands`` lexicographically
    (first operand most significant), ties in original row order."""
    n = operands[0].shape[0]
    perm = torch.arange(n, device=operands[0].device)
    for op in reversed(operands):
        if op.dtype == torch.bool:
            op = op.to(torch.int8)
        order = torch.argsort(op[perm], stable=True)
        perm = perm[order]
    return perm


def sort_block(block: Block, sort_keys: Sequence[SortKey]) -> Block:
    """Full sort of live rows (dead rows pushed to the end).  The output
    is compacted: rows [0, count) are the live rows in order."""
    n = block.capacity
    live = block.sel_mask()
    operands: List[torch.Tensor] = [~live]  # live rows first
    for sk in sort_keys:
        operands.extend(_sort_operand(block[sk.name], sk.desc, sk.nulls_first_resolved))
    perm = lexsort_stable(operands)
    sorted_block = block.take(perm)
    count = torch.sum(live, dtype=torch.int32)
    sel = torch.arange(n, dtype=torch.int32, device=live.device) < count
    return sorted_block.with_sel(sel)


def _single_key_rank(block: Block, sort_keys: Sequence[SortKey]) -> Optional[torch.Tensor]:
    """int64 rank where bigger = earlier in ORDER BY order, or None when
    the order does not rank-pack.  The reference's two cases:

    - a 64-bit integer-kind key with no validity and no selection:
      rank = x (desc) or ~x (asc), a bijection;
    - an integer-kind key of at most 32 bits: the value shifted left 2
      bits, dead rows at int64 min and NULL rows at a sentinel for their
      placement, which the shift keeps clear of every value.
    """
    if len(sort_keys) != 1:
        return None
    sk = sort_keys[0]
    col = block[sk.name]
    t = col.dtype
    int_kind = (t.is_integer or t.kind.value in ("date", "datetime", "duration", "bool")
                or (t.is_decimal and col.data.ndim == 1))
    if not int_kind or t.kind.value == "u64":
        return None
    x = col.data
    if col.validity is None and block.sel is None:
        r = x.to(torch.int64)
        return r if sk.desc else ~r
    if x.element_size() > 4:
        return None
    val = x.to(torch.int64)
    val = val if sk.desc else -val
    rank = (val << 2) | 2
    imin, imax = torch.iinfo(torch.int64).min, torch.iinfo(torch.int64).max
    if col.validity is not None:
        null_rank = imax if sk.nulls_first_resolved else imin + 1
        rank = torch.where(col.validity, rank, torch.full_like(rank, null_rank))
    if block.sel is not None:
        rank = torch.where(block.sel, rank, torch.full_like(rank, imin))
    return rank


def _top_ranks(rank: torch.Tensor, limit: int) -> torch.Tensor:
    """Positions of the ``limit`` best ranks, best first, ties by position:
    ``torch.topk`` gives only the limit-th best value (its tie order is
    unspecified), the rows ranking strictly better plus the first rows by
    position that equal it make exactly ``limit`` candidates, and one
    stable sort orders them."""
    from .merge import flagged_positions

    kth = torch.topk(rank, limit, sorted=False).values.min()
    better = rank > kth
    equal = rank == kth
    room = limit - torch.sum(better, dtype=torch.int64)
    cand = better | (equal & (torch.cumsum(equal.to(torch.int64), 0) <= room))
    pos = flagged_positions(cand, limit).long()
    order = torch.sort(rank[pos], descending=True, stable=True).indices
    return pos[order]


# The reference ranks a nullable key only on its per-tile top-k path
# (n >= 4 * 2048 and limit <= 128).  There its NULL rows tie by position;
# on its sort paths they order by the payload under the NULL, as in
# sort_block.  The port keeps both orders, so its rows equal the
# reference's.
_NULL_RANK_MIN_ROWS = 4 * 2048
_NULL_RANK_MAX_LIMIT = 128


def top_n(block: Block, sort_keys: Sequence[SortKey], limit: int) -> Block:
    """ORDER BY ... LIMIT k.  The output capacity is ``min(limit, n)``;
    its rows are the first ones of the stable full sort (live rows first,
    then the keys, then the original position), and ``sel`` marks the
    first ``live count`` of them.  A single key that rank-packs selects
    in O(n) (``_top_ranks``); any other order sorts every row."""
    n = block.capacity
    limit = min(limit, n)
    live = block.sel_mask()
    rank = _single_key_rank(block, sort_keys) if limit else None
    if rank is not None and block[sort_keys[0].name].validity is not None and not (
            n >= _NULL_RANK_MIN_ROWS and limit <= _NULL_RANK_MAX_LIMIT):
        rank = None
    if rank is not None:
        perm = _top_ranks(rank, limit)
    else:
        operands: List[torch.Tensor] = [~live]
        for sk in sort_keys:
            operands.extend(_sort_operand(block[sk.name], sk.desc,
                                          sk.nulls_first_resolved))
        perm = lexsort_stable(operands)[:limit]
    count = torch.sum(live, dtype=torch.int32)
    kept = torch.arange(limit, dtype=torch.int32, device=live.device) < count
    return block.take(perm).with_sel(kept)


def limit_block(block: Block, limit: int) -> Block:
    """LIMIT without ordering: keep the first ``limit`` live rows."""
    live = block.sel_mask()
    rank = torch.cumsum(live.to(torch.int32), dim=0)
    return block.and_sel(live & (rank <= limit))


__all__ = ["SortKey", "sort_block", "top_n", "limit_block", "lexsort_stable"]
