"""Sort and Limit.

Counterpart of ``tiflash_tpu/ops/sort.py``.  The reference sorts with one
``lax.sort(num_keys=k, is_stable=True)`` over (dead-last flag, key
operands..., row index).  ``torch.sort`` sorts on one key and is unstable
by default, so the port chains stable argsorts from the last key operand
to the first: each pass keeps the order of the passes before it among
ties, which gives the same lexicographic, stable order.

Descending order and NULL placement are key transforms, as in the
reference: integers flip bits (no INT_MIN negation overflow), floats
negate, bools become int8 first.  Top-N comes with the topN slice of the
port.
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


def limit_block(block: Block, limit: int) -> Block:
    """LIMIT without ordering: keep the first ``limit`` live rows."""
    live = block.sel_mask()
    rank = torch.cumsum(live.to(torch.int32), dim=0)
    return block.and_sel(live & (rank <= limit))


__all__ = ["SortKey", "sort_block", "limit_block", "lexsort_stable"]
