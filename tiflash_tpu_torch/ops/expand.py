"""Expand: grouping-sets replication for ROLLUP, CUBE and GROUPING SETS.

Counterpart of ``tiflash_tpu/ops/expand.py``.  Each input row is copied
once per grouping set, in set order; in each copy the key columns outside
that set are NULL, and an int64 ``groupingID`` column (1-based, TiDB's
grouping id) says which set the copy belongs to.  The output holds G
copies of the input's capacity, and its selection is the input's,
repeated.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.block import Block, Column
from ..core.dtypes import INT64


def expand_block(block: Block, grouping_sets: Sequence[Sequence[str]],
                 gid_name: str = "groupingID") -> Block:
    """Replicate rows per grouping set; key columns outside a set become
    NULL in its copy; adds the int64 ``gid_name`` column."""
    g = len(grouping_sets)
    n = block.capacity
    dev = block.device
    all_keys = {k for s in grouping_sets for k in s}
    out_cols = {}
    for name, col in zip(block.names, block.columns):
        off = [name in all_keys and name not in s for s in grouping_sets]
        parts_data = [torch.zeros_like(col.data) if o else col.data for o in off]
        data = torch.cat(parts_data)
        nullable = any(off)
        validity = None
        if nullable or col.validity is not None:
            validity = torch.cat([
                torch.zeros(n, dtype=torch.bool, device=dev) if o
                else col.valid_mask() for o in off])
        dtype = col.dtype.with_nullable(col.dtype.nullable or nullable)
        out_cols[name] = Column(data, validity, dtype, col.dictionary)
    gid = torch.arange(1, g + 1, dtype=torch.int64, device=dev).repeat_interleave(n)
    out_cols[gid_name] = Column(gid, None, INT64)
    return Block.from_dict(out_cols, sel=block.sel_mask().repeat(g))


__all__ = ["expand_block"]
