"""Row concatenation of blocks.

Counterpart of ``tiflash_tpu/exchange/skew.py``, which holds the
skew-aware shuffle join and ``concat_blocks``.  Only ``concat_blocks`` is
ported so far: ``Union`` and the right/full outer joins' unmatched build
tail need it.  The skew join comes with the distribution slice of the
port.
"""

from __future__ import annotations

import torch

from ..core.block import Block, Column


def concat_blocks(a: Block, b: Block) -> Block:
    """Row-concatenate two blocks with identical column names; nullability
    is unioned (an outer-join tail contributes NULL-filled columns)."""
    assert a.names == b.names, (a.names, b.names)
    cols = []
    for ca, cb in zip(a.columns, b.columns):
        data = torch.cat([ca.data, cb.data.to(ca.data.dtype)])
        if ca.validity is None and cb.validity is None:
            validity = None
        else:
            validity = torch.cat([ca.valid_mask(), cb.valid_mask()])
        dt = ca.dtype.with_nullable(ca.dtype.nullable or cb.dtype.nullable)
        st = None
        if ca.stats is not None and cb.stats is not None:
            st = (min(ca.stats[0], cb.stats[0]), max(ca.stats[1], cb.stats[1]))
        cols.append(Column(data, validity, dt, ca.dictionary, stats=st,
                           concat_sep=ca.concat_sep))
    sel = torch.cat([a.sel_mask(), b.sel_mask()])
    return Block(names=a.names, columns=tuple(cols), sel=sel)


__all__ = ["concat_blocks"]
