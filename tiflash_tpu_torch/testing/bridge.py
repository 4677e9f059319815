"""Carry Blocks of another engine into the port through numpy.

``export_blocks`` walks any Block-like object — one with ``names``,
``columns``, ``sel`` and ``clustered_by``, whose columns have ``data``,
``validity``, ``dtype``, ``dictionary``, ``stats`` and ``ndv`` — by
attribute name and ``np.asarray``.  It imports no engine, so the port can
take a table from the JAX reference in a test without importing jax
itself.  ``storage.catalog.blocks_from_numpy`` builds port Blocks from
its result.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _array(x):
    return None if x is None else np.asarray(x)


def _export_column(col) -> dict:
    dt = col.dtype
    stats = getattr(col, "stats", None)
    return {
        "data": np.asarray(col.data),
        "validity": _array(col.validity),
        "dtype": {"kind": dt.kind.name, "precision": int(dt.precision),
                  "scale": int(dt.scale), "nullable": bool(dt.nullable)},
        "dictionary": (None if col.dictionary is None
                       else tuple(col.dictionary)),
        "stats": None if stats is None else (int(stats[0]), int(stats[1])),
        "domain": getattr(col, "domain", None),
        "ndv": getattr(col, "ndv", None),
    }


def _export_block(block) -> dict:
    return {
        "names": tuple(block.names),
        "columns": [_export_column(c) for c in block.columns],
        "sel": _array(block.sel),
        "clustered_by": tuple(getattr(block, "clustered_by", ())),
    }


def export_blocks(obj: Any) -> Dict[str, dict]:
    """A ``{name: Block}`` mapping (or a catalog with ``.blocks()``) ->
    ``{name: plain dict of numpy arrays and descriptors}``."""
    if not isinstance(obj, dict):
        obj = obj.blocks()
    return {name: _export_block(b) for name, b in obj.items()}


__all__ = ["export_blocks"]
