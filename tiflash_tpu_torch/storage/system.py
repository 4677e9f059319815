"""System tables: engine introspection as queryable blocks.

Counterpart of ``tiflash_tpu/storage/system.py``.  Role analog:
``Storages/System/`` (``system.metrics``, ``system.dt_tables``,
``system.processes``), made on demand from the metrics registry, the
settings, the catalog and the service's query list, so any plan scans
them like ordinary tables (``TableScan("system_metrics")``).  They are
built on the device the caller names: a plan that joins one with a
catalog table reads both from one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..core import dtypes as dt
from ..core.block import Block
from ..runtime.metrics import METRICS
from ..runtime.settings import Settings
from .catalog import Catalog, _to_device, column_from_arrays, encode_strings


def _string_col(values):
    codes, d = encode_strings(np.array([str(v) for v in values], dtype=object))
    return column_from_arrays(codes, dt.STRING, dictionary=d)


def _int_col(values):
    return column_from_arrays(np.array(values, dtype=np.int64), dt.INT64)


def system_blocks(
    catalog: Optional[Catalog] = None,
    settings: Optional[Settings] = None,
    queries: Optional[list] = None,
    device="cpu",
) -> Dict[str, Block]:
    out: Dict[str, Block] = {}

    m = METRICS.dump()
    out["system_metrics"] = Block.from_dict({
        "name": _string_col(list(m.keys())),
        "value": column_from_arrays(np.array(list(m.values()), dtype=np.float64),
                                    dt.FLOAT64),
    })

    s = settings or Settings()
    fields = dataclasses.fields(s)
    out["system_settings"] = Block.from_dict({
        "name": _string_col([f.name for f in fields]),
        "value": _string_col([getattr(s, f.name) for f in fields]),
    })

    if catalog is not None:
        tables = list(catalog.tables.items())
        out["system_tables"] = Block.from_dict({
            "table": _string_col([name for name, _ in tables]),
            "rows": _int_col([t.row_count for _, t in tables]),
            "columns": _int_col([len(t.schema) for _, t in tables]),
        })

    if queries:
        out["system_queries"] = Block.from_dict({
            "id": _int_col([q["id"] for q in queries]),
            "state": _string_col([q["state"] for q in queries]),
        })
    return {name: _to_device(b, device) for name, b in out.items()}


__all__ = ["system_blocks"]
