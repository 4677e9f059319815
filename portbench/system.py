"""The system under test: ``tiflash_tpu_torch``'s query service.

The only module of the harness that imports the port.  It registers the
generated arrays in the port's catalog (``storage/catalog.py``:
``column_from_arrays`` and ``Catalog.register``, as the port's own
generator does) and serves them with ``mpp/service.py``'s
``QueryService`` over HTTP on 127.0.0.1.
"""

from __future__ import annotations

import re
from typing import Dict

from tiflash_tpu_torch.core import dtypes as dt
from tiflash_tpu_torch.mpp.service import QueryService, serve_background
from tiflash_tpu_torch.storage.catalog import Catalog, column_from_arrays


def _dtype(kind: str):
    """A generated column's kind as the port's type: ``DECIMAL(p,s)``;
    ``DECIMAL``, which is TPC-H's ``DECIMAL(15,2)``; or the name of one of
    the port's types (``INT64``, ``DATE``, ``STRING``, ...)."""
    m = re.fullmatch(r"DECIMAL\((\d+),\s*(\d+)\)", kind)
    if m:
        return dt.Decimal(int(m[1]), int(m[2]))
    if kind == "DECIMAL":
        return dt.Decimal(15, 2)
    t = getattr(dt, kind, None)
    if not isinstance(t, dt.DataType):
        raise ValueError(f"no type of the port is named {kind!r}")
    return t


def build_catalog(tables: Dict) -> Catalog:
    """The port's catalog over a configuration's generated tables
    (``dataset.py``)."""
    cat = Catalog()
    for name, t in tables.items():
        cols = {c: column_from_arrays(col.data, _dtype(col.kind), dictionary=col.dictionary)
                for c, col in t.columns.items()}
        cat.register(name, cols, unique_keys=t.unique_keys, clustered_by=t.clustered_by)
    return cat


def start(catalog: Catalog, device: str):
    """Start the service on ``device``; returns (service, http server, port)."""
    service = QueryService(catalog, device=device)
    httpd, port = serve_background(service, 0)
    return service, httpd, port


def counters() -> Dict:
    """The port's kernel counters, as plain numbers."""
    from tiflash_tpu_torch.ops import stream_fuse
    from tiflash_tpu_torch.ops.cuda import build, direct_agg, stream_agg, stream_tile

    return {"stream_tile_launches": stream_tile.LAUNCHES,
            "direct_agg_launches": direct_agg.LAUNCHES,
            "stream_agg_launches": stream_agg.LAUNCHES,
            "fused_runs": stream_fuse.FUSE_STATS.get("count", 0),
            "builds": len(build.BUILD_SECONDS),
            "build_seconds": round(sum(build.BUILD_SECONDS.values()), 3)}
