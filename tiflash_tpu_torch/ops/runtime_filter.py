"""Runtime filters: a Join's build keys narrow its probe subtree's rows.

Counterpart of the reference's runtime filter in
``tiflash_tpu/mpp/runner.py``.  A Join with an ``rf_id`` runs its build
subtree first; ``publish_runtime_filter`` takes, per build key, the
min/max over live valid rows and, for a small enough build, the sorted
key set; the probe subtree's ``RuntimeFilterApply`` narrows its child's
selection by them (``apply_runtime_filter``).  Both plan walks call
these: the single-device compiler without a mesh, the mesh runner with
one (``mpp/mesh.py``), where the min/max are reduced and the key set is
gathered across shards, so every shard holds the same global filter.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..core.block import Block
from ..runtime.metrics import METRICS

_BIG = 2 ** 62


def publish_runtime_filter(build_keys: Sequence[str], builds: Sequence[Block],
                           mesh=None, in_set_max: int = 1 << 20) -> List[list]:
    """One filter per local shard: for each build key, ``(min, max, sorted
    key set | None)`` over live valid rows, or None for a string or float
    key.  The key set (dead rows at 2^62) is published only for builds of
    at most ``in_set_max`` rows a shard.  ``builds`` holds one block per
    local shard of ``mesh`` (one block without a mesh)."""
    METRICS.counter("runtime_filters_published_total").inc()
    n_local = len(builds)
    per_shard: List[list] = [[] for _ in range(n_local)]
    cap = builds[0].capacity

    def local(b, kn):
        c = b[kn]
        ok = b.sel_mask() if c.validity is None else (b.sel_mask() & c.validity)
        data = c.data.to(torch.int64)
        big = torch.full_like(data, _BIG)
        if data.shape[0] == 0:
            e = torch.zeros((), dtype=torch.int64, device=data.device)
            return e + _BIG, e - _BIG, big
        return (torch.where(ok, data, big).min(), torch.where(ok, data, -big).max(),
                torch.where(ok, data, big))

    for kn in build_keys:
        c0 = builds[0][kn]
        if c0.dtype.is_string or c0.dtype.is_float:
            for e in per_shard:
                e.append(None)
            continue
        parts = (mesh.map(lambda b: local(b, kn), builds) if mesh is not None
                 else [local(builds[0], kn)])
        mns, mxs, keys = [p[0] for p in parts], [p[1] for p in parts], [p[2] for p in parts]
        if mesh is not None:
            mns, mxs = mesh.pmin(mns), mesh.pmax(mxs)
        sets = [None] * n_local
        if cap <= in_set_max:
            if mesh is not None:
                keys = mesh.all_gather_tiled(keys)  # the global membership set
                sets = mesh.map(lambda k: torch.sort(k).values, keys)
            else:
                sets = [torch.sort(keys[0]).values]
        for i in range(n_local):
            per_shard[i].append((mns[i], mxs[i], sets[i]))
    return per_shard


def apply_runtime_filter(child: Block, key_names: Sequence[str],
                         entries: Optional[list]) -> Block:
    """Narrow ``child``'s rows by one shard's published filter (a no-op
    when none was published)."""
    if entries is None:
        return child
    sel = child.sel_mask()
    for kn, entry in zip(key_names, entries):
        if entry is None:
            continue
        mn, mx, key_set = entry
        c = child[kn]
        data = c.data.to(torch.int64)
        keep = (data >= mn) & (data <= mx)
        if key_set is not None:
            lo = torch.searchsorted(key_set, data)
            hi = torch.searchsorted(key_set, data, right=True)
            keep = keep & (hi > lo)
        if c.validity is not None:
            keep = keep & c.validity
        sel = sel & keep
    return child.with_sel(sel)


__all__ = ["publish_runtime_filter", "apply_runtime_filter"]
