"""Distinct-count sketch (K minimum values) for ``approx_count_distinct``.

Counterpart of ``tiflash_tpu/ops/sketch.py``.  The sketch of a column is
the k smallest distinct 62-bit value hashes of its live non-NULL rows
(``ops/hashing.py:hash_columns_u63``), ascending, padded with 2^62.  With
fewer than k distinct hashes the count is exact; otherwise, with h_k the
k-th smallest hash out of a hash space H = 2^62, the estimate is
round((k - 1) * H / h_k).  The estimate is a number users see, so the
hashes, k = 4096 and the estimator are the reference's own.  The
reference selects the k smallest with a tiled bottom-k sort network (a
TPU workaround); here it is ``torch.unique`` and a slice.
"""

from __future__ import annotations

import torch

SKETCH_K = 4096
_HASH_SPACE = float(2 ** 62)
_INF = 2 ** 62  # above every hash (hashes are masked to 62 bits)


def kmv_candidates(hashes: torch.Tensor, live: torch.Tensor,
                   k: int = SKETCH_K) -> torch.Tensor:
    """The k smallest distinct hash values among live rows, ascending,
    padded with 2^62."""
    vals = torch.where(live, hashes.to(torch.int64),
                       torch.full_like(hashes, _INF, dtype=torch.int64))
    cands = torch.unique(vals, sorted=True)[:k]
    if cands.shape[0] < k:
        pad = torch.full((k - cands.shape[0],), _INF, dtype=torch.int64,
                         device=cands.device)
        cands = torch.cat([cands, pad])
    return cands


def kmv_estimate(cands: torch.Tensor) -> torch.Tensor:
    """NDV estimate (0-d int64) from an ascending candidate array."""
    k = cands.shape[0]
    m = torch.sum(cands < _INF, dtype=torch.int64)
    kth = torch.clamp(cands[k - 1].to(torch.float64), min=1.0)
    # a tensor over a tensor: a Python number over a tensor is a
    # reciprocal multiply in torch, not a correctly rounded division
    num = torch.full((), (k - 1) * _HASH_SPACE, dtype=torch.float64,
                     device=cands.device)
    est = torch.round(num / kth).to(torch.int64)
    return torch.where(m < k, m, est)


__all__ = ["SKETCH_K", "kmv_candidates", "kmv_estimate"]
