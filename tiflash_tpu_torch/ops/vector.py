"""Brute-force vector search: a batch of queries against a VECTOR column.

Counterpart of ``tiflash_tpu/ops/vector.py``.  Exact search, no index:
scoring is one (q, d) x (d, n) float32 product, then a batched k-smallest
selection.  The reference computes both in XLA outside any Pallas kernel,
so the port keeps them as ``torch.matmul`` and ``torch.topk``:

- the product stays float32.  On the card a TF32 product would round the
  operands to 10 mantissa bits, so ``vector_search`` refuses to run while
  ``torch.backends.cuda.matmul.allow_tf32`` is set;
- ``l1`` has no product identity.  The reference broadcasts (q, n, d) at
  once; here the queries go in chunks of at most ``L1_CHUNK_BYTES`` of
  broadcast, each row still one sum over d;
- the selection breaks ties as XLA's ``lax.top_k`` does: scores in the
  total order of their float32 bits (-0.0 before +0.0, NaN last), equal
  scores by lower row index.  CUDA ``torch.topk`` promises no tie order,
  so it runs over an int64 key that packs the order-preserving int32 image
  of each score above its row index.  Dead and NULL rows score ``+inf``.

Single-query ANN through the plan layer needs no node of its own:
``TopN(d, k) <- Projection(d = vec_l2_distance(v, lit([...])))``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.block import Block, Column
from ..expr.functions import _sqrt32

_METRICS = ("l2", "l1", "cosine", "inner_product")
# the most broadcast bytes one l1 chunk of queries materializes
L1_CHUNK_BYTES = 1 << 30


def vector_search(
    col: Column,
    queries: torch.Tensor,
    k: int,
    metric: str = "l2",
    sel: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest rows of ``col`` for each query row.

    col      VECTOR column, data (n, d) float32.
    queries  (q, d), taken as float32 on the column's device.
    k        neighbours per query (at most n are returned).
    metric   l2 | l1 | cosine | inner_product (inner_product ranks by the
             largest dot product: the negative inner product as distance).
    sel      optional (n,) live-row mask; dead and NULL rows never match
             while live rows remain.

    Returns (distances (q, k) float32, indices (q, k) int32), each query's
    neighbours best first."""
    if metric not in _METRICS:
        raise ValueError(f"metric must be one of {_METRICS}")
    if not col.dtype.is_vector:
        raise TypeError("vector_search needs a VECTOR column")
    x = col.data.float()
    q = queries.to(device=x.device, dtype=torch.float32)
    n = x.shape[0]

    if metric == "l1":
        score = _l1_scores(q, x)
    else:
        dot = _matmul_fp32(q, x)
        if metric == "l2":
            # |x-q|^2 = |q|^2 - 2 q.x + |x|^2, clamped: rounding can dip
            # below zero for near-identical vectors
            score = torch.clamp_min(
                torch.sum(q * q, dim=1)[:, None] - 2.0 * dot
                + torch.sum(x * x, dim=1)[None, :], 0.0)
        elif metric == "cosine":
            norms = (_sqrt32(torch.sum(q * q, dim=1))[:, None]
                     * _sqrt32(torch.sum(x * x, dim=1))[None, :])
            score = 1.0 - dot / torch.clamp_min(norms, 1e-30)
        else:
            score = -dot

    dead = None if sel is None else ~sel.to(x.device)
    if col.validity is not None:
        dead = ~col.validity if dead is None else (dead | ~col.validity)
    if dead is not None:
        score = torch.where(dead[None, :], torch.full_like(score, float("inf")), score)

    dist, idx = batched_min_k(score, min(k, n))
    if metric == "l2":
        dist = _sqrt32(dist)
    return dist, idx.to(torch.int32)


def _matmul_fp32(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q @ x.T in float32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("vector_search needs float32 products: unset "
                           "torch.backends.cuda.matmul.allow_tf32")
    return q @ x.T


def _l1_scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum |q_i - x_j| over d for every (i, j), queries in chunks."""
    n, d = x.shape
    step = max(1, L1_CHUNK_BYTES // max(1, n * d * 4))
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=x.device)
    for i in range(0, q.shape[0], step):
        out[i:i + step] = torch.sum(torch.abs(q[i:i + step, None, :] - x[None, :, :]), dim=-1)
    return out


def batched_min_k(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of (q, n) float32, best first, in
    ``lax.top_k``'s order: the total order of the float32 bits, then the
    lower index.  Returns (values, int64 indices)."""
    n = score.shape[1]
    bits = score.contiguous().view(torch.int32)
    key32 = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pos = torch.arange(n, dtype=torch.int64, device=score.device)
    key = key32.to(torch.int64) * (1 << 32) + pos[None, :]
    best = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    idx = best & 0xFFFFFFFF
    return torch.gather(score, 1, idx), idx


def block_vector_search(
    block: Block, column: str, queries: torch.Tensor, k: int,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``vector_search`` honoring the block's lazy selection mask."""
    return vector_search(block[column], queries, k, metric=metric,
                         sel=block.sel_mask())


__all__ = ["vector_search", "block_vector_search", "batched_min_k", "L1_CHUNK_BYTES"]
