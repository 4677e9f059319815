"""Segment-boundary fills.

Counterpart of ``tiflash_tpu/ops/segments.py``: ``forward_fill_positions``
and ``backward_fill_positions``, which ``ops/window.py`` and the
aggregation methods use to find each row's segment start and end.  Each
is one cumulative count of the flags and a gather from the dense table of
flagged positions (``ops/merge.py:flagged_positions``).  The reference
takes a ``cummax`` over positions; torch's CUDA ``cummax`` scans with
indices and took 245 ms of the window report's 294 ms of device time at
SF1 on an H100 (``bench/analytics.py``, PERF.md).  The reference's
``route_by_positions`` (a permutation written by a sort, because a TPU
scatter is slow) has no counterpart: the port indexes directly.
"""

from __future__ import annotations

import torch

from .merge import flagged_positions


def forward_fill_positions(flags: torch.Tensor) -> torch.Tensor:
    """Position (int64) of the most recent True at or before each row.
    ``flags[0]`` must be True."""
    n = flags.shape[0]
    seg = torch.cumsum(flags.to(torch.int64), 0) - 1
    return flagged_positions(flags, n)[seg.clamp(min=0)].to(torch.int64)


def backward_fill_positions(flags: torch.Tensor) -> torch.Tensor:
    """Position (int64) of the nearest True at or after each row.
    ``flags[-1]`` must be True."""
    n = flags.shape[0]
    counts = flags.to(torch.int64)
    before = torch.cumsum(counts, 0) - counts  # flags strictly before the row
    return flagged_positions(flags, n)[before.clamp(max=max(n - 1, 0))].to(torch.int64)


__all__ = ["forward_fill_positions", "backward_fill_positions"]
