"""Positions in a sorted array: the join's probe ranges and the N:M
expansion address map.

Counterpart of ``tiflash_tpu/ops/merge.py``, limited to what the join
needs (``probe_ranges_fast``, ``dense_inverse``).  The reference packs
value and position into one int64 and merges with single-operand sorts,
with a 31-bit fast path and a ``searchsorted`` fallback: a TPU sort
workaround.  On the card both functions are ``torch.searchsorted``.
``flagged_positions`` comes with the slices that compact blocks.
"""

from __future__ import annotations

from typing import Tuple

import torch


def probe_ranges_fast(
    sorted_keys: torch.Tensor,
    queries: torch.Tensor,
    num_live: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) = searchsorted(sorted_keys, queries, left/right), int32,
    clamped into the matchable prefix ``[0, num_live)``.

    Positions at or past ``num_live`` hold forced NULL/dead build rows
    whose sentinel key (2^63-1) must never match a probe key of that same
    real value; the clamp is a tensor op, so nothing syncs to the host."""
    keys = sorted_keys.to(torch.int64).contiguous()
    q = queries.to(torch.int64).contiguous()
    lo = torch.searchsorted(keys, q, side="left")
    hi = torch.searchsorted(keys, q, side="right")
    nl = num_live.to(torch.int64)
    return (torch.minimum(lo, nl).to(torch.int32),
            torch.minimum(hi, nl).to(torch.int32))


def dense_inverse(cum: torch.Tensor, num_out: int) -> torch.Tensor:
    """``searchsorted(cum, arange(num_out), side="right")`` for a
    nondecreasing non-negative ``cum``: the prefix-sum expansion address
    map (output slot -> source row) of the N:M join.  int32."""
    t = torch.arange(num_out, dtype=torch.int64, device=cum.device)
    return torch.searchsorted(cum.to(torch.int64).contiguous(), t,
                              side="right").to(torch.int32)


__all__ = ["probe_ranges_fast", "dense_inverse"]
