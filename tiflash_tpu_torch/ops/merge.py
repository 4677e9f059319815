"""Positions of rows: the join's probe ranges, the N:M expansion address
map, and the dense table of flagged rows.

Counterpart of ``tiflash_tpu/ops/merge.py``: ``flagged_positions`` (the
stream aggregation method's group-end table and top-N's candidate
compaction), ``probe_ranges_fast`` and ``dense_inverse``.  The reference
packs value and position into one int64 and merges with single-operand
sorts, with a 31-bit fast path and a ``searchsorted`` fallback: a TPU
sort workaround.  On the card the two range functions are
``torch.searchsorted`` and ``flagged_positions`` is a cumulative sum and
a scatter.
"""

from __future__ import annotations

from typing import Tuple

import torch

# unflagged rows scatter into this many trash slots past the table, by
# position, so they never pile onto one address
_TRASH_LANES = 1024


def flagged_positions(flags: torch.Tensor, num_out: int) -> torch.Tensor:
    """Indices of set flags, in order, as a dense (num_out,) int32 table
    padded with -1.  Each flagged row's slot is the count of flags before
    it; nothing syncs to the host."""
    n = flags.shape[0]
    dev = flags.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    rank = torch.cumsum(flags.to(torch.int64), 0) - 1
    trash = num_out + (pos % _TRASH_LANES)
    target = torch.where(flags & (rank < num_out), rank, trash)
    out = torch.full((num_out + _TRASH_LANES,), -1, dtype=torch.int32, device=dev)
    out.scatter_(0, target, pos.to(torch.int32))
    return out[:num_out]


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


__all__ = ["flagged_positions", "probe_ranges_fast", "dense_inverse"]
