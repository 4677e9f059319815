"""Grouped sums and counts over a dense slot domain: the direct method's
kernel.

Replaces the Pallas TPU kernel ``tiflash_tpu/ops/pallas/direct_agg.py``
(``direct_sums``, ``_direct_sums_once``, body ``_kernel``) with the
hand-written CUDA kernel ``tiflash_tpu_torch/csrc/direct_agg.cu`` for
Hopper (``sm_90a``).  ``direct_sums`` keeps the reference's contract,
``(slots, values, masks, live, n_slots) -> (sums (S, V) int64,
live_counts (S,) int64, nn_counts list)``, so ``ops/aggregate.py``'s
``_accumulate_direct_kernel`` ports line by line.

The wrapper does the reference's preparation in torch: dead rows go to
slot ``n_slots``, masked values become 0, and a 0/1 non-null column is
appended for every masked value.  It stacks the K value columns into one
contiguous (K, n) int64 tensor and allocates a zeroed (S, K+1) int64
output whose last column holds the live-row counts.  The kernel adds
each live row's values into its slot, mod 2^64.  Its shared-memory
accumulator is S x (columns) x 8 B, so the wrapper splits the K+1 output
columns into groups that fit one block's 227 KB, one launch per group.

Bound: device-memory bytes and shared-atomic contention.  A row costs
4 B of slot id; a live row adds 8 B per value column and one 64-bit
shared atomic per nonzero value.  Q7 over all nation pairs at SF1 reads
about 6.0M int32 slots and the live rows' values, with 625 live slots.
A warp-level pre-reduction or privatized accumulators would cut the
atomics; that is later speed work.

``direct_sums_plain`` is the same contract in plain torch; the wrappers
use it only for CPU tensors, and a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
THREADS = 256
BLOCKS_PER_SM = 4
# dynamic shared memory one block may use on sm_90 after the opt-in
MAX_SMEM = 232_448

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load_library

        lib = load_library("direct_agg")
        fn = lib.direct_agg_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def column_groups(n_slots: int, n_cols: int) -> List[Tuple[int, int]]:
    """[begin, end) ranges of output columns, each small enough that its
    S x (end - begin) int64 accumulator fits one block's shared memory."""
    per = MAX_SMEM // (8 * n_slots)
    if per < 1:
        raise ValueError(f"{n_slots} slots need {8 * n_slots} B of shared "
                         f"memory per column, above {MAX_SMEM}")
    return [(c, min(c + per, n_cols)) for c in range(0, n_cols, per)]


def _check_group_sums(slots: torch.Tensor, vals: torch.Tensor, n_slots: int,
                      out: torch.Tensor) -> None:
    if slots.dtype != torch.int32 or vals.dtype != torch.int64:
        raise TypeError(f"slots must be int32 and values int64, got "
                        f"{slots.dtype}/{vals.dtype}")
    if slots.dim() != 1 or vals.dim() != 2 or vals.shape[1] != slots.shape[0]:
        raise ValueError(f"values {tuple(vals.shape)} vs slots {tuple(slots.shape)}")
    if out.dtype != torch.int64 or tuple(out.shape) != (n_slots, vals.shape[0] + 1):
        raise ValueError(f"out must be ({n_slots}, {vals.shape[0] + 1}) int64")
    if slots.device != vals.device or slots.device != out.device:
        raise ValueError("slots, values and out must be on one device")


def group_sums(slots: torch.Tensor, vals: torch.Tensor, n_slots: int,
               out: torch.Tensor) -> torch.Tensor:
    """Add into ``out`` ((S, K+1) int64), per slot, the sum of each of the
    K rows of ``vals`` ((K, n) int64) mod 2^64 and, in the last column,
    the row count.  Rows whose slot lies outside [0, S) add nothing.  CPU
    tensors take the plain version; CUDA tensors launch the kernel, once
    per column group."""
    _check_group_sums(slots, vals, n_slots, out)
    if slots.device.type == "cpu":
        return group_sums_plain(slots, vals, n_slots, out)
    if slots.device.type != "cuda":
        raise RuntimeError(f"no direct_agg kernel for device {slots.device}")
    if not (slots.is_contiguous() and vals.is_contiguous() and out.is_contiguous()):
        raise ValueError("direct_agg kernel takes contiguous tensors")
    n = int(slots.shape[0])
    k = int(vals.shape[0])
    groups = column_groups(n_slots, k + 1)
    if n == 0:
        return out
    lib = _kernel_lib()
    props = torch.cuda.get_device_properties(slots.device)
    blocks = min(-(-n // THREADS), props.multi_processor_count * BLOCKS_PER_SM)
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    global LAUNCHES
    for c0, c1 in groups:
        rc = lib.direct_agg_launch(slots.data_ptr(), vals.data_ptr(), n, k,
                                   n_slots, c0, c1, out.data_ptr(), blocks,
                                   THREADS, stream)
        if rc != 0:
            raise RuntimeError(f"direct_agg kernel launch failed: cudaError {rc}")
        LAUNCHES += 1
    return out


def group_sums_plain(slots: torch.Tensor, vals: torch.Tensor, n_slots: int,
                     out: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``group_sums``: ``index_add_`` of the
    (n, K+1) rows (values and a ones column) into (S+1, K+1) int64, rows
    outside [0, S) in the trailing trash row, which is dropped.  int64
    ``index_add_`` wraps in two's complement, so the sums are the
    kernel's sums mod 2^64."""
    _check_group_sums(slots, vals, n_slots, out)
    n = slots.shape[0]
    inside = (slots >= 0) & (slots < n_slots)
    idx = torch.where(inside, slots, torch.full_like(slots, n_slots)).long()
    rows = torch.cat([vals, torch.ones((1, n), dtype=torch.int64,
                                       device=slots.device)]).T
    acc = torch.zeros((n_slots + 1, rows.shape[1]), dtype=torch.int64,
                      device=slots.device)
    acc.index_add_(0, idx, rows)
    out += acc[:n_slots]
    return out


def _check(slots, values, masks, live) -> None:
    if len(values) != len(masks):
        raise ValueError(f"{len(values)} values but {len(masks)} masks")
    n = slots.shape[0]
    for t in [live, *values, *(m for m in masks if m is not None)]:
        if t.shape != (n,):
            raise ValueError(f"column of shape {tuple(t.shape)}, expected ({n},)")
        if t.device != slots.device:
            raise ValueError("all inputs must be on one device")


def _direct(slots: torch.Tensor, values: Sequence[torch.Tensor],
            masks: Sequence[Optional[torch.Tensor]], live: torch.Tensor,
            n_slots: int, accumulate):
    _check(slots, values, masks, live)
    n = slots.shape[0]
    dev = slots.device
    slots = torch.where(live, slots.to(torch.int32),
                        torch.full((n,), n_slots, dtype=torch.int32, device=dev))
    cols: List[torch.Tensor] = []
    for v, m in zip(values, masks):
        v = v.to(torch.int64)
        cols.append(v if m is None else torch.where(m, v, torch.zeros_like(v)))
    nn_idx: List[int] = []
    for m in masks:
        if m is None:
            nn_idx.append(-1)
        else:
            cols.append((m & live).to(torch.int64))
            nn_idx.append(len(cols) - 1)
    vals = (torch.stack(cols) if cols
            else torch.zeros((0, n), dtype=torch.int64, device=dev))
    out = torch.zeros((n_slots, vals.shape[0] + 1), dtype=torch.int64, device=dev)
    accumulate(slots.contiguous(), vals.contiguous(), n_slots, out)
    counts = out[:, -1]
    nn_counts = [counts if ix < 0 else out[:, ix] for ix in nn_idx]
    return out[:, :len(values)], counts, nn_counts


def direct_sums(slots: torch.Tensor, values: Sequence[torch.Tensor],
                masks: Sequence[Optional[torch.Tensor]], live: torch.Tensor,
                n_slots: int):
    """Grouped sums and counts of int64 value columns.

    ``slots``: int (n,) in [0, n_slots) on live rows; dead rows may hold
    anything.  ``values[v]``: int (n,); ``masks[v]``: its validity or
    None.  Returns (sums (n_slots, V) int64 mod 2^64, live-row counts
    (n_slots,) int64, per-value non-null counts)."""
    return _direct(slots, values, masks, live, n_slots, group_sums)


def direct_sums_plain(slots: torch.Tensor, values: Sequence[torch.Tensor],
                      masks: Sequence[Optional[torch.Tensor]],
                      live: torch.Tensor, n_slots: int):
    """``direct_sums`` through the plain torch version on any device (the
    reference for the kernel)."""
    return _direct(slots, values, masks, live, n_slots, group_sums_plain)


__all__ = ["direct_sums", "direct_sums_plain", "group_sums",
           "group_sums_plain", "column_groups", "LAUNCHES"]
