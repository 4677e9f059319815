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
appended for every masked value.  It hands the K value columns to the
kernel as K separate (n,) int64 tensors (their pointers travel in the
launch parameters: nothing is stacked) and allocates a zeroed (S, K+1)
int64 output whose last column holds the live-row counts.  The kernel
adds each live row's values into its slot, mod 2^64, in shared memory.
``launch_plan`` (plain Python) splits the K+1 output columns into groups
whose S x cols x 8 B accumulator fits one block's 227 KB, one launch per
group, and gives each group as many private accumulator copies per block
as keep ``MIN_BLOCKS_PER_SM`` blocks on an SM, and the blocks per SM that
its shared memory allows.

Bound: device-memory bytes, 4 B of slot per row and 8 B per value column
of each live row: Q7 over all nation pairs at SF1 about 71 MB, 0.021 ms
at 3.35 TB/s.

``direct_sums_plain`` is the same contract in plain torch; the wrappers
use it only for CPU tensors, and a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
THREADS = 256
WARPS = THREADS // 32
# dynamic shared memory one block may use on sm_90 after the opt-in, and
# what one SM holds (1 KB of it reserved per resident block)
MAX_SMEM = 232_448
SM_SMEM = 233_472
BLOCK_RESERVED = 1024
MAX_BLOCKS_PER_SM = 2048 // THREADS
# private accumulator copies are added only while this many blocks fit
# (on an H100, 2 beat 1, 4 and 8 on Q7-pairs' domain and on a skewed one:
# bench/kernel_variants.py)
MIN_BLOCKS_PER_SM = 2

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load_library

        lib = load_library("direct_agg")
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.direct_agg_init.argtypes = [c_int]
        lib.direct_agg_init.restype = c_int
        lib.direct_agg_max_values.argtypes = []
        lib.direct_agg_max_values.restype = c_int
        lib.direct_agg_launch.argtypes = [
            c_ptr, c_ptr, c_int, ctypes.c_longlong, ctypes.c_longlong, c_int, c_int,
            c_int, c_int, c_ptr, c_int, c_int, c_int, c_ptr]
        lib.direct_agg_launch.restype = c_int
        rc = lib.direct_agg_init(MAX_SMEM)
        if rc != 0:
            raise RuntimeError(f"direct_agg kernel init failed: cudaError {rc}")
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


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    col_begin: int
    col_end: int
    copies: int          # private accumulator copies per block
    smem: int            # dynamic shared memory bytes per block
    blocks_per_sm: int


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``THREADS`` threads one SM holds with ``smem`` bytes of
    dynamic shared memory each."""
    return min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_RESERVED))


def launch_plan(n_slots: int, n_cols: int) -> List[GroupPlan]:
    """One launch per column group: copies double (up to one per warp)
    while ``MIN_BLOCKS_PER_SM`` blocks still fit an SM."""
    plans = []
    for c0, c1 in column_groups(n_slots, n_cols):
        per_copy = n_slots * (c1 - c0) * 8
        copies = 1
        while (2 * copies <= WARPS and 2 * copies * per_copy <= MAX_SMEM
               and blocks_per_sm(2 * copies * per_copy) >= MIN_BLOCKS_PER_SM):
            copies *= 2
        smem = copies * per_copy
        plans.append(GroupPlan(c0, c1, copies, smem, blocks_per_sm(smem)))
    return plans


Values = Union[torch.Tensor, Sequence[torch.Tensor]]


def _value_list(vals: Values) -> List[torch.Tensor]:
    """K (n,) columns from a sequence of them or a (K, n) tensor."""
    return list(vals.unbind(0)) if isinstance(vals, torch.Tensor) else list(vals)


def _check_group_sums(slots: torch.Tensor, vals: List[torch.Tensor], n_slots: int,
                      out: torch.Tensor) -> None:
    if slots.dtype != torch.int32 or slots.dim() != 1:
        raise TypeError(f"slots must be 1-D int32, got {slots.dtype} {tuple(slots.shape)}")
    for v in vals:
        if v.dtype != torch.int64:
            raise TypeError(f"values must be int64, got {v.dtype}")
        if tuple(v.shape) != tuple(slots.shape):
            raise ValueError(f"values {tuple(v.shape)} vs slots {tuple(slots.shape)}")
        if v.device != slots.device:
            raise ValueError("slots, values and out must be on one device")
    if out.dtype != torch.int64 or tuple(out.shape) != (n_slots, len(vals) + 1):
        raise ValueError(f"out must be ({n_slots}, {len(vals) + 1}) int64")
    if slots.device != out.device:
        raise ValueError("slots, values and out must be on one device")


def group_sums(slots: torch.Tensor, vals: Values, n_slots: int,
               out: torch.Tensor) -> torch.Tensor:
    """Add into ``out`` ((S, K+1) int64), per slot, the sum of each of the
    K value columns (a sequence of (n,) int64 tensors, or a (K, n)
    tensor) mod 2^64 and, in the last column, the row count.  Rows whose
    slot lies outside [0, S) add nothing.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, once per column group."""
    vals = _value_list(vals)
    _check_group_sums(slots, vals, n_slots, out)
    if slots.device.type == "cpu":
        return group_sums_plain(slots, vals, n_slots, out)
    if slots.device.type != "cuda":
        raise RuntimeError(f"no direct_agg kernel for device {slots.device}")
    if not all(t.is_contiguous() for t in (slots, out, *vals)):
        raise ValueError("direct_agg kernel takes contiguous tensors")
    n = int(slots.shape[0])
    plans = launch_plan(n_slots, len(vals) + 1)
    if n == 0:
        return out
    lib = _kernel_lib()
    if len(vals) > lib.direct_agg_max_values():
        raise ValueError(f"{len(vals)} value columns, above the kernel's "
                         f"{lib.direct_agg_max_values()}")
    n_sm = torch.cuda.get_device_properties(slots.device).multi_processor_count
    base = slots.data_ptr()
    head = min(n, (-base) % 16 // 4)  # rows before the first 16-byte aligned one
    ptrs = (ctypes.c_longlong * max(1, len(vals)))(*[v.data_ptr() for v in vals])
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    global LAUNCHES
    for g in plans:
        blocks = min(-(-n // (4 * THREADS)), n_sm * g.blocks_per_sm)
        rc = lib.direct_agg_launch(base, ptrs, len(vals), n, head, n_slots,
                                   g.col_begin, g.col_end, g.copies, out.data_ptr(), blocks, THREADS, g.smem, stream)
        if rc != 0:
            raise RuntimeError(f"direct_agg kernel launch failed: cudaError {rc}")
        LAUNCHES += 1
    return out


def group_sums_plain(slots: torch.Tensor, vals: Values, n_slots: int,
                     out: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``group_sums``: ``index_add_`` of the
    (n, K+1) rows (values and a ones column) into (S+1, K+1) int64, rows
    outside [0, S) in the trailing trash row, which is dropped.  int64
    ``index_add_`` wraps in two's complement, so the sums are the
    kernel's sums mod 2^64."""
    vals = _value_list(vals)
    _check_group_sums(slots, vals, n_slots, out)
    n = slots.shape[0]
    inside = (slots >= 0) & (slots < n_slots)
    idx = torch.where(inside, slots, torch.full_like(slots, n_slots)).long()
    rows = torch.stack([*vals, torch.ones(n, dtype=torch.int64,
                                          device=slots.device)], dim=1)
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
    out = torch.zeros((n_slots, len(cols) + 1), dtype=torch.int64, device=dev)
    accumulate(slots.contiguous(), [c.contiguous() for c in cols], n_slots, out)
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
           "group_sums_plain", "column_groups", "launch_plan", "blocks_per_sm",
           "GroupPlan", "LAUNCHES"]
