"""Grouped field sums for the fused scan -> filter -> project -> aggregate path.

Replaces the Pallas TPU kernel ``tiflash_tpu/ops/pallas/stream_agg.py``
(``stream_group_sums``, body ``_kernel``) with the hand-written CUDA
kernel ``tiflash_tpu_torch/csrc/stream_agg.cu`` for Hopper (``sm_90a``).
``stream_group_sums`` keeps the reference's signature and output
contract, ``(inputs, make_tile_values, n_slots, n_limbs, n_rows,
plane_fields) -> (S, n_fields) int64``, so the fuse and recombination code
around it ports line by line.

How it runs: the per-query tile function (filter, projection, key
packing, limb split) runs as torch code over row chunks of at most
``CHUNK_ROWS`` rows and yields ``slots`` int32 ``(m,)`` (dead rows = S)
and ``planes`` int32 ``(L, m)``; the kernel then adds every packed field
of every live row into its slot.  The reference traced the tile function
into its kernel body; generating per-query CUDA source to fuse it back in
is the first speed step of the port and is not done here.

Bound: device-memory bytes.  Q1 at SF1 reads 7 int32 input columns,
7 x 4 B x 6.0M rows, about 168 MB; the unfused slot and plane arrays
that the torch tile function writes and the kernel reads add about as
much again.

``stream_group_sums_plain`` is the same contract in vectorized torch
(extract the fields, ``index_add_`` into ``(S+1, n_fields)`` int64, drop
the trash row).  The wrappers use it only for CPU tensors; a CUDA tensor
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
# rows the torch tile function handles per kernel launch
CHUNK_ROWS = 1 << 22
THREADS = 256
BLOCKS_PER_SM = 8
_MAX_SMEM = 48 * 1024  # static limit without an opt-in attribute

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load_library

        lib = load_library("stream_agg")
        fn = lib.stream_agg_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def field_table(plane_fields: Optional[Sequence[Sequence[Tuple[int, int, int]]]],
                n_limbs: int) -> List[Tuple[int, int, int, int]]:
    """Rows of (plane, bit offset, capacity bits, out index).  Without a
    packed layout every plane is one 31-bit field."""
    if plane_fields is None:
        rows = [(li, 0, 31, li) for li in range(n_limbs)]
    else:
        if len(plane_fields) != n_limbs:
            raise ValueError(f"{len(plane_fields)} plane layouts for {n_limbs} planes")
        rows = [(li, off, cap, oi) for li, fs in enumerate(plane_fields)
                for off, cap, oi in fs]
    for li, off, cap, oi in rows:
        if not (0 <= off and 1 <= cap and off + cap <= 31):
            raise ValueError(f"field ({off}, {cap}) of plane {li} leaves int31")
    if sorted(r[3] for r in rows) != list(range(len(rows))):
        raise ValueError("field out indices must be 0..n_fields-1")
    return rows


Fields = Sequence[Tuple[int, int, int, int]]


def _check(slots: torch.Tensor, planes: torch.Tensor, fields: Fields,
           n_slots: int, out: torch.Tensor) -> None:
    if slots.dtype != torch.int32 or planes.dtype != torch.int32:
        raise TypeError(f"slots/planes must be int32, got {slots.dtype}/{planes.dtype}")
    if planes.dim() != 2 or slots.dim() != 1 or planes.shape[1] != slots.shape[0]:
        raise ValueError(f"planes {tuple(planes.shape)} vs slots {tuple(slots.shape)}")
    if any(not 0 <= f[0] < planes.shape[0] for f in fields):
        raise ValueError(f"a field names a plane outside 0..{planes.shape[0] - 1}")
    if out.dtype != torch.int64 or tuple(out.shape) != (n_slots, len(fields)):
        raise ValueError(f"out must be ({n_slots}, {len(fields)}) int64")
    if slots.device != planes.device or slots.device != out.device:
        raise ValueError("slots, planes and out must be on one device")


def group_sums(slots: torch.Tensor, planes: torch.Tensor, fields: Fields,
               n_slots: int, out: torch.Tensor) -> torch.Tensor:
    """Add, per slot, every field's sum over the rows into ``out``
    ((S, n_fields) int64, accumulated in place).  ``fields`` are the rows
    of ``field_table``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check(slots, planes, fields, n_slots, out)
    if slots.device.type == "cpu":
        return group_sums_plain(slots, planes, fields, n_slots, out)
    if slots.device.type != "cuda":
        raise RuntimeError(f"no stream_agg kernel for device {slots.device}")
    if not (slots.is_contiguous() and planes.is_contiguous() and out.is_contiguous()):
        raise ValueError("stream_agg kernel takes contiguous tensors")
    n_fields = len(fields)
    smem = n_slots * n_fields * 8 + n_fields * 16
    if smem > _MAX_SMEM:
        raise ValueError(f"{n_slots} slots x {n_fields} fields need {smem} B of "
                         "shared memory")
    m = int(slots.shape[0])
    if m == 0:
        return out
    lib = _kernel_lib()
    table = torch.tensor(fields, dtype=torch.int32, device=slots.device).reshape(-1, 4)
    props = torch.cuda.get_device_properties(slots.device)
    blocks = min(-(-m // THREADS), props.multi_processor_count * BLOCKS_PER_SM)
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    rc = lib.stream_agg_launch(slots.data_ptr(), planes.data_ptr(), m,
                               table.data_ptr(), n_fields, n_slots,
                               out.data_ptr(), blocks, THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"stream_agg kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def group_sums_plain(slots: torch.Tensor, planes: torch.Tensor,
                     fields: Fields, n_slots: int,
                     out: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``group_sums``: extract every field per
    element, ``index_add_`` into (S+1, n_fields) with dead rows in the
    trailing trash row, drop it."""
    _check(slots, planes, fields, n_slots, out)
    live = (slots >= 0) & (slots < n_slots)
    idx = torch.where(live, slots, torch.full_like(slots, n_slots)).long()
    cols = []
    for plane, off, cap, _ in sorted(fields, key=lambda r: r[3]):
        v = planes[plane].to(torch.int64)
        cols.append((v >> off) & ((1 << cap) - 1))
    vals = torch.stack(cols, dim=1) if cols else torch.zeros(
        (slots.shape[0], 0), dtype=torch.int64, device=slots.device)
    acc = torch.zeros((n_slots + 1, len(cols)), dtype=torch.int64,
                      device=slots.device)
    acc.index_add_(0, idx, vals)
    out += acc[:n_slots]
    return out


def _stream(inputs: Dict[str, torch.Tensor], make_tile_values: Callable,
            n_slots: int, n_limbs: int, n_rows: int, plane_fields,
            accumulate: Callable) -> torch.Tensor:
    if not inputs:
        raise ValueError("stream_group_sums needs at least one input column")
    dev = next(iter(inputs.values())).device
    staged = {}
    for nm, arr in inputs.items():
        if int(arr.shape[0]) != n_rows:
            raise ValueError(f"input {nm} has {arr.shape[0]} rows, expected {n_rows}")
        if arr.dtype == torch.bool:
            arr = arr.to(torch.int32)
        if arr.dtype != torch.int32:
            raise TypeError(f"input {nm} must be int32 or bool, got {arr.dtype}")
        staged[nm] = arr
    fields = field_table(plane_fields, n_limbs)
    out = torch.zeros((n_slots, len(fields)), dtype=torch.int64, device=dev)
    for start in range(0, n_rows, CHUNK_ROWS):
        stop = min(start + CHUNK_ROWS, n_rows)
        tile = {nm: arr[start:stop] for nm, arr in staged.items()}
        in_bounds = torch.ones(stop - start, dtype=torch.bool, device=dev)
        slots, limbs = make_tile_values(tile, in_bounds)
        if len(limbs) != n_limbs:
            raise ValueError(f"tile function gave {len(limbs)} planes, expected {n_limbs}")
        planes = torch.stack(limbs).to(torch.int32).contiguous()
        accumulate(slots.to(torch.int32).contiguous(), planes, fields, n_slots, out)
    return out


def stream_group_sums(inputs: Dict[str, torch.Tensor], make_tile_values: Callable,
                      n_slots: int, n_limbs: int, n_rows: int,
                      plane_fields=None) -> torch.Tensor:
    """Run the tile function over the rows and sum every field per slot.

    ``inputs``: 1-D int32/bool tensors of length ``n_rows``.
    ``make_tile_values(tile_dict, in_bounds) -> (slots int32, [plane int32])``
      runs per row chunk; each plane value is non-negative int31, and rows
      whose slot is outside [0, n_slots) contribute nothing.
    ``plane_fields``: optional packed layout — per plane a list of
      ``(bit_offset, capacity_bits, out_index)`` fields.
    Returns (n_slots, n_limbs) int64 sums, or with ``plane_fields``
    (n_slots, n_fields) ordered by ``out_index``."""
    return _stream(inputs, make_tile_values, n_slots, n_limbs, n_rows,
                   plane_fields, group_sums)


def stream_group_sums_plain(inputs: Dict[str, torch.Tensor],
                            make_tile_values: Callable, n_slots: int,
                            n_limbs: int, n_rows: int,
                            plane_fields=None) -> torch.Tensor:
    """``stream_group_sums`` through the plain torch version on any
    device (the reference for the kernel)."""
    return _stream(inputs, make_tile_values, n_slots, n_limbs, n_rows,
                   plane_fields, group_sums_plain)


__all__ = ["stream_group_sums", "stream_group_sums_plain", "group_sums",
           "group_sums_plain", "field_table", "LAUNCHES", "CHUNK_ROWS"]
