"""Grouped field sums for the fused scan -> filter -> project -> aggregate path.

Replaces the Pallas TPU kernel ``tiflash_tpu/ops/pallas/stream_agg.py``
(``stream_group_sums``, body ``_kernel``) with the hand-written CUDA
kernel ``tiflash_tpu_torch/csrc/stream_agg.cu`` for Hopper (``sm_90a``).
``stream_group_sums`` keeps the reference's signature and output
contract, ``(inputs, make_tile_values, n_slots, n_limbs, n_rows,
plane_fields) -> (S, n_fields) int64``, so the fuse and recombination code
around it ports line by line.

How it runs: a tile function (filter, projection, key packing, limb
split) runs as torch code over row chunks of at most ``CHUNK_ROWS`` rows
and yields ``slots`` int32 ``(m,)`` (dead rows = S) and L int32 planes
``(m,)``; the kernel (the "planes kernel") then adds every packed field
of every live row into its slot.  The fused path itself no longer comes
here: ``ops/cuda/stream_tile.py`` generates one kernel per plan that
computes the slots and planes in registers around the same accumulator
(``csrc/stream_agg_core.cuh``), as the reference traces its tile function
into its kernel body.  ``group_sums`` serves slots and planes that are
already in memory.

The kernel keeps each lane's (slot, plane) partials in uint32 (in
registers for the ``REGISTER_SHAPES`` sizes, else in thread-private
shared-memory columns) and extracts the packed fields only every
``2**headroom`` rows: ``headroom`` is the bits every packed field keeps
free above its largest value (``stream_fuse.FIELD_GROWTH_BITS``); 0
extracts at every row.  ``plan_launch`` is that choice, in plain Python.
The launch passes the plane pointers and the field table by value: no
device copy, no stack of the planes, no stream sync.

Bound: device-memory bytes, 4 B of slot per row and 4 B per plane of
each live row: Q1 at SF1 about 166 MB, 0.050 ms at 3.35 TB/s.

``group_sums_plain`` is the same contract in vectorized torch (extract
the fields, ``index_add_`` into ``(S+1, n_fields)`` int64, drop the trash
row); it raises when a live field breaks the stated headroom, the
invariant the kernel relies on.  The wrappers use it only for CPU
tensors; a CUDA tensor launches the kernel or raises.  ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
# rows the torch tile function handles per kernel launch: SF1's 6.0M
# lineitem rows in one chunk, so the tile function's launches and the
# kernel's fixed cost come once per query
CHUNK_ROWS = 1 << 23
THREADS = 256
# dynamic shared memory one block may use on sm_90 after the opt-in
MAX_SMEM = 232_448
# what one launch's parameters carry (csrc/stream_agg.cu)
MAX_PLANES = 240
MAX_FIELDS = 256
# (S max, L max) of the kernel's register instantiations, smallest first:
# the two layouts the fuse makes (Q6 1 x 2, Q1 6 x 6); every other layout
# takes the shared regime
REGISTER_SHAPES = ((1, 2), (6, 6))
# the 16-byte path adds 8 rows per lane per step, so it needs 2^3 rows
# of headroom between flushes
VECTOR_MIN_HEADROOM = 3

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load_library

        lib = load_library("stream_agg")
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.stream_agg_init.argtypes = [c_int]
        lib.stream_agg_init.restype = c_int
        lib.stream_agg_limits.argtypes = [ctypes.POINTER(c_int)] * 3
        lib.stream_agg_limits.restype = c_int
        lib.stream_agg_launch.argtypes = [
            c_ptr, c_ptr, c_int, ctypes.c_longlong, ctypes.c_longlong, c_int,
            c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_int, c_int, c_ptr, c_ptr]
        lib.stream_agg_launch.restype = c_int
        limits = [c_int() for _ in range(3)]
        lib.stream_agg_limits(*limits)
        if [x.value for x in limits] != [MAX_PLANES, MAX_FIELDS, len(REGISTER_SHAPES)]:
            raise RuntimeError("csrc/stream_agg.cu and ops/cuda/stream_agg.py disagree "
                               "on the kernel's limits")
        rc = lib.stream_agg_init(MAX_SMEM)
        if rc != 0:
            raise RuntimeError(f"stream_agg kernel init failed: cudaError {rc}")
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
Planes = Union[torch.Tensor, Sequence[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    regime: str            # "registers" or "shared"
    variant: int           # index into REGISTER_SHAPES, -1 for shared
    threads: int
    smem: int              # dynamic shared memory bytes per block
    vector: bool           # the headroom allows the 16-byte path


def plan_launch(n_slots: int, n_planes: int, n_fields: int,
                headroom: int) -> LaunchPlan:
    """How the kernel runs a layout: the smallest register shape that
    holds S x L, else thread-private shared-memory columns with as many
    threads (a multiple of 32, at most ``THREADS``) as 227 KB allows."""
    if not 1 <= n_planes <= MAX_PLANES or not 1 <= n_fields <= MAX_FIELDS:
        raise ValueError(f"{n_planes} planes and {n_fields} fields: the kernel "
                         f"takes 1..{MAX_PLANES} planes and 1..{MAX_FIELDS} fields")
    if not 0 <= headroom <= 30:
        raise ValueError(f"headroom {headroom} outside 0..30")
    totals = n_slots * n_fields * 8
    vector = headroom >= VECTOR_MIN_HEADROOM
    for v, (sm, lm) in enumerate(REGISTER_SHAPES):
        if n_slots <= sm and n_planes <= lm:
            return LaunchPlan("registers", v, THREADS, totals, vector)
    per_thread = n_slots * n_planes * 4
    threads = min(THREADS, (MAX_SMEM - totals) // per_thread // 32 * 32)
    if threads < 32:
        raise ValueError(f"{n_slots} slots x {n_planes} planes x {n_fields} fields "
                         f"do not fit {MAX_SMEM} B of shared memory")
    return LaunchPlan("shared", -1, threads, totals + threads * per_thread, vector)


@functools.lru_cache(maxsize=256)
def _packed_fields(fields: Tuple[Tuple[int, int, int, int], ...], n_planes: int):
    """The field table as the launch takes it: per plane the range of its
    fields, each field as offset | cap << 5 | out index << 10."""
    order = sorted(fields, key=lambda r: r[0])
    begin = [0] * (n_planes + 1)
    for plane, _, _, _ in order:
        begin[plane + 1] += 1
    for li in range(n_planes):
        begin[li + 1] += begin[li]
    packed = [off | cap << 5 | oi << 10 for _, off, cap, oi in order]
    return ((ctypes.c_ushort * len(begin))(*begin),
            (ctypes.c_uint * len(packed))(*packed))


def _plane_list(planes: Planes) -> List[torch.Tensor]:
    """L 1-D planes from a sequence of them or an (L, m) tensor."""
    return list(planes.unbind(0)) if isinstance(planes, torch.Tensor) else list(planes)


def _check(slots: torch.Tensor, planes: List[torch.Tensor], fields: Fields,
           n_slots: int, out: torch.Tensor, headroom: int) -> None:
    if slots.dtype != torch.int32 or slots.dim() != 1:
        raise TypeError(f"slots must be 1-D int32, got {slots.dtype} {tuple(slots.shape)}")
    for p in planes:
        if p.dtype != torch.int32 or tuple(p.shape) != tuple(slots.shape):
            raise ValueError(f"plane {p.dtype} {tuple(p.shape)} vs slots "
                             f"{tuple(slots.shape)}: planes are int32 rows of the slots")
        if p.device != slots.device:
            raise ValueError("slots, planes and out must be on one device")
    if any(not 0 <= f[0] < len(planes) for f in fields):
        raise ValueError(f"a field names a plane outside 0..{len(planes) - 1}")
    if any(f[2] <= headroom for f in fields):
        raise ValueError(f"a field of capacity <= headroom {headroom}")
    if out.dtype != torch.int64 or tuple(out.shape) != (n_slots, len(fields)):
        raise ValueError(f"out must be ({n_slots}, {len(fields)}) int64")
    if slots.device != out.device:
        raise ValueError("slots, planes and out must be on one device")


def group_sums(slots: torch.Tensor, planes: Planes, fields: Fields,
               n_slots: int, out: torch.Tensor, headroom: int = 0) -> torch.Tensor:
    """Add, per slot, every field's sum over the rows into ``out``
    ((S, n_fields) int64, accumulated in place).  ``planes``: L int32
    rows of the slots, as a sequence or an (L, m) tensor; ``fields`` are
    the rows of ``field_table``; every live field value is below
    2^(cap - headroom).  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    planes = _plane_list(planes)
    _check(slots, planes, fields, n_slots, out, headroom)
    if slots.device.type == "cpu":
        return group_sums_plain(slots, planes, fields, n_slots, out, headroom)
    if slots.device.type != "cuda":
        raise RuntimeError(f"no stream_agg kernel for device {slots.device}")
    if not all(t.is_contiguous() for t in (slots, out, *planes)):
        raise ValueError("stream_agg kernel takes contiguous tensors")
    plan = plan_launch(n_slots, len(planes), len(fields), headroom)
    m = int(slots.shape[0])
    if m == 0:
        return out
    lib = _kernel_lib()
    base = slots.data_ptr()
    ptrs = [p.data_ptr() for p in planes]
    # the 16-byte path reads row i of every array at one phase: the planes
    # must share the slots' address modulo 16
    vector = plan.vector and all((p - base) % 16 == 0 for p in ptrs)
    head = min(m, (-base) % 16 // 4) if vector else 0
    begin, packed = _packed_fields(tuple(tuple(f) for f in fields), len(planes))
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    rc = lib.stream_agg_launch(base, (ctypes.c_longlong * len(ptrs))(*ptrs),
                               len(ptrs), m, head, int(vector), begin, packed,
                               len(fields), n_slots, 1 << headroom, plan.variant,
                               plan.threads, plan.smem, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"stream_agg kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def group_sums_plain(slots: torch.Tensor, planes: Planes, fields: Fields,
                     n_slots: int, out: torch.Tensor,
                     headroom: int = 0) -> torch.Tensor:
    """Plain torch version of ``group_sums``: extract every field per
    element, ``index_add_`` into (S+1, n_fields) with dead rows in the
    trailing trash row, drop it.  Raises if a live field value is not
    below 2^(cap - headroom)."""
    planes = _plane_list(planes)
    _check(slots, planes, fields, n_slots, out, headroom)
    live = (slots >= 0) & (slots < n_slots)
    idx = torch.where(live, slots, torch.full_like(slots, n_slots)).long()
    cols = []
    for plane, off, cap, _ in sorted(fields, key=lambda r: r[3]):
        v = (planes[plane].to(torch.int64) >> off) & ((1 << cap) - 1)
        if headroom and bool((torch.where(live, v, 0) >> (cap - headroom)).any()):
            raise ValueError(f"a live value of field ({off}, {cap}) of plane {plane} "
                             f"breaks the {headroom}-bit headroom")
        cols.append(v)
    vals = torch.stack(cols, dim=1) if cols else torch.zeros(
        (slots.shape[0], 0), dtype=torch.int64, device=slots.device)
    acc = torch.zeros((n_slots + 1, len(cols)), dtype=torch.int64,
                      device=slots.device)
    acc.index_add_(0, idx, vals)
    out += acc[:n_slots]
    return out


def _stream(inputs: Dict[str, torch.Tensor], make_tile_values: Callable,
            n_slots: int, n_limbs: int, n_rows: int, plane_fields, headroom: int,
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
        planes = [(x if x.dtype == torch.int32 else x.to(torch.int32)).contiguous()
                  for x in limbs]
        accumulate(slots.to(torch.int32).contiguous(), planes, fields, n_slots, out,
                   headroom)
    return out


def stream_group_sums(inputs: Dict[str, torch.Tensor], make_tile_values: Callable,
                      n_slots: int, n_limbs: int, n_rows: int,
                      plane_fields=None, headroom: int = 0) -> torch.Tensor:
    """Run the tile function over the rows and sum every field per slot.

    ``inputs``: 1-D int32/bool tensors of length ``n_rows``.
    ``make_tile_values(tile_dict, in_bounds) -> (slots int32, [plane int32])``
      runs per row chunk; each plane value is non-negative int31, and rows
      whose slot is outside [0, n_slots) contribute nothing.
    ``plane_fields``: optional packed layout — per plane a list of
      ``(bit_offset, capacity_bits, out_index)`` fields.
    ``headroom``: bits every field keeps free above its live values (0:
      none, the kernel extracts the fields at every row).
    Returns (n_slots, n_limbs) int64 sums, or with ``plane_fields``
    (n_slots, n_fields) ordered by ``out_index``."""
    return _stream(inputs, make_tile_values, n_slots, n_limbs, n_rows,
                   plane_fields, headroom, group_sums)


def stream_group_sums_plain(inputs: Dict[str, torch.Tensor],
                            make_tile_values: Callable, n_slots: int,
                            n_limbs: int, n_rows: int,
                            plane_fields=None, headroom: int = 0) -> torch.Tensor:
    """``stream_group_sums`` through the plain torch version on any
    device (the reference for the kernel)."""
    return _stream(inputs, make_tile_values, n_slots, n_limbs, n_rows,
                   plane_fields, headroom, group_sums_plain)


__all__ = ["stream_group_sums", "stream_group_sums_plain", "group_sums",
           "group_sums_plain", "field_table", "plan_launch", "LaunchPlan",
           "LAUNCHES", "CHUNK_ROWS", "REGISTER_SHAPES"]
