"""The fused scan -> filter -> project -> aggregate kernel, generated per plan.

Replaces the whole Pallas TPU kernel ``tiflash_tpu/ops/pallas/stream_agg.py``
(``stream_group_sums`` at ``:160``, body ``_kernel``, whose traced tile
function at ``:88`` does the filter, projection arithmetic, key packing
and limb split): ``emit_cuda`` writes the plan's ``TileProgram`` as row
functions, ``csrc/stream_tile.cu.in`` wraps them in a persistent kernel
around the accumulator of ``csrc/stream_agg_core.cuh`` (the one the
planes kernel ``csrc/stream_agg.cu`` uses), and ``build.build_generated``
compiles the text with ``nvcc`` for ``sm_90a`` at first use, named by its
hash.  One launch per fused aggregation reads the raw input columns and
keeps slots, parts and planes in registers: no slot or plane column in
device memory.  The launch parameters carry the plan's literal values,
so a plan that differs only in them reuses the built library.

Bound: device-memory bytes.  The kernel reads every row of the
live-mask and key columns (4 B per int32, 1 B per bool, 8 B per int64);
the columns only the aggregates read are loaded for quads (4 rows)
holding a live row, so sparse selections (TPC-H Q6: 2% of rows) read
those in 32-byte sectors.  The least any load order needs reads a later
predicate's column, too, only in the sectors where earlier predicates
left a row live (``chip_smoke.tile_bound_bytes``).  Q1 at SF1: 7 int32
columns, 167,984,264 B, 0.050 ms at 3.35 TB/s.

``fused_group_sums_plain`` is the same contract in torch: ``evaluate``
over row chunks of ``stream_agg.CHUNK_ROWS`` rows, then
``group_sums_plain``.  ``fused_group_sums`` takes it for a table on the
CPU only; on a CUDA table it launches the kernel or raises, also for a
program that reads no array (a bare ``count(*)``: the caller names the
table's device).  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from .. import tile_program as TP
from . import stream_agg as SA

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
THREADS = 256
# quads (4 rows) a lane loads before it adds any, in the register regime
UNROLL = 2
# the register regime holds S x L uint32 partials and UNROLL x 4 rows of
# L planes per lane: layouts whose L x (S + 4 x UNROLL) fits this budget
# take it, larger ones the thread-private shared-memory columns
REGISTER_BUDGET = 128
TEMPLATE = "stream_tile.cu.in"
_STORAGE_BYTES = {"i32": 4, "u8": 1, "i64": 8}


@dataclasses.dataclass(frozen=True)
class TilePlan:
    regime: str      # "registers" or "shared"
    threads: int
    smem: int        # dynamic shared memory bytes per block
    vector: bool     # the headroom allows the 16-byte path


def plan_tile_launch(n_slots: int, n_planes: int, n_fields: int,
                     headroom: int) -> TilePlan:
    """Registers where L x (S + 4 x UNROLL) <= REGISTER_BUDGET, else
    thread-private shared-memory columns as ``stream_agg.plan_launch``
    sizes them."""
    if not 1 <= n_planes <= SA.MAX_PLANES or not 1 <= n_fields <= SA.MAX_FIELDS:
        raise ValueError(f"{n_planes} planes and {n_fields} fields: the kernel "
                         f"takes 1..{SA.MAX_PLANES} planes and 1..{SA.MAX_FIELDS} fields")
    if not 0 <= headroom <= 30:
        raise ValueError(f"headroom {headroom} outside 0..30")
    vector = headroom >= SA.VECTOR_MIN_HEADROOM
    totals = n_slots * n_fields * 8
    if n_planes * (n_slots + 4 * UNROLL) <= REGISTER_BUDGET:
        return TilePlan("registers", THREADS, totals, vector)
    per_thread = n_slots * n_planes * 4
    threads = min(THREADS, (SA.MAX_SMEM - totals) // per_thread // 32 * 32)
    if threads < 32:
        raise ValueError(f"{n_slots} slots x {n_planes} planes x {n_fields} fields "
                         f"do not fit {SA.MAX_SMEM} B of shared memory")
    return TilePlan("shared", threads, totals + threads * per_thread, vector)


def _ternary(values: Sequence[int], var: str, suffix: str) -> str:
    """A constexpr lookup of ``values[var]`` as a chain of conditionals."""
    expr = f"0{suffix}"
    for i in reversed(range(len(values))):
        expr = f"{var} == {i} ? {values[i]}{suffix} : ({expr})"
    return expr


def layout_source(fields: Sequence[Tuple[int, int, int, int]], n_planes: int,
                  headroom: int, plan: TilePlan) -> str:
    """The accumulator's compile-time constants: field table, headroom
    window and regime."""
    begin, packed = SA._packed_fields(tuple(tuple(f) for f in fields), n_planes)
    return "\n".join([
        f"constexpr int TILE_NF = {len(fields)};",
        f"constexpr int TILE_WINDOW = {1 << headroom};",
        f"constexpr bool TILE_REGISTERS = {'true' if plan.regime == 'registers' else 'false'};",
        f"constexpr int TILE_UNROLL = {UNROLL};",
        "struct TileLayout {",
        "  __device__ __forceinline__ constexpr int n_slots() const { return TILE_S; }",
        "  __device__ __forceinline__ constexpr int n_planes() const { return TILE_L; }",
        "  __device__ __forceinline__ constexpr int n_fields() const { return TILE_NF; }",
        "  __device__ __forceinline__ constexpr int begin(int l) const {",
        f"    return {_ternary(list(begin), 'l', '')};",
        "  }",
        "  __device__ __forceinline__ constexpr unsigned field(int f) const {",
        f"    return {_ternary(list(packed), 'f', 'u')};",
        "  }",
        "};",
        "",
    ])


@functools.lru_cache(maxsize=1)
def _template() -> str:
    from .build import CSRC

    return (CSRC / TEMPLATE).read_text()


def kernel_source(program: TP.TileProgram, fields, headroom: int) -> Tuple[str, TilePlan]:
    """(the generated kernel's whole source, its launch plan)."""
    n_planes = len(program.planes)
    plan = plan_tile_launch(program.n_slots, n_planes, len(fields), headroom)
    text = _template().replace(
        "@TILE_PROGRAM@",
        TP.emit_cuda(program) + "\n" + layout_source(fields, n_planes, headroom, plan))
    return text, plan


def _kernel_lib(text: str) -> ctypes.CDLL:
    """Build (or load) a generated source and set up its kernel."""
    from .build import build_generated

    lib = build_generated("stream_tile", text)
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.stream_tile_init.argtypes = [c_int]
    lib.stream_tile_init.restype = c_int
    lib.stream_tile_launch.argtypes = [
        c_ptr, ctypes.c_longlong, ctypes.c_longlong, c_int, c_ptr, c_int, c_int,
        c_int, c_ptr, c_ptr]
    lib.stream_tile_launch.restype = c_int
    rc = lib.stream_tile_init(SA.MAX_SMEM)
    if rc != 0:
        raise RuntimeError(f"stream_tile kernel init failed: cudaError {rc}")
    return lib


# (plan shape) -> (its built library, its launch plan)
_KERNELS: Dict[tuple, Tuple[ctypes.CDLL, TilePlan]] = {}


def _kernel(program: TP.TileProgram, fields, headroom: int) -> Tuple[ctypes.CDLL, TilePlan]:
    """The built kernel of the program's plan shape, generated and built at
    its first call; later calls find it by the program's structure (its
    nodes are interned, so the lookup walks nothing)."""
    key = (program.live, program.key_slot, program.planes, program.arrays,
           program.inputs, program.n_slots, tuple(map(tuple, fields)), headroom)
    hit = _KERNELS.get(key)
    if hit is None:
        text, plan = kernel_source(program, fields, headroom)
        hit = _KERNELS[key] = (_kernel_lib(text), plan)
    return hit


def _arrays(inputs: Dict[str, torch.Tensor], program: TP.TileProgram,
            n_rows: int) -> List[torch.Tensor]:
    out = []
    for a in program.arrays:
        x = inputs[a.name]
        if TP.STORAGE_OF_DTYPE.get(x.dtype) != a.storage or x.dim() != 1:
            raise TypeError(f"array {a.name}: {x.dtype} {tuple(x.shape)}, the program "
                            f"reads 1-D {a.storage}")
        if int(x.shape[0]) != n_rows:
            raise ValueError(f"array {a.name} has {x.shape[0]} rows, expected {n_rows}")
        out.append(x)
    return out


def vector_head(arrays: Sequence[torch.Tensor], storages: Sequence[str],
                n_rows: int):
    """The first row at which every array's 4-row quad is aligned for one
    vector load (16 B of int32 or int64 halves, 4 B of bool), or None
    when no row serves them all."""
    for head in range(4):
        ok = True
        for x, st in zip(arrays, storages):
            size = _STORAGE_BYTES[st]
            addr = x.data_ptr() + size * head
            if addr % (16 if st != "u8" else 4):
                ok = False
                break
        if ok:
            return min(head, n_rows)
    return None


def _device(arrays: Sequence[torch.Tensor], device) -> torch.device:
    """The one device of the call: ``device`` where given (a program that
    reads no array, as a bare ``count(*)``, has only this), else the
    arrays'.  Every array must lie on it."""
    if device is None:
        if not arrays:
            raise ValueError("a program that reads no array needs its device")
        device = arrays[0].device
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if any(x.device != dev for x in arrays):
        raise ValueError(f"the program's arrays must all be on {dev}")
    return dev


def fused_group_sums(inputs: Dict[str, torch.Tensor], program: TP.TileProgram,
                     n_slots: int, n_limbs: int, n_rows: int, plane_fields=None,
                     headroom: int = 0, device=None) -> torch.Tensor:
    """Per slot, the int64 sum of every packed field of the program's
    planes over the live rows: ``(n_slots, n_fields)`` ordered by out
    index, the ``stream_group_sums`` contract.  ``inputs``: the program's
    arrays by name, 1-D of ``n_rows`` rows.  ``device``: where the table
    lies (needed when the program reads no array).  On the CPU this takes
    the plain version; on CUDA it launches the generated kernel, also for
    a program that reads no array."""
    if program.n_slots != n_slots or len(program.planes) != n_limbs:
        raise ValueError(f"program of {program.n_slots} slots and "
                         f"{len(program.planes)} planes, called for {n_slots} x {n_limbs}")
    arrays = _arrays(inputs, program, n_rows)
    fields = SA.field_table(plane_fields, n_limbs)
    dev = _device(arrays, device)
    if dev.type == "cpu":
        return fused_group_sums_plain(inputs, program, n_slots, n_limbs, n_rows,
                                      plane_fields, headroom, dev)
    if dev.type != "cuda":
        raise RuntimeError(f"no stream_tile kernel for device {dev}")
    if not all(x.is_contiguous() for x in arrays):
        raise ValueError("stream_tile kernel takes contiguous arrays")
    if any(f[2] <= headroom for f in fields):
        raise ValueError(f"a field of capacity <= headroom {headroom}")
    lib, plan = _kernel(program, fields, headroom)
    out = torch.zeros((n_slots, len(fields)), dtype=torch.int64, device=dev)
    if n_rows == 0:
        return out
    storages = [a.storage for a in program.arrays]
    head = vector_head(arrays, storages, n_rows) if plan.vector else None
    ptrs = (ctypes.c_longlong * max(1, len(arrays)))(*[x.data_ptr() for x in arrays])
    prm = (ctypes.c_int * max(1, len(program.params)))(*program.params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.stream_tile_launch(ptrs, n_rows, head or 0, int(head is not None), prm,
                                len(program.params), plan.threads, plan.smem,
                                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"stream_tile kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def fused_group_sums_plain(inputs: Dict[str, torch.Tensor], program: TP.TileProgram,
                           n_slots: int, n_limbs: int, n_rows: int, plane_fields=None,
                           headroom: int = 0, device=None) -> torch.Tensor:
    """Plain torch version of ``fused_group_sums`` on any device: the
    program's ``evaluate`` over row chunks of ``stream_agg.CHUNK_ROWS``,
    each chunk's slots and planes summed by ``group_sums_plain`` (which
    raises if a live field breaks the headroom)."""
    arrays = _arrays(inputs, program, n_rows)
    fields = SA.field_table(plane_fields, n_limbs)
    dev = _device(arrays, device)
    out = torch.zeros((n_slots, len(fields)), dtype=torch.int64, device=dev)
    for start in range(0, n_rows, SA.CHUNK_ROWS):
        stop = min(start + SA.CHUNK_ROWS, n_rows)
        chunk = {a.name: x[start:stop] for a, x in zip(program.arrays, arrays)}
        in_bounds = torch.ones(stop - start, dtype=torch.bool, device=dev)
        slots, planes = TP.evaluate(program, TP.stage(program, chunk), in_bounds)
        SA.group_sums_plain(slots, planes, fields, n_slots, out, headroom)
    return out


__all__ = ["fused_group_sums", "fused_group_sums_plain", "plan_tile_launch",
           "kernel_source", "layout_source", "vector_head", "TilePlan", "LAUNCHES",
           "REGISTER_BUDGET"]
