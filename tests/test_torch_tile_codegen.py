"""The generated row functions (``tile_program.emit_cuda``), compiled for
the host.

There is no ``nvcc`` here, so the text that the fused kernel inlines is
compiled with ``g++`` instead, through a shim that defines ``__device__``
and ``__forceinline__`` away (the row functions are plain C++ on
scalars; loads and accumulation belong to the kernel's skeleton).  Every
program of the fusing cases of ``testing/fuse_cases.py`` and of TPC-H
Q1/Q6 is built in one ``g++`` call, each with a small harness that loads
every row of the raw arrays as the kernel's skeleton does, and run
through ``ctypes``.  Dead rows (``sel`` off) and NULL rows hold codes -5
and 1000 in their data, as narrow32 wraparound leaves them.  The slots
and planes must equal the program's torch ``evaluate`` bit for bit on
every row.  Skips where ``g++`` is absent.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import pytest
import torch

from tiflash_tpu_torch.ops import tile_program as TP
from tiflash_tpu_torch.ops.cuda import stream_agg as TSA
from tiflash_tpu_torch.ops.cuda import stream_tile as TST
from tiflash_tpu_torch.plan.compiler import compile_fragment
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing import fuse_cases as FC

# the extra programs: Q1/Q6, and the sel case with no int32 shadow (int64
# columns narrowed in the row function, dates read as they are)
EXTRA = ["tpch_q1", "tpch_q6", "sel_no_shadow"]

SHIM = """#pragma once
#include <cstdint>
#define __device__
#define __forceinline__ inline
"""

HARNESS = """
#include "shim.h"
namespace {{
{source}
}}  // namespace

extern "C" void run_{i}(const void* const* arr, long long n, const int* prm,
                        int* slots, unsigned* planes) {{
  for (long long i = 0; i < n; ++i) {{
    TileMask m{{}};
    TileAgg a{{}};
#define LOAD_M(k, T) m.a##k = static_cast<const T*>(arr[k])[i];
#define LOAD_A(k, T) a.a##k = static_cast<const T*>(arr[k])[i];
    TILE_MASK_ARRAYS(LOAD_M)
    TILE_AGG_ARRAYS(LOAD_A)
    slots[i] = (int)tile_slot(m, prm);
    unsigned out[TILE_L];
    tile_planes(m, a, prm, out);
    for (int l = 0; l < TILE_L; ++l) planes[l * n + i] = out[l];
  }}
}}
"""


def _programs():
    """(name, arrays, program) of every fused call the cases make."""
    from tiflash_tpu_torch.bench import tpch_queries as TQ
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    runs = [(c.name, c.plan(FC.TORCH),
             blocks_from_numpy(FC.numpy_tables(c.columns(c.n, c.seed)), "cpu"))
            for c in FC.CASES]
    li = generate_tpch(sf=0.002, seed=2, tables=["lineitem"]).blocks("cpu")
    runs += [("tpch_q1", TQ.q1_plan(), li), ("tpch_q6", TQ.q6_plan(), li)]
    sel = next(r for r in runs if r[0] == "sel")
    t = sel[2]["t"]
    bare = dataclasses.replace(t, columns=tuple(dataclasses.replace(c, narrow32=None)
                                                for c in t.columns))
    runs.append(("sel_no_shadow", sel[1], {"t": bare}))
    seen = []

    def spy(inputs, program, n_slots, n_limbs, n_rows, plane_fields, headroom, device):
        seen.append((inputs, program, n_rows))
        return torch.zeros((n_slots, len(TSA.field_table(plane_fields, n_limbs))),
                           dtype=torch.int64)

    real = TST.fused_group_sums
    TST.fused_group_sums = spy
    try:
        out = []
        for name, plan, tables in runs:
            compile_fragment(plan)(tables)
            inputs, program, n_rows = seen.pop()
            out.append((name, _junk_rows(inputs, tables["t" if "t" in tables else
                                                       "lineitem"]), program, n_rows))
    finally:
        TST.fused_group_sums = real
    return out


def _junk_rows(inputs, block):
    """The arrays with every dead row's and every NULL row's data set to
    -5 or 1000 (bool arrays as they are)."""
    n = block.capacity
    junk = torch.where(torch.arange(n) % 2 == 0, -5, 1000)
    dead = torch.zeros(n, dtype=torch.bool) if block.sel is None else ~block.sel
    out = {}
    for name, x in inputs.items():
        if x.dtype == torch.bool:
            out[name] = x
            continue
        col = name if name in block.names else None
        bad = dead.clone()
        if col is not None and block[col].validity is not None:
            bad |= ~block[col].validity
        out[name] = torch.where(bad, junk.to(x.dtype), x)
    return out


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the generated row source has no host build")
    programs = _programs()
    d = tmp_path_factory.mktemp("tile_codegen")
    (d / "shim.h").write_text(SHIM)
    files = []
    for i, (_, _, program, _) in enumerate(programs):
        path = d / f"program_{i}.cpp"
        path.write_text(HARNESS.format(i=i, source=TP.emit_cuda(program)))
        files.append(str(path))
    lib = d / "libtile_programs.so"
    proc = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d),
                           "-o", str(lib), *files], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib)), programs


def test_every_case_has_a_program(host_build):
    _, programs = host_build
    names = [p[0] for p in programs]
    assert names == [c.name for c in FC.CASES] + EXTRA
    # the cases cover every input storage and conversion
    kinds = {(a.storage, t.conversion) for _, _, prog, _ in programs
             for t in prog.inputs for a in [prog.arrays[t.array]]}
    assert kinds == {("i32", "id"), ("u8", "id"), ("i64", "id"), ("i64", "w0"),
                     ("i64", "w1")}


@pytest.mark.parametrize("index", range(len(FC.CASES) + len(EXTRA)))
def test_host_build_equals_evaluate(host_build, index):
    lib, programs = host_build
    name, arrays, program, n = programs[index]
    cols = [arrays[a.name].contiguous() for a in program.arrays]
    L = len(program.planes)
    ptrs = (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])
    prm = (ctypes.c_int * max(1, len(program.params)))(*program.params)
    slots = torch.empty(n, dtype=torch.int32)
    planes = torch.empty((L, n), dtype=torch.int32)
    fn = getattr(lib, f"run_{index}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = None
    fn(ptrs, n, prm, slots.data_ptr(), planes.data_ptr())
    want_slots, want_planes = TP.evaluate(program, TP.stage(program, arrays),
                                          torch.ones(n, dtype=torch.bool))
    assert torch.equal(slots, want_slots), name
    for got, want in zip(planes, want_planes):
        assert torch.equal(got, want), name
    if name in ("sel", "q1_like_nulls", "sel_no_shadow"):
        # the junk rows are dead or NULL: slot S, or a part zeroed
        assert int((want_slots == program.n_slots).sum()) > 0
