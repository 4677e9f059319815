"""Time the design alternatives of the port's fixed CUDA kernels on one card.

    python3 -m tiflash_tpu_torch.bench.kernel_variants

Each variant is this checkout's ``csrc/<kernel>.cu`` (with the shared
``csrc/stream_agg_core.cuh`` written in where it is included) with one
edit, an exact text substitution that must match once (an edited source
stops the script instead of timing something else).  All variants build at
once beside the real kernels and are loaded in their place, one at a
time, through the wrapper's own ``_kernel_lib``.  Each variant is held
against the plain version (``torch.equal``) on every input before it is
timed there:

- stream_agg (the planes kernel) at Q1's and Q6's own slots and planes
  at SF1 (seed 0), which the fused call's tile program makes on the card
  (``evaluate``): ``predicated_add`` (as committed), ``select_add``
  (``acc += hit ? v : 0``), ``u64_shared_atomic`` (one 64-bit shared
  atomicAdd where the kernel adds two native 32-bit ones);
- direct_agg at Q7-pairs' own arguments at SF1 and at the same rows with
  90% of the live rows moved into one slot (``skew``): ``base`` (as
  committed), ``u64_shared_atomic``, ``warp_aggregated`` (lanes that
  share a slot sum their values with ``__match_any_sync`` and
  ``__reduce_add_sync``, and one of them adds the sum), each at
  ``MIN_BLOCKS_PER_SM`` 1, 2, 4 and 8, which set the accumulator copies
  per block;
- join_probe at SSB's date, customer and part joins over a
  60,010,680-slot probe (``chip_smoke.ssb_join_inputs``): ``base`` (as
  committed: a matched flag stored only where a load finds it 0) and
  ``store_every_flag``, each at ``BLOCKS_PER_SM`` 4, 8 and 16.

CUDA events, median of 20, the L2 flushed by a read before each run;
every configuration is timed twice, the list forward and then backward,
and the smaller reading is kept.  Prints one line per configuration and
a JSON line with all of them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

SKEW_SLOT = 7
SKEW_SHARE = 0.9
BLOCKS_PER_SM = (1, 2, 4, 8)
JOIN_BLOCKS_PER_SM = (4, 8, 16)

_U64_ADD = """  unsigned* w = reinterpret_cast<unsigned*>(dst);
  const unsigned lo = (unsigned)v;
  const unsigned old = atomicAdd(w, lo);
  const unsigned hi = (unsigned)(v >> 32) + (old + lo < old ? 1u : 0u);
  if (hi) atomicAdd(w + 1, hi);
"""

STREAM_VARIANTS = {
    "predicated_add": [],
    "select_add": [("              if (hit) acc[s][l] += v[u][l][r];",
                    "              acc[s][l] += hit ? v[u][l][r] : 0u;")],
    "u64_shared_atomic": [(_U64_ADD, "  atomicAdd(dst, v);\n")],
}

DIRECT_VARIANTS = {
    "base": [],
    "u64_shared_atomic": [(_U64_ADD, "  atomicAdd(dst, v);\n")],
    "warp_aggregated": [("""#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (slot[r] < 0) continue;
      unsigned long long* dst = acc + (long long)slot[r] * cols + (c0 - p.col_begin);
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (v[r][j]) shared_add_u64(dst + j, v[r][j]);
    }
""", """    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned peers = __match_any_sync(0xffffffffu, slot[r]);
      const bool leader = lane == __ffs(peers) - 1;
      unsigned long long* dst = acc + (long long)slot[r] * cols + (c0 - p.col_begin);
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        unsigned long long sum = 0ull;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sum += (unsigned long long)__reduce_add_sync(
                     peers, (unsigned)(v[r][j] >> (16 * k)) & 0xffffu) << (16 * k);
        if (leader && slot[r] >= 0 && sum) shared_add_u64(dst + j, sum);
      }
    }
""")],
}


JOIN_VARIANTS = {
    "base": [],
    "store_every_flag": [(" && !p.flags[pos[r]]) p.flags[pos[r]] = 1;",
                          ") p.flags[pos[r]] = 1;")],
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"a variant's edit matches {src.count(old)} times, not "
                               f"once; the kernel source changed:\n{old}")
        src = src.replace(old, new)
    return src


def build_variants(build, kernel: str, variants: dict) -> dict:
    """{variant: path of its shared library}, one nvcc each, all at once."""
    src = (build.CSRC / f"{kernel}.cu").read_text()
    include = '#include "stream_agg_core.cuh"'
    if include in src:
        src = src.replace(include, (build.CSRC / "stream_agg_core.cuh").read_text())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in variants.items():
        cu = build.BUILD_DIR / f"variant_{kernel}_{name}.cu"
        cu.write_text(variant_source(src, edits))
        lib = build.BUILD_DIR / f"libvariant_{kernel}_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return jobs


def finish(jobs: dict) -> dict:
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = lib
    return libs


def use_library(build, mod, path) -> None:
    """Load ``path`` as ``mod``'s kernel library through its ``_kernel_lib``."""
    orig = build.load_library
    build.load_library = lambda _name: ctypes.CDLL(str(path))
    try:
        mod._lib = None
        mod._kernel_lib()
    finally:
        build.load_library = orig


def main() -> int:
    import torch

    from tiflash_tpu_torch.bench.compare_trees import smoke_helpers
    from tiflash_tpu_torch.bench.tpch_queries import q1_plan, q6_plan, q7_nation_pairs_plan
    from tiflash_tpu_torch.ops import tile_program as TP
    from tiflash_tpu_torch.ops.cuda import build, direct_agg as DA, join_probe as JP
    from tiflash_tpu_torch.ops.cuda import stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    if not torch.cuda.is_available():
        print("kernel_variants needs one CUDA card", file=sys.stderr)
        return 2
    smoke = smoke_helpers()
    card = smoke.card_line()
    print(card)
    jobs = {"stream_agg": build_variants(build, "stream_agg", STREAM_VARIANTS),
            "direct_agg": build_variants(build, "direct_agg", DIRECT_VARIANTS),
            "join_probe": build_variants(build, "join_probe", JOIN_VARIANTS)}
    libs = {k: finish(j) for k, j in jobs.items()}

    # the queries' own arguments, captured through the committed kernels
    gpu = generate_tpch(sf=smoke.SF, seed=smoke.SEED, tables=["lineitem"]).blocks("cuda")

    def planes_calls(plan_fn):
        (call,) = smoke.capture_calls(ST, "fused_group_sums", lambda: run_query(plan_fn(), gpu))
        inputs, program, n_slots, n_limbs, _, pf, h, _ = call
        slots, planes = TP.evaluate(program, TP.stage(program, inputs))
        return [(slots, planes, SA.field_table(pf, n_limbs), n_slots, None, h)]

    stream_in = {q: planes_calls(f) for q, f in (("q1", q1_plan), ("q6", q6_plan))}
    del gpu
    gpu = generate_tpch(sf=smoke.SF, seed=smoke.SEED, tables=smoke.Q7_TABLES).blocks("cuda")
    (q7,) = smoke.capture_calls(DA, "group_sums", lambda: run_query(q7_nation_pairs_plan(), gpu))
    del gpu
    slots, vals, n_slots, _ = q7
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    live = (slots >= 0) & (slots < n_slots)
    hot = live & (torch.rand(slots.shape, generator=g, device="cuda") < SKEW_SHARE)
    direct_in = {"q7_pairs": (slots, vals, n_slots),
                 "skew": (torch.where(hot, SKEW_SLOT, slots).to(torch.int32), vals, n_slots)}
    print(f"skew: {int(hot.sum())} of {int(live.sum())} live rows in slot {SKEW_SLOT}")
    join_in = {k: smoke.join_probe_args(*v) for k, v in smoke.ssb_join_inputs().items()}

    flush = smoke.L2Flush()
    results = []

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.int64, device="cuda")

    def stream_case(var, q):
        calls = stream_in[q]
        use_library(build, SA, libs["stream_agg"][var])
        for c in calls:
            shape = (c[3], len(c[2]))
            want = SA.group_sums_plain(*c[:4], zeros(shape), c[5])
            if not torch.equal(SA.group_sums(*c[:4], zeros(shape), c[5]), want):
                raise AssertionError(f"stream_agg {var} != plain at {q}")
        return smoke.time_ms(lambda: [SA.group_sums(*c[:4], zeros((c[3], len(c[2]))), c[5])
                                      for c in calls], smoke.KERNEL_REPS, flush)

    def direct_case(var, dom, mb):
        s, v, n = direct_in[dom]
        use_library(build, DA, libs["direct_agg"][var])
        DA.MIN_BLOCKS_PER_SM = mb
        want = DA.group_sums_plain(s, v, n, zeros((n, len(v) + 1)))
        if not torch.equal(DA.group_sums(s, v, n, zeros((n, len(v) + 1))), want):
            raise AssertionError(f"direct_agg {var} != plain at {dom}, {mb} blocks per SM")
        return smoke.time_ms(lambda: DA.group_sums(s, v, n, zeros((n, len(v) + 1))),
                             smoke.KERNEL_REPS, flush)

    def join_case(var, shape, bps):
        args = join_in[shape]
        use_library(build, JP, libs["join_probe"][var])
        JP.BLOCKS_PER_SM = bps
        got, want = JP.join_probe(*args), JP.join_probe_plain(*args)
        pairs = [(got[0], want[0]), (got[2], want[2])] + [
            (a, b) for gc, wc in zip(got[3], want[3]) for a, b in zip(gc, wc)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"join_probe {var} != plain at {shape}")
        del got, want, pairs
        return smoke.time_ms(lambda: JP.join_probe(*args), smoke.KERNEL_REPS, flush)

    configs = [("stream_agg", var, q, None) for q in stream_in for var in STREAM_VARIANTS]
    configs += [("direct_agg", var, dom, mb) for dom in direct_in
                for var in DIRECT_VARIANTS for mb in BLOCKS_PER_SM]
    configs += [("join_probe", var, shape, bps) for shape in join_in
                for var in JOIN_VARIANTS for bps in JOIN_BLOCKS_PER_SM]
    mb0, bps0 = DA.MIN_BLOCKS_PER_SM, JP.BLOCKS_PER_SM
    cases = {"stream_agg": lambda var, dom, mb: stream_case(var, dom),
             "direct_agg": direct_case, "join_probe": join_case}
    best = {}
    for cfg in configs + configs[::-1]:
        kernel, var, dom, mb = cfg
        ms = cases[kernel](var, dom, mb)
        best[cfg] = min(ms, best.get(cfg, ms))
    DA.MIN_BLOCKS_PER_SM, JP.BLOCKS_PER_SM = mb0, bps0
    for cfg in configs:
        kernel, var, dom, mb = cfg
        row = {"kernel": kernel, "variant": var, "input": dom, "ms": best[cfg]}
        where = ""
        if kernel == "join_probe":
            row.update(blocks_per_sm=mb)
            where = f" BLOCKS_PER_SM={mb}"
        elif mb is not None:
            saved, DA.MIN_BLOCKS_PER_SM = DA.MIN_BLOCKS_PER_SM, mb
            (plan,) = DA.launch_plan(direct_in[dom][2], len(direct_in[dom][1]) + 1)
            DA.MIN_BLOCKS_PER_SM = saved
            row.update(min_blocks_per_sm=mb, copies=plan.copies,
                       blocks_per_sm=plan.blocks_per_sm)
            where = f" MIN_BLOCKS_PER_SM={mb} (copies {plan.copies}, " \
                    f"{plan.blocks_per_sm} blocks/SM)"
        results.append(row)
        print(f"{kernel} {var} at {dom}{where}: {best[cfg]:.4f} ms, == plain [{card}]")
    print(json.dumps({"card": card, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
