"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``tiflash_tpu_torch/csrc``, holds it
against its plain torch version on the card, then drives TPC-H Q1 and Q6
at SF1 (5,999,438 lineitem rows, random data from seed 0) through
``tiflash_tpu_torch.runtime.executor.run_query`` on ``cuda`` and checks
the results bit-exact against the port's own CPU run and an independent
numpy computation.  Any failure exits non-zero.  The last line of
standard output is the JSON device record; the line before it lists the
kernels with their launch counts, errors and times.

Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import datetime
import json
import statistics
import subprocess
import sys
import time

SF = 1
SEED = 0
WARM_RUNS = 10
KERNEL_REPS = 20
Q1_CUTOFF = "1998-09-02"
Q6_RANGE = ("1994-01-01", "1995-01-01")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _days(s: str) -> int:
    return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days


def _half_up_div(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return q if num >= 0 else -q


def numpy_q1(li: dict) -> dict:
    """TPC-H Q1 over host arrays: int64 mantissas, group sums by masks."""
    import numpy as np

    live = li["l_shipdate"] <= _days(Q1_CUTOFF)
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    qty, ext = li["l_quantity"], li["l_extendedprice"]
    disc, tax = li["l_discount"], li["l_tax"]
    disc_price = ext * (100 - disc)                  # scale 4
    charge = disc_price * (100 + tax)                # scale 6
    out = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty",
                           "sum_base_price", "sum_disc_price", "sum_charge",
                           "avg_qty", "avg_price", "avg_disc", "count_order")}
    for i, rfs in enumerate(li["rf_dict"]):
        for j, lss in enumerate(li["ls_dict"]):
            g = live & (rf == i) & (ls == j)
            n = int(g.sum())
            if not n:
                continue
            sq, se, sd = (int(np.sum(x[g], dtype=np.int64)) for x in (qty, ext, disc))
            out["l_returnflag"].append(rfs)
            out["l_linestatus"].append(lss)
            out["sum_qty"].append(sq)
            out["sum_base_price"].append(se)
            out["sum_disc_price"].append(int(np.sum(disc_price[g], dtype=np.int64)))
            out["sum_charge"].append(int(np.sum(charge[g], dtype=np.int64)))
            # avg of a scale-2 decimal is scale 6: sum * 10^4 / n, half up
            out["avg_qty"].append(_half_up_div(sq * 10 ** 4, n))
            out["avg_price"].append(_half_up_div(se * 10 ** 4, n))
            out["avg_disc"].append(_half_up_div(sd * 10 ** 4, n))
            out["count_order"].append(n)
    return out


def numpy_q6(li: dict) -> dict:
    import numpy as np

    d = li["l_shipdate"]
    m = ((d >= _days(Q6_RANGE[0])) & (d < _days(Q6_RANGE[1]))
         & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
         & (li["l_quantity"] < 2400))
    rev = li["l_extendedprice"] * li["l_discount"]   # scale 4
    return {"revenue": [int(np.sum(rev[m], dtype=np.int64)) if m.any() else None]}


def lineitem_arrays(cat) -> dict:
    """Host numpy copies of the columns Q1/Q6 read, plus dictionaries."""
    t = cat["lineitem"].block
    li = {n: t[n].data.numpy() for n in (
        "l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
        "l_extendedprice", "l_discount", "l_tax")}
    li["rf_dict"] = t["l_returnflag"].dictionary
    li["ls_dict"] = t["l_linestatus"].dictionary
    return li


def block_result(block) -> tuple:
    """(decoded live rows, column types) of a result block."""
    return block.to_pylists(), [repr(c.dtype) for c in block.columns]


def edge_cases(q1_fields, q6_fields, n_q1: int):
    """(name, slots, planes, plane_fields) cases for kernel vs plain,
    random from a seeded generator on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    def planes(n_planes, m):
        return rnd(0, 2 ** 31 - 1, (n_planes, m))

    cases = [
        ("q1_shape", rnd(0, 7, (n_q1,)), planes(len(q1_fields), n_q1), q1_fields, 6),
        ("ragged_rows", rnd(-2, 9, (1_000_003,)), planes(len(q1_fields), 1_000_003),
         q1_fields, 6),
        ("all_dead", torch.full((300_001,), 6, dtype=torch.int32, device="cuda"),
         planes(len(q1_fields), 300_001), q1_fields, 6),
        ("keyless_s1", rnd(0, 2, (2_000_001,)), planes(len(q6_fields), 2_000_001),
         q6_fields, 1),
        ("s64_few_planes", rnd(0, 65, (3_000_017,)), planes(2, 3_000_017),
         [[(0, 15, 0), (15, 16, 1)], [(0, 31, 2)]], 64),
        ("full_31bit_field", rnd(0, 4, (2_500_000,)), planes(1, 2_500_000),
         [[(0, 31, 0)]], 4),
    ]
    return cases


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after a warm
    run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    from tiflash_tpu_torch.bench.tpch_queries import q1_plan, q6_plan
    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.ops.cuda import build, stream_agg as SA
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library("stream_agg")
    print(f"build stream_agg.cu: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.BUILD_SECONDS['stream_agg']:.2f} s)")
    for line in build.BUILD_LOG.get("stream_agg", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # data and the port's CPU reference runs (plain path)
    t0 = time.perf_counter()
    cat = generate_tpch(sf=SF, seed=SEED, tables=["lineitem"])
    n_rows = cat["lineitem"].row_count
    print(f"lineitem sf{SF}: {n_rows} rows in {time.perf_counter() - t0:.1f} s")
    cpu_tables = cat.blocks("cpu")
    cpu_res, layouts = {}, {}
    for name, plan_fn in (("q1", q1_plan), ("q6", q6_plan)):
        before = SF_.FUSE_STATS["count"]
        out, _ = run_query(plan_fn(), cpu_tables)
        if SF_.FUSE_STATS["count"] != before + 1:
            raise AssertionError(f"{name}: fuse did not engage on the CPU run")
        cpu_res[name] = block_result(out)
        layouts[name] = SF_.FUSE_STATS["plane_fields"]
    li = lineitem_arrays(cat)
    np_res = {"q1": numpy_q1(li), "q6": numpy_q6(li)}
    for name in ("q1", "q6"):
        if cpu_res[name][0] != np_res[name]:
            raise AssertionError(f"{name}: port CPU run != numpy\n{cpu_res[name][0]}\n"
                                 f"{np_res[name]}")
    print("cpu reference runs equal numpy for q1 and q6")

    # ---- 3. kernel against plain ----------------------------------------------
    # tolerance zero: the outputs are integer sums, compared with torch.equal
    max_err = 0
    for name, slots, planes, pf, n_slots in edge_cases(layouts["q1"], layouts["q6"], n_rows):
        fields = SA.field_table(pf, len(pf))
        got = SA.group_sums(slots, planes, fields, n_slots,
                            torch.zeros((n_slots, len(fields)), dtype=torch.int64,
                                        device="cuda"))
        want = SA.group_sums_plain(slots, planes, fields, n_slots,
                                   torch.zeros_like(got))
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain on {name}: max abs err {err}")
        print(f"kernel == plain (exact): {name} rows={slots.shape[0]} S={n_slots} "
              f"planes={len(pf)} fields={len(fields)}")

    # ---- 4. Q1 and Q6 at SF1 on the card ----------------------------------------
    gpu_tables = cat.blocks("cuda")
    torch.cuda.synchronize()
    SA.LAUNCHES = 0
    fused_before = SF_.FUSE_STATS["count"]
    launches_per_query = {}
    outs = {}
    for name, plan_fn in (("q1", q1_plan), ("q6", q6_plan)):
        l0, f0 = SA.LAUNCHES, SF_.FUSE_STATS["count"]
        out, summary = run_query(plan_fn(), gpu_tables)
        torch.cuda.synchronize()
        outs[name] = out
        launches_per_query[name] = SA.LAUNCHES - l0
        if SF_.FUSE_STATS["count"] != f0 + 1:
            raise AssertionError(f"{name}: fuse did not engage on cuda")
        if launches_per_query[name] < 1:
            raise AssertionError(f"{name}: stream_agg kernel was not launched")
        if summary.device != "cuda:0":
            raise AssertionError(f"{name}: result on {summary.device}")
    main_path_launches = SA.LAUNCHES
    if SF_.FUSE_STATS["count"] != fused_before + 2:
        raise AssertionError("fuse count off")
    for name, out in outs.items():
        got = block_result(out)
        if got != cpu_res[name]:
            raise AssertionError(f"{name}: cuda result != cpu result\n{got}\n{cpu_res[name]}")
        if got[0] != np_res[name]:
            raise AssertionError(f"{name}: cuda result != numpy")
        print(f"{name} sf{SF} on cuda: kernel launches {launches_per_query[name]}, "
              f"bit-exact vs port CPU run and numpy: {got[0]}")

    # timings: whole query, then the kernel vs the plain version on the
    # query's own slot/plane tensors (captured in one extra run)
    kernel_ms = plain_ms = None
    for name, plan_fn in (("q1", q1_plan), ("q6", q6_plan)):
        plan = plan_fn()
        q_ms = time_ms(lambda: run_query(plan, gpu_tables), WARM_RUNS)
        captured = []
        orig = SA.group_sums

        def capture(slots, planes, fields, n_slots, out):
            captured.append((slots.clone(), planes.clone(), fields, n_slots))
            return orig(slots, planes, fields, n_slots, out)

        SA.group_sums = capture
        try:
            run_query(plan, gpu_tables)
        finally:
            SA.group_sums = orig

        def run_all(fn):
            for slots, planes, fields, n_slots in captured:
                fn(slots, planes, fields, n_slots,
                   torch.zeros((n_slots, len(fields)), dtype=torch.int64,
                               device="cuda"))

        p1 = time_ms(lambda: run_all(SA.group_sums_plain), KERNEL_REPS)
        k1 = time_ms(lambda: run_all(SA.group_sums), KERNEL_REPS)
        k2 = time_ms(lambda: run_all(SA.group_sums), KERNEL_REPS)
        p2 = time_ms(lambda: run_all(SA.group_sums_plain), KERNEL_REPS)
        k_ms, p_ms = min(k1, k2), min(p1, p2)
        rows = sum(c[0].shape[0] for c in captured)
        print(f"{name} sf{SF} run_query median {q_ms:.3f} ms over {WARM_RUNS} warm runs; "
              f"stream_agg kernel {k_ms:.3f} ms vs plain {p_ms:.3f} ms over "
              f"{rows} rows in {len(captured)} launches [{card}]")
        if name == "q1":
            kernel_ms, plain_ms = k_ms, p_ms

    print(json.dumps({"kernels": [{
        "name": "stream_agg",
        "route": "cuda",
        "source": "tiflash_tpu_torch/csrc/stream_agg.cu",
        "replaces": "tiflash_tpu/ops/pallas/stream_agg.py:160",
        "launches": main_path_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
