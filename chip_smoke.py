"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tiflash_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and holds each against its plain torch
version on the card.  Then it drives two paths through
``tiflash_tpu_torch.runtime.executor.run_query`` on ``cuda``, at SF1 with
random data from seed 0:

- TPC-H Q1 and Q6 over the lineitem table (5,999,438 rows), which run
  the stream_agg kernel;
- TPC-H Q7 and Q7 over all nation pairs over the five-table catalog
  (nation, supplier, customer, orders, lineitem), which join and then
  aggregate by the sort method (Q7) or the direct_agg kernel (Q7-pairs).

Every result is checked bit-exact against the port's own CPU run and an
independent numpy computation.  Any failure exits non-zero.  The last
line of standard output is the JSON device record; the line before it
lists the kernels with their launch counts, errors and times.

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
Q7_RANGE = ("1995-01-01", "1996-12-31")
Q7_TABLES = ["nation", "supplier", "customer", "orders", "lineitem"]


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


def q7_arrays(cat) -> dict:
    """Host numpy copies of the columns Q7 reads, plus the nation names."""
    cols = {
        "nation": ("n_nationkey", "n_name"),
        "supplier": ("s_suppkey", "s_nationkey"),
        "customer": ("c_custkey", "c_nationkey"),
        "orders": ("o_orderkey", "o_custkey"),
        "lineitem": ("l_orderkey", "l_suppkey", "l_shipdate",
                     "l_extendedprice", "l_discount"),
    }
    out = {c: cat[t].block[c].data.numpy() for t, cs in cols.items() for c in cs}
    out["nation_dict"] = cat["nation"].block["n_name"].dictionary
    return out


def _q7_rows(a: dict):
    """The Q7 join graph in numpy: per lineitem row, whether it survives
    the shipdate filter and the four inner joins, and its supplier's and
    customer's nation-name codes.  Nations per suppkey and per custkey
    come from index arrays, orders from np.searchsorted on o_orderkey."""
    import numpy as np

    def by_key(keys, vals):
        table = np.full(int(keys.max()) + 2, -1, dtype=np.int64)
        table[keys] = vals
        return table

    def lookup(table, keys):
        safe = np.clip(keys, 0, len(table) - 1)
        return np.where((keys >= 0) & (keys < len(table)), table[safe], -1)

    name_of_nation = by_key(a["n_nationkey"], a["n_name"])
    supp_nation = lookup(name_of_nation, lookup(by_key(a["s_suppkey"],
                                                       a["s_nationkey"]),
                                                a["l_suppkey"]))
    order = np.argsort(a["o_orderkey"], kind="stable")
    okeys = a["o_orderkey"][order]
    pos = np.clip(np.searchsorted(okeys, a["l_orderkey"]), 0, len(okeys) - 1)
    found = okeys[pos] == a["l_orderkey"]
    custkey = np.where(found, a["o_custkey"][order[pos]], -1)
    cust_nation = lookup(name_of_nation, lookup(by_key(a["c_custkey"],
                                                       a["c_nationkey"]),
                                                custkey))
    d = a["l_shipdate"]
    live = ((d >= _days(Q7_RANGE[0])) & (d <= _days(Q7_RANGE[1]))
            & (supp_nation >= 0) & (cust_nation >= 0))
    volume = a["l_extendedprice"] * (100 - a["l_discount"])   # scale 4
    return live, supp_nation, cust_nation, volume


def _grouped(keys, volume, names, key_names) -> dict:
    """Group sums and counts by the key columns (nation-name codes sort
    like the names: the dictionary is sorted), with np.add.at."""
    import numpy as np

    uniq, inv = np.unique(np.stack(keys, 1), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    sums = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(sums, inv, volume)
    counts = np.bincount(inv, minlength=len(uniq))
    out = {}
    for j, nm in enumerate(key_names):
        col = uniq[:, j].tolist()
        out[nm] = [names[c] for c in col] if nm.endswith("nation") else col
    return out, sums.tolist(), counts.tolist()


def numpy_q7(a: dict) -> dict:
    """TPC-H Q7 over host arrays: FRANCE/GERMANY pairs by ship year."""
    import numpy as np

    live, sn, cn, volume = _q7_rows(a)
    names = a["nation_dict"]
    fr, de = names.index("FRANCE"), names.index("GERMANY")
    m = live & (((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr)))
    year = a["l_shipdate"].astype("datetime64[D]").astype("datetime64[Y]")
    year = year.astype(np.int64) + 1970
    out, sums, _ = _grouped([sn[m], cn[m], year[m]], volume[m], names,
                            ["supp_nation", "cust_nation", "l_year"])
    out["revenue"] = sums
    return out


def numpy_q7_pairs(a: dict) -> dict:
    """Q7's join graph over all nation pairs: revenue, average volume
    (scale 8, half up) and line count per (supp_nation, cust_nation)."""
    live, sn, cn, volume = _q7_rows(a)
    out, sums, counts = _grouped([sn[live], cn[live]], volume[live],
                                 a["nation_dict"], ["supp_nation", "cust_nation"])
    out["revenue"] = sums
    out["avg_volume"] = [_half_up_div(s * 10 ** 4, n) for s, n in zip(sums, counts)]
    out["n_lines"] = counts
    return out


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


def direct_cases(n_q7: int):
    """(name, slots, values, masks, live, n_slots) cases for the
    direct_agg kernel against its plain version, random from a seeded
    generator on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def ints(lo, hi, n, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=g, device="cuda", dtype=dtype)

    def live(n, frac):
        return torch.rand((n,), generator=g, device="cuda") < frac

    def case(name, n, S, k, live_frac=0.7, lo=0, hi=10 ** 9, null_frac=None,
             dead_slots=None):
        slots = ints(0, S, n, torch.int32)
        lv = live(n, live_frac)
        if dead_slots is not None:  # dead rows carry slots outside [0, S)
            bad = torch.where(ints(0, 2, n) == 0, dead_slots[0], dead_slots[1])
            slots = torch.where(lv, slots, bad.to(torch.int32))
        vals = [ints(lo, hi, n) for _ in range(k)]
        masks = [None if null_frac is None else live(n, 1 - null_frac)
                 for _ in range(k)]
        return name, slots, vals, masks, lv, S

    return [
        case("q7_pairs_shape", n_q7, 676, 1, live_frac=0.3),
        case("s4096_k10_column_groups", 2_000_000, 4096, 10),
        case("ragged_rows", 1_000_003, 100, 2),
        case("all_dead", 300_001, 676, 1, live_frac=0.0),
        case("dead_rows_slots_out_of_range", 1_500_001, 676, 1,
             dead_slots=(-7, 10 ** 6)),
        case("sums_wrap_mod_2_64", 1_000_000, 3, 2, live_frac=0.9,
             lo=2 ** 62 - 2 ** 20, hi=2 ** 62),
        case("nullable_value_nonnull_counts", 1_200_000, 700, 2, null_frac=0.3),
    ]


def check_direct_agg(DA, n_q7: int) -> int:
    """direct_agg kernel == plain on every case (torch.equal); returns the
    largest absolute difference seen (0)."""
    import torch

    max_err = 0
    for name, slots, vals, masks, lv, S in direct_cases(n_q7):
        got = DA.direct_sums(slots, vals, masks, lv, S)
        want = DA.direct_sums_plain(slots, vals, masks, lv, S)
        torch.cuda.synchronize()
        pairs = [(got[0], want[0]), (got[1], want[1])] + list(zip(got[2], want[2]))
        for a, b in pairs:
            err = int((a - b).abs().max()) if a.numel() else 0
            max_err = max(max_err, err)
            if not torch.equal(a, b):
                raise AssertionError(f"direct_agg kernel != plain on {name}: "
                                     f"max abs err {err}")
        groups = len(DA.column_groups(S, len(vals) + sum(m is not None for m in masks)
                                      + 1))
        print(f"direct_agg kernel == plain (exact): {name} rows={slots.shape[0]} "
              f"S={S} values={len(vals)} column_groups={groups}")
    # raw slots outside [0, S) on live rows: the kernel itself skips them
    slots = torch.tensor([0, -7, 10 ** 6, 3, 4, 3], dtype=torch.int32, device="cuda")
    vals = torch.arange(6, dtype=torch.int64, device="cuda").reshape(1, 6)
    out = DA.group_sums(slots, vals, 4, torch.zeros((4, 2), dtype=torch.int64,
                                                    device="cuda"))
    if out.tolist() != [[0, 1], [0, 0], [0, 0], [8, 2]]:
        raise AssertionError(f"direct_agg kernel read a row outside [0, S): {out.tolist()}")
    print("direct_agg kernel skips slots outside [0, S) (-7, 10^6, S)")
    return max_err


def time_pair(kernel, plain, reps: int):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain; the
    smaller of each pair."""
    p1 = time_ms(plain, reps)
    k1 = time_ms(kernel, reps)
    k2 = time_ms(kernel, reps)
    p2 = time_ms(plain, reps)
    return min(k1, k2), min(p1, p2)


def main() -> int:
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    from tiflash_tpu_torch.bench.tpch_queries import (q1_plan, q6_plan,
                                                      q7_nation_pairs_plan, q7_plan)
    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.ops.cuda import build, direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # ---- 2. build: one nvcc per source, all at once -------------------------
    kernels = ("stream_agg", "direct_agg")
    t0 = time.perf_counter()
    build.build_libraries(kernels)
    print(f"build {', '.join(k + '.cu' for k in kernels)}: "
          f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        print(f"  nvcc {k}.cu: {build.BUILD_SECONDS[k]:.2f} s")
        for line in build.BUILD_LOG.get(k, "").splitlines():
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

    t0 = time.perf_counter()
    cat7 = generate_tpch(sf=SF, seed=SEED, tables=Q7_TABLES)
    print(f"five-table catalog sf{SF}: " + ", ".join(
        f"{t} {cat7[t].row_count}" for t in Q7_TABLES)
        + f" rows in {time.perf_counter() - t0:.1f} s")
    q7_plans = (("q7", q7_plan), ("q7_pairs", q7_nation_pairs_plan))
    t0 = time.perf_counter()
    cpu7 = {name: block_result(run_query(plan_fn(), cat7.blocks("cpu"))[0])
            for name, plan_fn in q7_plans}
    a7 = q7_arrays(cat7)
    np7 = {"q7": numpy_q7(a7), "q7_pairs": numpy_q7_pairs(a7)}
    for name, _ in q7_plans:
        if cpu7[name][0] != np7[name]:
            raise AssertionError(f"{name}: port CPU run != numpy")
    print(f"cpu reference runs equal numpy for q7 and q7_pairs "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- 3. kernels against their plain versions --------------------------------
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
    direct_err = check_direct_agg(DA, cat7["lineitem"].row_count)

    # ---- 4. Q1 and Q6 at SF1 on the card ----------------------------------------
    gpu_tables = cat.blocks("cuda")
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = 0
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
    if DA.LAUNCHES:
        raise AssertionError("q1/q6 launched the direct_agg kernel")
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

        k_ms, p_ms = time_pair(lambda: run_all(SA.group_sums),
                               lambda: run_all(SA.group_sums_plain), KERNEL_REPS)
        rows = sum(c[0].shape[0] for c in captured)
        print(f"{name} sf{SF} run_query median {q_ms:.3f} ms over {WARM_RUNS} warm runs; "
              f"stream_agg kernel {k_ms:.3f} ms vs plain {p_ms:.3f} ms over "
              f"{rows} rows in {len(captured)} launches [{card}]")
        if name == "q1":
            kernel_ms, plain_ms = k_ms, p_ms
    del gpu_tables

    # ---- 5. Q7 and Q7 over all nation pairs at SF1 on the card -------------------
    gpu7 = cat7.blocks("cuda")
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = 0
    direct_per_query = {}
    for name, plan_fn in q7_plans:
        d0, s0 = DA.LAUNCHES, SA.LAUNCHES
        out, summary = run_query(plan_fn(), gpu7)
        torch.cuda.synchronize()
        direct_per_query[name] = DA.LAUNCHES - d0
        if SA.LAUNCHES != s0:
            raise AssertionError(f"{name}: launched the stream_agg kernel")
        if summary.device != "cuda:0" or summary.retries:
            raise AssertionError(f"{name}: ran on {summary.device} with "
                                 f"{summary.retries} retries")
        got = block_result(out)
        if got != cpu7[name]:
            raise AssertionError(f"{name}: cuda result != cpu result")
        if got[0] != np7[name]:
            raise AssertionError(f"{name}: cuda result != numpy")
        print(f"{name} sf{SF} on cuda: {summary.result_rows} groups, direct_agg "
              f"launches {direct_per_query[name]}, bit-exact vs port CPU run and numpy")
        if name == "q7":
            print(f"  q7 rows: {got[0]}")
    q7_launches = DA.LAUNCHES
    if direct_per_query["q7_pairs"] < 1:
        raise AssertionError("q7_pairs: direct_agg kernel was not launched")
    if len(np7["q7_pairs"]["n_lines"]) != 625:
        raise AssertionError(f"q7_pairs: {len(np7['q7_pairs']['n_lines'])} groups, "
                             "expected 625")

    direct_ms = direct_plain_ms = None
    for name, plan_fn in q7_plans:
        plan = plan_fn()
        q_ms = time_ms(lambda: run_query(plan, gpu7), WARM_RUNS)
        line = f"{name} sf{SF} run_query median {q_ms:.3f} ms over {WARM_RUNS} warm runs"
        if name == "q7_pairs":
            captured = []
            orig = DA.group_sums

            def capture_direct(slots, vals, n_slots, out):
                captured.append((slots.clone(), vals.clone(), n_slots))
                return orig(slots, vals, n_slots, out)

            DA.group_sums = capture_direct
            try:
                run_query(plan, gpu7)
            finally:
                DA.group_sums = orig

            def run_direct(fn):
                for slots, vals, n_slots in captured:
                    fn(slots, vals, n_slots,
                       torch.zeros((n_slots, vals.shape[0] + 1), dtype=torch.int64,
                                   device="cuda"))

            direct_ms, direct_plain_ms = time_pair(
                lambda: run_direct(DA.group_sums),
                lambda: run_direct(DA.group_sums_plain), KERNEL_REPS)
            slots, vals, n_slots = captured[0]
            live = int(((slots >= 0) & (slots < n_slots)).sum())
            line += (f"; direct_agg kernel {direct_ms:.3f} ms vs plain "
                     f"{direct_plain_ms:.3f} ms over {slots.shape[0]} rows "
                     f"({live} live), S={n_slots}, {vals.shape[0]} value columns")
        print(line + f" [{card}]")

    print(json.dumps({"kernels": [{
        "name": "stream_agg",
        "route": "cuda",
        "source": "tiflash_tpu_torch/csrc/stream_agg.cu",
        "replaces": "tiflash_tpu/ops/pallas/stream_agg.py:160",
        "launches": main_path_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "direct_agg",
        "route": "cuda",
        "source": "tiflash_tpu_torch/csrc/direct_agg.cu",
        "replaces": "tiflash_tpu/ops/pallas/direct_agg.py:116",
        "launches": q7_launches,
        "max_abs_err": direct_err,
        "ms": direct_ms,
        "plain_ms": direct_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
