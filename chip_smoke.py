"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tiflash_tpu_torch/csrc`` (one
``nvcc`` per source, all at once): the planes kernel ``stream_agg.cu``,
``direct_agg.cu``, the unique join's dense probe ``join_probe.cu``
(``join_probe_phase``: SSB's date, customer and part joins over a
60,010,680-slot probe, dense == sorted per tensor, kernel == plain,
timed against its byte bound and the sorted join), and the fused scan kernels that ``stream_tile.cu.in``
generates per plan for the run's fused aggregations (Q1, Q6 and the fuse
cases of ``tiflash_tpu_torch/testing/fuse_cases.py``, whose programs the
CPU reference runs give); and the disk spill tier
``tiflash_tpu_torch/native/spiller.cpp`` with ``g++ -lz``.  Holds each against its plain torch version on
the card.  Then it drives these paths through
``tiflash_tpu_torch.runtime.executor.run_query`` on ``cuda``, at SF1 with
random data from seed 0:

- TPC-H Q1 and Q6 over the lineitem table (5,999,438 rows): one launch
  of the generated kernel each, no planes kernel, no tile program
  evaluated in torch on the card; Q6 with a second draw of its literals
  reuses the built kernel; then on the same table the spec-form Q1/Q6,
  the function sweep, and the string phase (``string_phase``): the string
  sweep of ``bench/strings.py`` against the CPU run with dictionaries as
  tuples, the ship-month report (a GROUP BY over two string expressions,
  553 slots on the direct_agg kernel) against the CPU run and numpy, and
  the runtime error of CAST(l_shipmode AS JSON), and the runner's
  controls (``runtime_controls_phase``: a ``CancelFlag`` set from another
  thread mid-run of an out-of-core query, ``max_execution_time_ms``,
  ``max_result_rows`` in both modes, a failpoint); then, on one SF10
  catalog (``sf10_catalog``: lineitem with Q1's columns and l_orderkey,
  orders and customer with Q3's), Q1 (60M rows), whose ``sum_charge``
  takes the two-limb recombination, against numpy alone, and the
  reference's out-of-core rehearsal (``outofcore_phase``) through
  ``QueryRunner``: Q3 by grace hash join and GROUP BY l_orderkey by
  chunked aggregation and the bucketed final merge, both spilled to disk,
  Q1 partitioned by group into 2 or 4 partitions (one generated launch
  each), revenue per ship date by chunks; each against its in-memory
  card run (Q3 and Q1 also numpy), with the launches the CPU dispatch
  predicts (``outofcore_predictions``);
- TPC-H Q7 and Q7 over all nation pairs over the five-table catalog
  (nation, supplier, customer, orders, lineitem), which join and then
  aggregate by the sort method (Q7) or the direct_agg kernel (Q7-pairs),
  and EXPLAIN ANALYZE of Q7-pairs (``explain_phase``);
- TPC-H Q3, Q10, Q4 and Q22 over the three-table catalog (lineitem,
  orders, customer), and ORDER BY l_extendedprice DESC LIMIT 100 over
  the lineitem table: the plan rewrites, the stream aggregation method,
  top-N and semi/anti joins, with no kernel; then the same top-N over a
  100,000,000-row int64 column made on the card from a seed;
- TPC-H Q2, Q5, Q8, Q9, Q11-Q21 and Q18 at TPC-H's threshold of 300
  over the eight-table catalog: decimal division and wide compares,
  LIKE/IN, min/max and count_distinct, hashed two-column join keys, left
  outer and cross joins and a CTE, with no kernel, as the CPU dispatch
  predicts;
- the analytic plans of ``tiflash_tpu_torch/bench/analytics.py`` on the
  lineitem catalog (with its seven ship-year partitions) and the
  eight-table catalog, each sent through ``plan/serde.py``'s
  ``dumps``/``loads`` first: a ROLLUP report (an Expand to 23,997,752
  rows, GROUPING() and a rank window), a window report (rank, running,
  lag, ROWS and RANGE frames over 5,999,438 rows), the statistical, bit,
  quantile, group_concat and sketch aggregates, float sums by the stream
  method over 1.5M orders, Q1 over a Union of the partitions, Q13 as a
  right and as a full outer join, and NOT IN with and without a NULL in
  its subquery (``analytics_phase``), with no kernel, as the CPU dispatch
  predicts;
- the product slice (``vector_phase``, ``loader_phase``,
  ``service_phase``): exact vector search over a 1,000,000 x 128 float32
  corpus made on the host from a seed (64 queries, k = 100, every metric)
  against numpy float64 and the port's CPU run within (d + 4) float32
  ulps, and one ANN plan through ``run_query``; SF1 lineitem written as
  dbgen .tbl text, parsed by the port's native loader
  (``tiflash_tpu_torch/native/loader.cpp``, built with ``g++``), cached and
  reloaded, every column equal to the generated one, Q1/Q6 over it with
  one generated launch each, and the CLI's ``query`` in its own process;
  the HTTP query service over the eight-table catalog on the card (Q1 one
  stream_tile launch, Q7-pairs one direct_agg launch, Q3 none, each equal
  to its direct ``run_query``), four requests at once, one async, the
  cancel of a running out-of-core request, a failpoint, a system table and
  /status, each request's HTTP wall beside its direct run;
- distribution (``mesh_sf10_phase`` after the out-of-core phase,
  ``mesh_phase`` last), over ``Mesh([cuda:0] * 8)``: on the SF10 catalog
  Q3 and GROUP BY l_orderkey over 8 shards in memory, each against its
  single-device card run, the hash exchange ragged and padded; at SF1 the
  plans of ``mesh_plans`` (Q1, Q6, Q3, Q7-pairs, Q9, Q13 and its right
  outer form, Q18-300, top-N, approx_count_distinct, window_report and a
  laned per-ship-mode window), each logical plan handed to ``run_query``
  with the mesh (which distributes it), each against its single-device
  card run and a CPU worker's mesh run (``mesh_cpu_runs``), the card's
  ``distribute_plan`` tree equal to the one from the catalog's CPU
  tables, Q1/Q3/Q7-pairs also
  against numpy, with exactly the direct_agg launches the CPU spy
  predicts, every direct_agg call of the mesh run held kernel == plain,
  and no stream_agg or fused launch; the skewed join (60% of lineitem on one
  l_orderkey) through ``SkewShuffleJoin`` and the plain shuffle, per-shard
  rows and max share, against the single-device join; and Q3 through
  ``mpp/multihost.py`` over NCCL at world size 1.  Every shard tensor is
  held on the card;
- the SQL front end (``sql_phase``, last): the ``tests/sql_cases/*.test``
  scripts through ``testing/reftest.py``'s ``RefTestSession("cuda")`` and
  ``RefTestSession("cpu")`` in this process, every statement the same
  (exception, checked, unsupported, every SELECT's rows) and every
  recorded table passing on the card, then again with
  ``TIFLASH_REFTEST_DISTRIBUTED=1`` over ``Mesh([cuda:0] * 8)`` (the same
  rows in any order, as many distributed runs as over ``cpu_mesh(8)``);
  then TPC-H Q1 and Q6 as SQL text over SF 0.1 lineitem (the front end
  turns a table's Python rows into a block at every query, which is what
  cuts the scale) through one card session, bit-exact against
  ``run_query`` of ``q1_plan()`` / ``q6_plan()`` on the same catalog on
  the card and against numpy, each kernel's launches printed and held
  kernel == plain at every captured call, the wall split into host
  conversion, plan build, the engine run and the result's decode;
- the judges (``oracle_phase``, last), with the port's own oracle
  (``testing/plan_oracle.py``): the 126 trees of the two fuzzers, drawn
  by ``tests/torch_plan_draw.py`` (loaded by path; the reference
  fuzzer's 60 plan, 16 window and 10 grouping-set seeds, the port
  fuzzer's 40), each on ``cuda`` judged as the reference's fuzzer judges
  (sorted rows, floats to 6 places or within 1e-9 where that rounding
  splits two sums, a LIMIT by its row count), equal to the port's CPU run
  and launching what that run's captured calls predict; the 99 non-LIMIT
  ones again over ``Mesh([cuda:0] * 8)``, equal to the single-device run
  and judged; then the two kernels' shapes over 200,000 generated rows,
  5 seeds each (TPC-H Q1's for the fused kernel, a GROUP BY of about
  1,000 dictionary values behind a filter for direct_agg), with exactly
  the launches the CPU spy predicts, every captured call kernel ==
  plain, rows equal to the CPU run and judged by the oracle, whose
  answers a pool of spawned workers computes meanwhile.

Each kernel is held against its plain version (``torch.equal``) on edge
cases, and timed at the query's own arguments beside one ``index_add_``
of the same sums (the library yardstick) and its bound (the bytes it must
move over 3.35 TB/s), the L2 flushed before each run; the generated
kernel also beside the unfused path (the tile program evaluated in torch
on the card, then the planes kernel).
``tiflash_tpu_torch/bench/compare_trees.py`` times two checkouts' kernels
and queries against each other; ``tiflash_tpu_torch/bench/kernel_variants.py``
times the design alternatives of the kernels.

Every result is checked bit-exact against the port's own CPU run (but
the 100M-row top-N and Q1 at SF10, whose CPU runs would take most of the
script's time; the analytic plans' float columns hold within
``ANALYTIC_FLOAT_REL``) and an independent numpy computation (in the
eight-table phase, one per new mechanism: Q2, Q9, Q13, Q14, Q16 and
Q18-300; every analytic plan).  Any
failure exits non-zero.  The last line of standard output is the JSON
device record; the line before it lists the kernels with their launch
counts, errors and times.

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
SF10_REPS = 5          # Q1 at SF10: its plain version takes about 0.1 s a run
Q1_CUTOFF = "1998-09-02"
Q6_RANGE = ("1994-01-01", "1995-01-01")
Q7_RANGE = ("1995-01-01", "1996-12-31")
Q7_TABLES = ["nation", "supplier", "customer", "orders", "lineitem"]
Q3_TABLES = ["lineitem", "orders", "customer"]
Q3_DATE = "1995-03-15"
Q4_RANGE = ("1993-07-01", "1993-10-01")
Q10_RANGE = ("1993-10-01", "1994-01-01")
TOPN_LIMIT = 100
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT_OPS_PER_S = 67e12          # H100 SXM 32-bit rate outside the tensor cores
L2_FLUSH_BYTES = 256 << 20     # five times the 50 MB L2
EIGHT_TABLES = ["region", "nation", "supplier", "customer", "part", "partsupp",
                "orders", "lineitem"]
Q18_MIN_QTY = 300          # TPC-H's own threshold; the plan's default selects nothing
Q14_RANGE = ("1995-09-01", "1995-10-01")


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


def _pysum(x) -> int:
    """The exact sum of an int64 array as a Python int (int64 partial sums
    of 2^22 rows, each far from overflow)."""
    import numpy as np

    return sum(int(np.sum(x[i:i + (1 << 22)], dtype=np.int64))
               for i in range(0, len(x), 1 << 22))


def numpy_q1(li: dict) -> dict:
    """TPC-H Q1 over host arrays: int64 mantissas, group sums by masks,
    totals as Python ints."""
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
            sq, se, sd = (_pysum(x[g]) for x in (qty, ext, disc))
            out["l_returnflag"].append(rfs)
            out["l_linestatus"].append(lss)
            out["sum_qty"].append(sq)
            out["sum_base_price"].append(se)
            out["sum_disc_price"].append(_pysum(disc_price[g]))
            out["sum_charge"].append(_pysum(charge[g]))
            # avg of a scale-2 decimal is scale 6: sum * 10^4 / n, half up
            out["avg_qty"].append(_half_up_div(sq * 10 ** 4, n))
            out["avg_price"].append(_half_up_div(se * 10 ** 4, n))
            out["avg_disc"].append(_half_up_div(sd * 10 ** 4, n))
            out["count_order"].append(n)
    return out


def numpy_q6(li: dict, dates=Q6_RANGE, disc=(5, 7), quantity=2400) -> dict:
    """TPC-H Q6 over host arrays; ``disc`` and ``quantity`` as mantissas."""
    import numpy as np

    d = li["l_shipdate"]
    m = ((d >= _days(dates[0])) & (d < _days(dates[1]))
         & (li["l_discount"] >= disc[0]) & (li["l_discount"] <= disc[1])
         & (li["l_quantity"] < quantity))
    rev = li["l_extendedprice"] * li["l_discount"]   # scale 4
    return {"revenue": [int(np.sum(rev[m], dtype=np.int64)) if m.any() else None]}


def lineitem_arrays(cat) -> dict:
    """Host numpy copies of the columns Q1/Q6 and top-N read, plus
    dictionaries."""
    t = cat["lineitem"].block
    li = {n: t[n].data.numpy() for n in (
        "l_orderkey", "l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
        "l_extendedprice", "l_discount", "l_tax", "l_shipmode")}
    li["rf_dict"] = t["l_returnflag"].dictionary
    li["ls_dict"] = t["l_linestatus"].dictionary
    li["sm_dict"] = t["l_shipmode"].dictionary
    return li


def numpy_ship_month(li: dict) -> dict:
    """The ship-month report over host arrays: months from datetime64[M],
    modes lower-cased on the mode dictionary, sums by ``np.add.at``, rows
    in (month, mode) order."""
    import numpy as np

    months = li["l_shipdate"].astype("datetime64[D]").astype("datetime64[M]")
    month_no = months.astype(np.int64)
    lowered = [m.lower() for m in li["sm_dict"]]
    modes = sorted(set(lowered))
    mode_rank = np.array([modes.index(m) for m in lowered])[li["l_shipmode"]]
    m0 = int(month_no.min())
    key = (month_no - m0) * len(modes) + mode_rank
    sums = {}
    for name, vals in (("count_order", np.ones(len(key), np.int64)),
                       ("sum_qty", li["l_quantity"]),
                       ("sum_price", li["l_extendedprice"]),
                       ("disc", li["l_discount"])):
        acc = np.zeros(int(key.max()) + 1, np.int64)
        np.add.at(acc, key, vals)
        sums[name] = acc
    out = {k: [] for k in ("ship_month", "mode", "count_order", "sum_qty",
                           "sum_price", "avg_disc")}
    for k in np.nonzero(sums["count_order"])[0].tolist():
        n = int(sums["count_order"][k])
        month = np.datetime64(m0 + k // len(modes), "M")
        out["ship_month"].append(np.datetime_as_string(month, unit="M"))
        out["mode"].append(modes[k % len(modes)])
        out["count_order"].append(n)
        out["sum_qty"].append(int(sums["sum_qty"][k]))
        out["sum_price"].append(int(sums["sum_price"][k]))
        # avg of a scale-2 decimal is scale 6: sum * 10^4 / n, half up
        out["avg_disc"].append(_half_up_div(int(sums["disc"][k]) * 10 ** 4, n))
    return out


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


def tpch3_arrays(cat) -> dict:
    """Host numpy copies of the columns Q3, Q4, Q10 and Q22 read from the
    three-table catalog, plus the string dictionaries they compare."""
    cols = {
        "customer": ("c_custkey", "c_mktsegment", "c_acctbal"),
        "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
                   "o_orderpriority"),
        "lineitem": ("l_orderkey", "l_extendedprice", "l_discount", "l_shipdate",
                     "l_commitdate", "l_receiptdate", "l_returnflag"),
    }
    out = {c: cat[t].block[c].data.numpy() for t, cs in cols.items() for c in cs}
    out["segment_dict"] = cat["customer"].block["c_mktsegment"].dictionary
    out["priority_dict"] = cat["orders"].block["o_orderpriority"].dictionary
    out["returnflag_dict"] = cat["lineitem"].block["l_returnflag"].dictionary
    return out


def _order_of_line(a: dict):
    """Per lineitem row: the row of its order in the orders table (or -1),
    by np.searchsorted on the sorted o_orderkey."""
    import numpy as np

    okeys = a["o_orderkey"]
    pos = np.clip(np.searchsorted(okeys, a["l_orderkey"]), 0, len(okeys) - 1)
    return np.where(okeys[pos] == a["l_orderkey"], pos, -1)


def _group_sums(keys, vals):
    """(sorted unique keys, int64 sums of vals per key) with np.add.at."""
    import numpy as np

    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(sums, inv.reshape(-1), vals)
    return uniq, sums


def numpy_q3(a: dict) -> dict:
    """TPC-H Q3 over host arrays: BUILDING customers' orders before
    1995-03-15, their lines shipped after it, revenue per order, the top
    10 by (revenue desc, o_orderdate, l_orderkey)."""
    import numpy as np

    cut = _days(Q3_DATE)
    building = a["segment_dict"].index("BUILDING")
    cust_ok = np.zeros(int(a["c_custkey"].max()) + 1, dtype=bool)
    cust_ok[a["c_custkey"]] = a["c_mktsegment"] == building
    order_ok = (a["o_orderdate"] < cut) & cust_ok[a["o_custkey"]]
    orow = _order_of_line(a)
    m = (a["l_shipdate"] > cut) & (orow >= 0)
    m &= order_ok[np.maximum(orow, 0)]
    rev = a["l_extendedprice"] * (100 - a["l_discount"])   # scale 4
    okeys, sums = _group_sums(a["l_orderkey"][m], rev[m])
    orow_g = np.searchsorted(a["o_orderkey"], okeys)
    odate = a["o_orderdate"][orow_g].astype(np.int64)
    top = np.lexsort((okeys, odate, -sums))[:10]
    return {"l_orderkey": okeys[top].tolist(), "o_orderdate": odate[top].tolist(),
            "o_shippriority": a["o_shippriority"][orow_g][top].tolist(),
            "revenue": sums[top].tolist()}


def numpy_q10(a: dict) -> dict:
    """TPC-H Q10 over host arrays: returned lines of orders from
    1993-10-01 to 1994-01-01, revenue per customer, the top 20 by
    (revenue desc, c_custkey)."""
    import numpy as np

    lo, hi = (_days(d) for d in Q10_RANGE)
    order_ok = (a["o_orderdate"] >= lo) & (a["o_orderdate"] < hi)
    orow = _order_of_line(a)
    m = (a["l_returnflag"] == a["returnflag_dict"].index("R")) & (orow >= 0)
    m &= order_ok[np.maximum(orow, 0)]
    rev = a["l_extendedprice"] * (100 - a["l_discount"])   # scale 4
    custkeys, sums = _group_sums(a["o_custkey"][np.maximum(orow, 0)][m], rev[m])
    acctbal = np.zeros(int(a["c_custkey"].max()) + 1, dtype=np.int64)
    acctbal[a["c_custkey"]] = a["c_acctbal"]
    top = np.lexsort((custkeys, -sums))[:20]
    return {"c_custkey": custkeys[top].tolist(),
            "c_acctbal": acctbal[custkeys[top]].tolist(),
            "revenue": sums[top].tolist()}


def numpy_q4(a: dict) -> dict:
    """TPC-H Q4 over host arrays: orders of 1993Q3 with a line committed
    before it was received, counted per priority."""
    import numpy as np

    lo, hi = (_days(d) for d in Q4_RANGE)
    late = a["l_orderkey"][a["l_commitdate"] < a["l_receiptdate"]]
    m = ((a["o_orderdate"] >= lo) & (a["o_orderdate"] < hi)
         & np.isin(a["o_orderkey"], late))
    counts = np.bincount(a["o_orderpriority"][m], minlength=len(a["priority_dict"]))
    names = a["priority_dict"]
    return {"o_orderpriority": [names[i] for i in np.flatnonzero(counts)],
            "order_count": counts[counts > 0].tolist()}


def numpy_q22(a: dict) -> dict:
    """Q22's anti join: customers with a positive balance and no order,
    their count, balance sum (scale 2) and average (scale 6, half up)."""
    import numpy as np

    m = (a["c_acctbal"] > 0) & ~np.isin(a["c_custkey"], a["o_custkey"])
    n = int(m.sum())
    s = int(np.sum(a["c_acctbal"][m], dtype=np.int64))
    return {"numcust": [n], "totacctbal": [s if n else None],
            "avgbal": [_half_up_div(s * 10 ** 4, n) if n else None]}


def tpch8_arrays(cat) -> dict:
    """Host numpy copies of the eight-table catalog's columns that the
    numpy versions of Q2, Q9, Q13, Q14, Q16 and Q18 read, plus the string
    dictionaries they decode."""
    out = {}
    for t in EIGHT_TABLES:
        b = cat[t].block
        for n, c in zip(b.names, b.columns):
            out[n] = c.data.numpy()
            if c.dictionary is not None:
                out[n + "_dict"] = c.dictionary
    return out


def _key_table(keys, vals, fill=-1):
    """Dense lookup table vals[key] for small non-negative int keys."""
    import numpy as np

    table = np.full(int(keys.max()) + 2 if len(keys) else 1, fill, dtype=np.int64)
    table[keys] = vals
    return table


def _lookup(table, keys):
    import numpy as np

    safe = np.clip(keys, 0, len(table) - 1)
    return np.where((keys >= 0) & (keys < len(table)), table[safe], -1)


def numpy_q2(a: dict) -> dict:
    """TPC-H Q2's shape over host arrays: partsupp rows of EUROPE's
    suppliers, the minimum supply cost per part, the rows that reach it
    for parts of size 15, top 100 by (s_acctbal desc, ps_partkey), ties
    by partsupp row; every column the plan emits."""
    import numpy as np

    europe = a["r_name_dict"].index("EUROPE")
    region_of_nation = _key_table(a["n_nationkey"], a["n_regionkey"])
    s_ok = _lookup(_key_table(a["r_regionkey"], a["r_name"]),
                   region_of_nation[a["s_nationkey"]]) == europe
    supp_row = _key_table(a["s_suppkey"], np.arange(len(a["s_suppkey"])))
    srow = _lookup(supp_row, a["ps_suppkey"])
    m = srow >= 0
    m[m] = s_ok[srow[m]]
    pk, cost = a["ps_partkey"], a["ps_supplycost"]
    min_cost = np.full(int(pk.max()) + 1, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(min_cost, pk[m], cost[m])
    part_row = _key_table(a["p_partkey"], np.arange(len(a["p_partkey"])))
    prow = _lookup(part_row, pk)
    best = m & (cost == min_cost[pk]) & (prow >= 0)
    best[best] = a["p_size"][prow[best]] == 15
    rows = np.flatnonzero(best)
    acct = a["s_acctbal"][srow[rows]]
    rows = rows[np.lexsort((rows, pk[rows], -acct))][:TOPN_LIMIT]
    sr, pr = srow[rows], prow[rows]
    nk = a["s_nationkey"][sr]
    nrow = _key_table(a["n_nationkey"], np.arange(len(a["n_nationkey"])))[nk]
    rk = a["n_regionkey"][nrow]
    rrow = _key_table(a["r_regionkey"], np.arange(len(a["r_regionkey"])))[rk]
    names = {"n_name": a["n_name_dict"], "r_name": a["r_name_dict"],
             "p_brand": a["p_brand_dict"]}
    cols = {
        "ps_partkey": pk[rows], "ps_suppkey": a["ps_suppkey"][rows],
        "ps_availqty": a["ps_availqty"][rows], "ps_supplycost": cost[rows],
        "s_suppkey": a["s_suppkey"][sr], "s_nationkey": nk,
        "s_acctbal": a["s_acctbal"][sr], "n_nationkey": a["n_nationkey"][nrow],
        "n_name": a["n_name"][nrow], "n_regionkey": rk,
        "r_regionkey": a["r_regionkey"][rrow], "r_name": a["r_name"][rrow],
        "ps_partkey_m": pk[rows], "min_cost": cost[rows],
        "p_partkey": a["p_partkey"][pr], "p_size": a["p_size"][pr],
        "p_brand": a["p_brand"][pr],
    }
    return {k: ([names[k][c] for c in v.tolist()] if k in names else v.tolist())
            for k, v in cols.items()}


def numpy_q9(a: dict) -> dict:
    """TPC-H Q9's shape over host arrays: lineitem rows of parts of size
    at most 25, expanded over every partsupp row with the same (partkey,
    suppkey) (the pair is not unique), profit = extendedprice * (1 -
    discount) - supplycost * quantity at scale 4, summed per (supplier
    nation, order year), sorted by nation, then year descending."""
    import numpy as np

    size_of_part = _key_table(a["p_partkey"], a["p_size"])
    li_ok = _lookup(size_of_part, a["l_partkey"])
    li_ok = (li_ok >= 0) & (li_ok <= 25)
    # partsupp rows grouped by (partkey, suppkey): the N:M expansion
    ps_key = a["ps_partkey"] * (1 << 32) + a["ps_suppkey"]
    order = np.argsort(ps_key, kind="stable")
    skey = ps_key[order]
    l_key = a["l_partkey"] * (1 << 32) + a["l_suppkey"]
    lo = np.searchsorted(skey, l_key, side="left")
    hi = np.searchsorted(skey, l_key, side="right")
    cnt = np.where(li_ok, hi - lo, 0)
    li = np.repeat(np.arange(len(l_key)), cnt)
    first = np.repeat(lo, cnt)
    offs = np.arange(len(li)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    ps = order[first + offs]
    nation = _lookup(_key_table(a["s_suppkey"], a["s_nationkey"]), a["l_suppkey"][li])
    okeys = a["o_orderkey"]
    pos = np.clip(np.searchsorted(okeys, a["l_orderkey"][li]), 0, len(okeys) - 1)
    found = (okeys[pos] == a["l_orderkey"][li]) & (nation >= 0)
    li, ps, nation, pos = li[found], ps[found], nation[found], pos[found]
    amount = (a["l_extendedprice"][li] * (100 - a["l_discount"][li])
              - a["ps_supplycost"][ps] * a["l_quantity"][li])
    year = a["o_orderdate"][pos].astype("datetime64[D]").astype("datetime64[Y]")
    year = year.astype(np.int64) + 1970
    name_code = a["n_name"][_key_table(a["n_nationkey"], np.arange(25))[nation]]
    uniq, inv = np.unique(np.stack([name_code, -year], 1), axis=0, return_inverse=True)
    sums = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(sums, inv.reshape(-1), amount)
    return {"nation": [a["n_name_dict"][c] for c in uniq[:, 0].tolist()],
            "o_year": (-uniq[:, 1]).tolist(), "sum_profit": sums.tolist()}


def numpy_q13(a: dict) -> dict:
    """TPC-H Q13's shape over host arrays: per customer the number of its
    orders whose priority is not 1-URGENT (0 for none: the left outer join
    and count(o_orderkey)), then customers per count, sorted by (custdist
    desc, c_count desc)."""
    import numpy as np

    urgent = a["o_orderpriority_dict"].index("1-URGENT")
    keep = a["o_orderpriority"] != urgent
    per = np.zeros(int(a["c_custkey"].max()) + 1, dtype=np.int64)
    np.add.at(per, a["o_custkey"][keep], 1)
    c_count = per[a["c_custkey"]]
    counts, dist = np.unique(c_count, return_counts=True)
    top = np.lexsort((-counts, -dist))
    return {"c_count": counts[top].tolist(), "custdist": dist[top].tolist()}


def numpy_q14(a: dict) -> dict:
    """TPC-H Q14 over host arrays: revenue of lines shipped in September
    1995, the share of parts whose brand is LIKE 'Brand#2%', as a
    decimal(48,8) mantissa: half-up promo * 10^8 / total in Python ints."""
    import numpy as np

    lo, hi = (_days(d) for d in Q14_RANGE)
    d = a["l_shipdate"]
    prow = _lookup(_key_table(a["p_partkey"], np.arange(len(a["p_partkey"]))),
                   a["l_partkey"])
    m = (d >= lo) & (d < hi) & (prow >= 0)
    rev = a["l_extendedprice"] * (100 - a["l_discount"])            # scale 4
    brands = a["p_brand_dict"]
    promo_code = np.array([b.startswith("Brand#2") for b in brands])
    promo = m & promo_code[a["p_brand"][np.maximum(prow, 0)]]
    total = int(rev[m].sum()) if m.any() else None
    p = int(rev[promo].sum()) if promo.any() else None
    if total is None or p is None or total == 0:
        return {"promo_share": [None]}
    return {"promo_share": [_half_up_div(p * 10 ** 8, total)]}


def numpy_q16(a: dict) -> dict:
    """TPC-H Q16's shape over host arrays: distinct suppliers per brand of
    the partsupp rows of parts of size at most 25 (count_distinct),
    sorted by (supplier_cnt desc, p_brand)."""
    import numpy as np

    prow = _lookup(_key_table(a["p_partkey"], np.arange(len(a["p_partkey"]))),
                   a["ps_partkey"])
    m = prow >= 0
    m[m] = a["p_size"][prow[m]] <= 25
    brand = a["p_brand"][prow[m]]
    pairs = np.unique(np.stack([brand, a["ps_suppkey"][m]], 1), axis=0)
    brands, cnt = np.unique(pairs[:, 0], return_counts=True)
    names = a["p_brand_dict"]
    top = sorted(range(len(brands)), key=lambda i: (-cnt[i], names[brands[i]]))
    return {"p_brand": [names[brands[i]] for i in top],
            "supplier_cnt": [int(cnt[i]) for i in top]}


def numpy_q18(a: dict, min_qty: int = Q18_MIN_QTY) -> dict:
    """TPC-H Q18 over host arrays: orders whose lines' quantity sums past
    ``min_qty`` (a decimal(37,2): mantissa > min_qty * 100), joined to
    their order and customer, top 100 by (sum_qty desc, o_orderdate),
    ties by orders row."""
    import numpy as np

    okeys, sums = _group_sums(a["l_orderkey"], a["l_quantity"])
    big = sums > min_qty * 100
    okeys, sums = okeys[big], sums[big]
    pos = np.searchsorted(a["o_orderkey"], okeys)
    ok = (pos < len(a["o_orderkey"])) & (a["o_orderkey"][np.minimum(
        pos, len(a["o_orderkey"]) - 1)] == okeys)
    okeys, sums, pos = okeys[ok], sums[ok], pos[ok]
    cust = a["o_custkey"][pos]
    has_c = np.isin(cust, a["c_custkey"])
    okeys, sums, pos, cust = okeys[has_c], sums[has_c], pos[has_c], cust[has_c]
    odate = a["o_orderdate"][pos].astype(np.int64)
    top = np.lexsort((pos, odate, -sums))[:TOPN_LIMIT]
    return {"o_orderkey": okeys[top].tolist(), "o_custkey": cust[top].tolist(),
            "o_orderdate": odate[top].tolist(), "l_orderkey": okeys[top].tolist(),
            "sum_qty": sums[top].tolist(), "c_custkey": cust[top].tolist()}


def numpy_topn(keys, payload: dict, limit: int) -> dict:
    """ORDER BY keys DESC LIMIT limit, ties by position: np.argpartition
    for the limit-th key, every row at least that large, then a stable
    sort of those candidates."""
    import numpy as np

    limit = min(limit, len(keys))
    kth = keys[np.argpartition(keys, len(keys) - limit)[len(keys) - limit:]].min()
    cand = np.flatnonzero(keys >= kth)
    top = cand[np.argsort(-keys[cand], kind="stable")][:limit]
    return {name: col[top].tolist() for name, col in payload.items()}


def block_result(block) -> tuple:
    """(decoded live rows, column types) of a result block."""
    return block.to_pylists(), [repr(c.dtype) for c in block.columns]


S64_L3_FIELDS = [[(0, 12, 0), (12, 19, 1)], [(0, 31, 2)],
                 [(0, 10, 3), (10, 10, 4), (20, 11, 5)]]


def edge_cases(q1_fields, q6_fields, n_q1: int):
    """(name, slots, planes, plane_fields, S, headroom) cases for kernel vs
    plain, random from a seeded generator on the card.  Headroom-0 cases
    take random 31-bit planes; headroom cases planes whose every field
    keeps its top ``headroom`` bits clear (as the fuse's layouts do)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    def planes(n_planes, m):
        return rnd(0, 2 ** 31 - 1, (n_planes, m))

    def headroom_planes(pf, m, h):
        """One separate int32 tensor per plane, fields inside the headroom."""
        out = []
        for fields in pf:
            p = torch.zeros(m, dtype=torch.int32, device="cuda")
            for off, cap, _ in fields:
                p |= rnd(0, 2 ** (cap - h), (m,)) << off
            out.append(p)
        return out

    n_odd = 2_000_003
    odd_slots = rnd(-1, 7, (n_odd + 1,))
    odd_planes = headroom_planes(q1_fields, n_odd + 1, 6)
    cases = [
        ("q1_shape", rnd(0, 7, (n_q1,)), planes(len(q1_fields), n_q1), q1_fields, 6, 0),
        ("ragged_rows", rnd(-2, 9, (1_000_003,)), planes(len(q1_fields), 1_000_003),
         q1_fields, 6, 0),
        ("all_dead", torch.full((300_001,), 6, dtype=torch.int32, device="cuda"),
         planes(len(q1_fields), 300_001), q1_fields, 6, 0),
        ("keyless_s1", rnd(0, 2, (2_000_001,)), planes(len(q6_fields), 2_000_001),
         q6_fields, 1, 0),
        ("s64_few_planes", rnd(0, 65, (3_000_017,)), planes(2, 3_000_017),
         [[(0, 15, 0), (15, 16, 1)], [(0, 31, 2)]], 64, 0),
        ("full_31bit_field", rnd(0, 4, (2_500_000,)), planes(1, 2_500_000),
         [[(0, 31, 0)]], 4, 0),
        # the packed-headroom path: Q1's layout (registers) and S x L = 192
        # (thread-private shared-memory columns)
        ("headroom6_q1_layout", rnd(-1, 7, (n_q1,)),
         headroom_planes(q1_fields, n_q1, 6), q1_fields, 6, 6),
        ("headroom6_s64_l3_shared", rnd(0, 65, (3_000_017,)),
         headroom_planes(S64_L3_FIELDS, 3_000_017, 6), S64_L3_FIELDS, 64, 6),
        ("headroom6_q6_layout", rnd(0, 2, (2_000_001,)),
         headroom_planes(q6_fields, 2_000_001, 6), q6_fields, 1, 6),
        # a base that starts at an odd row: scalar head, then 16-byte quads
        ("headroom6_odd_row_base", odd_slots[1:], [p[1:] for p in odd_planes],
         q1_fields, 6, 6),
        # separate plane tensors whose 16-byte phases differ from the slots'
        ("headroom6_mixed_phases", odd_slots[1:], [p[:n_odd] for p in odd_planes],
         q1_fields, 6, 6),
    ]
    return cases


def check_stream_agg(SA, q1_fields, q6_fields, n_q1: int) -> int:
    """stream_agg kernel == plain on every case (torch.equal), planes as a
    list and, where they share one length, stacked; returns the largest
    absolute difference seen (0)."""
    import torch

    max_err = 0
    for name, slots, planes, pf, n_slots, h in edge_cases(q1_fields, q6_fields, n_q1):
        fields = SA.field_table(pf, len(pf))

        def run(fn, pl):
            out = torch.zeros((n_slots, len(fields)), dtype=torch.int64, device="cuda")
            return fn(slots, pl, fields, n_slots, out, h)

        want = run(SA.group_sums_plain, planes)
        forms = {"list": list(planes)}
        if isinstance(planes, torch.Tensor):
            forms["stacked"] = planes
        for form, pl in forms.items():
            got = run(SA.group_sums, pl)
            torch.cuda.synchronize()
            err = int((got - want).abs().max()) if got.numel() else 0
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(f"stream_agg kernel != plain on {name} ({form}): "
                                     f"max abs err {err}")
        plan = SA.plan_launch(n_slots, len(pf), len(fields), h)
        print(f"stream_agg kernel == plain (exact): {name} rows={slots.shape[0]} "
              f"S={n_slots} planes={len(pf)} fields={len(fields)} headroom={h} "
              f"regime={plan.regime} threads={plan.threads} forms={'+'.join(forms)}")
    return max_err


def time_ms(fn, reps: int, before=None) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after a warm
    run; ``before()`` runs outside the timed span before each run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class L2Flush:
    """Reads a buffer five times the 50 MB L2 before a timed run, so the
    run finds its inputs in device memory and no dirty lines to write
    back (a read leaves the cache clean)."""

    def __init__(self):
        import torch

        self.buf = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def __call__(self):
        self.buf.sum()


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
             dead_slots=None, hot_frac=None):
        slots = ints(0, S, n, torch.int32)
        if hot_frac is not None:  # skew: this share of the rows in slot 7
            slots = torch.where(live(n, hot_frac), 7, slots)
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
        case("skew_90pct_one_slot", n_q7, 676, 3, live_frac=0.9, hot_frac=0.9),
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
        # group_sums itself: value columns as a list and stacked (K, n)
        idx = torch.where(lv, slots, S)
        want_g = DA.group_sums_plain(idx, vals, S, torch.zeros(
            (S, len(vals) + 1), dtype=torch.int64, device="cuda"))
        for form, vs in (("list", vals), ("stacked", torch.stack(vals))):
            got_g = DA.group_sums(idx, vs, S, torch.zeros_like(want_g))
            if not torch.equal(got_g, want_g):
                raise AssertionError(f"direct_agg group_sums ({form}) != plain on {name}")
        plans = DA.launch_plan(S, len(vals) + sum(m is not None for m in masks) + 1)
        print(f"direct_agg kernel == plain (exact): {name} rows={slots.shape[0]} "
              f"S={S} values={len(vals)} column_groups={len(plans)} "
              f"copies={[g.copies for g in plans]} "
              f"blocks_per_sm={[g.blocks_per_sm for g in plans]} forms=list+stacked")
    # raw slots outside [0, S) on live rows: the kernel itself skips them
    slots = torch.tensor([0, -7, 10 ** 6, 3, 4, 3], dtype=torch.int32, device="cuda")
    vals = torch.arange(6, dtype=torch.int64, device="cuda").reshape(1, 6)
    out = DA.group_sums(slots, vals, 4, torch.zeros((4, 2), dtype=torch.int64,
                                                    device="cuda"))
    if out.tolist() != [[0, 1], [0, 0], [0, 0], [8, 2]]:
        raise AssertionError(f"direct_agg kernel read a row outside [0, S): {out.tolist()}")
    print("direct_agg kernel skips slots outside [0, S) (-7, 10^6, S)")
    return max_err


def time_turns(first, second, reps: int, before=None):
    """(first ms, second ms), measured first, second, second, first; the
    smaller of each pair."""
    f1 = time_ms(first, reps, before)
    s1 = time_ms(second, reps, before)
    s2 = time_ms(second, reps, before)
    f2 = time_ms(first, reps, before)
    return min(f1, f2), min(s1, s2)


def capture_calls(module, name: str, run) -> list:
    """The arguments of every ``module.<name>`` call that ``run()`` makes,
    each tensor cloned (a list of tensors as a list of clones)."""
    import torch

    captured = []
    orig = getattr(module, name)

    def spy(*args):
        def copy(a):
            if isinstance(a, torch.Tensor):
                return a.clone()
            if isinstance(a, list) and all(isinstance(t, torch.Tensor) for t in a):
                return [t.clone() for t in a]
            if isinstance(a, dict) and all(isinstance(t, torch.Tensor) for t in a.values()):
                return {k: t.clone() for k, t in a.items()}
            return a

        captured.append(tuple(copy(a) for a in args))
        return orig(*args)

    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return captured


def stream_agg_yardsticks(SA, captured, flush) -> dict:
    """At a query's captured ``group_sums`` calls: the kernel's and the
    plain version's time, the kernel's with every slot dead (what the slot
    pass alone costs), one ``index_add_`` of the pre-extracted int64
    fields into (S+1, n_fields) per call (the library yardstick), and the
    bound: 4 B of slot per row, 4 B per plane of each live row and the
    int64 output, over 3.35 TB/s (the adds, one per live field, are far
    under the int32 rate)."""
    import torch

    def run_all(fn):
        for slots, planes, fields, n_slots, _, h in captured:
            fn(slots, planes, fields, n_slots,
               torch.zeros((n_slots, len(fields)), dtype=torch.int64, device="cuda"), h)

    p_ms, k_ms = time_turns(lambda: run_all(SA.group_sums_plain),
                            lambda: run_all(SA.group_sums), KERNEL_REPS, flush)
    dead = [(torch.full_like(c[0], c[3]), *c[1:]) for c in captured]
    dead_ms = time_ms(lambda: [SA.group_sums(*c[:4], torch.zeros(
        (c[3], len(c[2])), dtype=torch.int64, device="cuda"), c[5]) for c in dead],
        KERNEL_REPS, flush)
    lib_in, n_bytes, n_ops, rows = [], 0, 0, 0
    for slots, planes, fields, n_slots, _, _ in captured:
        live_mask = (slots >= 0) & (slots < n_slots)
        live = int(live_mask.sum())
        idx = torch.where(live_mask, slots, n_slots).long()
        vals = torch.stack([(planes[pl].long() >> off) & ((1 << cap) - 1)
                            for pl, off, cap, _ in sorted(fields, key=lambda r: r[3])], 1)
        acc = torch.zeros((n_slots + 1, len(fields)), dtype=torch.int64, device="cuda")
        lib_in.append((acc, idx, vals))
        n_bytes += 4 * slots.shape[0] + 4 * len(planes) * live + 8 * n_slots * len(fields)
        n_ops += live * len(fields)
        rows += slots.shape[0]
    lib_ms = time_ms(lambda: [acc.index_add_(0, idx, vals) for acc, idx, vals in lib_in],
                     KERNEL_REPS, flush)
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S) * 1e3
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_bytes": n_bytes, "rows": rows, "launches": len(captured),
            "all_dead_ms": dead_ms}


TILE_CASE_ROWS = 1_000_003
Q6_OTHER = {"date": "1995-01-01", "date_end": "1996-01-01", "disc_lo": 0.02,
            "disc_hi": 0.04, "quantity": 25.0}   # a second qgen draw of Q6
SF10 = 10
# the SF10 catalog Q1 at SF10 and the out-of-core phase share
SF10_COLUMNS = {"lineitem": ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                             "l_returnflag", "l_linestatus", "l_shipdate", "l_orderkey"],
                "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
                "customer": ["c_custkey", "c_mktsegment"]}
Q1_COLUMNS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
              "l_linestatus", "l_shipdate"]
_STORAGE_BYTES = {"i32": 4, "u8": 1, "i64": 8}


def fused_source(SA, ST, call) -> tuple:
    """("stream_tile", generated source) of a captured ``fused_group_sums``
    call, for ``build.build_libraries(generated=...)``."""
    _, program, _, n_limbs, _, pf, h, _ = call
    return "stream_tile", ST.kernel_source(program, SA.field_table(pf, n_limbs), h)[0]


def _sector_bytes(mask, size: int) -> int:
    """The bytes of the 32-byte sectors (the device's access unit) of an
    array of ``size``-byte rows that hold a row where ``mask`` is set."""
    import torch

    per = 32 // size
    pad = torch.nn.functional.pad(mask, (0, -mask.shape[0] % per))
    return 32 * int(pad.view(-1, per).any(1).sum())


def tile_bound_bytes(TP, call) -> dict:
    """The bytes the fused kernel must move at a captured call.

    ``bound``: the fewest that any order of loads needs.  An array that a
    term of the live mask reads is needed only in the sectors holding a
    row that every term over the arrays loaded before it keeps (the first
    one whole); the least over all orders of those arrays, by dynamic
    programming over the sets loaded first.  The arrays no term reads
    (keys, aggregate inputs) come last, in the sectors of the live rows.
    Plus the int64 output.
    ``design``: what this kernel's order reads: every live-mask and key
    array whole, the arrays only the planes read in the sectors of the
    live rows, and the output.  ``whole``: every array whole.
    ``evaluate`` on the card finds the live rows (outside every timed
    span)."""
    import itertools

    import torch

    inputs, program, n_slots, _, n_rows, pf, _, dev = call
    tile = TP.stage(program, inputs)
    rows = torch.ones(n_rows, dtype=torch.bool, device=dev)
    slots, _ = TP.evaluate(program, tile, rows)
    live = slots < n_slots
    terms = TP.conjuncts(program.live)
    holds = TP.evaluate_nodes(terms, tile, program.params, rows)
    reads = [frozenset(program.arrays_read([t])) for t in terms]
    size = [_STORAGE_BYTES[a.storage] for a in program.arrays]
    pred = sorted(frozenset().union(*reads))
    kept = {}

    def live_after(loaded: frozenset):
        if loaded not in kept:
            m = rows
            for h, r in zip(holds, reads):
                if r <= loaded:
                    m = m & h
            kept[loaded] = m
        return kept[loaded]

    least = {frozenset(): 0}
    for k in range(1, len(pred) + 1):
        for sub in map(frozenset, itertools.combinations(pred, k)):
            least[sub] = min(least[sub - {a}] + _sector_bytes(live_after(sub - {a}), size[a])
                             for a in sub)
    rest = [k for k in program.arrays_read([program.key_slot, *program.planes])
            if k not in pred]
    out = 8 * n_slots * sum(len(f) for f in pf)
    mask = program.mask_arrays()
    agg = program.agg_arrays()
    return {"bound": least[frozenset(pred)] + sum(_sector_bytes(live, size[k]) for k in rest)
            + out,
            "design": sum(_sector_bytes(rows, size[k]) for k in mask)
            + sum(_sector_bytes(live, size[k]) for k in agg) + out,
            "whole": sum(_sector_bytes(rows, size[k]) for k in mask + agg) + out}


def fused_yardsticks(SA, ST, TP, call, flush, reps: int = KERNEL_REPS) -> dict:
    """At a query's captured ``fused_group_sums`` call: the generated
    kernel held against its plain version (``torch.equal``), then timed
    beside it (``evaluate`` then ``group_sums_plain``), the unfused path
    (``evaluate`` on the card, then the planes kernel), one ``index_add_``
    of the tile values' int64 fields into (S+1, F) (the library
    yardstick), and the byte bound and the kernel design's bytes
    (``tile_bound_bytes``).  Also the planes kernel's arguments at this
    call (``planes_call``)."""
    import torch

    inputs, program, n_slots, n_limbs, _, pf, h, _ = call
    fields = SA.field_table(pf, n_limbs)

    def zeros():
        return torch.zeros((n_slots, len(fields)), dtype=torch.int64, device="cuda")

    err = fused_equals_plain(ST, call)
    p_ms, k_ms = time_turns(lambda: ST.fused_group_sums_plain(*call),
                            lambda: ST.fused_group_sums(*call), reps, flush)

    def unfused():
        slots, planes = TP.evaluate(program, TP.stage(program, inputs))
        SA.group_sums(slots, planes, fields, n_slots, zeros(), h)

    un_ms = time_ms(unfused, reps, flush)
    slots, planes = TP.evaluate(program, TP.stage(program, inputs))
    live = (slots >= 0) & (slots < n_slots)
    idx = torch.where(live, slots, n_slots).long()
    vals = torch.stack([(planes[pl].long() >> off) & ((1 << cap) - 1)
                        for pl, off, cap, _ in sorted(fields, key=lambda r: r[3])], 1)
    acc = torch.zeros((n_slots + 1, len(fields)), dtype=torch.int64, device="cuda")
    lib_ms = time_ms(lambda: acc.index_add_(0, idx, vals), reps, flush)
    nb = tile_bound_bytes(TP, call)
    bound_ms = nb["bound"] / HBM_BYTES_PER_S * 1e3
    design_ms = nb["design"] / HBM_BYTES_PER_S * 1e3
    return {"ms": k_ms, "plain_ms": p_ms, "unfused_ms": un_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_bytes": nb["bound"], "max_abs_err": err,
            "design_bound_ms": design_ms, "design_bound_bytes": nb["design"],
            "full_column_bound_ms": nb["whole"] / HBM_BYTES_PER_S * 1e3,
            "share_of_bound": bound_ms / k_ms, "share_of_design_bound": design_ms / k_ms,
            "live": int(live.sum()),
            "rows": int(slots.shape[0]),
            "planes_call": (slots, [p.contiguous() for p in planes], fields, n_slots,
                            None, h)}


def fused_line(name: str, y: dict, card: str) -> str:
    return (f"{name} stream_tile: kernel == plain (exact), kernel {y['ms']:.4f} ms, unfused "
            f"(evaluate + planes kernel) {y['unfused_ms']:.4f} ms, plain {y['plain_ms']:.4f} "
            f"ms, index_add_ {y['library_ms']:.4f} ms, bound {y['bound_ms']:.4f} ms "
            f"({y['bound_bytes']} B at 3.35 TB/s, the fewest sectors any load order reads), "
            f"share of bound {y['share_of_bound']:.1%}; kernel design (mask and key columns "
            f"whole) {y['design_bound_ms']:.4f} ms ({y['design_bound_bytes']} B), share "
            f"{y['share_of_design_bound']:.1%}; every column whole "
            f"{y['full_column_bound_ms']:.4f} ms; {y['live']} of {y['rows']} rows live; L2 "
            f"flushed before each run [{card}]")


def fused_equals_plain(ST, call) -> int:
    """The generated kernel == its plain version (``torch.equal``) on a
    captured call's own card inputs; returns the largest absolute
    difference (0), raises on any."""
    import torch

    got = ST.fused_group_sums(*call)
    want = ST.fused_group_sums_plain(*call)
    torch.cuda.synchronize()
    if got.device.type != "cuda" or want.device != got.device:
        raise AssertionError(f"stream_tile outputs on {got.device} and {want.device}")
    err = int((got - want).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"stream_tile kernel != plain: max abs err {err}")
    return err


def check_stream_tile(SA, ST, cases) -> int:
    """The generated kernel == its plain version (``torch.equal``) at each
    case's own fused call on the card, and the case's card result == its
    CPU run.  ``cases``: (name, plan, cpu tables, card tables).  Returns
    the largest absolute difference seen (0)."""
    import torch

    from tiflash_tpu_torch.runtime.executor import run_query

    max_err = 0
    for name, plan, cpu_tables, gpu_tables in cases:
        want_rows = block_result(run_query(plan, cpu_tables)[0])
        out = []
        l0 = ST.LAUNCHES
        calls = capture_calls(ST, "fused_group_sums",
                              lambda: out.append(run_query(plan, gpu_tables)[0]))
        torch.cuda.synchronize()
        if len(calls) != 1 or ST.LAUNCHES != l0 + 1:
            raise AssertionError(f"{name}: {len(calls)} fused calls and "
                                 f"{ST.LAUNCHES - l0} launches on the card")
        if out[0].device.type != "cuda":
            raise AssertionError(f"{name}: result on {out[0].device}")
        if block_result(out[0]) != want_rows:
            raise AssertionError(f"{name}: cuda result != cpu result")
        c = calls[0]
        try:
            max_err = max(max_err, fused_equals_plain(ST, c))
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
        _, program, n_slots, n_limbs, n_rows, pf, h, _ = c
        plan_ = ST.plan_tile_launch(n_slots, n_limbs, sum(map(len, pf)), h)
        storages = sorted({a.storage for a in program.arrays})
        print(f"stream_tile kernel == plain (exact): {name} rows={n_rows} S={n_slots} "
              f"planes={n_limbs} fields={sum(map(len, pf))} arrays={len(program.arrays)} "
              f"{'/'.join(storages)} params={len(program.params)} regime={plan_.regime} "
              f"threads={plan_.threads}; result == cpu run")
    return max_err


def direct_agg_yardsticks(DA, captured, flush) -> dict:
    """At Q7-pairs' captured ``group_sums`` calls: kernel, plain, the
    kernel with every slot dead (the slot pass alone), one
    ``index_add_`` of the (n, K+1) int64 rows (values and ones) into
    (S+1, K+1), and the bound: 4 B of slot per row, 8 B per value of each
    live row and the output, over 3.35 TB/s.  ``sector_bound_ms`` counts
    instead every 32-byte sector that holds a live row's value: what
    device memory moves for rows scattered among dead ones."""
    import torch

    def run_all(fn):
        for slots, vals, n_slots, _ in captured:
            fn(slots, vals, n_slots,
               torch.zeros((n_slots, len(vals) + 1), dtype=torch.int64, device="cuda"))

    p_ms, k_ms = time_turns(lambda: run_all(DA.group_sums_plain),
                            lambda: run_all(DA.group_sums), KERNEL_REPS, flush)
    dead_ms = time_ms(lambda: [DA.group_sums(torch.full_like(c[0], c[2]), c[1], c[2], torch.zeros(
        (c[2], len(c[1]) + 1), dtype=torch.int64, device="cuda")) for c in captured],
        KERNEL_REPS, flush)
    lib_in, n_bytes, sector_bytes, rows, lives = [], 0, 0, 0, 0
    for slots, vals, n_slots, _ in captured:
        n, k = slots.shape[0], len(vals)
        live_mask = (slots >= 0) & (slots < n_slots)
        live = int(live_mask.sum())
        quads = int(torch.nn.functional.pad(live_mask, (0, -n % 4)).view(-1, 4).any(1).sum())
        idx = torch.where(live_mask, slots, n_slots).long()
        rows_in = torch.stack([*vals, torch.ones(n, dtype=torch.int64, device="cuda")], 1)
        acc = torch.zeros((n_slots + 1, k + 1), dtype=torch.int64, device="cuda")
        lib_in.append((acc, idx, rows_in))
        out_bytes = 8 * n_slots * (k + 1)
        n_bytes += 4 * n + 8 * k * live + out_bytes
        sector_bytes += 4 * n + 32 * k * quads + out_bytes
        rows += n
        lives += live
    lib_ms = time_ms(lambda: [acc.index_add_(0, idx, r) for acc, idx, r in lib_in],
                     KERNEL_REPS, flush)
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_bytes": n_bytes,
            "sector_bound_ms": sector_bytes / HBM_BYTES_PER_S * 1e3,
            "rows": rows, "live": lives, "launches": len(captured), "all_dead_ms": dead_ms}


def yardstick_line(name: str, y: dict, card: str) -> str:
    return (f"{name}: kernel {y['ms']:.4f} ms, plain {y['plain_ms']:.4f} ms, "
            f"index_add_ {y['library_ms']:.4f} ms, bound {y['bound_ms']:.4f} ms "
            f"({y['bound_bytes']} B at 3.35 TB/s), share of bound "
            f"{y['bound_ms'] / y['ms']:.1%}, {y['rows']} rows in {y['launches']} "
            f"launches; the same slots all dead (the slot pass alone) "
            f"{y['all_dead_ms']:.4f} ms; L2 flushed before each run [{card}]")


SSB_PROBE_ROWS = 60_010_680   # lineorder's capacity at SF10


def ssb_date_keys():
    """SSB's d_datekey values, 1992-01-01 to 1998-12-30 as yyyymmdd."""
    start = datetime.date(1992, 1, 1)
    return [int((start + datetime.timedelta(days=d)).strftime("%Y%m%d"))
            for d in range(2556)]


def ssb_join_inputs():
    """SSB's dimension joins at SF10's shapes, made on the card from the
    seed: {name: (probe block, build block, payload columns)}.  A
    60,010,680-slot int32 probe key ``lo_key`` against ``k`` of the date
    build (2,556 rows, span 61,130, every row live, 2 payload columns, a
    probe selection of about 1 in 5 as after earlier joins), customer
    (300,000 rows, 1 in 5 live as under a region filter, 2 columns, no
    probe selection: the first join) and part (800,000 rows, 2 in 5 live,
    1 column, a probe selection); payload columns ``b0``, ``b1``."""
    import torch

    from tiflash_tpu_torch.core import dtypes as dt
    from tiflash_tpu_torch.core.block import Block, Column

    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    n = SSB_PROBE_ROWS

    def ints(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=g, device="cuda", dtype=torch.int32)

    def share(frac, size):
        return torch.rand(size, generator=g, device="cuda") < frac

    def col(data):
        return Column(data, None, dt.INT32, stats=(int(data.min()), int(data.max())))

    shapes = {"date": (torch.tensor(ssb_date_keys(), dtype=torch.int32, device="cuda"),
                       2, None, 0.2),
              "customer": (torch.arange(1, 300_001, dtype=torch.int32, device="cuda"),
                           2, 0.2, None),
              "part": (torch.arange(1, 800_001, dtype=torch.int32, device="cuda"),
                       1, 0.4, 0.4)}
    out = {}
    for name, (bkeys, n_cols, build_live, probe_live) in shapes.items():
        m = bkeys.shape[0]
        build = Block.from_dict(
            {"k": col(bkeys), **{f"b{c}": col(ints(0, 1000, m)) for c in range(n_cols)}},
            sel=None if build_live is None else share(build_live, m))
        pkeys = bkeys[torch.randint(0, m, (n,), generator=g, device="cuda")]
        probe = Block.from_dict({"lo_key": col(pkeys), "lo_revenue": col(ints(0, 10 ** 6, n))},
                                sel=None if probe_live is None else share(probe_live, n))
        out[name] = (probe, build, n_cols)
    return out


def join_probe_args(probe, build, n_cols) -> tuple:
    """The arguments ``probe_join_dense`` hands ``join_probe`` for an
    inner join of ``ssb_join_inputs``' blocks."""
    from tiflash_tpu_torch.ops import join as J

    lo, span = J.dense_key_span([probe["lo_key"]], [build["k"]])
    jb = J.build_join_dense(build, build["k"], lo, span)
    return (probe["lo_key"].data, None, probe.sel, jb.table, lo, jb.perm,
            build.capacity <= probe.capacity,
            [(build[f"b{c}"].data, None) for c in range(n_cols)], False)


def join_probe_phase(card: str, flush) -> dict:
    """SSB's dimension joins at SF10's shapes on the card
    (``ssb_join_inputs``).  Each: the whole ``hash_join`` on the dense
    method equals the sorted method tensor for tensor (rule taken away)
    and launches the kernel once; the kernel equals its plain version at
    its own call; timed (CUDA events, median of ``KERNEL_REPS``, L2
    flushed): the kernel and plain in turns, the whole join on each
    method, and the byte bound (``join_probe.probe_bytes`` over 3.35
    TB/s)."""
    import torch

    from tiflash_tpu_torch.ops import join as J
    from tiflash_tpu_torch.ops.cuda import join_probe as JP

    out = {}
    for name, (probe, build, n_cols) in ssb_join_inputs().items():
        n, m = probe.capacity, build.capacity

        def dense():
            return J.hash_join(probe, build, ["lo_key"], ["k"])

        def by_sort():
            rule = J.dense_key_span
            J.dense_key_span = lambda *a: None
            try:
                return J.hash_join(probe, build, ["lo_key"], ["k"])
            finally:
                J.dense_key_span = rule

        JP.LAUNCHES = 0
        got, gx = dense()
        torch.cuda.synchronize()
        launches = JP.LAUNCHES
        want, wx = by_sort()
        same = [torch.equal(a, b) for a, b in
                [(got.sel, want.sel), (gx["matched_flags"], wx["matched_flags"]),
                 (gx["overflow"], wx["overflow"])]
                + [(a.data, b.data) for a, b in zip(got.columns, want.columns)]
                + [(a.validity, b.validity) for a, b in zip(got.columns, want.columns)
                   if a.validity is not None or b.validity is not None]]
        if launches != 1 or not all(same) or got.names != want.names:
            raise AssertionError(f"join_probe {name}: {launches} launches, dense == sorted "
                                 f"per tensor {same}")
        del got, want, gx, wx
        args = join_probe_args(probe, build, n_cols)
        k_out, p_out = JP.join_probe(*args), JP.join_probe_plain(*args)
        pairs = [(k_out[0], p_out[0]), (k_out[2], p_out[2])] + [
            (a, b) for ka, pa in zip(k_out[3], p_out[3]) for a, b in zip(ka, pa)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"join_probe {name}: kernel != plain")
        matched = int(k_out[0].sum())
        del k_out, p_out, pairs
        p_ms, k_ms = time_turns(lambda: JP.join_probe_plain(*args),
                                lambda: JP.join_probe(*args), KERNEL_REPS, flush)
        sorted_ms, dense_ms = time_turns(by_sort, dense, KERNEL_REPS, flush)
        n_bytes = JP.probe_bytes(n, 4, probe.sel is not None, False, [4] * n_cols)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"rows": n, "build_rows": m, "span": int(args[3].shape[0]),
                     "columns": n_cols, "matched": matched, "launches": launches,
                     "max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                     "bound_bytes": n_bytes, "share_of_bound": bound_ms / k_ms,
                     "dense_join_ms": dense_ms, "sorted_join_ms": sorted_ms}
        print(f"join_probe {name}: {n} probe slots ({matched} matched) x {m} build rows "
              f"(span {out[name]['span']}), {n_cols} payload columns: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms ({n_bytes} B at 3.35 TB/s), "
              f"share of bound {bound_ms / k_ms:.1%}; whole hash_join dense {dense_ms:.4f} "
              f"ms, sorted {sorted_ms:.4f} ms; dense == sorted per tensor, kernel == plain; "
              f"L2 flushed before each run [{card}]")
    return out


def eight_table_queries() -> list:
    """(name, plan function) of the eight-table phase, in the order run:
    the fifteen TPC-H queries of the slice and Q18 at TPC-H's threshold."""
    from tiflash_tpu_torch.bench import tpch_queries as Q

    out = [(f"q{n}", getattr(Q, f"q{n}_plan"))
           for n in (2, 5, 8, 9, 11, 12, 13, 14, 15, 16, 17, 18)]
    out.append(("q18_300", lambda: Q.q18_plan(min_qty=Q18_MIN_QTY)))
    out += [(f"q{n}", getattr(Q, f"q{n}_plan")) for n in (19, 20, 21)]
    return out


# one numpy version per mechanism the slice adds
NUMPY8 = {"q2": numpy_q2, "q9": numpy_q9, "q13": numpy_q13, "q14": numpy_q14,
          "q16": numpy_q16, "q18_300": numpy_q18}


def join_probe_spy(run) -> tuple:
    """(``run()``'s result, the join_probe launches its dense joins make
    on the card).  On the CPU ``join_probe`` runs its plain version; each
    call counts the launches the kernel takes for it: one per
    ``MAX_COLUMNS`` payload columns, none over an empty probe."""
    from tiflash_tpu_torch.ops.cuda import join_probe as JP

    launches = []
    real = JP.join_probe

    def spy(keys, key_valid, sel, table, lo, perm, gather_sorted, columns, want_bidx):
        launches.append(0 if keys.shape[0] == 0
                        else len(range(0, max(1, len(columns)), JP.MAX_COLUMNS)))
        return real(keys, key_valid, sel, table, lo, perm, gather_sorted, columns,
                    want_bidx)

    JP.join_probe = spy
    try:
        out = run()
    finally:
        JP.join_probe = real
    return out, sum(launches)


def cpu_run_with_spy(plan, tables):
    """One ``run_query`` on the CPU with a spy on the direct_agg kernel's
    branch, on the fused path and on the dense joins' probe, which launch
    a kernel on the card.  Returns (block_result, retries, (branch calls,
    fused runs, join_probe launches))."""
    from tiflash_tpu_torch.ops import aggregate as TA
    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.runtime.executor import run_query

    calls = []
    real_branch = TA._accumulate_direct_kernel
    TA._accumulate_direct_kernel = lambda *a: calls.append(1) or real_branch(*a)
    f0 = SF_.FUSE_STATS["count"]
    try:
        (out, summary), joins = join_probe_spy(lambda: run_query(plan, tables))
    finally:
        TA._accumulate_direct_kernel = real_branch
    return (block_result(out), summary.retries,
            (len(calls), SF_.FUSE_STATS["count"] - f0, joins))


def card_run_checked(name: str, plan, tables, cpu_result, cpu_retries: int,
                     predicted) -> tuple:
    """One ``run_query`` on the card: it must launch the kernels the CPU
    dispatch predicts (a fused run launches the generated stream_tile
    kernel, never the planes kernel; the dense joins exactly the
    join_probe launches the CPU run's calls take, counted from 0 just
    before), take the CPU run's retries and equal its result.  Returns
    (result, summary, direct_agg launches, stream_tile launches,
    join_probe launches)."""
    import torch

    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, join_probe as JP
    from tiflash_tpu_torch.ops.cuda import stream_agg as SA, stream_tile as ST
    from tiflash_tpu_torch.runtime.executor import run_query

    d0, s0, p0, f0 = DA.LAUNCHES, ST.LAUNCHES, SA.LAUNCHES, SF_.FUSE_STATS["count"]
    JP.LAUNCHES = 0
    out, summary = run_query(plan, tables)
    torch.cuda.synchronize()
    direct, stream, fused, joins = (DA.LAUNCHES - d0, ST.LAUNCHES - s0,
                                    SF_.FUSE_STATS["count"] - f0, JP.LAUNCHES)
    want_branch, want_fused, want_joins = predicted
    if ((direct > 0) != (want_branch > 0) or fused != want_fused
            or (stream > 0) != (want_fused > 0) or SA.LAUNCHES != p0
            or joins != want_joins):
        raise AssertionError(
            f"{name}: direct_agg launches {direct}, stream_tile launches {stream}, "
            f"planes kernel launches {SA.LAUNCHES - p0}, "
            f"fused runs {fused}, join_probe launches {joins}; the CPU dispatch predicts "
            f"{want_branch} direct_agg branch calls, {want_fused} fused runs and "
            f"{want_joins} join_probe launches")
    if summary.device != "cuda:0" or summary.retries != cpu_retries:
        raise AssertionError(f"{name}: ran on {summary.device} with "
                             f"{summary.retries} retries (CPU: {cpu_retries})")
    got = block_result(out)
    if got != cpu_result:
        raise AssertionError(f"{name}: cuda result != cpu result\n{got}\n{cpu_result}")
    return got, summary, direct, stream, joins


def eight_table_phase(card: str, sf: float = SF):
    """Q2-Q21 and Q18 at threshold 300 on the eight-table catalog: each
    through ``run_query`` on the CPU (with a spy on the two kernels'
    branches), then on the card, bit-exact against the CPU run, six also
    against numpy; the card's launches must equal what the CPU dispatch
    predicts.  Prints each query's warm ``run_query`` median.  Returns
    the catalog, its card tables, the CPU results and each query's
    join_probe launches."""
    import torch

    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    t0 = time.perf_counter()
    cat8 = generate_tpch(sf=sf, seed=SEED)
    print(f"eight-table catalog sf{sf}: " + ", ".join(
        f"{t} {cat8[t].row_count}" for t in EIGHT_TABLES)
        + f" rows in {time.perf_counter() - t0:.1f} s")
    queries = eight_table_queries()

    t0 = time.perf_counter()
    cpu8, cpu_retries, predicted = {}, {}, {}
    cpu_tables = cat8.blocks("cpu")
    for name, plan_fn in queries:
        cpu8[name], cpu_retries[name], predicted[name] = cpu_run_with_spy(
            plan_fn(), cpu_tables)
    del cpu_tables
    a8 = tpch8_arrays(cat8)
    for name, fn in NUMPY8.items():
        want = fn(a8)
        if cpu8[name][0] != want:
            raise AssertionError(f"{name}: port CPU run != numpy\n{cpu8[name][0]}\n{want}")
    del a8
    print(f"cpu runs of {len(queries)} queries, {', '.join(NUMPY8)} equal numpy "
          f"({time.perf_counter() - t0:.1f} s); kernel branches and fused runs "
          f"predicted: {predicted}")

    gpu8 = cat8.blocks("cuda")
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    joins = {}
    for name, plan_fn in queries:
        got, summary, direct, stream, joins[name] = card_run_checked(
            name, plan_fn(), gpu8, cpu8[name], cpu_retries[name], predicted[name])
        checked = " and numpy" if name in NUMPY8 else ""
        print(f"{name} sf{sf} on cuda: {summary.result_rows} rows, {summary.retries} "
              f"retries {summary.overflow_nodes}, direct_agg launches {direct}, "
              f"stream_tile launches {stream}, join_probe launches {joins[name]} "
              f"(as the CPU run's dense joins predict), bit-exact vs port CPU run{checked}")
        if name in ("q13", "q14", "q18_300"):
            print(f"  {name} rows: {got[0]}")
    for name, plan_fn in queries:
        plan = plan_fn()
        q_ms = time_ms(lambda: run_query(plan, gpu8), WARM_RUNS)
        print(f"{name} sf{sf} run_query median {q_ms:.3f} ms over {WARM_RUNS} warm "
              f"runs, {cpu_retries[name]} retries each [{card}]")
    return cat8, gpu8, cpu8, joins


SPEC_RUNS = 5
# device events per Q1 / Q6 run_query, PR 5 (bench/compare_trees.py)
PR5_EVENTS = {"q1": 249, "q6": 51}


def spec_phase(card: str, names, cpu_tables, gpu_tables, builder_cpu: dict,
               sf: float = SF) -> None:
    """The spec-form TPC-H queries ``names`` (``bench/tpch_spec.py``) on one
    catalog: each through ``run_query`` on the CPU with the kernel spy,
    then on the card with the launch counts set to 0 just before and read
    just after, bit-exact against the CPU run.  Then each builder on the
    card: its rows must equal its CPU run's (``builder_cpu``, held to numpy
    elsewhere; filled here where missing), and the spec rows must equal
    them where the quantity is the same.  Prints each spec query's
    ``run_query`` median beside its builder's and whether it fused.
    Returns each spec query's join_probe launches."""
    import torch

    from tiflash_tpu_torch.bench.tpch_spec import SPEC_QUERIES
    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.runtime.executor import run_query

    cpu, retries, predicted = {}, {}, {}
    for name in names:
        spec, builder, _ = SPEC_QUERIES[name]
        cpu[name], retries[name], predicted[name] = cpu_run_with_spy(spec(), cpu_tables)
        if name not in builder_cpu:
            builder_cpu[name] = block_result(run_query(builder(), cpu_tables)[0])
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    joins = {}
    for name in names:
        spec, _, _ = SPEC_QUERIES[name]
        joins[name] = card_run_checked(f"{name}_spec", spec(), gpu_tables, cpu[name],
                                       retries[name], predicted[name])[4]
    launches = (ST.LAUNCHES, DA.LAUNCHES)
    for name in names:
        spec, builder, same = SPEC_QUERIES[name]
        b0 = SF_.FUSE_STATS["count"]
        got_b = block_result(run_query(builder(), gpu_tables)[0])
        builder_fused = SF_.FUSE_STATS["count"] > b0
        if got_b != builder_cpu[name]:
            raise AssertionError(f"{name}: builder's cuda result != its cpu result")
        if same and cpu[name][0] != got_b[0]:
            raise AssertionError(f"{name}: spec rows != builder rows on the card\n"
                                 f"{cpu[name][0]}\n{got_b[0]}")
        sp, bp = spec(), builder()
        spec_ms = time_ms(lambda: run_query(sp, gpu_tables), SPEC_RUNS)
        builder_ms = time_ms(lambda: run_query(bp, gpu_tables), SPEC_RUNS)
        print(f"{name} spec form sf{sf} on cuda: bit-exact vs port CPU run"
              + (", equal to the builder's rows" if same else "")
              + f"; fused {bool(predicted[name][1])} (builder {builder_fused}); "
              f"run_query median {spec_ms:.3f} ms, builder {builder_ms:.3f} ms, "
              f"over {SPEC_RUNS} warm runs [{card}]")
        if name in ("q8", "q12", "q14"):
            print(f"  {name} spec rows: {cpu[name][0]}")
    print(f"spec-form {', '.join(names)}: stream_tile launches {launches[0]}, "
          f"direct_agg launches {launches[1]}, join_probe launches {joins} (as the CPU "
          f"dispatch predicts: {[predicted[n] for n in names]})")
    return joins


def _ulp_key(t):
    """float64 tensor -> int64 keys whose differences count ulps."""
    import torch

    i = t.view(torch.int64)
    return torch.where(i >= 0, i, torch.iinfo(torch.int64).min - i)


def compare_sweep(gpu_out, cpu_out, ulps: dict) -> dict:
    """Column by column and row by row: validity equal, values equal on
    valid rows (bit patterns; wide decimals limb by limb), except the
    columns of ``ulps``, held within their ulp bound.  Returns the largest
    ulp gap of each bounded column."""
    import torch

    gaps = {}
    if list(gpu_out.names) != list(cpu_out.names):
        raise AssertionError(f"sweep columns differ: {gpu_out.names} != {cpu_out.names}")
    for name, g, c in zip(gpu_out.names, gpu_out.columns, cpu_out.columns):
        if not g.data.is_cuda or (g.validity is not None and not g.validity.is_cuda):
            raise AssertionError(f"sweep column {name} left the card")
        if repr(g.dtype) != repr(c.dtype):
            raise AssertionError(f"sweep column {name}: {g.dtype} != {c.dtype}")
        if g.dictionary != c.dictionary:
            raise AssertionError(f"sweep column {name}: dictionaries differ")
        valid = c.valid_mask()
        if not torch.equal(g.valid_mask().cpu(), valid):
            raise AssertionError(f"sweep column {name}: NULLs differ")
        gd, cd = g.data.cpu()[valid], c.data[valid]
        if gd.dtype in (torch.float64, torch.float32, torch.uint64):
            gd, cd = gd.to(torch.float64) if gd.dtype == torch.float32 else gd, \
                cd.to(torch.float64) if cd.dtype == torch.float32 else cd
            gd, cd = gd.view(torch.int64), cd.view(torch.int64)
        if name in ulps:
            gap = int((_ulp_key(gd.view(torch.float64))
                       - _ulp_key(cd.view(torch.float64))).abs().max())
            if gap > ulps[name]:
                raise AssertionError(f"sweep column {name}: {gap} ulps > {ulps[name]}")
            gaps[name] = gap
        elif not torch.equal(gd, cd):
            bad = int((gd != cd).reshape(len(gd), -1).any(dim=1).sum())
            raise AssertionError(f"sweep column {name}: {bad} rows differ")
    return gaps


def sweep_phase(card: str, cpu_tables, gpu_tables) -> None:
    """``functions_sweep_plan()`` over lineitem on the card against the
    port's CPU run, column by column and row by row (``compare_sweep``),
    with the launch counts set to 0 just before and read just after (the
    sweep has no aggregation: none may launch).  Then each family's
    expressions, evaluated on the card over the sweep's materialized
    inputs, synchronized and timed."""
    import torch

    from tiflash_tpu_torch.bench.tpch_spec import (SWEEP_FAMILIES, SWEEP_ULPS,
                                                   functions_sweep_plan,
                                                   sweep_base_plan)
    from tiflash_tpu_torch.expr.compile import ExprEvaluator
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.runtime.executor import run_query

    plan = functions_sweep_plan()
    t0 = time.perf_counter()
    cpu_out, _ = run_query(plan, cpu_tables)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    gpu_out, summary = run_query(plan, gpu_tables)
    torch.cuda.synchronize()
    if SA.LAUNCHES or DA.LAUNCHES or ST.LAUNCHES:
        raise AssertionError("the function sweep launched an aggregation kernel")
    if summary.device != "cuda:0":
        raise AssertionError(f"sweep: result on {summary.device}")
    gaps = compare_sweep(gpu_out, cpu_out, SWEEP_ULPS)
    print(f"function sweep sf{SF} on cuda: {len(gpu_out.names)} columns x "
          f"{gpu_out.capacity} rows equal the port's CPU run ({cpu_s:.1f} s); "
          f"integers, decimals, dates, datetimes, bools and exact floats "
          f"bit-exact; transcendental columns within {SWEEP_ULPS} ulps, largest "
          f"gaps seen {gaps}")
    del cpu_out, gpu_out
    base, _ = run_query(sweep_base_plan(), gpu_tables)
    ev = ExprEvaluator(base)
    for fam, exprs in SWEEP_FAMILIES.items():
        ms = time_ms(lambda: [ev.evaluate(e) for e in exprs.values()], SPEC_RUNS)
        print(f"  sweep family {fam}: {len(exprs)} columns over {base.capacity} rows "
              f"in {ms:.3f} ms (median of {SPEC_RUNS}, synchronized) [{card}]")


def device_profile(fn):
    """(summed device time in ms of the CUDA kernels and copies ``fn()``
    runs, the number of device events, {kernel name: device ms}) from one
    ``torch.profiler`` trace; (None, 0, {}) where it holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {e.key: getattr(e, "self_device_time_total", 0) / 1e3
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    us = sum(by_name.values()) * 1e3
    events = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return (us / 1e3 if us else None), events, by_name


def device_busy_ms(fn):
    """Summed device time of ``fn()``'s CUDA kernels and copies (ms)."""
    return device_profile(fn)[0]


JSON_ERROR = "Invalid JSON text: The document root must not be followed by other values."


def string_phase(card: str, cpu_tables, gpu_tables, li: dict) -> dict:
    """The string slice on the lineitem catalog.

    1. ``strings_sweep_plan()`` on the card against the port's CPU run,
       column by column and row by row, dictionaries as tuples (tolerance
       zero), with the launch counts set to 0 just before and read just
       after (no aggregation: none may launch); then each family's
       expressions over the sweep's materialized inputs, synchronized and
       timed.
    2. ``ship_month_plan()`` on the card against the CPU run and
       ``numpy_ship_month``: one direct_agg launch per run; its warm
       ``run_query`` median, device busy time and idle share; the captured
       ``direct_sums`` call held kernel == plain; the kernel timed at its
       captured ``group_sums`` arguments (``direct_agg_yardsticks``).
    3. CAST(l_shipmode AS JSON): no mode is a JSON document, so the run
       raises the reference's ``EngineError``; behind a selection that
       keeps no row it does not.

    Returns the ship-month report's launches and yardsticks."""
    import torch

    from tiflash_tpu_torch.bench.strings import (STRING_SWEEP_FAMILIES,
                                                 ship_month_plan,
                                                 strings_sweep_base_plan,
                                                 strings_sweep_plan)
    from tiflash_tpu_torch.expr.compile import ExprEvaluator
    from tiflash_tpu_torch.expr.nodes import call, col
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.plan import nodes as P
    from tiflash_tpu_torch.runtime.errors import EngineError
    from tiflash_tpu_torch.runtime.executor import run_query

    # ---- the string sweep ----
    plan = strings_sweep_plan()
    t0 = time.perf_counter()
    cpu_out, _ = run_query(plan, cpu_tables)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    t0 = time.perf_counter()
    gpu_out, summary = run_query(plan, gpu_tables)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    if SA.LAUNCHES or DA.LAUNCHES or ST.LAUNCHES:
        raise AssertionError("the string sweep launched an aggregation kernel")
    if summary.device != "cuda:0":
        raise AssertionError(f"string sweep: result on {summary.device}")
    compare_sweep(gpu_out, cpu_out, {})
    print(f"string sweep sf{SF} on cuda: {len(gpu_out.names)} columns x "
          f"{gpu_out.capacity} rows equal the port's CPU run (codes, dictionaries, "
          f"integers, dates, durations and NULLs bit-exact; CPU {cpu_s:.1f} s, first "
          f"card run {gpu_s:.2f} s), no kernel launched")
    del cpu_out, gpu_out
    base, _ = run_query(strings_sweep_base_plan(), gpu_tables)
    ev = ExprEvaluator(base)
    for fam, exprs in STRING_SWEEP_FAMILIES.items():
        ms = time_ms(lambda: [ev.evaluate(e) for e in exprs.values()], SPEC_RUNS)
        print(f"  string family {fam}: {len(exprs)} columns over {base.capacity} "
              f"rows in {ms:.3f} ms (median of {SPEC_RUNS}, synchronized) [{card}]")
    del base, ev

    # ---- the ship-month report ----
    cpu_res = block_result(run_query(ship_month_plan(), cpu_tables)[0])
    want = numpy_ship_month(li)
    if cpu_res[0] != want:
        raise AssertionError(f"ship_month: port CPU run != numpy\n{cpu_res[0]}\n{want}")
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    out, summary = run_query(ship_month_plan(), gpu_tables)
    torch.cuda.synchronize()
    launches = DA.LAUNCHES
    if launches != 1 or SA.LAUNCHES or ST.LAUNCHES:
        raise AssertionError(f"ship_month: direct_agg launches {launches}, "
                             f"stream_agg launches {SA.LAUNCHES}; expected 1 and 0")
    got = block_result(out)
    if got != cpu_res:
        raise AssertionError(f"ship_month: cuda result != cpu result\n{got}\n{cpu_res}")
    if summary.device != "cuda:0" or summary.retries:
        raise AssertionError(f"ship_month: ran on {summary.device} with "
                             f"{summary.retries} retries")
    plan = ship_month_plan()
    captured = capture_calls(DA, "direct_sums", lambda: run_query(plan, gpu_tables))
    if len(captured) != 1:
        raise AssertionError(f"ship_month: {len(captured)} direct_sums calls")
    slots, values, masks, live, n_slots = captured[0]
    k_out = DA.direct_sums(slots, values, masks, live, n_slots)
    p_out = DA.direct_sums_plain(slots, values, masks, live, n_slots)
    torch.cuda.synchronize()
    pairs = [(k_out[0], p_out[0]), (k_out[1], p_out[1])] + list(zip(k_out[2], p_out[2]))
    max_err = max(int((a - b).abs().max()) for a, b in pairs)
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"ship_month: direct_agg kernel != plain (max abs err "
                             f"{max_err})")
    n_groups = int((k_out[1] > 0).sum())
    print(f"ship_month sf{SF} on cuda: {summary.result_rows} groups of a {n_slots}-slot "
          f"domain, direct_agg launches {launches}, bit-exact vs port CPU run and numpy;"
          f" kernel == plain at the captured direct_sums call ({len(values)} value "
          f"columns, {n_groups} occupied slots)")
    print(f"  ship_month rows (first 3): " + str({k: v[:3] for k, v in got[0].items()}))
    q_ms = time_ms(lambda: run_query(plan, gpu_tables), WARM_RUNS)
    busy = device_busy_ms(lambda: run_query(plan, gpu_tables))
    busy_txt = ("device busy not measured (the trace held no device time)"
                if busy is None else f"device busy {busy:.3f} ms, idle share "
                f"{1 - busy / q_ms:.1%} of the median")
    print(f"ship_month sf{SF} run_query median {q_ms:.3f} ms over {WARM_RUNS} warm "
          f"runs; {busy_txt} [{card}]")
    flush = L2Flush()
    groups = capture_calls(DA, "group_sums", lambda: run_query(plan, gpu_tables))
    y = direct_agg_yardsticks(DA, groups, flush)
    print("  " + yardstick_line("ship_month direct_agg", y, card))

    # ---- the runtime error channel on the card ----
    bad = P.Projection({"j": call("cast_as_json", col("l_shipmode"))},
                       P.TableScan("lineitem"))
    try:
        run_query(bad, gpu_tables)
    except EngineError as e:
        if str(e) != JSON_ERROR:
            raise AssertionError(f"cast_as_json: raised {e!r}") from None
    else:
        raise AssertionError("cast_as_json over l_shipmode did not raise")
    dead = P.Projection({"j": call("cast_as_json", col("l_shipmode"))},
                        P.Selection(col("l_linenumber") > 7, P.TableScan("lineitem")))
    out, summary = run_query(dead, gpu_tables)
    if summary.result_rows != 0 or out["j"].data.device.type != "cuda":
        raise AssertionError("cast_as_json behind an empty selection")
    print(f"runtime errors on cuda: CAST(l_shipmode AS JSON) raises EngineError "
          f"{JSON_ERROR!r}; behind l_linenumber > 7 (no live row) it does not")
    return {"launches": launches, "max_abs_err": max_err, "yardsticks": y}


def sf10_catalog():
    """The SF10 catalog (seed 0) that Q1 at SF10 and the out-of-core
    phase share: lineitem, orders and customer with the columns of
    ``SF10_COLUMNS``.  Returns (catalog, seconds to make it)."""
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    t0 = time.perf_counter()
    cat = generate_tpch(sf=SF10, seed=SEED, tables=Q3_TABLES, column_subset=SF10_COLUMNS)
    return cat, time.perf_counter() - t0


def sf10_q1_phase(card: str, flush, cat, gen_s: float) -> dict:
    """TPC-H Q1 at SF10 on the shared SF10 catalog (``sf10_catalog``): one
    launch of the generated kernel over about 60M rows; ``sum_charge``'s
    bound passes 2^62, so the fuse recombines its plane sums in two-limb
    wide decimals (``wide_out``).  Held bit-exact against numpy with
    Python integers (no CPU run of the port).  Prints the data generation
    time, the kernel source's generation time and build, the kernel's
    time and its bound.  The returned dict holds numpy's rows (``want``)."""
    import torch

    from tiflash_tpu_torch.bench.tpch_queries import q1_plan
    from tiflash_tpu_torch.ops import tile_program as TP
    from tiflash_tpu_torch.ops.cuda import build, stream_agg as SA, stream_tile as ST
    from tiflash_tpu_torch.runtime.executor import run_query

    t = cat["lineitem"].block
    li = {n: t[n].data.numpy() for n in Q1_COLUMNS}
    li["rf_dict"] = t["l_returnflag"].dictionary
    li["ls_dict"] = t["l_linestatus"].dictionary
    want = numpy_q1(li)
    gpu = cat.blocks("cuda")
    n_rows = cat["lineitem"].row_count
    del t, li
    torch.cuda.synchronize()
    SA.LAUNCHES = ST.LAUNCHES = 0
    n_built = len(build.BUILD_SECONDS)
    t0 = time.perf_counter()
    out = []
    (call,) = capture_calls(ST, "fused_group_sums",
                            lambda: out.append(run_query(q1_plan(), gpu)[0]))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if ST.LAUNCHES != 1 or SA.LAUNCHES:
        raise AssertionError(f"q1 sf{SF10}: stream_tile launches {ST.LAUNCHES}, planes "
                             f"kernel {SA.LAUNCHES}; expected 1 and 0")
    if out[0]["sum_charge"].data.dim() != 2:
        raise AssertionError(f"q1 sf{SF10}: sum_charge did not take the two-limb "
                             f"recombination")
    got = block_result(out[0])[0]
    if got != want:
        raise AssertionError(f"q1 sf{SF10}: cuda result != numpy\n{got}\n{want}")
    _, program, _, n_limbs, _, pf, h, _ = call
    t0 = time.perf_counter()
    ST.kernel_source(program, SA.field_table(pf, n_limbs), h)
    src_s = time.perf_counter() - t0
    # kernel == plain, then kernel, plain, unfused and one index_add_ at
    # the query's own call
    y = fused_yardsticks(SA, ST, TP, call, flush, SF10_REPS)
    y.pop("planes_call")
    err, k_ms, n_bytes = y["max_abs_err"], y["ms"], y["bound_bytes"]
    plan = q1_plan()
    q_ms = time_ms(lambda: run_query(plan, gpu), WARM_RUNS)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    new_builds = len(build.BUILD_SECONDS) - n_built
    print(f"q1 sf{SF10} on cuda: {n_rows} lineitem rows made in {gen_s:.1f} s; one "
          f"stream_tile launch, sum_charge through the two-limb recombination, "
          f"bit-exact vs numpy (Python integers): {got['sum_charge']}; source generated "
          f"in {src_s * 1e3:.1f} ms, {new_builds} new builds, first run {first_s:.2f} s")
    print(f"  q1 sf{SF10} stream_tile: kernel == plain (exact), kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({n_bytes} B at 3.35 TB/s), share of bound {bound_ms / k_ms:.1%}; run_query "
          f"median {q_ms:.3f} ms over {WARM_RUNS} warm runs [{card}]")
    print("  " + fused_line(f"q1 sf{SF10}", y, card))
    del gpu, call, out
    return {"rows": n_rows, "ms": k_ms, "bound_ms": bound_ms, "run_query_ms": q_ms,
            "plain_ms": y["plain_ms"], "library_ms": y["library_ms"],
            "unfused_ms": y["unfused_ms"],
            "source_generation_s": src_s, "new_builds": new_builds, "max_abs_err": err,
            "want": want}


# ---- the runtime slice: the out-of-core rehearsal at SF10, the runner's controls --

def hc_plan():
    """The high-cardinality GROUP BY of the reference's SF10 rehearsal
    (``tools/rehearse_sf10.py``): per l_orderkey of the lines shipped after
    1995-03-15, sum(l_extendedprice) and count(*)."""
    from tiflash_tpu_torch.expr.nodes import col
    from tiflash_tpu_torch.ops.aggregate import AggDesc
    from tiflash_tpu_torch.plan import nodes as P

    return P.Aggregation(
        ["l_orderkey"], [AggDesc("sum", "l_extendedprice", "s"), AggDesc("count", None, "c")],
        P.Selection(col("l_shipdate") > Q3_DATE,
                    P.TableScan("lineitem",
                                columns=["l_orderkey", "l_extendedprice", "l_shipdate"])))


def daily_revenue_plan():
    """Revenue and lines per ship date over lineitem (about 2,526 dates:
    a key domain the direct method takes)."""
    from tiflash_tpu_torch.ops.aggregate import AggDesc
    from tiflash_tpu_torch.plan import nodes as P

    return P.Aggregation(
        ["l_shipdate"], [AggDesc("sum", "l_extendedprice", "revenue"),
                         AggDesc("count", None, "n")],
        P.TableScan("lineitem", columns=["l_shipdate", "l_extendedprice"]))


def numpy_hc(cat) -> dict:
    """``hc_plan`` over host arrays: per l_orderkey of the lines shipped
    after 1995-03-15, sum(l_extendedprice) and count(*), as sorted numpy
    arrays (keys, sums, counts)."""
    import numpy as np

    t = cat["lineitem"].block
    m = t["l_shipdate"].data.numpy() > _days(Q3_DATE)
    k = t["l_orderkey"].data.numpy()[m]
    v = t["l_extendedprice"].data.numpy()[m]
    order = np.argsort(k, kind="stable")
    k, v = k[order], v[order]
    uniq, starts = np.unique(k, return_index=True)
    return {"l_orderkey": uniq, "s": np.add.reduceat(v, starts) if len(k) else v[:0],
            "c": np.diff(np.append(starts, len(k)))}


def check_hc(name: str, block, want: dict) -> None:
    """A ``hc_plan`` result equals ``numpy_hc``: every key, sum and count;
    raises naming the first differing row."""
    import numpy as np

    n, cols = _rows_by_key(block, "l_orderkey")
    got = {nm: d.cpu().numpy() for nm, (_, d) in zip(block.names, cols)}
    if n != len(want["l_orderkey"]):
        raise AssertionError(f"{name}: {n} groups, numpy {len(want['l_orderkey'])}")
    for nm in ("l_orderkey", "s", "c"):
        bad = np.nonzero(got[nm] != want[nm])[0]
        if len(bad):
            i = int(bad[0])
            raise AssertionError(f"{name}: {nm} differs from numpy at {len(bad)} rows, "
                                 f"first at key {want['l_orderkey'][i]}: {got[nm][i]} "
                                 f"vs {want[nm][i]}")


def q3_arrays(cat) -> dict:
    """Host numpy copies of the columns ``numpy_q3`` reads."""
    cols = {"customer": ("c_custkey", "c_mktsegment"),
            "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
            "lineitem": ("l_orderkey", "l_extendedprice", "l_discount", "l_shipdate")}
    out = {c: cat[t].block[c].data.numpy() for t, cs in cols.items() for c in cs}
    out["segment_dict"] = cat["customer"].block["c_mktsegment"].dictionary
    return out


def partition_budget(plan_fn, tables, wanted=(2, 4)) -> tuple:
    """A ``max_bytes_per_device`` below the plan's estimate
    (``estimate_plan_bytes`` of the tree the runner runs) whose sizing
    budget gives the group-partitioned path a partition count in
    ``wanted`` by the port's own rule (``outofcore._partition_count``).
    Returns (budget, partitions, estimate)."""
    from tiflash_tpu_torch.runtime import outofcore as OC
    from tiflash_tpu_torch.runtime.executor import QueryRunner
    from tiflash_tpu_torch.runtime.memory import block_bytes, estimate_plan_bytes

    plan = QueryRunner(plan_fn()).plan
    est = estimate_plan_bytes(plan, tables)
    spec = OC.groupagg_spec(plan)
    base = tables[spec["table"]]
    h = OC._host_key_hash(base, spec["cols"])
    floor = sum(block_bytes(b) for b in tables.values()) // 64
    for i in range(63, 0, -1):
        budget = est * i // 64
        n_parts = OC._partition_count(block_bytes(base), max(budget, floor), h,
                                      base.capacity)
        if n_parts in wanted:
            return budget, n_parts, est
    raise AssertionError(f"no budget below {est} B gives {wanted} partitions")


def ooc_spy(run) -> tuple:
    """``run()`` with spies on the two kernels' wrappers: each
    ``fused_group_sums`` call is one stream_tile launch, each direct_agg
    ``group_sums`` call one launch per column group
    (``direct_agg.column_groups``), on the CPU (plain) as on the card.
    Marks the launches so far at each out-of-core piece's output
    (``outofcore._to_host_rows``) and keeps each wrapper's first call,
    cloned.  Returns (run's value, marks [(direct, stream)], totals,
    first calls by wrapper)."""
    import torch

    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_tile as ST
    from tiflash_tpu_torch.runtime import outofcore as OC

    count = {"direct": 0, "stream": 0}
    marks, first = [], {}
    real = (DA.group_sums, ST.fused_group_sums, OC._to_host_rows)

    def clone(args):
        def one(a):
            if isinstance(a, torch.Tensor):
                return a.clone()
            if isinstance(a, list) and all(isinstance(t, torch.Tensor) for t in a):
                return [t.clone() for t in a]
            if isinstance(a, dict) and all(isinstance(t, torch.Tensor) for t in a.values()):
                return {k: t.clone() for k, t in a.items()}
            return a
        return tuple(one(a) for a in args)

    def direct(slots, vals, n_slots, out):
        count["direct"] += len(DA.column_groups(n_slots, len(DA._value_list(vals)) + 1))
        first.setdefault("direct_agg", clone((slots, vals, n_slots, out)))
        return real[0](slots, vals, n_slots, out)

    def stream(*args):
        count["stream"] += 1
        first.setdefault("stream_tile", clone(args))
        return real[1](*args)

    def host(block):
        marks.append((count["direct"], count["stream"]))
        return real[2](block)

    DA.group_sums, ST.fused_group_sums, OC._to_host_rows = direct, stream, host
    try:
        value = run()
    finally:
        DA.group_sums, ST.fused_group_sums, OC._to_host_rows = real
    return value, marks, (count["direct"], count["stream"]), first


def per_piece(marks, total, pieces: int) -> tuple:
    """(launches per piece, launches after the last piece), each as
    (direct_agg, stream_tile); every piece must launch alike."""
    incs = [(b[0] - a[0], b[1] - a[1])
            for a, b in zip([(0, 0)] + marks[:pieces - 1], marks[:pieces])]
    if len(set(incs)) != 1:
        raise AssertionError(f"pieces launch unevenly: {incs}")
    last = marks[pieces - 1]
    return incs[0], (total[0] - last[0], total[1] - last[1])


def outofcore_predictions(cpu_tables) -> dict:
    """The launches of ``q1_partitioned`` and ``daily_revenue`` predicted
    by the port's CPU run of the same plans at SF1 (lineitem), through
    ``QueryRunner`` with the phase's settings (Q1's budget chosen for 2 or
    4 partitions at SF1 by the same rule): per piece and after the last
    piece, which the card run scales to its own piece count."""
    from tiflash_tpu_torch.bench.tpch_queries import q1_plan
    from tiflash_tpu_torch.runtime.executor import QueryRunner
    from tiflash_tpu_torch.runtime.settings import Settings

    budget, _, _ = partition_budget(q1_plan, cpu_tables)
    out = {}
    for name, plan_fn, s in (
            ("q1_partitioned", q1_plan, Settings(max_bytes_per_device=budget)),
            ("daily_revenue", daily_revenue_plan,
             Settings(max_bytes_before_external_group_by=1))):
        t0 = time.perf_counter()
        (_, summary), marks, total, _ = ooc_spy(
            lambda: QueryRunner(plan_fn(), settings=s).run(cpu_tables))
        info = summary.out_of_core
        each, tail = per_piece(marks, total, info["pieces"])
        out[name] = {"mode": info["mode"], "pieces": info["pieces"], "per_piece": each,
                     "tail": tail}
        print(f"{name} sf{SF} cpu prediction: {info['mode']} out-of-core, "
              f"{info['pieces']} pieces; per piece {each[0]} direct_agg and {each[1]} "
              f"stream_tile launches, after the last {tail[0]} and {tail[1]} "
              f"({time.perf_counter() - t0:.1f} s)")
    return out


def _rows_by_key(block, key: str):
    """A result's live rows sorted by ``key`` (unique per row), each column
    as (validity, data with invalid rows zeroed), on its device.  A wide
    decimal's limbs become int64 where every valid value fits, so a value
    compares equal in either storage."""
    import torch

    from tiflash_tpu_torch.core.wide import narrow_i64, resize_wide

    b = block.compact()
    n = int(b.num_rows())
    order = torch.argsort(b[key].data[:n], stable=True)
    out = []
    for c in b.columns:
        v = c.valid_mask()[:n][order]
        d = c.data[:n][order]
        if d.dim() == 2 and d.dtype == torch.int64:
            two, ov = resize_wide(d, 2)
            val, fits = narrow_i64(two)
            if bool(((fits & ~ov) | ~v).all()):
                d = val
        mask = v if d.dim() == 1 else v[:, None]
        out.append((v, torch.where(mask, d, torch.zeros_like(d))))
    return n, out


def same_rows(a, b, key=None) -> bool:
    """Two results hold the same rows: decoded and in order (small
    results), or by a unique key on the card (large ones), NULLs and
    values.  Types are not compared: an out-of-core final merge sums
    partial sums, so a decimal sum's type widens as the reference's does
    (Decimal(37,2) in memory, Decimal(59,2) out of core) and a count
    becomes nullable; the values are the same."""
    import torch

    if key is None:
        return block_result(a)[0] == block_result(b)[0]
    if a.names != b.names:
        return False
    na, ra = _rows_by_key(a, key)
    nb, rb = _rows_by_key(b, key)
    return na == nb and all(torch.equal(va, vb) and torch.equal(da, db)
                            for (va, da), (vb, db) in zip(ra, rb))


def outofcore_phase(card: str, cat, q1_want: dict, pred: dict, flush) -> dict:
    """The reference's SF10 out-of-core rehearsal on the card, on the
    shared SF10 catalog: each run in memory (``run_query``), then through
    ``QueryRunner`` with its settings, the counts set to 0 just before and
    read just after; bit-exact against the in-memory card run (Q3 and Q1
    also against numpy), in the expected mode, the kernels launched as the
    CPU dispatch predicts scaled to the card's piece count.  Prints mode,
    pieces, launches, bytes and chunk files spilled, wall times, device
    busy time and the allocator's peak against the budget.  Returns the
    kernels' yardsticks at their first out-of-core call."""
    import shutil
    import tempfile

    import torch

    from tiflash_tpu_torch.bench.tpch_queries import q1_plan, q3_plan
    from tiflash_tpu_torch.ops import tile_program as TP
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.runtime.executor import QueryRunner, run_query
    from tiflash_tpu_torch.runtime.memory import block_bytes
    from tiflash_tpu_torch.runtime.metrics import METRICS
    from tiflash_tpu_torch.runtime.settings import Settings

    gpu = cat.blocks("cuda")
    resident = sum(block_bytes(b, shadows=True) for b in gpu.values())
    t0 = time.perf_counter()
    want3 = numpy_q3(q3_arrays(cat))
    want_hc = numpy_hc(cat)
    q1_budget, q1_parts, q1_est = partition_budget(q1_plan, gpu)
    print(f"out-of-core phase sf{SF10}: tables on the card {resident} B; numpy q3 and "
          f"Q1's budget {q1_budget} B (estimate {q1_est} B, {q1_parts} partitions) in "
          f"{time.perf_counter() - t0:.1f} s")
    spill_dir = tempfile.mkdtemp(prefix="ooc_spill_")
    runs = (
        ("q3_grace", q3_plan, Settings(max_bytes_before_external_join=1,
                                       spill_dir=spill_dir), "grace", None, want3),
        ("hc_external", hc_plan, Settings(max_bytes_before_external_group_by=1,
                                          spill_dir=spill_dir), "chunked", "l_orderkey", None),
        ("q1_partitioned", q1_plan, Settings(max_bytes_per_device=q1_budget), "groupagg",
         None, q1_want),
        ("daily_revenue", daily_revenue_plan, Settings(max_bytes_before_external_group_by=1),
         "chunked", "l_shipdate", None),
    )
    out = {}
    try:
        for name, plan_fn, s, mode, key, numpy_want in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mem_out, mem_sum = run_query(plan_fn(), gpu)
            torch.cuda.synchronize()
            mem_s = time.perf_counter() - t0
            m0 = METRICS.dump()
            torch.cuda.synchronize()
            SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
            t0 = time.perf_counter()
            (got, summary), marks, total, first = ooc_spy(
                lambda: QueryRunner(plan_fn(), settings=s).run(gpu))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = (DA.LAUNCHES, ST.LAUNCHES, SA.LAUNCHES)
            m1 = METRICS.dump()
            info = summary.out_of_core
            if info.get("mode") != mode or f"[{mode} out-of-core]" not in summary.plan_text:
                raise AssertionError(f"{name}: ran {info.get('mode')}, expected {mode}")
            if summary.device != "cuda:0" or mem_sum.device != "cuda:0":
                raise AssertionError(f"{name}: results on {summary.device}/{mem_sum.device}")
            if name == "hc_external":
                check_hc(f"{name} in memory", mem_out, want_hc)
                check_hc(name, got, want_hc)
            if not same_rows(got, mem_out, key):
                raise AssertionError(f"{name}: out-of-core rows != in-memory rows")
            if numpy_want is not None and block_result(got)[0] != numpy_want:
                raise AssertionError(f"{name}: rows != numpy\n{block_result(got)[0]}\n"
                                     f"{numpy_want}")
            if launches[:2] != total or launches[2]:
                raise AssertionError(f"{name}: launches (direct_agg, stream_tile, planes) "
                                     f"{launches}, the wrappers' calls give {total}")
            pieces = info["pieces"]
            if name in pred:
                p = pred[name]
                if p["mode"] != mode:
                    raise AssertionError(f"{name}: the CPU prediction ran {p['mode']}")
                want_l = tuple(e * pieces + t for e, t in zip(p["per_piece"], p["tail"]))
                if launches[:2] != want_l:
                    raise AssertionError(f"{name}: launches {launches[:2]}, the CPU dispatch "
                                         f"predicts {want_l} at {pieces} pieces")
            spilled = int(m1["spill_disk_bytes_total"] - m0["spill_disk_bytes_total"])
            files = int(m1["spill_chunk_files_total"] - m0["spill_chunk_files_total"])
            staged = int(m1["spill_bytes_total"] - m0["spill_bytes_total"])
            if s.spill_dir and not (spilled > 0 and files > 0):
                raise AssertionError(f"{name}: nothing spilled to {s.spill_dir}")
            busy = device_busy_ms(lambda: QueryRunner(plan_fn(), settings=s).run(gpu))
            busy_txt = ("not measured" if busy is None else
                        f"{busy:.3f} ms (idle {1 - busy / (wall * 1e3):.1%} of the wall)")
            print(f"{name} sf{SF10} on cuda: [{mode} out-of-core], {pieces} "
                  f"{'chunks' if mode in ('chunked', 'sliced') else 'partitions'}"
                  f"{', final merge ' + str(info['merge_buckets']) + ' buckets' if info.get('merge_buckets') else ''}"
                  f", sizing budget {info['budget_bytes']} B; launches direct_agg "
                  f"{launches[0]}, stream_tile {launches[1]}, planes kernel {launches[2]}"
                  f"{' (as predicted)' if name in pred else ''}; spilled {spilled} B in "
                  f"{files} chunk files ({staged} B staged); wall {wall:.3f} s (kernel builds {summary.compile_seconds:.2f} s), "
                  f"in memory {mem_s:.3f} s; device busy {busy_txt}; allocator peak "
                  f"{summary.peak_device_bytes} B (tables {resident} B) against the budget; "
                  f"{summary.result_rows} rows, bit-exact vs the in-memory card run"
                  f"{' and numpy' if numpy_want is not None or name == 'hc_external' else ''}"
                  f" [{card}]")
            out[name] = {"mode": mode, "pieces": pieces, "wall_s": wall, "in_memory_s": mem_s,
                         "busy_ms": busy, "launches": launches[:2], "spilled_bytes": spilled,
                         "spill_files": files, "peak_bytes": summary.peak_device_bytes,
                         "budget_bytes": info["budget_bytes"], "rows": summary.result_rows}
            if name == "q1_partitioned":
                call = first["stream_tile"]
                y = fused_yardsticks(SA, ST, TP, call, flush, SF10_REPS)
                y.pop("planes_call")
                out[name]["stream_tile"] = y
                print("  " + fused_line(f"{name} (first partition)", y, card))
            if "direct_agg" in first:
                call = first["direct_agg"]
                slots, vals, n_slots, _ = call
                zeros = torch.zeros((n_slots, len(DA._value_list(vals)) + 1),
                                    dtype=torch.int64, device="cuda")
                k = DA.group_sums(slots, vals, n_slots, zeros.clone())
                pl = DA.group_sums_plain(slots, vals, n_slots, zeros.clone())
                if not torch.equal(k, pl):
                    raise AssertionError(f"{name}: direct_agg kernel != plain at a chunk")
                y = direct_agg_yardsticks(DA, [call], flush)
                y["max_abs_err"] = int((k - pl).abs().max())
                out[name]["direct_agg"] = y
                print("  " + yardstick_line(f"{name} direct_agg (first chunk, S={n_slots})",
                                            y, card))
            del got, mem_out, first
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    return out


def runtime_controls_phase(card: str, cpu_tables, gpu_tables) -> None:
    """The runner's controls on the card at SF1, each as on the CPU: a
    ``CancelFlag`` set from another thread mid-run of an out-of-core query
    raises ``QueryCancelled``; ``max_execution_time_ms=1`` raises
    ``QueryTimeout``; ``max_result_rows`` throws in ``throw`` mode and
    truncates in ``break`` mode; failpoint ``exception_before_fragment_run``
    raises through ``run_query``."""
    import threading

    from tiflash_tpu_torch.bench.tpch_queries import q1_plan
    from tiflash_tpu_torch.runtime.cancel import CancelFlag, QueryCancelled, QueryTimeout
    from tiflash_tpu_torch.runtime.errors import LIMIT_EXCEEDED, EngineError
    from tiflash_tpu_torch.runtime.executor import QueryRunner, run_query
    from tiflash_tpu_torch.runtime.failpoint import FailPoint, FailPointError
    from tiflash_tpu_torch.runtime.metrics import METRICS
    from tiflash_tpu_torch.runtime.settings import Settings

    flag = CancelFlag()
    rows_per_chunk = 20_000
    n_chunks = -(-gpu_tables["lineitem"].capacity // rows_per_chunk)
    c0 = METRICS.dump()["ooc_chunks_total"]

    def cancel_after_two_chunks():
        deadline = time.monotonic() + 60
        while METRICS.dump()["ooc_chunks_total"] < c0 + 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        flag.set()

    th = threading.Thread(target=cancel_after_two_chunks, daemon=True)
    th.start()
    s = Settings(max_bytes_before_external_group_by=1, max_spilled_rows_per_file=rows_per_chunk)
    try:
        QueryRunner(daily_revenue_plan(), settings=s, cancel=flag).run(gpu_tables)
        raise AssertionError("the out-of-core query was not cancelled")
    except QueryCancelled:
        pass
    th.join(timeout=60)
    done = int(METRICS.dump()["ooc_chunks_total"] - c0)
    if not 2 <= done < n_chunks:
        raise AssertionError(f"cancelled after {done} of {n_chunks} chunks")
    print(f"cancel: a flag set from another thread stopped daily_revenue sf{SF} "
          f"(chunked, {n_chunks} chunks of {rows_per_chunk} rows) after {done} chunks: "
          f"QueryCancelled [{card}]")
    try:
        run_query(q1_plan(), gpu_tables, settings=Settings(max_execution_time_ms=1))
        raise AssertionError("max_execution_time_ms=1 did not time out")
    except QueryTimeout:
        pass
    full = block_result(run_query(q1_plan(), gpu_tables)[0])[0]
    for tables in (cpu_tables, gpu_tables):
        try:
            run_query(q1_plan(), tables, settings=Settings(max_result_rows=2))
            raise AssertionError("max_result_rows=2 did not throw")
        except EngineError as e:
            if e.code != LIMIT_EXCEEDED:
                raise
    brk = Settings(max_result_rows=2, result_overflow_mode="break")
    got = block_result(run_query(q1_plan(), gpu_tables, settings=brk)[0])
    if got != block_result(run_query(q1_plan(), cpu_tables, settings=brk)[0]) or \
            got[0] != {k: v[:2] for k, v in full.items()}:
        raise AssertionError(f"break mode: {got[0]} is not the CPU's first two rows")
    FailPoint.enable("exception_before_fragment_run")
    try:
        run_query(q1_plan(), gpu_tables)
        raise AssertionError("the failpoint did not fire")
    except FailPointError:
        pass
    finally:
        FailPoint.disable_all()
    print(f"max_execution_time_ms=1: QueryTimeout; max_result_rows=2: LIMIT_EXCEEDED "
          f"(throw) on the card and the CPU, the first 2 rows (break) equal to the CPU's; "
          f"exception_before_fragment_run raised through run_query [{card}]")


def explain_phase(card: str, gpu7) -> dict:
    """EXPLAIN ANALYZE of Q7-pairs on the card: per-node subtree and self
    times (CUDA events after a synchronize; 2 warm and 20 timed rounds);
    the self times must sum to within 10% of one timed run of the same
    tree, the median of 20 runs, one at the end of each timed round.
    Measured in the report's rounds, a slow or fast stretch of the host
    touches both sides alike; measured after the report instead, the two
    medians read 86.0-118.2% of each other over 20 back-to-back repeats
    on an idle host.  Prints both sides' spread over
    their 20 samples: the self-time sum of each round, and each run of
    the tree."""
    import statistics

    import tiflash_tpu_torch.runtime.analyze as A
    from tiflash_tpu_torch.bench.tpch_queries import q7_nation_pairs_plan
    from tiflash_tpu_torch.runtime.executor import QueryRunner

    runner = QueryRunner(q7_nation_pairs_plan())
    runner.run(gpu7)  # the rewritten, auto-sized tree
    entries = list(A.walk_subtrees(runner.plan))
    samples, whole_runs, real_once = {}, [], A._run_once

    def once(node, tables, device):
        t = real_once(node, tables, device)
        samples.setdefault(id(node), []).append(t)
        if sum(map(len, samples.values())) % len(entries) == 0:  # a round's end
            whole_runs.append(real_once(runner.plan, tables, device))
        return t

    A._run_once = once
    try:
        report = A.explain_analyze(runner.plan, gpu7, k1=2, k2=20)
    finally:
        A._run_once = real_once
    whole_runs = whole_runs[2:]
    whole = statistics.median(whole_runs) if len(whole_runs) == 20 else None
    selfs = [r["self_s"] for r in report]
    if any(v is None for v in selfs) or whole is None:
        raise AssertionError(f"q7_pairs: a subtree did not run alone: {report}")
    total = sum(selfs)
    print(f"explain analyze q7_pairs sf{SF} [{card}]:")
    print(A.format_analyze(report))
    print(f"  self times sum {total * 1e3:.3f} ms; one timed run of the tree "
          f"{whole * 1e3:.3f} ms ({total / whole:.1%})")
    # each round's self-time sum, from that round's subtree times
    rounds = None
    if all(len(samples.get(id(n), ())) == 22 for _, n in entries):
        t = {path: samples[id(n)][2:] for path, n in entries}
        kids = {path: [c for c, _ in entries if c.startswith(path + ".")
                       and c.count(".") == path.count(".") + 1] for path, _ in entries}
        rounds = [sum(max(t[p][r] - sum(t[c][r] for c in kids[p]), 0.0) for p in t)
                  for r in range(20)]

    def spread(xs):
        if xs is None:
            return None
        q = statistics.quantiles(xs, n=4)
        return {"min_ms": min(xs) * 1e3, "q1_ms": q[0] * 1e3,
                "median_ms": statistics.median(xs) * 1e3, "q3_ms": q[2] * 1e3,
                "max_ms": max(xs) * 1e3}

    out = {"self_sum_ms": total * 1e3, "run_ms": whole * 1e3,
           "self_sum_rounds": spread(rounds), "run_samples": spread(whole_runs)}
    for k, label in (("self_sum_rounds", "self-time sum per round"),
                     ("run_samples", "one run of the tree")):
        v = out[k]
        print(f"  {label} over 20: " + ("not measured (a node repeats in the tree)"
                                         if v is None else
                                         f"min {v['min_ms']:.3f}, quartiles {v['q1_ms']:.3f} / "
                                         f"{v['median_ms']:.3f} / {v['q3_ms']:.3f}, max "
                                         f"{v['max_ms']:.3f} ms"))
    if abs(total - whole) > 0.1 * whole:
        raise AssertionError(f"q7_pairs: self times sum {total} s, one run {whole} s")
    return out


# ---- the analytic slice: numpy versions and the card phase -------------------

ANALYTIC_FLOAT_REL = 1e-12   # float columns: card vs CPU run, and vs numpy
ANALYTIC_FLOATS = {"stats_grouped": ("var_price", "sd_price"),
                   "stats_stream": ("sum_price", "avg_price")}
KMV_REL = 0.05               # the KMV estimate vs the exact count (3 std errors)


def analytic_arrays(cat) -> dict:
    """Host numpy copies of the lineitem columns the analytic plans read,
    plus their dictionaries."""
    t = cat["lineitem"].block
    out = {n: t[n].data.numpy() for n in (
        "l_orderkey", "l_linenumber", "l_partkey", "l_suppkey", "l_quantity",
        "l_extendedprice", "l_discount", "l_tax", "l_shipdate", "l_shipmode",
        "l_returnflag", "l_linestatus")}
    for n in ("l_shipmode", "l_returnflag", "l_linestatus"):
        out[n + "_dict"] = t[n].dictionary
    out["rf_dict"], out["ls_dict"] = out["l_returnflag_dict"], out["l_linestatus_dict"]
    return out


def _group_starts(codes):
    """(order that sorts ``codes`` stably, start of each run in it, the
    run's code)."""
    import numpy as np

    order = np.argsort(codes, kind="stable")
    s = codes[order]
    starts = np.nonzero(np.r_[True, s[1:] != s[:-1]])[0]
    return order, starts, s[starts]


def numpy_rollup(a: dict) -> dict:
    """``rollup_report`` over host arrays: Q1's sums per ROLLUP level with
    int64 run sums (every total is below 2^63 at SF1), the level, each
    level's charge rank, in the plan's order."""
    import numpy as np

    live = a["l_shipdate"] <= _days(Q1_CUTOFF)
    keys = [a[k][live].astype(np.int64) for k in ("l_shipmode", "l_returnflag",
                                                  "l_linestatus")]
    dicts = [a[k + "_dict"] for k in ("l_shipmode", "l_returnflag", "l_linestatus")]
    qty, ext = a["l_quantity"][live], a["l_extendedprice"][live]
    disc, tax = a["l_discount"][live], a["l_tax"][live]
    disc_price = ext * (100 - disc)
    charge = disc_price * (100 + tax)
    vals = (qty, ext, disc_price, charge, disc)
    rows = []
    for n_keys in (3, 2, 1, 0):
        code = np.zeros(len(qty), dtype=np.int64)
        for k in keys[:n_keys]:
            code = code * 16 + k
        order, starts, _ = _group_starts(code)
        sums = [np.add.reduceat(v[order].astype(np.int64), starts) for v in vals]
        counts = np.diff(np.r_[starts, len(order)])
        level = 3 - n_keys
        groups = []
        for g, st in enumerate(starts):
            row0 = order[st]
            kv = [dicts[i][keys[i][row0]] if i < n_keys else None for i in range(3)]
            sq, se, sd, sc, sdisc = (int(s[g]) for s in sums)
            n = int(counts[g])
            groups.append(kv + [level, sq, se, sd, sc, _half_up_div(sq * 10 ** 4, n),
                                _half_up_div(se * 10 ** 4, n),
                                _half_up_div(sdisc * 10 ** 4, n), n])
        charges = sorted((g[7] for g in groups), reverse=True)
        for g in groups:
            g.append(1 + sum(c > g[7] for c in charges))
        rows += groups
    rows.sort(key=lambda r: (r[3], r[-1]) + tuple((v is not None, v or "") for v in r[:3]))
    names = ["l_shipmode", "l_returnflag", "l_linestatus", "level", "sum_qty",
             "sum_base_price", "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
             "avg_disc", "count_order", "charge_rank"]
    return {n: [r[i] for r in rows] for i, n in enumerate(names)}


def _run_bounds(part_starts_mask):
    """Per row of a sorted array: its run's first and last positions."""
    import numpy as np

    n = len(part_starts_mask)
    pos = np.arange(n)
    start = np.maximum.accumulate(np.where(part_starts_mask, pos, 0))
    ends = np.r_[np.nonzero(part_starts_mask)[0][1:] - 1, n - 1]
    end = ends[np.cumsum(part_starts_mask) - 1]
    return start, end


def numpy_window_report(a: dict, top: int = 3) -> dict:
    """``window_report`` over host arrays: ranks by sorting, running and
    moving values by cumulative sums and shifts inside each order, the
    7-day RANGE counts by binary search per ship mode."""
    import numpy as np

    ok, ln, sk = a["l_orderkey"], a["l_linenumber"], a["l_suppkey"]
    ext, qty, sd, sm = (a["l_extendedprice"], a["l_quantity"], a["l_shipdate"],
                        a["l_shipmode"])
    n = len(ok)
    pos = np.arange(n)
    # rank() over (partition by l_suppkey order by l_extendedprice desc)
    o = np.lexsort((-ext, sk))
    new_part = np.r_[True, sk[o][1:] != sk[o][:-1]]
    new_peer = new_part | np.r_[True, ext[o][1:] != ext[o][:-1]]
    rank = np.empty(n, dtype=np.int64)
    rank[o] = (np.maximum.accumulate(np.where(new_peer, pos, 0))
               - np.maximum.accumulate(np.where(new_part, pos, 0)) + 1)
    # per order by l_linenumber
    o = np.lexsort((ln, ok))
    start, end = _run_bounds(np.r_[True, ok[o][1:] != ok[o][:-1]])
    q, e, d = qty[o], ext[o], sd[o]
    cq = np.cumsum(q)
    run = np.empty(n, dtype=np.int64)
    run[o] = cq - np.where(start > 0, cq[start - 1], 0)
    prev = np.empty(n, dtype=np.int64)
    prev[o] = np.where(pos > start, d[pos - 1], -1)
    lo, hi = np.maximum(pos - 2, start), np.minimum(pos + 2, end)
    ce = np.cumsum(e)
    s = ce[hi] - np.where(lo > 0, ce[lo - 1], 0)
    cnt = hi - lo + 1
    num = s * 10 ** 4
    qd = num // cnt
    avg = qd + (2 * (num - qd * cnt) >= cnt)      # half up (all positive)
    mn = np.full(n, np.iinfo(np.int64).max)
    mx = np.full(n, np.iinfo(np.int64).min)
    for k in range(-2, 3):
        src = np.clip(pos + k, 0, n - 1)
        inside = (pos + k >= lo) & (pos + k <= hi)
        mn = np.where(inside, np.minimum(mn, e[src]), mn)
        mx = np.where(inside, np.maximum(mx, e[src]), mx)
    mov = {}
    for name, v in (("mov_avg", avg), ("mov_min", mn), ("mov_max", mx)):
        mov[name] = np.empty(n, dtype=np.int64)
        mov[name][o] = v
    # per l_shipmode by l_shipdate, RANGE 7 PRECEDING .. 7 FOLLOWING
    o = np.lexsort((sd, sm))
    key = sm[o].astype(np.int64) * 100_000 + sd[o]
    lo3 = np.searchsorted(key, key - 7, "left")
    hi3 = np.searchsorted(key, key + 7, "right")
    cq3 = np.r_[0, np.cumsum(qty[o])]
    ships, qsum = np.empty(n, dtype=np.int64), np.empty(n, dtype=np.int64)
    ships[o] = hi3 - lo3
    qsum[o] = cq3[hi3] - cq3[lo3]
    keep = np.nonzero(rank <= top)[0]
    keep = keep[np.lexsort((ln[keep], ok[keep], rank[keep], sk[keep]))]
    out = {"l_orderkey": ok[keep], "l_linenumber": ln[keep], "l_suppkey": sk[keep],
           "l_extendedprice": ext[keep], "l_quantity": qty[keep],
           "l_shipdate": sd[keep],
           "l_shipmode": [a["l_shipmode_dict"][c] for c in sm[keep]],
           "price_rank": rank[keep], "run_qty": run[keep],
           "prev_ship": [None if v < 0 else int(v) for v in prev[keep]],
           **{k: v[keep] for k, v in mov.items()},
           "ships_15d": ships[keep], "qty_15d": qsum[keep]}
    return {k: v if isinstance(v, list) else v.tolist() for k, v in out.items()}


def _rel_close(got, want) -> float:
    """The largest relative distance of two float lists (NULLs equal);
    inf when NULL-ness differs."""
    worst = 0.0
    for x, y in zip(got, want):
        if (x is None) != (y is None):
            return float("inf")
        if y is not None and x != y:
            worst = max(worst, abs(x - y) / abs(y))
    return worst if len(got) == len(want) else float("inf")


def numpy_stats_grouped(a: dict) -> dict:
    """``stats_grouped`` over host arrays: per (ship mode, return flag)
    the sample variance and population deviation of the price as a double
    (numpy's two-pass ``var``/``std``), an XOR of part keys, the median
    quantity (the element at floor(0.5 (n - 1)) of the sorted values),
    the sorted distinct line statuses joined by ';', distinct parts."""
    import numpy as np

    code = a["l_shipmode"].astype(np.int64) * 16 + a["l_returnflag"]
    order, starts, codes = _group_starts(code)
    bounds = np.r_[starts, len(order)]
    x = a["l_extendedprice"].astype(np.float64) / 100.0
    out = {k: [] for k in ("l_shipmode", "l_returnflag", "var_price", "sd_price",
                           "xor_part", "median_qty", "statuses", "parts")}
    for g, c in enumerate(codes):
        rows = order[bounds[g]:bounds[g + 1]]
        out["l_shipmode"].append(a["l_shipmode_dict"][c // 16])
        out["l_returnflag"].append(a["l_returnflag_dict"][c % 16])
        out["var_price"].append(float(np.var(x[rows], ddof=1)))
        out["sd_price"].append(float(np.std(x[rows])))
        out["xor_part"].append(int(np.bitwise_xor.reduce(a["l_partkey"][rows])))
        q = np.sort(a["l_quantity"][rows])
        out["median_qty"].append(int(q[int(np.floor(0.5 * (len(q) - 1)))]))
        st = sorted({a["l_linestatus_dict"][v] for v in np.unique(a["l_linestatus"][rows])})
        out["statuses"].append(";".join(st))
        out["parts"].append(int(len(np.unique(a["l_partkey"][rows]))))
    return out


def numpy_stats_first(a: dict) -> dict:
    """``stats_first`` over host arrays: per (ship mode, return flag) the
    earliest ship date (the first row in ship-date order), AND of part
    keys, OR of supplier keys, line count."""
    import numpy as np

    code = a["l_shipmode"].astype(np.int64) * 16 + a["l_returnflag"]
    order, starts, codes = _group_starts(code)
    bounds = np.r_[starts, len(order)]
    out = {k: [] for k in ("l_shipmode", "l_returnflag", "first_ship", "and_part",
                           "or_supp", "n_lines")}
    for g, c in enumerate(codes):
        rows = order[bounds[g]:bounds[g + 1]]
        out["l_shipmode"].append(a["l_shipmode_dict"][c // 16])
        out["l_returnflag"].append(a["l_returnflag_dict"][c % 16])
        out["first_ship"].append(int(a["l_shipdate"][rows].min()))
        out["and_part"].append(int(np.bitwise_and.reduce(a["l_partkey"][rows])))
        out["or_supp"].append(int(np.bitwise_or.reduce(a["l_suppkey"][rows])))
        out["n_lines"].append(len(rows))
    return out


def numpy_stats_stream(a: dict) -> dict:
    """``stats_stream`` over host arrays: per order the sum, average and
    count of the price as a double, in order-key order."""
    import numpy as np

    order, starts, keys = _group_starts(a["l_orderkey"])
    x = a["l_extendedprice"][order].astype(np.float64) / 100.0
    s = np.add.reduceat(x, starts)
    n = np.diff(np.r_[starts, len(order)])
    return {"l_orderkey": keys, "sum_price": s, "avg_price": s / n, "n_lines": n}


def numpy_not_in(a8: dict, with_null: bool) -> dict:
    """``not_in``: lines whose supplier is not in the subquery (count,
    total quantity); with a NULL in the subquery, none."""
    import numpy as np

    from tiflash_tpu_torch.bench.analytics import NOT_IN_MAX_SUPPKEY, NOT_IN_NULL_KEY

    sub = a8["s_suppkey"][a8["s_suppkey"] <= NOT_IN_MAX_SUPPKEY]
    if with_null and NOT_IN_NULL_KEY in sub:
        return {"n_lines": [0], "qty": [None]}
    keep = ~np.isin(a8["l_suppkey"], sub)
    return {"n_lines": [int(keep.sum())],
            "qty": [_pysum(a8["l_quantity"][keep]) if keep.any() else None]}


def _block_arrays(block) -> dict:
    """Live rows of a result block as host arrays (values, validity)."""
    sel = block.sel_mask().cpu()
    return {n: (c.data.cpu()[sel].numpy(),
                None if c.validity is None else c.validity.cpu()[sel].numpy())
            for n, c in zip(block.names, block.columns)}


def check_stream_numpy(block, want: dict) -> float:
    """``stats_stream``'s result against numpy: keys and counts exact, the
    float sums within ``ANALYTIC_FLOAT_REL``.  Returns the largest
    relative distance."""
    import numpy as np

    got = _block_arrays(block)
    order = np.argsort(got["l_orderkey"][0], kind="stable")
    if not (np.array_equal(got["l_orderkey"][0][order], want["l_orderkey"])
            and np.array_equal(got["n_lines"][0][order], want["n_lines"])):
        raise AssertionError("stats_stream: keys or counts != numpy")
    worst = 0.0
    for name in ("sum_price", "avg_price"):
        g, w = got[name][0][order], want[name]
        worst = max(worst, float(np.max(np.abs(g - w) / np.abs(w))))
    if worst > ANALYTIC_FLOAT_REL:
        raise AssertionError(f"stats_stream: {worst} relative from numpy")
    return worst


def block_summary(block) -> dict:
    """A result block as plain host data: names, column types and the live
    rows' (values, validity) arrays."""
    return {"names": tuple(block.names),
            "dtypes": [repr(c.dtype) for c in block.columns],
            "arrays": _block_arrays(block)}


def analytic_same(name: str, got, want: dict) -> float:
    """The card's result block of one analytic plan against the CPU run's
    ``block_summary``: the same names, types and live rows, exact but for
    the plan's float columns, which hold within ``ANALYTIC_FLOAT_REL``.
    Returns the largest relative distance of those (0.0 when bit-exact)."""
    import numpy as np

    if got.names != want["names"] or [repr(c.dtype) for c in got.columns] != \
            want["dtypes"]:
        raise AssertionError(f"{name}: schema differs between the card and the CPU")
    g, w = _block_arrays(got), want["arrays"]
    worst = 0.0
    for col in w:
        (gd, gv), (wd, wv) = g[col], w[col]
        if (gv is None) != (wv is None) or (gv is not None and not np.array_equal(gv, wv)):
            raise AssertionError(f"{name}.{col}: NULLs differ between card and CPU")
        valid = np.ones(len(wd), dtype=bool) if wv is None else wv
        if col in ANALYTIC_FLOATS.get(name, ()):
            diff = np.abs(gd[valid] - wd[valid]) / np.abs(wd[valid])
            worst = max(worst, float(diff.max()) if diff.size else 0.0)
        elif not np.array_equal(gd[valid], wd[valid]) or gd.shape != wd.shape:
            raise AssertionError(f"{name}.{col}: card != CPU run")
    if worst > ANALYTIC_FLOAT_REL:
        raise AssertionError(f"{name}: floats {worst} relative from the CPU run")
    return worst


def analytics_numpy_check(name: str, out, li: dict, a8: dict) -> str:
    """Hold one analytic plan's CPU result to its numpy version; returns
    what was checked."""
    if name == "stats_stream":
        worst = check_stream_numpy(out, numpy_stats_stream(li))
        return f"numpy (floats within {worst:.3g} relative)"
    if name == "stats_kmv":
        import numpy as np

        got = out.to_pylists()
        exact = len(np.unique(li["l_orderkey"]))
        est = got["approx_orders"][0]
        if got["n_lines"] != [len(li["l_orderkey"])] or abs(est - exact) > KMV_REL * exact:
            raise AssertionError(f"stats_kmv: estimate {est}, exact {exact}")
        return f"numpy (estimate {est} of {exact} distinct, {est / exact - 1:+.4%})"
    want = {"rollup_report": lambda: numpy_rollup(li),
            "window_report": lambda: numpy_window_report(li),
            "stats_grouped": lambda: numpy_stats_grouped(li),
            "stats_first": lambda: numpy_stats_first(li),
            "partitioned_q1": lambda: numpy_q1(li),
            "q13_right": lambda: numpy_q13(a8), "q13_full": lambda: numpy_q13(a8),
            "not_in": lambda: numpy_not_in(a8, False),
            "not_in_null": lambda: numpy_not_in(a8, True)}[name]()
    got = out.to_pylists()
    floats = ANALYTIC_FLOATS.get(name, ())
    if list(got) != list(want):
        raise AssertionError(f"{name}: columns {list(got)} != numpy's {list(want)}")
    worst = 0.0
    for col in want:
        if col in floats:
            worst = max(worst, _rel_close(got[col], want[col]))
        elif got[col] != want[col]:
            raise AssertionError(f"{name}.{col}: port CPU run != numpy\n"
                                 f"{got[col][:8]}\n{want[col][:8]}")
    if worst > ANALYTIC_FLOAT_REL:
        raise AssertionError(f"{name}: floats {worst} relative from numpy")
    return "numpy" + (f" (floats within {worst:.3g} relative)" if floats else "")


ANALYTIC_CPU_THREADS = 2   # the worker's torch threads, beside the main process


def analytics_cpu_runs(sf: float = SF) -> dict:
    """The analytic plans' CPU side, run in a worker process while the
    card phases run: the catalogs from the seed (the same tables the main
    process makes), each plan through ``serde.dumps``/``loads`` and
    ``run_query`` on the CPU with a spy on the direct_agg kernel's branch
    and the fused path, its result held to numpy.  Returns, per plan, the
    result's ``block_summary``, retries, predicted launches (branch calls,
    fused runs), what numpy checked, rows and seconds."""
    import torch

    from tiflash_tpu_torch.bench.analytics import ANALYTICS, lineitem_tables
    from tiflash_tpu_torch.ops import aggregate as TA
    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.plan import serde
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    torch.set_num_threads(ANALYTIC_CPU_THREADS)
    cat = generate_tpch(sf=sf, seed=SEED, tables=["lineitem"])
    cat8 = generate_tpch(sf=sf, seed=SEED)
    li, a8 = analytic_arrays(cat), tpch8_arrays(cat8)
    tables = {"lineitem": lineitem_tables(cat.blocks("cpu")), "eight": cat8.blocks("cpu")}
    out = {}
    for name, (fn, c) in ANALYTICS.items():
        t0 = time.perf_counter()
        calls = []
        real = TA._accumulate_direct_kernel
        TA._accumulate_direct_kernel = lambda *a: calls.append(1) or real(*a)
        f0 = SF_.FUSE_STATS["count"]
        try:
            res, summary = run_query(serde.loads(serde.dumps(fn())), tables[c])
        finally:
            TA._accumulate_direct_kernel = real
        out[name] = {"summary": block_summary(res), "retries": summary.retries,
                     "predicted": (len(calls), SF_.FUSE_STATS["count"] - f0),
                     "checked": analytics_numpy_check(name, res, li, a8),
                     "rows": summary.result_rows,
                     "seconds": time.perf_counter() - t0}
    return out


def start_analytics_cpu_runs():
    """A one-worker process pool (spawned: the worker touches no card)
    running ``analytics_cpu_runs``, then ``mesh_cpu_runs`` (one worker, so
    the card phases' host work shares the cores with one process only);
    returns (pool, pending analytics result, pending mesh result).  The
    caller terminates the pool."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    return pool, pool.apply_async(analytics_cpu_runs), pool.apply_async(mesh_cpu_runs)


def analytics_phase(card: str, cat, cat8, cpu: dict) -> dict:
    """The analytic plans of ``bench/analytics.py`` at SF1 on the card:
    each through ``serde.dumps``/``loads`` and ``run_query``, with the
    launch counts set to 0 before and read after, equal to its CPU run
    (``cpu``, from ``analytics_cpu_runs``; floats within
    ``ANALYTIC_FLOAT_REL``), with the CPU run's retries and the launches
    its dispatch predicts.  Prints each plan's ``run_query`` median of 10
    warm runs, device busy time, idle share, device events and kernels.
    Returns {name: direct_agg launches}."""
    import torch

    from tiflash_tpu_torch.bench.analytics import ANALYTICS, lineitem_tables
    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.plan import serde
    from tiflash_tpu_torch.runtime.executor import run_query

    for name, r in cpu.items():
        print(f"{name} sf{SF} cpu run (worker process): {r['rows']} rows, "
              f"{r['retries']} retries, equal to {r['checked']} ({r['seconds']:.1f} s)")
    plans = {name: serde.loads(serde.dumps(fn())) for name, (fn, _) in ANALYTICS.items()}
    gpu_tables = {"lineitem": lineitem_tables(cat.blocks("cuda")),
                  "eight": cat8.blocks("cuda")}
    torch.cuda.synchronize()
    launches = {}
    for name, (_, c) in ANALYTICS.items():
        SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
        f0 = SF_.FUSE_STATS["count"]
        out, summary = run_query(plans[name], gpu_tables[c])
        torch.cuda.synchronize()
        launches[name] = DA.LAUNCHES
        want_branch, want_fused = cpu[name]["predicted"]
        if ((DA.LAUNCHES > 0) != (want_branch > 0) or SA.LAUNCHES or ST.LAUNCHES
                or SF_.FUSE_STATS["count"] != f0 + want_fused):
            raise AssertionError(f"{name}: direct_agg {DA.LAUNCHES}, stream_tile "
                                 f"{ST.LAUNCHES}, planes {SA.LAUNCHES} launches; the CPU "
                                 f"dispatch predicts {cpu[name]['predicted']}")
        if summary.device != "cuda:0" or summary.retries != cpu[name]["retries"]:
            raise AssertionError(f"{name}: ran on {summary.device} with "
                                 f"{summary.retries} retries (CPU {cpu[name]['retries']})")
        worst = analytic_same(name, out, cpu[name]["summary"])
        exact = "bit-exact" if worst == 0.0 else f"floats within {worst:.3g} relative"
        tables, plan = gpu_tables[c], plans[name]
        q_ms = time_ms(lambda: run_query(plan, tables), WARM_RUNS)
        busy, events, by_name = device_profile(lambda: run_query(plan, tables))
        busy_txt = ("device busy not measured (the trace held no device time)"
                    if busy is None else f"device busy {busy:.4f} ms in {events} "
                    f"device events, idle share {1 - busy / q_ms:.1%}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"{name} sf{SF} on cuda: {summary.result_rows} rows, {summary.retries} "
              f"retries, {exact} vs port CPU run; kernels launched: direct_agg "
              f"{DA.LAUNCHES}, stream_tile {ST.LAUNCHES}, stream_agg {SA.LAUNCHES}; "
              f"run_query median {q_ms:.3f} ms over {WARM_RUNS} warm runs; {busy_txt}; "
              f"top device ops {[(k[:72], round(v, 4)) for k, v in top]} [{card}]")
    return launches


# ---- the product slice: vectors, the .tbl loader, the HTTP service -------------

VEC_ROWS = 1_000_000           # tools/vector_bench.py's shape
VEC_DIMS = 128
VEC_QUERIES = 64
VEC_K = 100
VEC_SEED = 11
VEC_DUP = 10                   # rows 1000.. copy row 123, query 0 is row 123
VEC_ULP_SLACK = 4              # the bound of tests/torch_vector_bounds.py
VEC_L1_QUERIES = 8             # l1's CPU run and whole-corpus numpy check
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
EPS32 = 2.0 ** -23


def vector_data():
    """The corpus (VEC_ROWS, VEC_DIMS) and the queries, float32 from
    VEC_SEED; row 123 repeats at rows 1000..1009 and is query 0, so every
    metric meets exact ties."""
    import numpy as np

    rng = np.random.default_rng(VEC_SEED)
    x = rng.standard_normal((VEC_ROWS, VEC_DIMS), dtype=np.float32)
    x[1000:1000 + VEC_DUP] = x[123]
    q = rng.standard_normal((VEC_QUERIES, VEC_DIMS), dtype=np.float32)
    q[0] = x[123]
    return x, q


def vector_truth(metric: str, x, q):
    """(q, n) float64 distances of float32 rows, and each one's bound:
    (d + VEC_ULP_SLACK) float32 ulps of the magnitude the sum is made of,
    through the square root for l2."""
    import numpy as np

    d = x.shape[1]
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    unit = (d + VEC_ULP_SLACK) * EPS32
    if metric == "l1":
        s = np.stack([np.abs(x64 - qi).sum(axis=1) for qi in q64])
        return s, unit * s
    nq, nx = np.linalg.norm(q64, axis=1), np.linalg.norm(x64, axis=1)
    dot = q64 @ x64.T
    if metric == "l2":
        s = np.maximum(nq[:, None] ** 2 - 2 * dot + nx[None, :] ** 2, 0)
        b = unit * (nq[:, None] + nx[None, :]) ** 2
        return np.sqrt(s), np.sqrt(s + b) - np.sqrt(np.maximum(s - b, 0))
    if metric == "cosine":
        return 1 - dot / np.maximum(nq[:, None] * nx[None, :], 1e-30), \
            np.full(dot.shape, unit * 3)
    return -dot, unit * (np.abs(q64) @ np.abs(x64).T)


def check_search(name: str, dist, idx, truth, bound, other=None) -> dict:
    """Distances within the bound of the float64 truth; no row missed by
    more than its bound; and against ``other`` (dist, idx) the same
    indices but where both rows' truths lie within their bounds."""
    import numpy as np

    dist, idx = dist.cpu().numpy().astype(np.float64), idx.cpu().numpy().astype(np.int64)
    worst, moved = 0.0, 0
    for qi in range(idx.shape[0]):
        t, b = truth[qi], bound[qi]
        err = np.abs(dist[qi] - t[idx[qi]])
        if np.any(err > b[idx[qi]]):
            raise AssertionError(f"{name}: query {qi} distance off by more than its bound")
        worst = max(worst, float((err / np.maximum(b[idx[qi]], 1e-300)).max()))
        if np.any(np.diff(dist[qi]) < 0):
            raise AssertionError(f"{name}: query {qi} not sorted best first")
        nearer = np.flatnonzero(t + b < t[idx[qi][-1]] - b[idx[qi][-1]])
        if len(np.setdiff1d(nearer, idx[qi])):
            raise AssertionError(f"{name}: query {qi} missed a nearer row")
        if other is not None:
            o_idx = other[1][qi]
            diff = idx[qi] != o_idx
            moved += int(diff.sum())
            gap = np.abs(t[idx[qi]] - t[o_idx])
            if np.any(gap[diff] > (b[idx[qi]] + b[o_idx])[diff]):
                raise AssertionError(f"{name}: query {qi} index differs beyond the bound")
    return {"worst_share_of_bound": worst, "indices_moved": moved}


def vector_phase(card: str) -> dict:
    """Batched exact search over a 1M x 128 float32 corpus on the card
    (``ops/vector.py``), every metric held to numpy float64 and to the
    port's CPU run; one ANN plan through ``run_query``; times."""
    import numpy as np
    import torch

    from tiflash_tpu_torch.core.block import Block, Column
    from tiflash_tpu_torch.core.dtypes import INT64, Vector
    from tiflash_tpu_torch.expr.nodes import call, col, lit
    from tiflash_tpu_torch.ops.sort import SortKey
    from tiflash_tpu_torch.ops.vector import batched_min_k, vector_search
    from tiflash_tpu_torch.plan import nodes as P
    from tiflash_tpu_torch.runtime.executor import run_query

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 products are on: the search must stay float32")
    t0 = time.perf_counter()
    x, q = vector_data()
    xc, qc = torch.from_numpy(x).cuda(), torch.from_numpy(q).cuda()
    card_col = Column(xc, None, Vector(VEC_DIMS))
    cpu_col = Column(torch.from_numpy(x), None, Vector(VEC_DIMS))
    torch.cuda.synchronize()
    print(f"vector corpus {VEC_ROWS} x {VEC_DIMS} float32 ({x.nbytes} B on the card), "
          f"{VEC_QUERIES} queries, k={VEC_K}: made in {time.perf_counter() - t0:.1f} s")
    out = {}
    for metric in ("l2", "cosine", "inner_product", "l1"):
        t0 = time.perf_counter()
        dist, idx = vector_search(card_col, qc, VEC_K, metric=metric)
        torch.cuda.synchronize()
        if dist.shape != (VEC_QUERIES, VEC_K) or idx.dtype != torch.int32 or not dist.is_cuda:
            raise AssertionError(f"{metric}: result {tuple(dist.shape)} {idx.dtype}")
        nq = VEC_L1_QUERIES if metric == "l1" else VEC_QUERIES
        truth, bound = vector_truth(metric, x, q[:nq])
        cpu = vector_search(cpu_col, torch.from_numpy(q[:nq]), VEC_K, metric=metric)
        vs_cpu = check_search(f"{metric} card vs cpu", dist[:nq], idx[:nq], truth, bound,
                              other=(None, cpu[1].numpy()))
        check_search(f"{metric} cpu", cpu[0], cpu[1], truth, bound)
        if metric == "l1":  # the other queries: their rows' distances
            rows = idx.cpu().numpy().astype(np.int64)
            t_l1 = np.abs(x[rows].astype(np.float64) - q[:, None, :]).sum(axis=-1)
            if np.any(np.abs(dist.cpu().numpy() - t_l1) > (VEC_DIMS + VEC_ULP_SLACK) * EPS32
                      * t_l1):
                raise AssertionError("l1: a distance off by more than its bound")
        first = idx[0, :1 + VEC_DUP].tolist()
        if metric != "inner_product" and first != [123] + list(range(1000, 1000 + VEC_DUP)):
            raise AssertionError(f"{metric}: the exact ties of query 0 came as {first}")
        out[metric] = vs_cpu
        print(f"vector {metric}: within (d+{VEC_ULP_SLACK}) float32 ulps of numpy float64 "
              f"and of the port's CPU run ({nq} queries, all rows): largest error "
              f"{vs_cpu['worst_share_of_bound']:.3f} of the bound, {vs_cpu['indices_moved']} "
              f"indices differ from the CPU run within it; query 0's ties in index order "
              f"({time.perf_counter() - t0:.1f} s)")
    del truth, bound

    # one ANN plan: TopN(d, k) <- Projection(d = vec_l2_distance(v, q0))
    table = {"vt": Block.from_dict({
        "id": Column(torch.arange(VEC_ROWS, dtype=torch.int64, device="cuda"), None, INT64),
        "v": card_col})}
    def ann_plan():
        return P.TopN([SortKey("d")], VEC_K, P.Projection(
            {"id": col("id"), "d": call("vec_l2_distance", col("v"), lit(q[0].tolist()))},
            P.TableScan("vt")))

    res, summary = run_query(ann_plan(), table)
    got = res.to_pylists()
    l2 = np.sqrt(((x.astype(np.float64) - q[0].astype(np.float64)) ** 2).sum(axis=1))
    unit = (VEC_DIMS + VEC_ULP_SLACK) * EPS32
    b = np.sqrt(l2 ** 2 * (1 + unit)) - np.sqrt(l2 ** 2 * (1 - unit))
    ids = np.asarray(got["id"])
    want = np.argsort(l2, kind="stable")[:VEC_K]
    if summary.device != "cuda:0" or len(ids) != VEC_K:
        raise AssertionError(f"ann plan: {len(ids)} rows on {summary.device}")
    if np.any(np.abs(np.asarray(got["d"]) - l2[ids]) > b[ids]) or np.any(
            np.abs(l2[ids] - l2[want]) > (b[ids] + b[want])):
        raise AssertionError("ann plan: rows differ from numpy beyond the bound")
    if ids[:1 + VEC_DUP].tolist() != [123] + list(range(1000, 1000 + VEC_DUP)):
        raise AssertionError(f"ann plan: ties {ids[:1 + VEC_DUP].tolist()}")
    plan = ann_plan()
    ann_ms = time_ms(lambda: run_query(plan, table), WARM_RUNS)
    print(f"vector ann plan on cuda: TopN(d, {VEC_K}) over {VEC_ROWS} rows, ids equal numpy's "
          f"but within the bound ({int((ids != want).sum())} differ), ties in index order; "
          f"run_query median {ann_ms:.3f} ms over {WARM_RUNS} warm runs [{card}]")

    # times: the whole search, the product alone, the selection alone
    score = torch.empty((VEC_QUERIES, VEC_ROWS), device="cuda")
    times = {m: time_ms(lambda m=m: vector_search(card_col, qc, VEC_K, metric=m), KERNEL_REPS)
             for m in ("l2", "cosine", "inner_product", "l1")}
    mm_ms = time_ms(lambda: torch.matmul(qc, xc.T, out=score), KERNEL_REPS)
    topk_ms = time_ms(lambda: batched_min_k(score, VEC_K), KERNEL_REPS)
    flops = 2.0 * VEC_QUERIES * VEC_ROWS * VEC_DIMS
    bytes_ms = (x.nbytes + q.nbytes + VEC_QUERIES * VEC_K * 8) / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bytes_ms, mm_ms)
    print(f"vector search l2 {times['l2']:.4f} ms, cosine {times['cosine']:.4f}, "
          f"inner_product {times['inner_product']:.4f}, l1 {times['l1']:.4f} (median of "
          f"{KERNEL_REPS}, CUDA events); the fp32 product alone {mm_ms:.4f} ms "
          f"({flops / mm_ms / 1e9:.1f} TFLOP/s of {FP32_OPS_PER_S / 1e12:.0f}; "
          f"{flops / FP32_OPS_PER_S * 1e3:.4f} ms at peak), the top-k alone {topk_ms:.4f} ms; "
          f"bound max(bytes {bytes_ms:.4f}, product {mm_ms:.4f}) = {bound_ms:.4f} ms, l2 at "
          f"{bound_ms / times['l2']:.1%} of it [{card}]")
    del score, table, xc, card_col
    torch.cuda.empty_cache()
    return {"ms": times, "matmul_ms": mm_ms, "topk_ms": topk_ms, "bound_ms": bound_ms,
            "ann_ms": ann_ms, "checks": out}


SHIP_INSTRUCT = ("COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN")


def loader_phase(card: str, cat, cpu_res: dict, np_res: dict) -> dict:
    """SF1 lineitem written as dbgen .tbl (set-up), parsed by the port's
    native loader, cached and reloaded; every column against the generated
    catalog's; Q1/Q6 on the loaded catalog on the card; the CLI's query
    command on the same directory."""
    import os
    from pathlib import Path

    import numpy as np
    import torch

    from tiflash_tpu_torch.bench.tpch_queries import q1_plan, q6_plan
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.plan import serde
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage import native_loader as NL
    from tiflash_tpu_torch.testing.tbl import fields_of, write_tbl

    root = Path(__file__).resolve().parent
    d = root / "tiflash_tpu_torch" / "build" / "tbl"
    d.mkdir(parents=True, exist_ok=True)
    path, cache = d / "lineitem.tbl", d / "lineitem.tbl.tfc"
    for p in (path, cache):
        if p.exists():
            p.unlink()
    n = cat["lineitem"].row_count
    instr = np.random.default_rng(SEED).integers(0, 4, n).astype(np.int32)
    schema = NL.TPCH_SCHEMAS["lineitem"]
    t0 = time.perf_counter()
    size = write_tbl(str(path), fields_of(cat["lineitem"].block.as_dict(), schema,
                                          {"l_shipinstruct": ("string", instr, SHIP_INSTRUCT)}))
    write_s = time.perf_counter() - t0
    NL.get_lib()
    print(f"lineitem sf{SF} as .tbl: {n} rows, {size} B written in {write_s:.1f} s (set-up); "
          f"g++ tiflash_tpu_torch/native/loader.cpp: {NL.BUILD_SECONDS:.2f} s -> "
          f"{NL.library_path().name}")
    t0 = time.perf_counter()
    parsed = NL.load_table(str(path), schema)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    NL.save_table(str(d / "saved.tfc"), parsed)  # the TFC1 write alone
    save_s = time.perf_counter() - t0
    (d / "saved.tfc").unlink()
    del parsed
    NL.load_table(str(path), schema, cache=str(cache))  # parse again, keep its cache
    os.rename(path, str(path) + ".away")  # the reload must come from the cache
    try:
        t0 = time.perf_counter()
        loaded = NL.load_tpch_dir(str(d), ["lineitem"])
        load_s = time.perf_counter() - t0
    finally:
        os.rename(str(path) + ".away", path)
    gen, got = cat["lineitem"].block.as_dict(), loaded["lineitem"].block.as_dict()
    for name, c in gen.items():
        if not torch.equal(got[name].data, c.data) or got[name].dictionary != c.dictionary:
            raise AssertionError(f"loader: column {name} differs from the generated one")
    if got["l_shipinstruct"].dictionary != SHIP_INSTRUCT or not np.array_equal(
            got["l_shipinstruct"].data.numpy(), instr):
        raise AssertionError("loader: l_shipinstruct differs from what was written")
    print(f"loader: {len(got)} columns equal the generated catalog's (data torch.equal, "
          f"dictionaries equal); parse {parse_s:.3f} s at the default thread count "
          f"({size / parse_s / 1e6:.1f} MB/s, {n / parse_s / 1e6:.2f} M rows/s), cache save "
          f"(save_table of the parsed columns) {save_s:.3f} s, cache load {load_s:.3f} s "
          f"({cache.stat().st_size} B) [{card}]")

    tables = loaded.blocks("cuda")
    torch.cuda.synchronize()
    ST.LAUNCHES = 0
    launches = {}
    for name, plan_fn in (("q1", q1_plan), ("q6", q6_plan)):
        l0 = ST.LAUNCHES
        out, summary = run_query(plan_fn(), tables)
        torch.cuda.synchronize()
        launches[name] = ST.LAUNCHES - l0
        res = block_result(out)
        if launches[name] != 1 or summary.device != "cuda:0":
            raise AssertionError(f"loaded {name}: {launches[name]} stream_tile launches "
                                 f"on {summary.device}")
        if res != cpu_res[name] or res[0] != np_res[name]:
            raise AssertionError(f"loaded {name}: rows differ from the generated catalog's")
    print(f"q1 and q6 on cuda over the loaded catalog: 1 stream_tile launch each, bit-exact "
          f"vs the generated catalog's runs and numpy")

    plan_file = d / "q1.json"
    plan_file.write_text(serde.dumps(q1_plan()))
    env = dict(os.environ, PYTHONPATH=str(root))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tiflash_tpu_torch.cli", "--tbl-dir", str(d),
                           "--tables", "lineitem", "query", str(plan_file)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli query failed ({proc.returncode}):\n{proc.stderr}")
    cols = run_query(q1_plan(), tables)[0].to_pylists()
    names = list(cols)
    want = ["\t".join(names)] + ["\t".join(str(cols[c][i]) for c in names)
                                 for i in range(len(cols[names[0]]))]
    if proc.stdout.splitlines() != want:
        raise AssertionError(f"cli query printed\n{proc.stdout}\nexpected\n" + "\n".join(want))
    print(f"cli: python -m tiflash_tpu_torch.cli --tbl-dir ... --tables lineitem query q1.json "
          f"printed run_query's {len(want) - 1} rows, {cli_s:.1f} s in its own process "
          f"(start, cache load, copy to the card, Q1)")
    for p in (path, cache, plan_file):
        p.unlink()
    del tables
    return {"parse_s": parse_s, "parse_mb_s": size / parse_s / 1e6, "save_s": save_s,
            "load_s": load_s, "cli_s": cli_s, "launches": launches}


def _http(url: str, path: str, obj=None):
    """(status, decoded JSON) of a GET, or a POST of ``obj``."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if obj is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_state(url: str, qid: int, states, timeout: float = 300.0) -> dict:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        _, res = _http(url, f"/result?id={qid}")
        if res["state"] in states:
            return res
        time.sleep(0.005)
    raise AssertionError(f"query {qid} never reached {states}: {res}")


SERVICE_REPS = 5


def service_phase(card: str, cat8) -> dict:
    """The HTTP query service over the SF1 eight-table catalog on the card:
    each answer equal to the plan's direct ``run_query`` on the card, with
    the kernels it launches; concurrency, async, cancel of an out-of-core
    query, a failpoint, a system table, /status; each request's HTTP wall
    beside the direct run's median."""
    import concurrent.futures as cf
    import tempfile
    import threading
    from pathlib import Path

    import torch

    from tiflash_tpu_torch.bench.tpch_queries import (
        q1_plan, q3_plan, q6_plan, q7_nation_pairs_plan, q10_plan)
    from tiflash_tpu_torch.mpp.service import QueryService, serve_background
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.plan import serde
    from tiflash_tpu_torch.runtime.executor import run_query

    plans = {"q1": q1_plan, "q7_pairs": q7_nation_pairs_plan, "q3": q3_plan,
             "q6": q6_plan, "q10": q10_plan}
    gpu8 = cat8.blocks("cuda")
    direct, direct_ms = {}, {}
    for name, plan_fn in plans.items():
        out, _ = run_query(plan_fn(), gpu8)
        # what the service sends: the rows through JSON
        direct[name] = json.loads(json.dumps(out.to_pylists(), default=str))
        plan = plan_fn()
        direct_ms[name] = time_ms(lambda: run_query(plan, gpu8)[0].to_pylists(), WARM_RUNS)
    svc = QueryService(cat8, device="cuda")
    httpd, port = serve_background(svc)
    url = f"http://127.0.0.1:{port}"
    try:
        # one request per plan, its launches read just around it
        want_launches = {"q1": (1, 0), "q7_pairs": (0, 1), "q3": (0, 0)}
        http_ms, thread_ms, launches = {}, {}, {}
        for name, (st_want, da_want) in want_launches.items():
            body = {"plan": serde.plan_to_json(plans[name]())}
            torch.cuda.synchronize()
            SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
            code, resp = _http(url, "/query", body)
            launches[name] = {"stream_tile": ST.LAUNCHES, "direct_agg": DA.LAUNCHES,
                              "planes": SA.LAUNCHES}
            if code != 200 or resp["columns"] != direct[name]:
                raise AssertionError(f"service {name}: {code}, rows differ from run_query's")
            if (ST.LAUNCHES, DA.LAUNCHES, SA.LAUNCHES) != (st_want, da_want, 0):
                raise AssertionError(f"service {name}: launches {launches[name]}")
            if resp["summary"]["backend"] != "cuda":
                raise AssertionError(f"service {name}: backend {resp['summary']['backend']}")
            walls = []
            for _ in range(SERVICE_REPS):
                t0 = time.perf_counter()
                code, again = _http(url, "/query", body)
                walls.append((time.perf_counter() - t0) * 1e3)
                if code != 200 or again["columns"] != direct[name]:
                    raise AssertionError(f"service {name}: a repeat differs")
            http_ms[name] = statistics.median(walls)
            # the same direct run in a fresh thread, as each request runs
            plan, threaded = plans[name](), []
            for _ in range(SERVICE_REPS):
                t0 = time.perf_counter()
                th = threading.Thread(target=lambda: run_query(plan, gpu8)[0].to_pylists())
                th.start()
                th.join()
                threaded.append((time.perf_counter() - t0) * 1e3)
            thread_ms[name] = statistics.median(threaded)
            print(f"service {name}: equal to run_query's rows, launches {launches[name]}; "
                  f"HTTP wall median {http_ms[name]:.3f} ms over {SERVICE_REPS}, direct "
                  f"run_query + to_pylists median {direct_ms[name]:.3f} ms (in a fresh thread "
                  f"{thread_ms[name]:.3f}), service overhead "
                  f"{http_ms[name] - direct_ms[name]:.3f} ms [{card}]")

        # four at once, each equal to its lone result
        names4 = ("q1", "q6", "q3", "q10")

        def one(name):
            t0 = time.perf_counter()
            code, resp = _http(url, "/query", {"plan": serde.plan_to_json(plans[name]())})
            return name, code, resp, (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(4) as ex:
            together = list(ex.map(one, names4))
        all_ms = (time.perf_counter() - t0) * 1e3
        for name, code, resp, _ in together:
            if code != 200 or resp["columns"] != direct[name]:
                raise AssertionError(f"service {name} concurrent: {code}, rows differ")
        print(f"service: {', '.join(names4)} at once, each equal to its lone result; "
              f"{all_ms:.1f} ms for all four ("
              + ", ".join(f"{n} {ms:.1f}" for n, _, _, ms in together) + f" ms) [{card}]")

        # async, polled through /result
        code, sub = _http(url, "/query", {"plan": serde.plan_to_json(q6_plan()), "async": True})
        res = _wait_state(url, sub["query_id"], ("FINISHED", "FAILED", "CANCELLED"))
        if code != 200 or res["state"] != "FINISHED" or res["columns"] != direct["q6"]:
            raise AssertionError(f"service async q6: {res.get('state')}")
        print("service: async q6 polled through /result, FINISHED, equal to run_query's rows")

        # cancel a running out-of-core request; its slot comes back
        build_dir = Path(__file__).resolve().parent / "tiflash_tpu_torch" / "build"
        with tempfile.TemporaryDirectory(dir=build_dir) as spill:
            code, sub = _http(url, "/query", {
                "plan": serde.plan_to_json(hc_plan()), "async": True,
                "settings": {"max_bytes_before_external_group_by": 1, "spill_dir": spill}})
            qid = sub["query_id"]
            _wait_state(url, qid, ("RUNNING",))
            t0 = time.perf_counter()
            code, res = _http(url, "/cancel", {"query_id": qid})
            res = _wait_state(url, qid, ("CANCELLED", "FINISHED", "FAILED"))
            cancel_ms = (time.perf_counter() - t0) * 1e3
            if code != 200 or res["state"] != "CANCELLED":
                raise AssertionError(f"service cancel: {code}, {res['state']}")
        slots = [svc._admission.acquire(blocking=False)
                 for _ in range(svc.settings.service_max_concurrency)]
        for got_slot in slots:
            if got_slot:
                svc._admission.release()
        if not all(slots):
            raise AssertionError("service cancel: an admission slot was not returned")
        code, resp = _http(url, "/query", {"plan": serde.plan_to_json(q6_plan())})
        if code != 200 or resp["columns"] != direct["q6"]:
            raise AssertionError("service: the request after the cancel failed")
        print(f"service: an out-of-core GROUP BY l_orderkey (external group-by threshold 1 "
              f"B, spill_dir) cancelled while RUNNING: CANCELLED {cancel_ms:.1f} ms after "
              f"/cancel; every admission slot free, the next request answered")

        # a failpoint gives 500 kind failpoint, then off
        fp = "exception_before_fragment_run"
        _http(url, "/failpoint", {"name": fp, "action": "enable"})
        try:
            code, resp = _http(url, "/query", {"plan": serde.plan_to_json(q1_plan())})
        finally:
            _http(url, "/failpoint", {"name": fp, "action": "disable"})
        if code != 500 or resp.get("kind") != "failpoint":
            raise AssertionError(f"service failpoint: {code} {resp}")
        code, resp = _http(url, "/query", {"plan": serde.plan_to_json(q1_plan())})
        if code != 200 or resp["columns"] != direct["q1"]:
            raise AssertionError("service: q1 after the failpoint")

        # a system table, built on the card
        code, resp = _http(url, "/query", {"plan": {
            "exec": "TableScan", "table": "system_tables", "columns": None}})
        want_tables = {n: t.row_count for n, t in cat8.tables.items()}
        if code != 200 or dict(zip(resp["columns"]["table"], resp["columns"]["rows"])) \
                != want_tables or resp["summary"]["backend"] != "cuda":
            raise AssertionError(f"service system_tables: {code} {resp}")
        code, st = _http(url, "/status")
        if code != 200 or st["backend"] != "cuda" or st["devices"] != 1 \
                or not st["memory"].get("bytes_in_use"):
            raise AssertionError(f"service status: {st}")
        print(f"service: failpoint 500 kind failpoint, then off; system_tables on the card "
              f"lists the {len(want_tables)} tables; /status backend cuda, devices 1, "
              f"{st['memory']['bytes_in_use']} B in use of {st['memory']['bytes_limit']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    return {"http_ms": http_ms, "direct_ms": direct_ms, "thread_ms": thread_ms,
            "launches": launches}


# ---- the distribution slice: TPC-H over eight shards of one card ----------------

MESH_SHARDS = 8
MESH_REPS = 5          # the wall median of each mesh query and its single-device run
SF10_MESH_REPS = 3
SKEW_HOT_FRAC = 0.6    # the share of lineitem rows given the hot l_orderkey


def approx_cd_plan():
    """``approx_count_distinct(l_orderkey)`` over lineitem (keyless: the
    distributed form sends each shard's KMV candidates)."""
    from tiflash_tpu_torch.ops.aggregate import AggDesc
    from tiflash_tpu_torch.plan import nodes as P

    return P.Aggregation([], [AggDesc("approx_count_distinct", "l_orderkey", "ndv")],
                         P.TableScan("lineitem", columns=["l_orderkey"]))


def ship_mode_lanes_plan():
    """Per ship mode (7 values, fewer than the shards) by ship date: rank,
    a running sum of quantity and the previous line's price; the planner
    splits each mode into order-key lanes (a ``LanedWindow``)."""
    from tiflash_tpu_torch.ops.sort import SortKey
    from tiflash_tpu_torch.ops.window import WindowDesc
    from tiflash_tpu_torch.plan import nodes as P

    return P.Window(["l_shipmode"], [SortKey("l_shipdate")], [
        WindowDesc("rank", "r"), WindowDesc("sum", "run_qty", arg="l_quantity"),
        WindowDesc("lag", "prev_price", arg="l_extendedprice")],
        P.TableScan("lineitem", columns=["l_shipmode", "l_shipdate", "l_quantity",
                                         "l_extendedprice", "l_orderkey",
                                         "l_linenumber"]))


def mesh_plans() -> list:
    """(name, plan function, catalog) of the mesh phase at SF1: "eight" is
    the eight-table catalog, "lineitem" the lineitem catalog with its
    ship-year partitions (``bench/analytics.lineitem_tables``)."""
    from tiflash_tpu_torch.bench import analytics as A
    from tiflash_tpu_torch.bench import tpch_queries as Q

    return [("q1", Q.q1_plan, "eight"), ("q6", Q.q6_plan, "eight"),
            ("q3", Q.q3_plan, "eight"), ("q7_pairs", Q.q7_nation_pairs_plan, "eight"),
            ("q9", Q.q9_plan, "eight"), ("q13", Q.q13_plan, "eight"),
            ("q13_right", lambda: A.q13_outer_plan("right_outer"), "eight"),
            ("q18_300", lambda: Q.q18_plan(min_qty=Q18_MIN_QTY), "eight"),
            ("topn", lambda: Q.sort_topn_plan(TOPN_LIMIT), "eight"),
            ("approx_cd", approx_cd_plan, "eight"),
            ("window_report", A.window_report_plan, "lineitem"),
            ("ship_mode_lanes", ship_mode_lanes_plan, "lineitem")]


def mesh_distribute(plan_fn, tables):
    """``distribute_plan`` for ``MESH_SHARDS`` shards, with the tables
    for its sampled estimates and the laned-window planner."""
    from tiflash_tpu_torch.plan.auto import distribute_plan
    from tiflash_tpu_torch.plan.distribute import _rf_counter

    _rf_counter[0] = 0
    stats = {n: b.capacity for n, b in tables.items()}
    return distribute_plan(plan_fn(), stats, MESH_SHARDS, tables=tables)


def result_digest(block) -> tuple:
    """(names, dictionaries, row count, SHA-256 of the live rows in a
    canonical order): each column as int64 words (a double's bits; a
    decimal as int64 where every valid value fits, else two limbs; NULL
    values zeroed, the validity beside), the rows sorted lexicographically
    on the block's own device.  Equal digests mean the same multiset of
    values, bit for bit.  Types are left out: a distributed sum of
    partial sums widens a decimal's type, as the reference's does."""
    import hashlib

    import torch

    from tiflash_tpu_torch.core.wide import narrow_i64, resize_wide

    b = block.compact()
    n = int(b.num_rows())
    words = []
    for c in b.columns:
        d = c.data[:n]
        if d.dim() == 2 and d.dtype == torch.int64 and c.dtype.is_decimal:
            two, ov = resize_wide(d, 2)
            val, fits = narrow_i64(two)
            ok = (fits & ~ov) | ~c.valid_mask()[:n]
            d = val if bool(ok.all()) else two
        if d.dtype == torch.float64:
            d = d.view(torch.int64)
        elif d.dtype == torch.float32:
            d = d.view(torch.int32)
        d = d.to(torch.int64).reshape(n, -1)
        v = c.valid_mask()[:n]
        words.append(torch.where(v[:, None], d, torch.zeros_like(d)))
        words.append(v.to(torch.int64)[:, None])
    mat = torch.cat(words, 1) if words else torch.zeros((n, 0), dtype=torch.int64)
    for i in reversed(range(mat.shape[1])):
        mat = mat[torch.argsort(mat[:, i], stable=True)]
    digest = hashlib.sha256(mat.cpu().numpy().tobytes()).hexdigest()
    return (list(b.names),
            [None if c.dictionary is None else hashlib.sha256(
                "\x00".join(c.dictionary).encode()).hexdigest() for c in b.columns],
            n, digest)


def mesh_cpu_runs(sf: float = SF) -> dict:
    """The mesh phase's CPU side, run in a worker process while the card
    phases run: the SF1 catalogs from the seed; per mesh plan the
    logical plan handed to a ``QueryRunner`` over ``Mesh([cpu] * 8)``
    (the card's route, in the card's wire mode) with a spy on the
    direct_agg kernel's branch, on its ``group_sums`` calls and on the
    fused path.  Returns per plan the result's digest
    (``result_digest``), retries and the predicted (branch calls, fused
    runs, direct_agg launches: one per column group of each call with
    rows, as ``launch_plan`` splits it)."""
    import torch

    from tiflash_tpu_torch.bench.analytics import lineitem_tables
    from tiflash_tpu_torch.mpp.mesh import cpu_mesh
    from tiflash_tpu_torch.mpp.runner import ExchangeConfig
    from tiflash_tpu_torch.ops import aggregate as TA
    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA
    from tiflash_tpu_torch.runtime.executor import QueryRunner
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    torch.set_num_threads(ANALYTIC_CPU_THREADS)
    cat = generate_tpch(sf=sf, seed=SEED, tables=["lineitem"])
    cat8 = generate_tpch(sf=sf, seed=SEED)
    tables = {"lineitem": lineitem_tables(cat.blocks("cpu")), "eight": cat8.blocks("cpu")}
    mesh = cpu_mesh(MESH_SHARDS)
    out = {}
    for name, plan_fn, c in mesh_plans():
        t0 = time.perf_counter()
        calls, launches = [], []
        real, real_sums = TA._accumulate_direct_kernel, DA.group_sums

        def sums_spy(slots, vals, n_slots, acc):
            k = len(DA._value_list(vals))
            launches.append(len(DA.launch_plan(n_slots, k + 1)) if slots.shape[0] else 0)
            return real_sums(slots, vals, n_slots, acc)

        TA._accumulate_direct_kernel = lambda *a: calls.append(1) or real(*a)
        DA.group_sums = sums_spy
        f0 = SF_.FUSE_STATS["count"]
        try:
            # the card's wire mode, so retries and launches match it
            runner = QueryRunner(plan_fn(), mesh=mesh, cfg=ExchangeConfig(mode="ragged"))
            res, summary = runner.run(tables[c])
        finally:
            TA._accumulate_direct_kernel, DA.group_sums = real, real_sums
        out[name] = {"rows": result_digest(res), "retries": summary.retries,
                     "predicted": (len(calls), SF_.FUSE_STATS["count"] - f0, sum(launches)),
                     "seconds": time.perf_counter() - t0}
    return out


def shards_on_card(shards) -> bool:
    """Every tensor of every shard lies on the card."""
    return all(c.data.is_cuda and (c.validity is None or c.validity.is_cuda)
               and (b.sel is None or b.sel.is_cuda) for b in shards for c in b.columns)


# the exchanges' byte counters (``runtime/metrics.py``), by kind
EXCHANGE_COUNTERS = {"hash": "exchange_hash_bytes_total",
                     "gather": "exchange_gather_bytes_total"}


def exchange_bytes(before: dict) -> dict:
    """Bytes the exchanges moved since ``before`` (a ``METRICS.dump()``),
    by kind."""
    from tiflash_tpu_torch.runtime.metrics import METRICS

    now = METRICS.dump()
    return {k: int(now[c] - before[c]) for k, c in EXCHANGE_COUNTERS.items()
            if now[c] != before[c]}


def mesh_runner(plan, mesh, mode: str = "auto"):
    """A ``QueryRunner`` over ``mesh`` with the hash exchanges in wire mode
    ``mode`` (``auto``: the settings' default, ragged on the card)."""
    from tiflash_tpu_torch.mpp.runner import ExchangeConfig
    from tiflash_tpu_torch.runtime.executor import QueryRunner

    return QueryRunner(plan, mesh=mesh,
                       cfg=None if mode == "auto" else ExchangeConfig(mode=mode))


def mesh_run(plan, tables, mesh, mode: str = "auto"):
    """One distributed run on the card (a logical plan is distributed by
    the runner), its exchanges' bytes counted and the sharded inputs and
    outputs held on the card: (result, summary, exchange bytes)."""
    import torch

    from tiflash_tpu_torch.mpp import runner as R
    from tiflash_tpu_torch.runtime.metrics import METRICS

    before = METRICS.dump()
    seen = []
    real = R.collect_result

    def spy(out):
        seen.append(shards_on_card(out))
        return real(out)

    R.collect_result = spy
    try:
        runner = mesh_runner(plan, mesh, mode)
        out, summary = runner.run(tables)
    finally:
        R.collect_result = real
    torch.cuda.synchronize()
    if not seen or not all(seen) or not all(shards_on_card(s)
                                            for s in runner._sharded.values()):
        raise AssertionError("a shard tensor left the card")
    return out, summary, exchange_bytes(before)


def mesh_timing(dist_fn, single_fn, reps: int) -> dict:
    """Wall medians of the distributed and single-device runs, the
    distributed run's profiler busy time and idle share."""
    dist_ms = time_ms(dist_fn, reps)
    single_ms = time_ms(single_fn, reps)
    busy = device_busy_ms(dist_fn)
    idle = None if busy is None else max(0.0, 1.0 - busy / dist_ms)
    return {"mesh_ms": dist_ms, "single_ms": single_ms, "busy_ms": busy,
            "idle_share": idle}


def skew_tables(cat8, device: str):
    """SF1 lineitem (l_orderkey, l_extendedprice) with ``SKEW_HOT_FRAC``
    of its rows given one hot l_orderkey (the first order's), rows drawn
    from the seed, and orders (o_orderkey, o_custkey): the distribution
    of ``__graft_entry__.py:dryrun_multichip``'s skew join at full SF1."""
    import numpy as np
    import torch

    from tiflash_tpu_torch.core.block import Block

    li = cat8["lineitem"].block
    od = cat8["orders"].block
    n = li.capacity
    rng = np.random.default_rng(SEED + 7)
    hot = rng.random(n) < SKEW_HOT_FRAC
    keys = li["l_orderkey"].data.clone()
    hot_key = int(od["o_orderkey"].data[0])
    keys[torch.from_numpy(hot)] = hot_key
    lcols = {"l_orderkey": li["l_orderkey"].with_data(keys),
             "l_extendedprice": li["l_extendedprice"]}
    tables = {"l": Block.from_dict(lcols),
              "o": Block.from_dict({k: od[k] for k in ("o_orderkey", "o_custkey")})}
    return {k: Block.from_dict({c: b[c].with_data(b[c].data.to(device))
                                for c in b.names}) for k, b in tables.items()}, hot_key


def skew_join_phase(card: str, cat8, mesh) -> dict:
    """BASELINE config 4 at SF1 on one card: lineitem ⋈ orders with 60% of
    the probe rows on one key, through ``SkewShuffleJoin`` and through the
    plain ``shuffle_join`` over 8 shards (capacity retries as the runner
    grows them), and on one device.  Prints each's per-shard joined rows
    and max share; the rows must be bit-exact between all three."""
    import torch

    from tiflash_tpu_torch.mpp.runner import (ExchangeConfig, collect_result,
                                              compile_distributed, shard_catalog_blocks)
    from tiflash_tpu_torch.plan import nodes as P
    from tiflash_tpu_torch.plan.distribute import shuffle_join
    from tiflash_tpu_torch.runtime.executor import _grow, read_flags, run_query

    tables, hot_key = skew_tables(cat8, mesh.devices[0])
    n = tables["l"].capacity
    sharded = shard_catalog_blocks(tables, mesh)
    if not all(shards_on_card(s) for s in sharded.values()):
        raise AssertionError("skew join: a shard left the card")

    def skew():
        return P.SkewShuffleJoin(kind="inner", probe_keys=["l_orderkey"],
                                 build_keys=["o_orderkey"], probe=P.TableScan("l"),
                                 build=P.TableScan("o"))

    def plain():
        return shuffle_join("inner", ["l_orderkey"], ["o_orderkey"], P.TableScan("l"),
                            P.TableScan("o"))

    def run(plan, cfg):
        for _ in range(8):
            out, flags = compile_distributed(plan, mesh, cfg)(sharded)
            flagged = {k: v for k, v in read_flags(flags).items() if v > 0}
            if not flagged:
                return out
            _grow(plan, flagged, cfg)
        raise AssertionError(f"skew join: overflow persisted {flagged}")

    single, _ = run_query(P.Join(kind="inner", probe_keys=["l_orderkey"],
                                 build_keys=["o_orderkey"], probe=P.TableScan("l"),
                                 build=P.TableScan("o")), tables)
    res = {}
    for name, mk in (("skew", skew), ("plain", plain)):
        plan, cfg = mk(), ExchangeConfig()
        out = run(plan, cfg)
        torch.cuda.synchronize()
        if not shards_on_card(out):
            raise AssertionError(f"skew join {name}: a shard left the card")
        per = [int(b.num_rows()) for b in out]
        got = collect_result(out)
        if not _same_keyed(got, single):
            raise AssertionError(f"skew join {name}: rows != single-device join")
        plan2, cfg2 = mk(), cfg
        ms = time_ms(lambda: compile_distributed(plan2, mesh, cfg2)(sharded), MESH_REPS)
        res[name] = {"per_shard": per, "max_share": max(per) / max(sum(per), 1),
                     "ms": ms, "grown": dict(cfg.capacities)}
        print(f"skew join sf{SF} {name}: per-shard joined rows {per} (max share "
              f"{res[name]['max_share']:.3f}), {sum(per)} rows of {n} probe rows "
              f"({SKEW_HOT_FRAC:.0%} on l_orderkey {hot_key}), median {ms:.3f} ms, "
              f"bit-exact vs the single-device join [{card}]")
    single_ms = time_ms(lambda: run_query(P.Join(
        kind="inner", probe_keys=["l_orderkey"], build_keys=["o_orderkey"],
        probe=P.TableScan("l"), build=P.TableScan("o")), tables), MESH_REPS)
    res["single_ms"] = single_ms
    print(f"skew join sf{SF} single device: median {single_ms:.3f} ms [{card}]")
    return res


def _same_keyed(a, b) -> bool:
    """Two results of the skew join hold the same multiset of rows
    (compared on the card: the four columns sorted lexicographically)."""
    import torch

    def canon(x):
        x = x.compact()
        n = int(x.num_rows())
        cols = [x[c].data[:n].to(torch.int64) for c in
                ("l_orderkey", "l_extendedprice", "o_orderkey", "o_custkey")]
        mix = torch.stack(cols, 1)
        for i in reversed(range(mix.shape[1])):
            mix = mix[torch.argsort(mix[:, i], stable=True)]
        return mix

    return torch.equal(canon(a), canon(b))


def mesh_direct_agg_check(DA, captured) -> int:
    """Every captured ``group_sums`` call of a mesh run: kernel == plain
    (``torch.equal``) on the call's own inputs; returns the max abs
    error (0, or it raises)."""
    import torch

    worst = 0
    for slots, vals, n_slots, acc in captured:
        k = DA.group_sums(slots, vals, n_slots, torch.zeros_like(acc))
        p = DA.group_sums_plain(slots, vals, n_slots, torch.zeros_like(acc))
        torch.cuda.synchronize()
        err = int((k - p).abs().max()) if k.numel() else 0
        worst = max(worst, err)
        if not torch.equal(k, p):
            raise AssertionError(f"mesh direct_agg: kernel != plain at a captured call "
                                 f"({slots.shape[0]} rows, S={n_slots}, max abs err {err})")
    return worst


def mesh_phase(card: str, cat, cat8, cpu: dict) -> dict:
    """The distribution slice on the card: ``Mesh([cuda:0] * 8)``.  Each
    plan of ``mesh_plans``: ``mesh_distribute`` must give the same tree
    from the card's tables as from the same catalog's CPU tables (one
    process: a pushed projection orders its columns by set iteration, as
    the reference's does, so the tree's text follows the process's string
    hashing); the logical plan is handed to ``run_query``'s runner
    with the mesh (which distributes it), and the result held bit-exact
    against the port's single-device run on the card and the CPU worker's
    mesh run; Q1, Q3 and Q7-pairs also against numpy.  The direct_agg
    branch calls and launches must be exactly the CPU spy's, every
    ``group_sums`` call of the run kernel == plain on its own inputs (and
    Q7-pairs' timed at them); no stream_agg or fused kernel runs under a
    mesh.  Prints each plan's wall median beside the single-device one,
    the profiler's busy time and idle share, the exchanges' bytes and the
    allocator peak; then the skewed join and the single-process NCCL run.
    Returns the launches and the Q7-pairs yardsticks."""
    import torch

    from tiflash_tpu_torch.bench.analytics import lineitem_tables
    from tiflash_tpu_torch.mpp.mesh import Mesh
    from tiflash_tpu_torch.ops import aggregate as TA
    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.plan import serde
    from tiflash_tpu_torch.runtime.executor import run_query

    t_phase = time.perf_counter()
    mesh = Mesh([torch.device("cuda:0")] * MESH_SHARDS)
    tables = {"lineitem": lineitem_tables(cat.blocks("cuda")), "eight": cat8.blocks("cuda")}
    host = {"lineitem": lineitem_tables(cat.blocks("cpu")), "eight": cat8.blocks("cpu")}
    numpy_want = {"q1": numpy_q1(lineitem_arrays(cat8)),
                  "q3": numpy_q3(tpch3_arrays(cat8)),
                  "q7_pairs": numpy_q7_pairs(q7_arrays(cat8))}
    flush = L2Flush()
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    sa_launches = st_launches = fused_runs = 0
    out_info, direct_err, q7y = {}, 0, None
    for name, plan_fn, c in mesh_plans():
        own = mesh_distribute(plan_fn, tables[c])
        on_host = mesh_distribute(plan_fn, host[c])
        if serde.dumps(own) != serde.dumps(on_host):
            import difflib

            raise AssertionError(
                f"mesh {name}: distribute_plan on the card gives another tree than on "
                "the CPU:\n" + "\n".join(difflib.unified_diff(
                    on_host.pretty().splitlines(), own.pretty().splitlines(), "cpu",
                    "cuda", lineterm="", n=1)))
        calls = []
        real = TA._accumulate_direct_kernel
        TA._accumulate_direct_kernel = lambda *a: calls.append(1) or real(*a)
        d0, s0, t0, f0 = DA.LAUNCHES, SA.LAUNCHES, ST.LAUNCHES, SF_.FUSE_STATS["count"]
        got_run = []
        try:
            captured = capture_calls(DA, "group_sums", lambda: got_run.append(
                mesh_run(plan_fn(), tables[c], mesh)))
        finally:
            TA._accumulate_direct_kernel = real
        out, summary, xbytes = got_run[0]
        launches = DA.LAUNCHES - d0
        sa_launches += SA.LAUNCHES - s0
        st_launches += ST.LAUNCHES - t0
        fused_runs += SF_.FUSE_STATS["count"] - f0
        if summary.num_devices != MESH_SHARDS or summary.device != "cuda:0":
            raise AssertionError(f"mesh {name}: {summary.num_devices} shards on "
                                 f"{summary.device}")
        if (len(calls), 0, launches) != tuple(cpu[name]["predicted"]):
            raise AssertionError(f"mesh {name}: {len(calls)} direct_agg branch calls, "
                                 f"{launches} launches; the CPU spy predicts (branch "
                                 f"calls, fused runs, launches) {cpu[name]['predicted']}")
        if summary.retries != cpu[name]["retries"]:
            raise AssertionError(f"mesh {name}: {summary.retries} retries, CPU "
                                 f"{cpu[name]['retries']}")
        single, _ = run_query(plan_fn(), tables[c])
        got = result_digest(out)
        if got != result_digest(single):
            raise AssertionError(f"mesh {name}: rows != the single-device run")
        if list(got) != list(cpu[name]["rows"]):
            raise AssertionError(f"mesh {name}: rows != the CPU mesh run")
        checked = ["single-device", "cpu mesh"]
        if name in numpy_want:
            if block_result(out)[0] != numpy_want[name]:
                raise AssertionError(f"mesh {name}: rows != numpy")
            checked.append("numpy")
        # the comparison's launches come after the count was read
        err = mesh_direct_agg_check(DA, captured)
        direct_err = max(direct_err, err)
        if name == "q7_pairs":
            q7y = dict(direct_agg_yardsticks(DA, captured, flush), max_abs_err=err,
                       launches=launches)
            print("  " + yardstick_line("mesh q7_pairs direct_agg (per-shard calls)",
                                        q7y, card))
        del captured
        laned = "LanedWindow" in summary.plan_text
        note = "; ".join(sorted({ln.split("[laned window declined: ")[1].rstrip("]")
                                 for ln in own.pretty().splitlines()
                                 if "laned window declined" in ln}))
        tm = mesh_timing(lambda: run_query(plan_fn(), tables[c], mesh=mesh),
                         lambda: run_query(plan_fn(), tables[c]), MESH_REPS)
        out_info[name] = dict(tm, rows=summary.result_rows, direct_agg_launches=launches,
                              branch_calls=len(calls), exchange_bytes=xbytes,
                              peak_bytes=summary.peak_device_bytes, laned=laned)
        print(f"mesh {name} sf{SF} x{MESH_SHARDS} shards (logical plan through run_query): "
              f"{summary.result_rows} rows bit-exact vs {', '.join(checked)}; card's "
              f"distribute_plan == CPU's; direct_agg launches {launches} (CPU spy "
              f"{cpu[name]['predicted'][2]} launches in {len(calls)} branch calls; "
              f"kernel == plain at each of {len(calls)} calls); median "
              f"{tm['mesh_ms']:.3f} ms vs single-device {tm['single_ms']:.3f} ms; busy "
              + (f"{tm['busy_ms']:.3f} ms, idle share {tm['idle_share']:.3f}"
                 if tm["busy_ms"] is not None else "not measured")
              + f"; exchanges {xbytes} bytes; peak {summary.peak_device_bytes} bytes"
              + (" [LanedWindow]" if laned else "")
              + (f" [laned declined: {note}]" if note else "") + f" [{card}]")
    if sa_launches or st_launches or fused_runs:
        raise AssertionError(f"under the mesh: stream_agg {sa_launches}, stream_tile "
                             f"{st_launches} launches, {fused_runs} fused runs")
    if not out_info["ship_mode_lanes"]["laned"]:
        raise AssertionError("ship_mode_lanes did not plan a LanedWindow")
    if out_info["q7_pairs"]["direct_agg_launches"] < 1 or q7y is None:
        raise AssertionError("q7_pairs: no direct_agg launch under the mesh")
    mesh_launches = sum(v["direct_agg_launches"] for v in out_info.values())
    skew = skew_join_phase(card, cat8, mesh)
    mh = multihost_phase(card, cat8)
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"queries": out_info, "direct_agg_launches": mesh_launches,
            "stream_agg_launches": sa_launches, "stream_tile_launches": st_launches,
            "fused_runs": fused_runs, "direct_agg_max_abs_err": direct_err,
            "q7_pairs": q7y, "skew": skew, "multihost": mh}


def multihost_phase(card: str, cat8) -> dict:
    """Q3 through ``mpp/multihost.py`` in one process: NCCL, world size 1,
    eight local shards on the card; bit-exact against the single-device
    run."""
    import socket

    import torch
    import torch.distributed as dist

    from tiflash_tpu_torch.bench.tpch_queries import q3_plan
    from tiflash_tpu_torch.mpp.multihost import (global_mesh, init_multihost,
                                                 replicate_result, shard_local_blocks)
    from tiflash_tpu_torch.mpp.runner import collect_result, compile_distributed
    from tiflash_tpu_torch.runtime.executor import run_query

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", num_processes=1, process_id=0, backend="nccl")
    try:
        mesh = global_mesh(local_shards=MESH_SHARDS)
        tables = {t: cat8.blocks("cuda")[t] for t in Q3_TABLES}
        plan = mesh_distribute(q3_plan, tables)
        sharded = shard_local_blocks(tables, mesh)
        out, flags = compile_distributed(plan, mesh)(sharded)
        if any(int(v) for v in flags.values()):
            raise AssertionError(f"multihost q3: overflow {flags}")
        if not shards_on_card(out):
            raise AssertionError("multihost q3: a shard left the card")
        got = collect_result(replicate_result(out, mesh))
        single, _ = run_query(q3_plan(), tables)
        if block_result(got)[0] != block_result(single)[0]:
            raise AssertionError("multihost q3: rows != the single-device run")
        ms = time_ms(lambda: compile_distributed(plan, mesh)(sharded), MESH_REPS)
        print(f"multihost q3 sf{SF}: NCCL ({dist.get_backend()}), world size "
              f"{dist.get_world_size()}, {mesh.local_size} local shards: "
              f"{int(got.num_rows())} rows bit-exact vs the single-device run; median "
              f"{ms:.3f} ms [{card}]")
        torch.cuda.synchronize()
        return {"ms": ms, "backend": dist.get_backend(), "shards": mesh.size}
    finally:
        dist.destroy_process_group()


def mesh_sf10_phase(card: str, cat10) -> dict:
    """SF10 (the shared SF10 catalog) over eight shards of the card, in
    memory: Q3 and the high-cardinality GROUP BY l_orderkey (``hc_plan``),
    each bit-exact against its single-device run; both wall medians; the
    hash exchange's padded and ragged modes timed on the GROUP BY."""
    import torch

    from tiflash_tpu_torch.bench.tpch_queries import q3_plan
    from tiflash_tpu_torch.mpp.mesh import Mesh
    from tiflash_tpu_torch.runtime.executor import run_query

    t_phase = time.perf_counter()
    mesh = Mesh([torch.device("cuda:0")] * MESH_SHARDS)
    tables = cat10.blocks("cuda")
    res = {}
    # the padded mode's buffers are P x the ragged mode's rows (P * C per
    # shard, C sized from the partial aggregate's slot capacity): Q3's
    # exceeds the card at SF10, so it runs ragged only
    for name, plan_fn, key, modes in (("q3", q3_plan, None, ("ragged",)),
                                      ("hc", hc_plan, "l_orderkey", ("ragged", "padded"))):
        dist = mesh_distribute(plan_fn, tables)
        single, ssum = run_query(plan_fn(), tables)
        by_mode = {}
        for mode in modes:
            out, summary, xbytes = mesh_run(dist, tables, mesh, mode)
            if not same_rows(out, single, key):
                raise AssertionError(f"mesh sf10 {name} ({mode}): rows != single device")
            ms = time_ms(lambda: mesh_runner(dist, mesh, mode).run(tables), SF10_MESH_REPS)
            by_mode[mode] = {"ms": ms, "exchange_bytes": xbytes,
                             "peak_bytes": summary.peak_device_bytes,
                             "retries": summary.retries}
            del out
        single_ms = time_ms(lambda: run_query(plan_fn(), tables), SF10_MESH_REPS)
        busy = device_busy_ms(lambda: run_query(dist, tables, mesh=mesh))
        res[name] = {"rows": ssum.result_rows, "single_ms": single_ms, "busy_ms": busy,
                     "idle_share": None if busy is None
                     else max(0.0, 1 - busy / by_mode["ragged"]["ms"]), **by_mode}
        modes_text = ", ".join(
            f"{m} {v['ms']:.1f} ms (exchanges {v['exchange_bytes']} bytes, peak "
            f"{v['peak_bytes']} bytes)" for m, v in by_mode.items())
        print(f"mesh sf10 {name} x{MESH_SHARDS}: {ssum.result_rows} rows bit-exact vs the "
              f"single-device run; {modes_text}; single-device {single_ms:.1f} ms; busy "
              + (f"{busy:.1f} ms" if busy is not None else "not measured") + f" [{card}]")
        del single
    print(f"mesh sf10 phase: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return res


# ---- the SQL front end: the parity scripts, then Q1 and Q6 as SQL text -----------

SQL_CASES = ("types", "dml", "select", "joins", "subquery", "analytic", "errors")
SQL_SF = 0.1           # the front end turns a table's Python rows into a block per query
SQL_REPEATS = 3        # warm statements per SQL query whose split is the median
LINEITEM_DDL = (
    "create table lineitem (l_orderkey bigint not null, l_partkey bigint not null, "
    "l_suppkey bigint not null, l_linenumber bigint not null, "
    "l_quantity decimal(15,2) not null, l_extendedprice decimal(15,2) not null, "
    "l_discount decimal(15,2) not null, l_tax decimal(15,2) not null, "
    "l_returnflag char(1) not null, l_linestatus char(1) not null, "
    "l_shipdate date not null, l_commitdate date not null, l_receiptdate date not null, "
    "l_shipmode char(10) not null)")
# TPC-H's Q1 and Q6 text, with the validation run's substitutions as literals
# (Q1: DELTA 90, so the cutoff date is 1998-09-02; Q6: 1994, 0.06, 24)
SQL_Q1 = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice) as sum_base_price, "
    "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price, "
    "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge, "
    "avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price, "
    "avg(l_discount) as avg_disc, count(*) as count_order "
    "from lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
SQL_Q6 = (
    "select sum(l_extendedprice * l_discount) as revenue from lineitem "
    "where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' "
    "and l_discount between 0.05 and 0.07 and l_quantity < 24")


def planes_equal_plain(SA, call) -> int:
    """The planes kernel == its plain version (``torch.equal``) on a
    captured ``group_sums`` call's own card inputs, each into zeros;
    returns the largest absolute difference (0), raises on any."""
    import torch

    slots, planes, fields, n_slots, out, *rest = call
    got = SA.group_sums(slots, planes, fields, n_slots, torch.zeros_like(out), *rest)
    want = SA.group_sums_plain(slots, planes, fields, n_slots, torch.zeros_like(out), *rest)
    torch.cuda.synchronize()
    err = int((got - want).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"stream_agg kernel != plain at a captured call "
                             f"({slots.shape[0]} rows, S={n_slots}, max abs err {err})")
    return err


def _on_card(x) -> bool:
    import torch

    if isinstance(x, torch.Tensor):
        return x.device.type == "cuda"
    if isinstance(x, dict):
        return any(_on_card(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_on_card(v) for v in x)
    return x is not None and torch.device(x).type == "cuda"


def held_kernel_run(what: str, SA, DA, ST, run) -> tuple:
    """``run()`` with every kernel's count set to 0 just before it and
    every wrapper call captured: each kernel's launches must be exactly
    what its captured card calls make (direct_agg: ``launch_plan``'s
    column groups per call with rows; stream_tile and the planes kernel:
    one per call with rows), and each card call is held kernel == plain
    on its own inputs.  Returns (launches, max abs error), each keyed by
    kernel."""
    import torch

    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    calls = capture_kernel_calls(run)
    torch.cuda.synchronize()
    launches = {"stream_tile": ST.LAUNCHES, "direct_agg": DA.LAUNCHES,
                "stream_agg": SA.LAUNCHES}
    card = {"direct_agg": [c for c in calls["direct_agg"] if _on_card(c[0])],
            "stream_agg": [c for c in calls["stream_agg"] if _on_card(c[0])],
            # (inputs, program, S, n_limbs, n_rows, plane_fields, headroom, device)
            "stream_tile": [c for c in calls["stream_tile"]
                            if _on_card(c[7] if len(c) > 7 and c[7] is not None else c[0])]}
    predicted = launches_of(DA, card)
    if launches != predicted:
        raise AssertionError(f"{what}: launches {launches}, the captured calls make "
                             f"{predicted}")
    errs = {"stream_tile": max([fused_equals_plain(ST, c) for c in card["stream_tile"]],
                               default=0),
            "direct_agg": mesh_direct_agg_check(DA, card["direct_agg"]),
            "stream_agg": max([planes_equal_plain(SA, c) for c in card["stream_agg"]],
                              default=0)}
    return launches, errs


def sql_script_runs(device: str, distributed: bool) -> dict:
    """Each script of ``tests/sql_cases`` through one
    ``RefTestSession(device)``, with ``TIFLASH_REFTEST_DISTRIBUTED`` set
    or not: per statement (exception, checked, unsupported, the rows of
    its SELECTs), and the session's totals."""
    import os
    import pathlib

    from tiflash_tpu_torch.runtime.failpoint import FailPoint
    from tiflash_tpu_torch.testing.reftest import RefTestSession, parse_test_file

    cases = pathlib.Path(__file__).resolve().parent / "tests" / "sql_cases"
    before = os.environ.pop("TIFLASH_REFTEST_DISTRIBUTED", None)
    if distributed:
        os.environ["TIFLASH_REFTEST_DISTRIBUTED"] = "1"
    out = {}
    try:
        for name in SQL_CASES:
            t0 = time.perf_counter()
            sess = RefTestSession(device)
            records = []
            for stmt, expected in parse_test_file(str(cases / f"{name}.test")):
                n, c, u = len(sess.results), sess.checked, len(sess.unsupported)
                err = None
                try:
                    sess.run_statement(stmt, expected)
                except Exception as e:
                    err = (type(e).__name__, str(e))
                records.append((err, sess.checked - c, sess.unsupported[u:],
                                sess.results[n:]))
            FailPoint.disable_all()
            out[name] = {"records": records, "checked": sess.checked,
                         "unsupported": len(sess.unsupported),
                         "distributed_runs": sess.distributed_runs,
                         "s": time.perf_counter() - t0}
    finally:
        FailPoint.disable_all()
        os.environ.pop("TIFLASH_REFTEST_DISTRIBUTED", None)
        if before is not None:
            os.environ["TIFLASH_REFTEST_DISTRIBUTED"] = before
    return out


def _unordered(results) -> list:
    return [sorted(repr(r) for r in rows) for rows in results]


def sql_scripts_check(card: str, SA, DA, ST) -> dict:
    """The parity scripts on the card against the same scripts on the CPU,
    in one process: every statement the same (exception, checked,
    unsupported, every SELECT's rows), no recorded table failing on the
    card; then with the distributed switch over ``Mesh([cuda:0] * 8)``,
    the same rows (in any order) and as many distributed runs as over
    ``cpu_mesh(8)``.  Each card run is a ``held_kernel_run``: its
    launches are exactly its captured calls' and each call is held
    kernel == plain."""
    runs, held = {}, {}
    for dev, dist in (("cpu", False), ("cuda", False), ("cuda", True), ("cpu", True)):
        if dev == "cpu":
            runs[(dev, dist)] = sql_script_runs(dev, dist)
            continue
        got = []
        key = "scripts_mesh" if dist else "scripts"
        held[key] = held_kernel_run(f"sql {key}", SA, DA, ST,
                                    lambda: got.append(sql_script_runs(dev, dist)))
        runs[(dev, dist)] = got[0]
    cpu, gpu = runs[("cpu", False)], runs[("cuda", False)]
    gpu_d, cpu_d = runs[("cuda", True)], runs[("cpu", True)]
    totals = {"statements": 0, "checked": 0, "unsupported": 0, "distributed_runs": 0}
    for name in SQL_CASES:
        a, b = cpu[name], gpu[name]
        for i, (ra, rb) in enumerate(zip(a["records"], b["records"])):
            if ra != rb:
                raise AssertionError(f"sql {name} statement {i}: card {rb} != cpu {ra}")
            if rb[0] is not None and rb[0][0] == "AssertionError":
                raise AssertionError(f"sql {name} statement {i}: a recorded table failed "
                                     f"on the card: {rb[0][1][:300]}")
        for k in ("checked", "unsupported"):
            if a[k] != b[k] or len(a["records"]) != len(b["records"]):
                raise AssertionError(f"sql {name}: {k} card {b[k]} != cpu {a[k]}")
        d, dc = gpu_d[name], cpu_d[name]
        if d["distributed_runs"] != dc["distributed_runs"] or d["checked"] != b["checked"]:
            raise AssertionError(f"sql {name} distributed: {d['distributed_runs']} runs, "
                                 f"{d['checked']} checked on the card; cpu mesh "
                                 f"{dc['distributed_runs']} runs, single {b['checked']}")
        for i, (rs, rd) in enumerate(zip(b["records"], d["records"])):
            if _unordered(rs[3]) != _unordered(rd[3]) or rs[0] != rd[0]:
                raise AssertionError(f"sql {name} statement {i}: the mesh run's rows differ "
                                     f"from the single-device card run's")
        totals["statements"] += len(b["records"])
        for k in ("checked", "unsupported"):
            totals[k] += b[k]
        totals["distributed_runs"] += d["distributed_runs"]
        print(f"sql {name}.test: {len(b['records'])} statements, {b['checked']} checked, "
              f"{b['unsupported']} unsupported, card == cpu; distributed "
              f"{d['distributed_runs']} runs over 8 shards of cuda:0, rows equal; walls "
              f"cpu {a['s']:.2f} s, card {b['s']:.2f} s, card mesh {d['s']:.2f} s, cpu mesh "
              f"{dc['s']:.2f} s [{card}]")
    if not totals["distributed_runs"]:
        raise AssertionError("sql: no statement took the distributed path")
    print(f"sql scripts: {totals['statements']} statements, {totals['checked']} checked, "
          f"{totals['unsupported']} unsupported, {totals['distributed_runs']} distributed "
          f"runs; card, cpu and mesh sessions agree")
    for key, (launches, errs) in held.items():
        print(f"sql {key} on the card: launches {launches}, each exactly its captured "
              f"calls'; kernel == plain at every call (max abs err {errs}) [{card}]")
    return {"totals": totals, "launches": {k: v[0] for k, v in held.items()},
            "max_abs_err": {k: max(v[1][k] for v in held.values()) for k in
                            ("stream_tile", "direct_agg", "stream_agg")}}


def sql_query_phase(card: str, SA, DA, ST) -> dict:
    """TPC-H Q1 and Q6 as SQL text through one ``RefTestSession("cuda")``
    over SF 0.1 lineitem (the catalog's host columns as the session's
    rows): rows and types bit-exact against ``run_query`` of the plan
    builders on the same catalog on the card and against numpy, the
    session's own check against the plan's answer as its recorded table.
    The first statement is a ``held_kernel_run`` (launches exactly the
    captured calls', each kernel == plain); then ``SQL_REPEATS`` more,
    each checked, whose wall split is reported as medians: host
    conversion, the engine run, the result's decode, and the rest
    (tokenizing, parsing, the SELECT builder and the recorded-table
    comparison)."""
    import statistics

    import torch

    import tiflash_tpu_torch.plan.compiler as PC
    from tiflash_tpu_torch.bench.tpch_queries import q1_plan, q6_plan
    from tiflash_tpu_torch.ops.cuda import build
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.tpch import generate_tpch
    from tiflash_tpu_torch.testing import oracle as O
    from tiflash_tpu_torch.testing import reftest as R

    t0 = time.perf_counter()
    cat = generate_tpch(sf=SQL_SF, seed=SEED, tables=["lineitem"])
    n_rows = cat["lineitem"].row_count
    sess = R.RefTestSession(device="cuda")
    sess.run_statement(LINEITEM_DDL, None)
    schema = sess.tables["lineitem"][0]
    host = O.block_to_pytable(cat.blocks("cpu")["lineitem"])
    sess.tables["lineitem"] = (schema, {c: host[c] for c in schema})
    del host
    print(f"sql lineitem sf{SQL_SF}: {n_rows} rows made and loaded into the session as "
          f"Python rows in {time.perf_counter() - t0:.1f} s")
    gpu_tables = cat.blocks("cuda")
    li = lineitem_arrays(cat)
    out = {"rows": n_rows, "launches": {}, "max_abs_err": {}, "ms": {}}
    for name, sql, plan_fn, want_np in (("q1", SQL_Q1, q1_plan, numpy_q1(li)),
                                       ("q6", SQL_Q6, q6_plan, numpy_q6(li))):
        plan_out, summary = run_query(plan_fn(), gpu_tables)
        want = block_result(plan_out)
        if want[0] != want_np:
            raise AssertionError(f"sql {name}: run_query of the plan != numpy")
        plan_rows = O.block_to_pytable(plan_out)
        recorded = ["\t".join(plan_rows)] + ["\t".join(str(v) for v in r)
                                             for r in zip(*plan_rows.values())]

        def statement(wrap):
            """One checked statement, ``wrap(run)`` around it: its wall
            split (seconds) with ``nvcc`` of a new fused shape apart."""
            spent = {"conversion": 0.0, "run": 0.0, "decode": 0.0}
            blocks = []
            real_p2b, real_cf, real_rows = O.pytable_to_block, PC.compile_fragment, R._block_rows

            def p2b(*a, **k):
                t = time.perf_counter()
                try:
                    return real_p2b(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    spent["conversion"] += time.perf_counter() - t

            def cf(plan, *a, **k):
                fn = real_cf(plan, *a, **k)

                def run(tables):
                    t = time.perf_counter()
                    res = fn(tables)
                    torch.cuda.synchronize()
                    spent["run"] += time.perf_counter() - t
                    return res
                return run

            def rows_of(block):
                t = time.perf_counter()
                blocks.append(block)
                try:
                    return real_rows(block)
                finally:
                    spent["decode"] += time.perf_counter() - t

            built = dict(build.BUILD_SECONDS)
            checked = sess.checked
            torch.cuda.synchronize()
            O.pytable_to_block, PC.compile_fragment, R._block_rows = p2b, cf, rows_of
            try:
                t = time.perf_counter()
                res = wrap(lambda: sess.run_statement(sql, recorded))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            finally:
                O.pytable_to_block, PC.compile_fragment, R._block_rows = (
                    real_p2b, real_cf, real_rows)
            if sess.checked != checked + 1:
                raise AssertionError(f"sql {name}: the session did not check its answer")
            got = block_result(blocks[-1].compact())
            if got != want or got[0] != want_np:
                raise AssertionError(f"sql {name}: SQL result != run_query of the plan / "
                                     f"numpy\n{got}\n{want}")
            nvcc = sum(v for k, v in build.BUILD_SECONDS.items() if k not in built)
            spent["run"] -= nvcc
            split = {"wall": wall, "nvcc": nvcc, **spent,
                     "parse_build_compare": wall - sum(spent.values()) - nvcc}
            return res, split, got

        (launches, errs), first, got = statement(
            lambda run: held_kernel_run(f"sql {name}", SA, DA, ST, run))
        reps = [statement(lambda run: run())[1] for _ in range(SQL_REPEATS)]
        med = {k: statistics.median(r[k] for r in reps) * 1e3 for k in first}
        run_samples = ", ".join(f"{r['run'] * 1e3:.1f}" for r in reps)
        out["launches"][name] = launches
        for k, e in errs.items():
            out["max_abs_err"][k] = max(out["max_abs_err"].get(k, 0), e)
        plan_ms = time_ms(lambda: run_query(plan_fn(), gpu_tables), 3)
        out["ms"][name] = {"first": {k: v * 1e3 for k, v in first.items()},
                           "median": med, "repeats": SQL_REPEATS, "plan_run_query": plan_ms}
        print(f"sql {name} (TPC-H text) sf{SQL_SF} on cuda: {len(got[0][next(iter(got[0]))])} "
              f"rows, bit-exact vs run_query of {plan_fn.__name__}() on the card and numpy, "
              f"checked by the session {1 + SQL_REPEATS} times; launches stream_tile "
              f"{launches['stream_tile']}, direct_agg {launches['direct_agg']}, stream_agg "
              f"{launches['stream_agg']}, each exactly its captured calls'"
              f"{', kernel == plain at every captured call' if any(launches.values()) else ''}")
        print(f"  first statement {first['wall'] * 1e3:.1f} ms (spies and nvcc of a new "
              f"fused shape {first['nvcc'] * 1e3:.1f} ms included); medians over "
              f"{SQL_REPEATS} more: wall {med['wall']:.1f} ms, host conversion "
              f"{med['conversion']:.1f} ms, parse, build and compare "
              f"{med['parse_build_compare']:.1f} ms, engine run {med['run']:.1f} ms "
              f"(samples {run_samples}), "
              f"result decode {med['decode']:.1f} ms; run_query of the plan builder median "
              f"{plan_ms:.3f} ms over 3 warm runs [{card}]")
    return out


def sql_phase(card: str, SA, DA, ST) -> dict:
    """The SQL front end on the card (``sql_scripts_check``, then
    ``sql_query_phase``): launches per script run and per SQL query, and
    each kernel's largest error."""
    t0 = time.perf_counter()
    scripts = sql_scripts_check(card, SA, DA, ST)
    queries = sql_query_phase(card, SA, DA, ST)
    print(f"sql phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return {"scripts": scripts["totals"], "rows": queries["rows"], "ms": queries["ms"],
            "launches": {**scripts["launches"], **queries["launches"]},
            "max_abs_err": {k: max(scripts["max_abs_err"][k], queries["max_abs_err"][k])
                            for k in scripts["max_abs_err"]}}


# ---- the judges: generated plans and the two kernels' shapes, held against
# the port's oracle ---------------------------------------------------------------

ORACLE_WORKERS = 3     # processes computing the families' CPU side and oracle answers
KERNEL_NAMES = ("stream_tile", "direct_agg", "stream_agg")


def load_draw():
    """``tests/torch_plan_draw.py`` of this checkout, loaded by path: the
    fuzzers' generators (jax-free), the two kernels' families and the
    judge."""
    import importlib.util
    from pathlib import Path

    name = "torch_plan_draw"
    if name not in sys.modules:
        path = Path(__file__).resolve().parent / "tests" / "torch_plan_draw.py"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def launches_of(DA, calls: dict) -> dict:
    """The launches a run's captured kernel-wrapper calls make on the card:
    direct_agg one per ``launch_plan`` column group of each call with rows,
    stream_tile and the planes kernel one per call with rows."""
    return {
        "stream_tile": sum(1 for c in calls["stream_tile"] if c[4] > 0),
        "direct_agg": sum(len(DA.launch_plan(c[2], len(DA._value_list(c[1])) + 1))
                          for c in calls["direct_agg"] if c[0].shape[0]),
        "stream_agg": sum(1 for c in calls["stream_agg"] if c[0].shape[0])}


def capture_kernel_calls(run) -> dict:
    """Every call ``run()`` makes to a kernel wrapper (``capture_calls``),
    keyed by kernel: direct_agg's and the planes kernel's ``group_sums``
    and the generated kernel's ``fused_group_sums``."""
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST

    calls = {}

    def with_sa():
        calls["stream_agg"] = capture_calls(SA, "group_sums", run)

    def with_st():
        calls["stream_tile"] = capture_calls(ST, "fused_group_sums", with_sa)

    calls["direct_agg"] = capture_calls(DA, "group_sums", with_st)
    return calls


def spied_cpu_run(run) -> tuple:
    """``run()`` on the CPU with every kernel wrapper's calls captured:
    (its value, the launches the same run makes on the card, the
    generated stream_tile sources it needs)."""
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST

    out = []
    calls = capture_kernel_calls(lambda: out.append(run()))
    sources = [fused_source(SA, ST, c) for c in calls["stream_tile"] if c[4] > 0]
    return out[0], launches_of(DA, calls), sources


def family_cpu_side(family: str, seed: int, n: int) -> dict:
    """One family run's CPU side, in a worker process: the table from the
    seed, the port's CPU run with the launches it predicts for the card,
    and the oracle's answer over the CPU block's values
    (``block_to_pytable``)."""
    import torch

    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.testing.oracle import block_to_pytable

    torch.set_num_threads(1)
    D = load_draw()
    t0 = time.perf_counter()
    plan, cat = D.FAMILIES[family](seed, n)
    cpu = cat.blocks("cpu")
    (res, summary), predicted, sources = spied_cpu_run(lambda: run_query(plan, cpu))
    t1 = time.perf_counter()
    want = D.execute_plan_oracle(D.oracle_plan(plan), {"t": block_to_pytable(cpu["t"])})
    return {"cpu": block_to_pytable(res), "retries": summary.retries,
            "predicted": predicted, "sources": sources, "oracle": want,
            "cpu_s": t1 - t0, "oracle_s": time.perf_counter() - t1}


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def oracle_trees(card: str, D, SA, DA, ST) -> dict:
    """Every tree of the reference fuzzer's plan, window and grouping-set
    seeds and of the port fuzzer's seeds on ``cuda``: each run judged by
    the oracle as the reference's fuzzer judges (``judge``), equal to the
    port's CPU run (the float rule; a LIMIT by row count), launching
    exactly what the CPU run's captured calls predict, every overflow flag
    0; then each non-LIMIT tree over ``Mesh([cuda:0] * 8)``, equal to its
    single-device card run and judged again."""
    import torch

    from tiflash_tpu_torch.mpp.mesh import Mesh
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.testing.oracle import block_to_pytable, pytable_to_block

    mesh = Mesh([torch.device("cuda:0")] * MESH_SHARDS)
    gens = {g: {"trees": 0, "judged": 0, "norm": 0, "approx": 0, "count": 0, "mesh": 0}
            for g in D.GENERATORS}
    predicted, read, mesh_read = {}, {}, {}
    errs = dict.fromkeys(KERNEL_NAMES, 0)
    secs = {"oracle": 0.0, "cpu": 0.0, "card": 0.0, "mesh": 0.0}
    mesh_retries = 0
    for gen, seed, d in D.all_draws():
        what = f"{gen} seed {seed} ({d.shape}):\n{d.plan.pretty()}"
        t0 = time.perf_counter()
        want = D.oracle_rows(d)
        t1 = time.perf_counter()
        cpu_blocks = {n: pytable_to_block(t, d.schemas[n], "cpu") for n, t in d.tables.items()}
        (cpu_out, cpu_sum), pred, _ = spied_cpu_run(lambda: run_query(d.plan, cpu_blocks))
        t2 = time.perf_counter()
        gpu_blocks = {n: pytable_to_block(t, d.schemas[n], "cuda") for n, t in d.tables.items()}
        ran = []
        launches, e = held_kernel_run(what, SA, DA, ST,
                                      lambda: ran.append(run_query(d.plan, gpu_blocks)))
        out, summary = ran[0]
        t3 = time.perf_counter()
        if launches != pred:
            raise AssertionError(f"{what}\nlaunches {launches}, the CPU run predicts {pred}")
        if summary.device != "cuda:0" or summary.retries or cpu_sum.retries:
            raise AssertionError(f"{what}\nran on {summary.device} with {summary.retries} "
                                 f"retries (CPU: {cpu_sum.retries}): an overflow flag was set")
        got, cpu_got = block_to_pytable(out), block_to_pytable(cpu_out)
        if d.shape == "limit":
            if D.n_rows(got) != D.n_rows(cpu_got):
                raise AssertionError(f"{what}\n{D.n_rows(got)} rows on the card, "
                                     f"{D.n_rows(cpu_got)} on the CPU")
        else:
            D.assert_same_rows(got, cpu_got, what)
        how = D.judge(got, want, d.shape, what)
        g = gens[gen]
        g["trees"] += 1
        g["judged"] += 1
        g[how] += 1
        _add(predicted, pred)
        _add(read, launches)
        errs = {k: max(errs[k], e[k]) for k in errs}
        secs["oracle"] += t1 - t0
        secs["cpu"] += t2 - t1
        secs["card"] += t3 - t2
        if d.shape == "limit":
            continue
        mesh_out = []
        ml, me = held_kernel_run(what + " (mesh)", SA, DA, ST,
                                 lambda: mesh_out.append(mesh_run(d.plan, gpu_blocks, mesh)))
        mo, ms, _ = mesh_out[0]
        if ms.device != "cuda:0":
            raise AssertionError(f"{what}\nmesh result on {ms.device}")
        mesh_got = block_to_pytable(mo)
        D.assert_same_rows(mesh_got, got, what + "\nmesh vs single-device card run")
        D.judge(mesh_got, want, d.shape, what + " (mesh)")
        g["mesh"] += 1
        mesh_retries += ms.retries
        _add(mesh_read, ml)
        errs = {k: max(errs[k], me[k]) for k in errs}
        secs["mesh"] += time.perf_counter() - t3
    torch.cuda.synchronize()
    n_trees = sum(g["trees"] for g in gens.values())
    n_mesh = sum(g["mesh"] for g in gens.values())
    print(f"oracle trees on cuda: {n_trees} trees judged by the port's oracle and equal "
          f"to the CPU run ({', '.join(f'{k} {v}' for k, v in gens.items())}); {n_mesh} "
          f"over Mesh([cuda:0] * {MESH_SHARDS}) equal to the single-device run and judged "
          f"({mesh_retries} mesh retries); launches predicted {predicted}, read {read}, "
          f"under the mesh {mesh_read}; seconds {', '.join(f'{k} {v:.1f}' for k, v in secs.items())} "
          f"[{card}]")
    return {"generators": gens, "mesh_runs": n_mesh, "mesh_retries": mesh_retries,
            "limit_by_count": sum(g["count"] for g in gens.values()),
            "launches": {"predicted": predicted, "read": read, "mesh": mesh_read},
            "max_abs_err": errs, "seconds": secs}


def oracle_families(card: str, D, SA, DA, ST, pending: dict) -> dict:
    """The two kernels' families on ``cuda``, each run: launches exactly
    the CPU run's prediction (at least one of its kernel's), every
    captured call kernel == plain, rows equal to the CPU run and judged by
    the oracle (both computed by a worker, ``family_cpu_side``), and its
    ``run_query`` median of ``WARM_RUNS``."""
    from tiflash_tpu_torch.ops.cuda import build
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.testing.oracle import block_to_pytable

    t0 = time.perf_counter()
    sides = {key: p.get() for key, p in pending.items()}
    waited = time.perf_counter() - t0
    # the fused shapes' sources, one nvcc each, all at once
    t0 = time.perf_counter()
    generated = list(dict.fromkeys(s for side in sides.values() for s in side["sources"]))
    build.build_libraries((), generated=generated)
    build_s = time.perf_counter() - t0
    fams = {f: {"rows": D.FAMILY_ROWS, "runs": 0, "groups": [], "ms": [],
                "launches": {}, "predicted": {}} for f in D.FAMILIES}
    errs = dict.fromkeys(KERNEL_NAMES, 0)
    for (fam, seed), side in sides.items():
        what = f"family {fam} seed {seed}"
        plan, cat = D.FAMILIES[fam](seed, D.FAMILY_ROWS)
        gpu = cat.blocks("cuda")
        ran = []
        launches, e = held_kernel_run(what, SA, DA, ST,
                                      lambda: ran.append(run_query(plan, gpu)))
        out, summary = ran[0]
        kernel = D.FAMILY_KERNEL[fam]
        if launches != side["predicted"] or launches[kernel] < 1:
            raise AssertionError(f"{what}: launches {launches}, the CPU run predicts "
                                 f"{side['predicted']}; {kernel} must launch")
        if summary.device != "cuda:0" or summary.retries or side["retries"]:
            raise AssertionError(f"{what}: ran on {summary.device} with {summary.retries} "
                                 f"retries (CPU: {side['retries']})")
        got = block_to_pytable(out)
        D.assert_same_rows(got, side["cpu"], what)
        D.judge(got, side["oracle"], "agg", what)
        f = fams[fam]
        f["runs"] += 1
        f["groups"].append(D.n_rows(got))
        f["ms"].append(time_ms(lambda: run_query(plan, gpu), WARM_RUNS))
        _add(f["launches"], launches)
        _add(f["predicted"], side["predicted"])
        errs = {k: max(errs[k], e[k]) for k in errs}
        del gpu, cat
    for fam, f in fams.items():
        print(f"oracle family {fam} on cuda: {f['runs']} runs of {f['rows']} rows, groups "
              f"{f['groups']}, launches {f['launches']} (predicted {f['predicted']}), every "
              f"captured call kernel == plain, rows == CPU run and judged by the oracle; "
              f"run_query medians of {WARM_RUNS} {[round(m, 4) for m in f['ms']]} ms [{card}]")
    cpu_s = sum(s["cpu_s"] for s in sides.values())
    oracle_s = sum(s["oracle_s"] for s in sides.values())
    print(f"  workers: {ORACLE_WORKERS} processes, CPU runs {cpu_s:.1f} s and the oracle "
          f"{oracle_s:.1f} s of their time; the phase waited {waited:.1f} s for them; "
          f"{len(generated)} fused sources built in {build_s:.2f} s")
    return {"families": fams, "max_abs_err": errs, "worker_cpu_s": cpu_s,
            "worker_oracle_s": oracle_s, "waited_s": waited, "build_s": build_s}


def oracle_phase(card: str, SA, DA, ST) -> dict:
    """The port's judges on the card (``oracle_trees``, then
    ``oracle_families``, whose CPU side and oracle answers a pool of
    ``ORACLE_WORKERS`` spawned processes computes meanwhile).  Prints one
    JSON line; a failed judgement raises."""
    import multiprocessing

    D = load_draw()
    t0 = time.perf_counter()
    pool = multiprocessing.get_context("spawn").Pool(ORACLE_WORKERS)
    try:
        pending = {(f, s): pool.apply_async(family_cpu_side, (f, s, D.FAMILY_ROWS))
                   for f in D.FAMILIES for s in D.FAMILY_SEEDS}
        trees = oracle_trees(card, D, SA, DA, ST)
        fams = oracle_families(card, D, SA, DA, ST, pending)
    finally:
        pool.terminate()
        pool.join()
    seconds = time.perf_counter() - t0
    launches = {k: {"predicted": trees["launches"]["predicted"].get(k, 0)
                    + sum(f["predicted"].get(k, 0) for f in fams["families"].values()),
                    "read": trees["launches"]["read"].get(k, 0)
                    + sum(f["launches"].get(k, 0) for f in fams["families"].values()),
                    "mesh": trees["launches"]["mesh"].get(k, 0)} for k in KERNEL_NAMES}
    line = {"oracle_phase": {
        "trees": trees["generators"], "mesh_runs": trees["mesh_runs"],
        "limit_by_count": trees["limit_by_count"], "launches": launches,
        "families": {f: {"rows": v["rows"], "runs": v["runs"], "groups": v["groups"],
                         "run_query_ms": v["ms"], "launches": v["launches"]}
                     for f, v in fams["families"].items()},
        "seconds": seconds, "tree_seconds": trees["seconds"],
        "worker_oracle_s": fams["worker_oracle_s"], "worker_cpu_s": fams["worker_cpu_s"],
        "waited_s": fams["waited_s"], "card": card}}
    print(json.dumps(line))
    return {"launches": launches,
            "max_abs_err": {k: max(trees["max_abs_err"][k], fams["max_abs_err"][k])
                            for k in KERNEL_NAMES}}


def main() -> int:
    """Checks the card, starts the analytic plans' CPU runs in a worker
    process (``analytics_cpu_runs``), runs every phase (``_main``), and
    stops the worker whatever happens."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    import tiflash_tpu_torch  # noqa: F401  (outside the repo this fails here)

    pool, analytic_cpu, mesh_cpu = start_analytics_cpu_runs()
    try:
        return _main(analytic_cpu, mesh_cpu)
    finally:
        pool.terminate()
        pool.join()


def _main(analytic_cpu, mesh_cpu) -> int:
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    from tiflash_tpu_torch.bench.tpch_queries import (
        q1_plan, q3_plan, q4_plan, q6_plan, q7_nation_pairs_plan, q7_plan, q10_plan,
        q22_plan, sort_topn_plan, topn_100m_block, topn_100m_plan)
    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.ops import tile_program as TP
    from tiflash_tpu_torch.ops.cuda import build, direct_agg as DA, join_probe as JP
    from tiflash_tpu_torch.ops.cuda import stream_agg as SA, stream_tile as ST
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
    from tiflash_tpu_torch.storage.tpch import generate_tpch
    from tiflash_tpu_torch.testing import fuse_cases as FC

    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # data and the port's CPU reference runs (plain path); the fused calls
    # they make give the generated kernels' sources
    t0 = time.perf_counter()
    cat = generate_tpch(sf=SF, seed=SEED, tables=["lineitem"])
    n_rows = cat["lineitem"].row_count
    print(f"lineitem sf{SF}: {n_rows} rows in {time.perf_counter() - t0:.1f} s")
    cpu_tables = cat.blocks("cpu")
    cpu_res, layouts, sources = {}, {}, {}
    for name, plan_fn in (("q1", q1_plan), ("q6", q6_plan)):
        before = SF_.FUSE_STATS["count"]
        out = []
        calls = capture_calls(ST, "fused_group_sums",
                              lambda: out.append(run_query(plan_fn(), cpu_tables)[0]))
        if SF_.FUSE_STATS["count"] != before + 1 or len(calls) != 1:
            raise AssertionError(f"{name}: fuse did not engage on the CPU run")
        cpu_res[name] = block_result(out[0])
        layouts[name] = SF_.FUSE_STATS["plane_fields"]
        sources[name] = fused_source(SA, ST, calls[0])
    li = lineitem_arrays(cat)
    np_res = {"q1": numpy_q1(li), "q6": numpy_q6(li)}
    for name in ("q1", "q6"):
        if cpu_res[name][0] != np_res[name]:
            raise AssertionError(f"{name}: port CPU run != numpy\n{cpu_res[name][0]}\n"
                                 f"{np_res[name]}")
    print("cpu reference runs equal numpy for q1 and q6")
    ooc_pred = outofcore_predictions(cpu_tables)
    t0 = time.perf_counter()
    tile_cases = []
    for c in FC.CASES:
        tables = FC.numpy_tables(c.columns(TILE_CASE_ROWS, c.seed))
        cpu_t = blocks_from_numpy(tables, "cpu")
        calls = capture_calls(ST, "fused_group_sums",
                              lambda: run_query(c.plan(FC.TORCH), cpu_t))
        if len(calls) != 1:
            raise AssertionError(f"{c.name}: the fuse did not engage on the CPU run")
        sources[c.name] = fused_source(SA, ST, calls[0])
        tile_cases.append((c.name, c.plan(FC.TORCH), cpu_t,
                           blocks_from_numpy(tables, "cuda")))
    print(f"{len(tile_cases)} fuse cases at {TILE_CASE_ROWS} rows made and run on the "
          f"cpu ({time.perf_counter() - t0:.1f} s)")

    # ---- 2. build: one nvcc per source, all at once --------------------------
    kernels = ("stream_agg", "direct_agg", "join_probe")
    generated = list(dict.fromkeys(sources.values()))
    t0 = time.perf_counter()
    build.build_libraries(kernels, generated=generated)
    print(f"build {', '.join(k + '.cu' for k in kernels)} and {len(generated)} generated "
          f"stream_tile sources: {time.perf_counter() - t0:.2f} s")
    tags = {prefix + "-" + build.source_tag(text): [n for n, v in sources.items()
                                                    if v == (prefix, text)]
            for prefix, text in generated}
    for k in list(kernels) + list(tags):
        print(f"  nvcc {k}{'.cu' if k in kernels else ' (' + ', '.join(tags[k]) + ')'}: "
              f"{build.BUILD_SECONDS[k]:.2f} s")
        for line in build.BUILD_LOG.get(k, "").splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    generated_build_s = {k: build.BUILD_SECONDS[k] for k in tags}
    from tiflash_tpu_torch.runtime import spill

    spill.get_lib()
    print(f"  g++ tiflash_tpu_torch/native/spiller.cpp -lz (the disk spill tier): "
          f"{spill.BUILD_SECONDS:.2f} s -> {spill.library_path().name}")

    t0 = time.perf_counter()
    cat7 = generate_tpch(sf=SF, seed=SEED, tables=Q7_TABLES)
    print(f"five-table catalog sf{SF}: " + ", ".join(
        f"{t} {cat7[t].row_count}" for t in Q7_TABLES)
        + f" rows in {time.perf_counter() - t0:.1f} s")
    q7_plans = (("q7", q7_plan), ("q7_pairs", q7_nation_pairs_plan))
    t0 = time.perf_counter()
    cpu7, joins7 = {}, {}
    for name, plan_fn in q7_plans:
        out, joins7[name] = join_probe_spy(
            lambda: run_query(plan_fn(), cat7.blocks("cpu"))[0])
        cpu7[name] = block_result(out)
    a7 = q7_arrays(cat7)
    np7 = {"q7": numpy_q7(a7), "q7_pairs": numpy_q7_pairs(a7)}
    for name, _ in q7_plans:
        if cpu7[name][0] != np7[name]:
            raise AssertionError(f"{name}: port CPU run != numpy")
    print(f"cpu reference runs equal numpy for q7 and q7_pairs "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- 3. kernels against their plain versions --------------------------------
    # tolerance zero: the outputs are integer sums, compared with torch.equal
    max_err = check_stream_agg(SA, layouts["q1"], layouts["q6"], n_rows)
    direct_err = check_direct_agg(DA, cat7["lineitem"].row_count)
    tile_err = check_stream_tile(SA, ST, tile_cases)
    del tile_cases

    # ---- 3b. the position table's probe at SSB's dimension joins, SF10 shapes --
    join_y = join_probe_phase(card, L2Flush())

    # ---- 4. Q1 and Q6 at SF1 on the card: one generated launch each ------------
    gpu_tables = cat.blocks("cuda")
    on_card = []
    real_evaluate = TP.evaluate

    def evaluate_spy(program, tile, in_bounds=None):
        if any(t.is_cuda for t in tile.values()):
            on_card.append(1)
        return real_evaluate(program, tile, in_bounds)

    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    fused_before = SF_.FUSE_STATS["count"]
    launches_per_query = {}
    outs = {}
    TP.evaluate = evaluate_spy
    try:
        for name, plan_fn in (("q1", q1_plan), ("q6", q6_plan)):
            l0, f0 = ST.LAUNCHES, SF_.FUSE_STATS["count"]
            out, summary = run_query(plan_fn(), gpu_tables)
            torch.cuda.synchronize()
            outs[name] = out
            launches_per_query[name] = ST.LAUNCHES - l0
            if SF_.FUSE_STATS["count"] != f0 + 1:
                raise AssertionError(f"{name}: fuse did not engage on cuda")
            if launches_per_query[name] != 1:
                raise AssertionError(f"{name}: {launches_per_query[name]} stream_tile "
                                     f"launches, expected 1")
            if summary.device != "cuda:0":
                raise AssertionError(f"{name}: result on {summary.device}")
    finally:
        TP.evaluate = real_evaluate
    main_path_launches = ST.LAUNCHES
    planes_launches = SA.LAUNCHES
    if SF_.FUSE_STATS["count"] != fused_before + 2:
        raise AssertionError("fuse count off")
    if DA.LAUNCHES or SA.LAUNCHES or on_card:
        raise AssertionError(f"q1/q6 launched direct_agg {DA.LAUNCHES} and the planes "
                             f"kernel {SA.LAUNCHES} times, evaluated on the card "
                             f"{len(on_card)} times; expected 0")
    for name, out in outs.items():
        got = block_result(out)
        if got != cpu_res[name]:
            raise AssertionError(f"{name}: cuda result != cpu result\n{got}\n{cpu_res[name]}")
        if got[0] != np_res[name]:
            raise AssertionError(f"{name}: cuda result != numpy")
        print(f"{name} sf{SF} on cuda: stream_tile launches {launches_per_query[name]}, "
              f"planes kernel launches 0, evaluate on the card 0; bit-exact vs port CPU "
              f"run and numpy: {got[0]}")

    # timings: whole query (median and profiler), then at the query's own
    # fused call: the generated kernel, the unfused path, plain, one
    # index_add_ and the bound; the planes kernel at the planes the
    # program's evaluate makes on the card
    flush = L2Flush()
    stream_y, tile_y, q_ms = {}, {}, {}
    for name, plan_fn in (("q1", q1_plan), ("q6", q6_plan)):
        plan = plan_fn()
        q_ms[name] = time_ms(lambda: run_query(plan, gpu_tables), WARM_RUNS)
        busy, events, by_name = device_profile(lambda: run_query(plan, gpu_tables))
        tile_dev = sum(ms for k, ms in by_name.items() if "stream_tile_kernel" in k)
        (call,) = capture_calls(ST, "fused_group_sums", lambda: run_query(plan, gpu_tables))
        y = fused_yardsticks(SA, ST, TP, call, flush)
        tile_y[name] = y
        stream_y[name] = stream_agg_yardsticks(SA, [y.pop("planes_call")], flush)
        _, program, S, L, _, pf, h, _ = call
        tp = ST.plan_tile_launch(S, L, sum(map(len, pf)), h)
        busy_txt = ("device busy not measured (the trace held no device time)"
                    if busy is None else f"device busy {busy:.4f} ms in {events} device "
                    f"events per run (PR 5: {PR5_EVENTS[name]}), of which the stream_tile "
                    f"kernel {tile_dev:.4f} ms, idle share {1 - busy / q_ms[name]:.1%} of "
                    f"the median")
        print(f"{name} sf{SF} run_query median {q_ms[name]:.3f} ms over {WARM_RUNS} warm "
              f"runs; {busy_txt}; stream_tile regime {tp.regime}, headroom {h}, 16-byte "
              f"path {tp.vector}, {len(program.params)} launch parameters [{card}]")
        print("  " + fused_line(name, y, card))
        print("  " + yardstick_line(f"{name} stream_agg (planes kernel)", stream_y[name],
                                    card))

    # literal reuse: a second Q6 draw builds nothing new
    n_built = len(build.BUILD_SECONDS)
    plan = q6_plan(**Q6_OTHER)
    got = block_result(run_query(plan, gpu_tables)[0])
    want = numpy_q6(li, (Q6_OTHER["date"], Q6_OTHER["date_end"]),
                    (round(Q6_OTHER["disc_lo"] * 100), round(Q6_OTHER["disc_hi"] * 100)),
                    round(Q6_OTHER["quantity"] * 100))
    if got[0] != want or got != block_result(run_query(plan, cpu_tables)[0]):
        raise AssertionError(f"q6 {Q6_OTHER}: cuda result != numpy / cpu run")
    if len(build.BUILD_SECONDS) != n_built:
        raise AssertionError("q6 with other literals built a new library")
    print(f"q6 {Q6_OTHER} on cuda: bit-exact vs numpy and the CPU run, {got[0]}; no new "
          f"build ({n_built} libraries built or loaded in this process)")

    # ---- 4b. spec-form Q1 and Q6, and the function sweep, on lineitem ----
    spec_joins = spec_phase(card, ("q1", "q6"), cpu_tables, gpu_tables,
                            {"q1": cpu_res["q1"], "q6": cpu_res["q6"]})
    sweep_phase(card, cpu_tables, gpu_tables)
    ship = string_phase(card, cpu_tables, gpu_tables, li)
    runtime_controls_phase(card, cpu_tables, gpu_tables)
    del gpu_tables, cpu_tables

    # ---- 4c. Q1 at SF10: one launch over 60M rows, the two-limb recombination;
    # then the out-of-core rehearsal on the same SF10 catalog
    cat10, gen_s = sf10_catalog()
    print(f"sf{SF10} catalog: " + ", ".join(f"{t} {cat10[t].row_count}" for t in Q3_TABLES)
          + f" rows ({', '.join(f'{t}: {len(c)} columns' for t, c in SF10_COLUMNS.items())})"
          + f" in {gen_s:.1f} s")
    sf10 = sf10_q1_phase(card, flush, cat10, gen_s)
    ooc = outofcore_phase(card, cat10, sf10.pop("want"), ooc_pred, flush)
    mesh_sf10_phase(card, cat10)
    del cat10

    # ---- 5. Q7 and Q7 over all nation pairs at SF1 on the card -------------------
    gpu7 = cat7.blocks("cuda")
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    direct_per_query = {}
    for name, plan_fn in q7_plans:
        d0 = DA.LAUNCHES
        JP.LAUNCHES = 0
        out, summary = run_query(plan_fn(), gpu7)
        torch.cuda.synchronize()
        direct_per_query[name] = DA.LAUNCHES - d0
        if SA.LAUNCHES or ST.LAUNCHES:
            raise AssertionError(f"{name}: launched a stream_agg kernel")
        if JP.LAUNCHES != joins7[name]:
            raise AssertionError(f"{name}: {JP.LAUNCHES} join_probe launches, the CPU "
                                 f"run's dense joins predict {joins7[name]}")
        if summary.device != "cuda:0" or summary.retries:
            raise AssertionError(f"{name}: ran on {summary.device} with "
                                 f"{summary.retries} retries")
        got = block_result(out)
        if got != cpu7[name]:
            raise AssertionError(f"{name}: cuda result != cpu result")
        if got[0] != np7[name]:
            raise AssertionError(f"{name}: cuda result != numpy")
        print(f"{name} sf{SF} on cuda: {summary.result_rows} groups, direct_agg "
              f"launches {direct_per_query[name]}, join_probe launches {JP.LAUNCHES} (as "
              f"predicted), bit-exact vs port CPU run and numpy")
        if name == "q7":
            print(f"  q7 rows: {got[0]}")
    q7_launches = DA.LAUNCHES
    if direct_per_query["q7_pairs"] < 1:
        raise AssertionError("q7_pairs: direct_agg kernel was not launched")
    if len(np7["q7_pairs"]["n_lines"]) != 625:
        raise AssertionError(f"q7_pairs: {len(np7['q7_pairs']['n_lines'])} groups, "
                             "expected 625")

    direct_y = None
    for name, plan_fn in q7_plans:
        plan = plan_fn()
        q7_ms = time_ms(lambda: run_query(plan, gpu7), WARM_RUNS)
        print(f"{name} sf{SF} run_query median {q7_ms:.3f} ms over {WARM_RUNS} warm "
              f"runs [{card}]")
        if name == "q7_pairs":
            captured = capture_calls(DA, "group_sums", lambda: run_query(plan, gpu7))
            direct_y = direct_agg_yardsticks(DA, captured, flush)
            slots, vals, n_slots, _ = captured[0]
            lp = DA.launch_plan(n_slots, len(vals) + 1)
            print(f"  q7_pairs direct_agg: {direct_y['live']} live rows, S={n_slots}, "
                  f"{len(vals)} value columns, copies {[g.copies for g in lp]}, "
                  f"blocks per SM {[g.blocks_per_sm for g in lp]}; 32-byte-sector "
                  f"bound {direct_y['sector_bound_ms']:.4f} ms")
            print("  " + yardstick_line("q7_pairs direct_agg", direct_y, card))


    # ---- 6. Q3, Q10, Q4, Q22 and top-N at SF1; top-N over 100M rows --------
    # no kernel is on this path: Q3's stream aggregation has 1.5M groups
    # (the fuse declines), Q4's 5 priorities take the masked method
    t0 = time.perf_counter()
    cat3 = generate_tpch(sf=SF, seed=SEED, tables=Q3_TABLES)
    print(f"three-table catalog sf{SF}: " + ", ".join(
        f"{t} {cat3[t].row_count}" for t in Q3_TABLES)
        + f" rows in {time.perf_counter() - t0:.1f} s")
    a3 = tpch3_arrays(cat3)
    np3 = {"q3": numpy_q3(a3), "q10": numpy_q10(a3), "q4": numpy_q4(a3),
           "q22": numpy_q22(a3),
           "topn": numpy_topn(li["l_extendedprice"],
                              {"l_orderkey": li["l_orderkey"],
                               "l_extendedprice": li["l_extendedprice"]}, TOPN_LIMIT)}
    cats = {"three": cat3, "lineitem": cat}
    slice3 = (("q3", q3_plan, "three"), ("q10", q10_plan, "three"),
              ("q4", q4_plan, "three"), ("q22", q22_plan, "three"),
              ("topn", lambda: sort_topn_plan(TOPN_LIMIT), "lineitem"))
    t0 = time.perf_counter()
    cpu3, joins3 = {}, {}
    for name, plan_fn, c in slice3:
        out, joins3[name] = join_probe_spy(
            lambda: run_query(plan_fn(), cats[c].blocks("cpu"))[0])
        cpu3[name] = block_result(out)
        if cpu3[name][0] != np3[name]:
            raise AssertionError(f"{name}: port CPU run != numpy\n{cpu3[name][0]}\n"
                                 f"{np3[name]}")
    print(f"cpu reference runs equal numpy for q3, q10, q4, q22 and topn "
          f"({time.perf_counter() - t0:.1f} s)")

    gpu3 = {c: cats[c].blocks("cuda") for c in cats}
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    fused_before = SF_.FUSE_STATS["count"]
    for name, plan_fn, c in slice3:
        JP.LAUNCHES = 0
        out, summary = run_query(plan_fn(), gpu3[c])
        torch.cuda.synchronize()
        if summary.device != "cuda:0" or summary.retries:
            raise AssertionError(f"{name}: ran on {summary.device} with "
                                 f"{summary.retries} retries")
        if JP.LAUNCHES != joins3[name]:
            raise AssertionError(f"{name}: {JP.LAUNCHES} join_probe launches, the CPU "
                                 f"run's dense joins predict {joins3[name]}")
        got = block_result(out)
        if got != cpu3[name]:
            raise AssertionError(f"{name}: cuda result != cpu result\n{got}\n{cpu3[name]}")
        if got[0] != np3[name]:
            raise AssertionError(f"{name}: cuda result != numpy")
        print(f"{name} sf{SF} on cuda: {summary.result_rows} rows, join_probe launches "
              f"{JP.LAUNCHES} (as predicted), bit-exact vs port CPU run and numpy")
        if name in ("q3", "q22"):
            print(f"  {name} rows: {got[0]}")
    if (SA.LAUNCHES or DA.LAUNCHES or ST.LAUNCHES
            or SF_.FUSE_STATS["count"] != fused_before):
        raise AssertionError("q3/q10/q4/q22/topn reached an aggregation kernel or the "
                             "fused path")
    for name, plan_fn, c in slice3:
        plan, tables = plan_fn(), gpu3[c]
        q_ms = time_ms(lambda: run_query(plan, tables), WARM_RUNS)
        print(f"{name} sf{SF} run_query median {q_ms:.3f} ms over {WARM_RUNS} warm "
              f"runs [{card}]")
    del gpu3

    t0 = time.perf_counter()
    big = {"big": topn_100m_block(device="cuda")}
    torch.cuda.synchronize()
    n_big = big["big"].capacity
    print(f"topn_100m block: {n_big} rows made on the card from its seed in "
          f"{time.perf_counter() - t0:.2f} s")
    out, summary = run_query(topn_100m_plan(TOPN_LIMIT), big)
    if summary.device != "cuda:0":
        raise AssertionError(f"topn_100m: result on {summary.device}")
    k_host = big["big"]["k"].data.cpu().numpy()
    want = numpy_topn(k_host, {"k": k_host, "v": big["big"]["v"].data.cpu().numpy()},
                      TOPN_LIMIT)
    del k_host
    if out.to_pylists() != want:
        raise AssertionError("topn_100m: cuda result != numpy")
    print(f"topn_100m on cuda: {summary.result_rows} rows of {n_big}, bit-exact vs numpy")
    plan = topn_100m_plan(TOPN_LIMIT)
    q_ms = time_ms(lambda: run_query(plan, big), WARM_RUNS)
    print(f"topn_100m run_query median {q_ms:.3f} ms over {WARM_RUNS} warm runs [{card}]")
    del big

    # ---- 7. Q2-Q21 at SF1 on the eight-table catalog ---------------------------
    cat8, gpu8, cpu8, joins8 = eight_table_phase(card)

    # ---- 8. spec-form Q4, Q8, Q12 and Q14 on the eight-table catalog ------------
    spec_joins.update(spec_phase(card, ("q4", "q8", "q12", "q14"), cat8.blocks("cpu"), gpu8,
                                 {"q8": cpu8["q8"], "q12": cpu8["q12"]}))
    del gpu8

    # ---- 9. the analytic plans at SF1, serialized, on both catalogs ---------------
    t0 = time.perf_counter()
    cpu_runs = analytic_cpu.get()
    print(f"analytic plans' CPU runs ready ({time.perf_counter() - t0:.1f} s of waiting)")
    analytic_launches = analytics_phase(card, cat, cat8, cpu_runs)

    # ---- 10. the product slice: vector search, the .tbl loader, the service -------
    t0 = time.perf_counter()
    vector = vector_phase(card)
    loader = loader_phase(card, cat, cpu_res, np_res)
    service = service_phase(card, cat8)
    print(f"vector, loader and service phases: {time.perf_counter() - t0:.1f} s "
          f"({vector['ms']['l2']:.4f} ms l2 search, {loader['parse_mb_s']:.1f} MB/s parse, "
          f"q1 over HTTP {service['http_ms']['q1']:.3f} ms) [{card}]")

    # ---- 11. the distribution slice: SF1 over eight shards of the card -----------
    t0 = time.perf_counter()
    cpu_mesh_runs = mesh_cpu.get()
    print(f"mesh plans' CPU runs ready ({time.perf_counter() - t0:.1f} s of waiting)")
    # EXPLAIN ANALYZE of Q7-pairs, once the worker process is idle
    explain_phase(card, gpu7)
    mesh = mesh_phase(card, cat, cat8, cpu_mesh_runs)

    # ---- 12. the SQL front end: the parity scripts, TPC-H Q1 and Q6 as SQL text ----
    sql = sql_phase(card, SA, DA, ST)
    sql_launches = {k: {q: v[k] for q, v in sql["launches"].items()}
                    for k in ("stream_tile", "direct_agg", "stream_agg")}

    # ---- 13. the judges: generated plans, both kernels' shapes and the mesh,
    # held against the port's oracle
    judged = oracle_phase(card, SA, DA, ST)
    oracle_launches = {k: v["read"] for k, v in judged["launches"].items()}

    join_main = {**{f"{k}_spec": v for k, v in spec_joins.items()}, **joins7, **joins3,
                 **joins8}
    if not sum(join_main.values()):
        raise AssertionError("no main-path run launched join_probe")
    q1y = stream_y["q1"]
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "share_of_bound")

    def entry(name, replaces, launches, max_abs, y):
        return {"name": name, "route": "cuda",
                "source": f"tiflash_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                "launches": launches, "max_abs_err": max_abs, "ms": y["ms"],
                "plain_ms": y["plain_ms"], "bound_ms": y["bound_ms"],
                "bound_by": "bytes", "library_ms": y["library_ms"],
                "share_of_bound": y["bound_ms"] / y["ms"]}

    # the fuse cases, Q1, Q6 and Q1 at SF10, each kernel == plain
    tile_err = max(tile_err, tile_y["q1"]["max_abs_err"], tile_y["q6"]["max_abs_err"],
                   sf10["max_abs_err"], sql["max_abs_err"]["stream_tile"],
                   judged["max_abs_err"]["stream_tile"])
    design = ("design_bound_ms", "share_of_design_bound")
    tile = dict(entry("stream_tile", "tiflash_tpu/ops/pallas/stream_agg.py:160",
                      main_path_launches, tile_err, tile_y["q1"]),
                source="tiflash_tpu_torch/csrc/stream_tile.cu.in",
                tile_function="tiflash_tpu/ops/pallas/stream_agg.py:88",
                loader_launches=loader["launches"],
                mesh_launches=mesh["stream_tile_launches"],
                sql_launches=sql_launches["stream_tile"],
                oracle_launches=oracle_launches["stream_tile"],
                service_launches={n: v["stream_tile"] for n, v in service["launches"].items()},
                unfused_ms=tile_y["q1"]["unfused_ms"], build_seconds=generated_build_s,
                **{k: tile_y["q1"][k] for k in design},
                q6={k: tile_y["q6"][k] for k in keys + ("unfused_ms",) + design},
                sf10_q1=sf10,
                q1_partitioned={"launches": ooc["q1_partitioned"]["launches"][1],
                                "partitions": ooc["q1_partitioned"]["pieces"],
                                **{k: ooc["q1_partitioned"]["stream_tile"][k] for k in
                                   keys + ("max_abs_err", "unfused_ms")}})
    print(json.dumps({"kernels": [
        # the planes kernel: off the main path since the generated kernel
        # (0 launches there), timed at the planes evaluate makes on the card
        dict(entry("stream_agg", "tiflash_tpu/ops/pallas/stream_agg.py:160",
                   planes_launches, max(max_err, sql["max_abs_err"]["stream_agg"],
                                        judged["max_abs_err"]["stream_agg"]), q1y),
             on_main_path=False,
             sql_launches=sql_launches["stream_agg"],
             oracle_launches=oracle_launches["stream_agg"],
             mesh_launches=mesh["stream_agg_launches"],
             q6={k: stream_y["q6"][k] for k in keys if k in stream_y["q6"]}),
        dict(entry("direct_agg", "tiflash_tpu/ops/pallas/direct_agg.py:116",
                   q7_launches, max(direct_err, mesh["direct_agg_max_abs_err"],
                                    sql["max_abs_err"]["direct_agg"],
                                    judged["max_abs_err"]["direct_agg"]), direct_y),
             analytics_launches=analytic_launches,
             mesh_launches=mesh["direct_agg_launches"],
             sql_launches=sql_launches["direct_agg"],
             oracle_launches=oracle_launches["direct_agg"],
             # Q7-pairs over the mesh: its per-shard calls, each kernel == plain
             mesh_q7_pairs={k: mesh["q7_pairs"][k] for k in (
                 "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")},
             mesh={n: v["direct_agg_launches"] for n, v in mesh["queries"].items()
                   if v["direct_agg_launches"]},
             service_launches={n: v["direct_agg"] for n, v in service["launches"].items()},
             sector_bound_ms=direct_y["sector_bound_ms"],
             # l_shipdate's range stats give a dense domain: each chunk's
             # partial takes the direct method, as the CPU dispatch predicts
             daily_revenue={"launches": ooc["daily_revenue"]["launches"][0],
                            "chunks": ooc["daily_revenue"]["pieces"],
                            **{k: ooc["daily_revenue"].get("direct_agg", {}).get(k) for k in (
                                "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}},
             ship_month={"launches": ship["launches"],
                         "max_abs_err": ship["max_abs_err"],
                         **{k: ship["yardsticks"][k] for k in (
                             "ms", "plain_ms", "bound_ms", "library_ms")}}),
        tile,
        # the unique join's dense probe (replaces no TPU kernel): launches
        # read on the main path (each query's run_query on the card,
        # counted from 0, equal to its CPU run's dense joins); timed at
        # SSB's date, customer and part joins over 60,010,680 probe slots
        {"name": "join_probe", "route": "cuda",
         "source": "tiflash_tpu_torch/csrc/join_probe.cu",
         "replaces": "none (the sorted probe: ops/merge.py probe_ranges_fast, then a take "
                     "per column)",
         "launches": sum(join_main.values()), "launches_by_query": join_main,
         "max_abs_err": 0,
         "bound_by": "bytes",
         **{k: join_y["date"][k] for k in ("ms", "plain_ms", "bound_ms", "share_of_bound",
                                           "dense_join_ms", "sorted_join_ms")},
         "shapes": join_y},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
