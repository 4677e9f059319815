"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tiflash_tpu_torch/csrc`` (one
``nvcc`` per source, all at once): the planes kernel ``stream_agg.cu``,
``direct_agg.cu``, and the fused scan kernels that ``stream_tile.cu.in``
generates per plan for the run's fused aggregations (Q1, Q6 and the fuse
cases of ``tiflash_tpu_torch/testing/fuse_cases.py``, whose programs the
CPU reference runs give).  Holds each against its plain torch version on
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
  the runtime error of CAST(l_shipmode AS JSON); then Q1 at SF10 (about
  60M rows, Q1's columns only), whose ``sum_charge`` takes the two-limb
  recombination, against numpy alone;
- TPC-H Q7 and Q7 over all nation pairs over the five-table catalog
  (nation, supplier, customer, orders, lineitem), which join and then
  aggregate by the sort method (Q7) or the direct_agg kernel (Q7-pairs);
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
  predicts.

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


def cpu_run_with_spy(plan, tables):
    """One ``run_query`` on the CPU with a spy on the direct_agg kernel's
    branch and on the fused path, which launch a kernel on the card.
    Returns (block_result, retries, (branch calls, fused runs))."""
    from tiflash_tpu_torch.ops import aggregate as TA
    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.runtime.executor import run_query

    calls = []
    real_branch = TA._accumulate_direct_kernel
    TA._accumulate_direct_kernel = lambda *a: calls.append(1) or real_branch(*a)
    f0 = SF_.FUSE_STATS["count"]
    try:
        out, summary = run_query(plan, tables)
    finally:
        TA._accumulate_direct_kernel = real_branch
    return (block_result(out), summary.retries,
            (len(calls), SF_.FUSE_STATS["count"] - f0))


def card_run_checked(name: str, plan, tables, cpu_result, cpu_retries: int,
                     predicted) -> tuple:
    """One ``run_query`` on the card: it must launch the kernels the CPU
    dispatch predicts (a fused run launches the generated stream_tile
    kernel, never the planes kernel), take the CPU run's retries and equal
    its result.  Returns (result, summary, direct_agg launches, stream_tile
    launches)."""
    import torch

    from tiflash_tpu_torch.ops import stream_fuse as SF_
    from tiflash_tpu_torch.ops.cuda import direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
    from tiflash_tpu_torch.runtime.executor import run_query

    d0, s0, p0, f0 = DA.LAUNCHES, ST.LAUNCHES, SA.LAUNCHES, SF_.FUSE_STATS["count"]
    out, summary = run_query(plan, tables)
    torch.cuda.synchronize()
    direct, stream, fused = (DA.LAUNCHES - d0, ST.LAUNCHES - s0,
                             SF_.FUSE_STATS["count"] - f0)
    want_branch, want_fused = predicted
    if ((direct > 0) != (want_branch > 0) or fused != want_fused
            or (stream > 0) != (want_fused > 0) or SA.LAUNCHES != p0):
        raise AssertionError(
            f"{name}: direct_agg launches {direct}, stream_tile launches {stream}, "
            f"planes kernel launches {SA.LAUNCHES - p0}, "
            f"fused runs {fused}; the CPU dispatch predicts {want_branch} "
            f"direct_agg branch calls and {want_fused} fused runs")
    if summary.device != "cuda:0" or summary.retries != cpu_retries:
        raise AssertionError(f"{name}: ran on {summary.device} with "
                             f"{summary.retries} retries (CPU: {cpu_retries})")
    got = block_result(out)
    if got != cpu_result:
        raise AssertionError(f"{name}: cuda result != cpu result\n{got}\n{cpu_result}")
    return got, summary, direct, stream


def eight_table_phase(card: str, sf: float = SF):
    """Q2-Q21 and Q18 at threshold 300 on the eight-table catalog: each
    through ``run_query`` on the CPU (with a spy on the two kernels'
    branches), then on the card, bit-exact against the CPU run, six also
    against numpy; the card's launches must equal what the CPU dispatch
    predicts (none).  Prints each query's warm ``run_query`` median.
    Returns the catalog, its card tables and the CPU results."""
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
    for name, plan_fn in queries:
        got, summary, direct, stream = card_run_checked(
            name, plan_fn(), gpu8, cpu8[name], cpu_retries[name], predicted[name])
        checked = " and numpy" if name in NUMPY8 else ""
        print(f"{name} sf{sf} on cuda: {summary.result_rows} rows, {summary.retries} "
              f"retries {summary.overflow_nodes}, direct_agg launches {direct}, "
              f"stream_tile launches {stream}, bit-exact vs port CPU run{checked}")
        if name in ("q13", "q14", "q18_300"):
            print(f"  {name} rows: {got[0]}")
    for name, plan_fn in queries:
        plan = plan_fn()
        q_ms = time_ms(lambda: run_query(plan, gpu8), WARM_RUNS)
        print(f"{name} sf{sf} run_query median {q_ms:.3f} ms over {WARM_RUNS} warm "
              f"runs, {cpu_retries[name]} retries each [{card}]")
    return cat8, gpu8, cpu8


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
    ``run_query`` median beside its builder's and whether it fused."""
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
    for name in names:
        spec, _, _ = SPEC_QUERIES[name]
        card_run_checked(f"{name}_spec", spec(), gpu_tables, cpu[name],
                         retries[name], predicted[name])
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
          f"direct_agg launches {launches[1]} (as the CPU dispatch predicts: "
          f"{[predicted[n] for n in names]})")


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


def sf10_q1_phase(card: str, flush) -> dict:
    """TPC-H Q1 at SF10 (lineitem only, Q1's seven columns): one launch of
    the generated kernel over about 60M rows; ``sum_charge``'s bound passes
    2^62, so the fuse recombines its plane sums in two-limb wide decimals
    (``wide_out``).  Held bit-exact against numpy with Python integers (no
    CPU run of the port).  Prints the data generation time, the kernel
    source's generation time and build, the kernel's time and its bound."""
    import torch

    from tiflash_tpu_torch.bench.tpch_queries import q1_plan
    from tiflash_tpu_torch.ops import tile_program as TP
    from tiflash_tpu_torch.ops.cuda import build, stream_agg as SA, stream_tile as ST
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    t0 = time.perf_counter()
    cat = generate_tpch(sf=SF10, seed=SEED, tables=["lineitem"],
                        column_subset={"lineitem": Q1_COLUMNS})
    gen_s = time.perf_counter() - t0
    t = cat["lineitem"].block
    li = {n: t[n].data.numpy() for n in Q1_COLUMNS}
    li["rf_dict"] = t["l_returnflag"].dictionary
    li["ls_dict"] = t["l_linestatus"].dictionary
    want = numpy_q1(li)
    gpu = cat.blocks("cuda")
    n_rows = cat["lineitem"].row_count
    del cat, t, li
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
            "source_generation_s": src_s, "new_builds": new_builds, "max_abs_err": err}


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
    running ``analytics_cpu_runs``; returns (pool, pending result).  The
    caller terminates the pool."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    return pool, pool.apply_async(analytics_cpu_runs)


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


def main() -> int:
    """Checks the card, starts the analytic plans' CPU runs in a worker
    process (``analytics_cpu_runs``), runs every phase (``_main``), and
    stops the worker whatever happens."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    import tiflash_tpu_torch  # noqa: F401  (outside the repo this fails here)

    pool, analytic_cpu = start_analytics_cpu_runs()
    try:
        return _main(analytic_cpu)
    finally:
        pool.terminate()
        pool.join()


def _main(analytic_cpu) -> int:
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
    from tiflash_tpu_torch.ops.cuda import build, direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.ops.cuda import stream_tile as ST
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
    kernels = ("stream_agg", "direct_agg")
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
    max_err = check_stream_agg(SA, layouts["q1"], layouts["q6"], n_rows)
    direct_err = check_direct_agg(DA, cat7["lineitem"].row_count)
    tile_err = check_stream_tile(SA, ST, tile_cases)
    del tile_cases

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
    spec_phase(card, ("q1", "q6"), cpu_tables, gpu_tables,
               {"q1": cpu_res["q1"], "q6": cpu_res["q6"]})
    sweep_phase(card, cpu_tables, gpu_tables)
    ship = string_phase(card, cpu_tables, gpu_tables, li)
    del gpu_tables, cpu_tables

    # ---- 4c. Q1 at SF10: one launch over 60M rows, the two-limb recombination
    sf10 = sf10_q1_phase(card, flush)

    # ---- 5. Q7 and Q7 over all nation pairs at SF1 on the card -------------------
    gpu7 = cat7.blocks("cuda")
    torch.cuda.synchronize()
    SA.LAUNCHES = DA.LAUNCHES = ST.LAUNCHES = 0
    direct_per_query = {}
    for name, plan_fn in q7_plans:
        d0 = DA.LAUNCHES
        out, summary = run_query(plan_fn(), gpu7)
        torch.cuda.synchronize()
        direct_per_query[name] = DA.LAUNCHES - d0
        if SA.LAUNCHES or ST.LAUNCHES:
            raise AssertionError(f"{name}: launched a stream_agg kernel")
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
    cpu3 = {}
    for name, plan_fn, c in slice3:
        cpu3[name] = block_result(run_query(plan_fn(), cats[c].blocks("cpu"))[0])
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
        out, summary = run_query(plan_fn(), gpu3[c])
        torch.cuda.synchronize()
        if summary.device != "cuda:0" or summary.retries:
            raise AssertionError(f"{name}: ran on {summary.device} with "
                                 f"{summary.retries} retries")
        got = block_result(out)
        if got != cpu3[name]:
            raise AssertionError(f"{name}: cuda result != cpu result\n{got}\n{cpu3[name]}")
        if got[0] != np3[name]:
            raise AssertionError(f"{name}: cuda result != numpy")
        print(f"{name} sf{SF} on cuda: {summary.result_rows} rows, bit-exact vs port "
              f"CPU run and numpy")
        if name in ("q3", "q22"):
            print(f"  {name} rows: {got[0]}")
    if (SA.LAUNCHES or DA.LAUNCHES or ST.LAUNCHES
            or SF_.FUSE_STATS["count"] != fused_before):
        raise AssertionError("q3/q10/q4/q22/topn reached a kernel or the fused path")
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
    cat8, gpu8, cpu8 = eight_table_phase(card)

    # ---- 8. spec-form Q4, Q8, Q12 and Q14 on the eight-table catalog ------------
    spec_phase(card, ("q4", "q8", "q12", "q14"), cat8.blocks("cpu"), gpu8,
               {"q8": cpu8["q8"], "q12": cpu8["q12"]})
    del gpu8

    # ---- 9. the analytic plans at SF1, serialized, on both catalogs ---------------
    t0 = time.perf_counter()
    cpu_runs = analytic_cpu.get()
    print(f"analytic plans' CPU runs ready ({time.perf_counter() - t0:.1f} s of waiting)")
    analytic_launches = analytics_phase(card, cat, cat8, cpu_runs)

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
                   sf10["max_abs_err"])
    design = ("design_bound_ms", "share_of_design_bound")
    tile = dict(entry("stream_tile", "tiflash_tpu/ops/pallas/stream_agg.py:160",
                      main_path_launches, tile_err, tile_y["q1"]),
                source="tiflash_tpu_torch/csrc/stream_tile.cu.in",
                tile_function="tiflash_tpu/ops/pallas/stream_agg.py:88",
                unfused_ms=tile_y["q1"]["unfused_ms"], build_seconds=generated_build_s,
                **{k: tile_y["q1"][k] for k in design},
                q6={k: tile_y["q6"][k] for k in keys + ("unfused_ms",) + design},
                sf10_q1=sf10)
    print(json.dumps({"kernels": [
        # the planes kernel: off the main path since the generated kernel
        # (0 launches there), timed at the planes evaluate makes on the card
        dict(entry("stream_agg", "tiflash_tpu/ops/pallas/stream_agg.py:160",
                   planes_launches, max_err, q1y), on_main_path=False,
             q6={k: stream_y["q6"][k] for k in keys if k in stream_y["q6"]}),
        dict(entry("direct_agg", "tiflash_tpu/ops/pallas/direct_agg.py:116",
                   q7_launches, direct_err, direct_y),
             analytics_launches=analytic_launches,
             sector_bound_ms=direct_y["sector_bound_ms"],
             ship_month={"launches": ship["launches"],
                         "max_abs_err": ship["max_abs_err"],
                         **{k: ship["yardsticks"][k] for k in (
                             "ms", "plain_ms", "bound_ms", "library_ms")}}),
        tile,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
