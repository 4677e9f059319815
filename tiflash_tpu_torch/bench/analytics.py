"""Analytic SQL plans over TPC-H data: window functions, grouping sets,
the statistical, bit, quantile, string and sketch aggregates, outer and
null-aware joins, and UNION ALL over a partitioned table.

Every plan is built from the port's plan nodes only, and every node is
one the JAX package has, so the same tree runs in both packages (the
tests carry each plan over through ``plan/serde.py``).  They run on
TPC-H's lineitem catalog (``generate_tpch(..., tables=["lineitem"])``),
except Q13's outer-join forms and ``NOT IN``, which read the eight-table
catalog.  SQL spellings:

- ``rollup_report``: TPC-DS q36/q86's shape on Q1's aggregates:
  ``GROUP BY ROLLUP(l_shipmode, l_returnflag, l_linestatus)`` (an Expand
  of 4 sets), ``GROUPING()`` for the level, ``RANK() OVER (PARTITION BY
  level ORDER BY sum_charge DESC)``, ordered;
- ``window_report``: the top 3 lines per supplier by price, beside a
  running quantity per order, the previous ship date, a 5-row moving
  average, minimum and maximum of the price, and per ship mode the lines
  and quantity shipped within 7 days either side (a RANGE frame);
- ``stats_grouped`` / ``stats_first`` / ``stats_kmv`` / ``stats_stream``:
  ``var_samp``, ``stddev_pop`` of ``CAST(l_extendedprice AS DOUBLE)``,
  ``bit_xor``, the median quantity, ``group_concat(DISTINCT l_linestatus
  SEPARATOR ';')`` and a grouped ``approx_count_distinct`` (exact); then
  ``first(l_shipdate)`` over ship-date order with ``bit_and``/``bit_or``;
  a keyless ``approx_count_distinct(l_orderkey)`` (the KMV estimate); and
  float ``sum``/``avg`` per order by the stream method (1.5M groups at
  SF1);
- ``partitioned_q1``: Q1 over lineitem partitioned by ship year (a
  Union of seven partition scans, ``ship_year_partitions``);
- ``q13_right``, ``q13_full``: Q13 with its customer-orders join written
  as a right and as a full outer join (every order has a customer, so
  both equal Q13);
- ``not_in``, ``not_in_null``: ``l_suppkey NOT IN (SELECT s_suppkey FROM
  supplier WHERE s_suppkey <= 2000)``, and the same with one key made
  NULL by ``nullif``, which SQL's NOT IN turns into zero rows.

``CAST(l_extendedprice AS DOUBLE)`` is spelled ``COALESCE(l_extendedprice,
1e300)``: MySQL types a COALESCE of a DECIMAL and a DOUBLE as DOUBLE, and
the column is never NULL, so it gives the cast's doubles (the cast itself,
``expr/functions.py:cast_column``) on every device, in a call that the
plan wire format carries (it has no codec for ``Cast``).  ``pow(x, 1)``
would not do: CUDA's ``pow`` of two tensors may miss by an ulp.
"""

from __future__ import annotations

import datetime
from typing import Dict

import torch

from ..core.block import Block
from ..expr.nodes import call, col, lit
from ..ops.aggregate import AggDesc
from ..ops.sort import SortKey
from ..ops.window import WindowDesc
from ..plan import nodes as P
from . import tpch_queries as Q

Q1_CUTOFF = "1998-09-02"
ROLLUP_KEYS = ["l_shipmode", "l_returnflag", "l_linestatus"]
SHIP_YEARS = list(range(1992, 1999))
PARTITION_TABLES = [f"lineitem_{y}" for y in SHIP_YEARS]
NOT_IN_MAX_SUPPKEY = 2000
# group capacities (``Aggregation.num_slots``) from the keys' domains: the
# sort method's output, and what runs above it, is this many slots, not
# the input's rows; more groups would overflow and retry larger
ROLLUP_SLOTS = 128
STATS_SLOTS = 32
NOT_IN_NULL_KEY = 1000
Q1_COLUMNS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
              "l_returnflag", "l_linestatus", "l_shipdate"]


def _q1_aggs():
    return [
        AggDesc("sum", "l_quantity", "sum_qty"),
        AggDesc("sum", "l_extendedprice", "sum_base_price"),
        AggDesc("sum", "disc_price", "sum_disc_price"),
        AggDesc("sum", "charge", "sum_charge"),
        AggDesc("avg", "l_quantity", "avg_qty"),
        AggDesc("avg", "l_extendedprice", "avg_price"),
        AggDesc("avg", "l_discount", "avg_disc"),
        AggDesc("count", None, "count_order"),
    ]


def rollup_report_plan() -> P.PlanNode:
    """Q1's sums over ROLLUP(l_shipmode, l_returnflag, l_linestatus), the
    rollup level from GROUPING(), each level's groups ranked by charge."""
    scan = P.TableScan("lineitem", columns=Q1_COLUMNS + ["l_shipmode"])
    filt = P.Selection(col("l_shipdate") <= Q1_CUTOFF, scan)
    proj = P.Projection({
        **{k: col(k) for k in ROLLUP_KEYS},
        "l_quantity": col("l_quantity"),
        "l_extendedprice": col("l_extendedprice"),
        "l_discount": col("l_discount"),
        "disc_price": col("l_extendedprice") * (lit(1.0) - col("l_discount")),
        "charge": col("l_extendedprice") * (lit(1.0) - col("l_discount"))
        * (lit(1.0) + col("l_tax")),
    }, filt)
    sets = [ROLLUP_KEYS[:k] for k in range(len(ROLLUP_KEYS), -1, -1)]
    expand = P.Expand(sets, proj)
    aggs = _q1_aggs()
    # the group estimate a planner passes: ROLLUP of 7 ship modes, 3 flags
    # and 2 statuses has at most 42 + 21 + 7 + 1 = 71 groups
    agg = P.Aggregation(keys=ROLLUP_KEYS + ["groupingID"], aggs=aggs, child=expand,
                        num_slots=ROLLUP_SLOTS)
    gid = col("groupingID")
    # grouping(gid, ids...) is 1 where the column is rolled up: the sets
    # that keep l_linestatus are {1}, l_returnflag {1, 2}, l_shipmode
    # {1, 2, 3}
    level = (call("grouping", gid, lit(1)) + call("grouping", gid, lit(1), lit(2))
             + call("grouping", gid, lit(1), lit(2), lit(3)))
    named = P.Projection({**{k: col(k) for k in ROLLUP_KEYS}, "level": level,
                          **{a.name: col(a.name) for a in aggs}}, agg)
    ranked = P.Window(["level"], [SortKey("sum_charge", desc=True)],
                      [WindowDesc("rank", "charge_rank")], named)
    return P.Sort([SortKey("level"), SortKey("charge_rank")]
                  + [SortKey(k) for k in ROLLUP_KEYS], ranked)


def window_report_plan(top: int = 3) -> P.PlanNode:
    """Per supplier its ``top`` priciest lines, with window columns over
    the whole table: per order a running quantity, the previous ship
    date and a 5-row moving average, minimum and maximum of the price;
    per ship mode the lines and quantity shipped within 7 days either
    side of this line's ship date."""
    scan = P.TableScan("lineitem", columns=[
        "l_orderkey", "l_linenumber", "l_suppkey", "l_extendedprice",
        "l_quantity", "l_shipdate", "l_shipmode"])
    by_supplier = P.Window(["l_suppkey"], [SortKey("l_extendedprice", desc=True)],
                           [WindowDesc("rank", "price_rank")], scan)
    by_order = P.Window(["l_orderkey"], [SortKey("l_linenumber")], [
        WindowDesc("sum", "run_qty", arg="l_quantity"),
        WindowDesc("lag", "prev_ship", arg="l_shipdate"),
        WindowDesc("avg", "mov_avg", arg="l_extendedprice", frame=(2, 2)),
        WindowDesc("min", "mov_min", arg="l_extendedprice", frame=(2, 2)),
        WindowDesc("max", "mov_max", arg="l_extendedprice", frame=(2, 2)),
    ], by_supplier)
    by_mode = P.Window(["l_shipmode"], [SortKey("l_shipdate")], [
        WindowDesc("count", "ships_15d", frame=(7, 7), frame_type="range"),
        WindowDesc("sum", "qty_15d", arg="l_quantity", frame=(7, 7),
                   frame_type="range"),
    ], by_order)
    kept = P.Selection(col("price_rank") <= top, by_mode)
    return P.Sort([SortKey("l_suppkey"), SortKey("price_rank"), SortKey("l_orderkey"),
                   SortKey("l_linenumber")], kept)


def _price_as_double() -> P.PlanNode:
    return call("coalesce", col("l_extendedprice"), lit(1e300))


def stats_grouped_plan() -> P.PlanNode:
    """Per (ship mode, return flag): the variance and deviation of the
    price as a double, an XOR of part keys, the median quantity, the
    distinct line statuses and the number of distinct parts."""
    scan = P.TableScan("lineitem", columns=[
        "l_shipmode", "l_returnflag", "l_linestatus", "l_extendedprice",
        "l_partkey", "l_quantity"])
    proj = P.Projection({
        "l_shipmode": col("l_shipmode"), "l_returnflag": col("l_returnflag"),
        "l_linestatus": col("l_linestatus"), "l_partkey": col("l_partkey"),
        "l_quantity": col("l_quantity"), "price_d": _price_as_double()}, scan)
    agg = P.Aggregation(["l_shipmode", "l_returnflag"], [
        AggDesc("var_samp", "price_d", "var_price"),
        AggDesc("stddev_pop", "price_d", "sd_price"),
        AggDesc("bit_xor", "l_partkey", "xor_part"),
        AggDesc("quantile", "l_quantity", "median_qty", param=0.5),
        AggDesc("group_concat", "l_linestatus", "statuses", separator=";",
                distinct=True),
        AggDesc("approx_count_distinct", "l_partkey", "parts"),
    ], proj, num_slots=STATS_SLOTS)
    return P.Sort([SortKey("l_shipmode"), SortKey("l_returnflag")], agg)


def stats_first_plan() -> P.PlanNode:
    """Per (ship mode, return flag), over lines in ship-date order: the
    first ship date, an AND of part keys, an OR of supplier keys and the
    line count."""
    scan = P.TableScan("lineitem", columns=[
        "l_shipmode", "l_returnflag", "l_shipdate", "l_partkey", "l_suppkey",
        "l_orderkey", "l_linenumber"])
    ordered = P.Sort([SortKey("l_shipdate"), SortKey("l_orderkey"),
                      SortKey("l_linenumber")], scan)
    agg = P.Aggregation(["l_shipmode", "l_returnflag"], [
        AggDesc("first", "l_shipdate", "first_ship"),
        AggDesc("bit_and", "l_partkey", "and_part"),
        AggDesc("bit_or", "l_suppkey", "or_supp"),
        AggDesc("count", None, "n_lines"),
    ], ordered)
    return P.Sort([SortKey("l_shipmode"), SortKey("l_returnflag")], agg)


def stats_kmv_plan() -> P.PlanNode:
    """The keyless distinct-order estimate (KMV sketch) beside the line
    count."""
    scan = P.TableScan("lineitem", columns=["l_orderkey"])
    return P.Aggregation([], [
        AggDesc("approx_count_distinct", "l_orderkey", "approx_orders"),
        AggDesc("count", None, "n_lines"),
    ], scan)


def stats_stream_plan() -> P.PlanNode:
    """Per order the float sum and average of the price: the stream
    method over the orderkey-clustered lineitem."""
    scan = P.TableScan("lineitem", columns=["l_orderkey", "l_extendedprice"])
    proj = P.Projection({"l_orderkey": col("l_orderkey"),
                         "price_d": _price_as_double()}, scan)
    return P.Aggregation(["l_orderkey"], [
        AggDesc("sum", "price_d", "sum_price"),
        AggDesc("avg", "price_d", "avg_price"),
        AggDesc("count", None, "n_lines"),
    ], proj)


def partitioned_q1_plan() -> P.PlanNode:
    """TPC-H Q1 over lineitem partitioned by ship year: its scan is the
    Union of the seven partitions' scans."""
    plan = Q.q1_plan()
    sel = plan.child.child.child  # Sort -> Aggregation -> Projection -> Selection
    assert isinstance(sel, P.Selection) and isinstance(sel.child, P.TableScan)
    sel.child = P.partition_table_scan(PARTITION_TABLES, Q1_COLUMNS)
    sel.__post_init__()
    return plan


def ship_year_partitions(lineitem: Block) -> Dict[str, Block]:
    """lineitem split by the year of ``l_shipdate``, one table per year of
    ``SHIP_YEARS``, each on the input's device (as a table partitioned by
    RANGE on the ship year)."""
    days = lineitem["l_shipdate"].data.to(torch.int64)
    epoch = datetime.date(1970, 1, 1)
    out = {}
    for year, name in zip(SHIP_YEARS, PARTITION_TABLES):
        lo = (datetime.date(year, 1, 1) - epoch).days
        hi = (datetime.date(year + 1, 1, 1) - epoch).days
        rows = torch.nonzero((days >= lo) & (days < hi)).flatten()
        out[name] = lineitem.take(rows)
    return out


def q13_outer_plan(kind: str) -> P.PlanNode:
    """TPC-H Q13 with orders as the probe side and customer as the build
    side of a ``right_outer`` or ``full_outer`` join: the customers with
    no (non-urgent) order come from the unmatched build tail."""
    assert kind in ("right_outer", "full_outer")
    plan = Q.q13_plan()
    left = plan.child.child.child  # Sort -> Aggregation -> Aggregation -> Join
    assert isinstance(left, P.Join) and left.kind == "left"
    outer = P.Join(kind=kind, probe_keys=["o_custkey"], build_keys=["c_custkey"],
                   probe=left.build, build=left.probe, unique_build=True)
    per_cust = plan.child.child
    per_cust.child = outer
    per_cust.__post_init__()
    return plan


def not_in_plan(with_null: bool = False) -> P.PlanNode:
    """The lines whose supplier is NOT IN a subquery of suppliers (count
    and total quantity); ``with_null`` turns one subquery key into NULL,
    so NOT IN is never true."""
    sub = P.Selection(col("s_suppkey") <= NOT_IN_MAX_SUPPKEY,
                      P.TableScan("supplier", columns=["s_suppkey"]))
    key = (call("nullif", col("s_suppkey"), lit(NOT_IN_NULL_KEY)) if with_null
           else col("s_suppkey"))
    sub = P.Projection({"s_suppkey": key}, sub)
    lines = P.TableScan("lineitem", columns=["l_suppkey", "l_quantity"])
    anti = P.Join(kind="anti_null_aware", probe_keys=["l_suppkey"],
                  build_keys=["s_suppkey"], probe=lines, build=sub, unique_build=True)
    return P.Aggregation([], [AggDesc("count", None, "n_lines"),
                              AggDesc("sum", "l_quantity", "qty")], anti)


# name -> (plan builder, catalog: "lineitem" (plus its ship-year
# partitions) or "eight")
ANALYTICS = {
    "rollup_report": (rollup_report_plan, "lineitem"),
    "window_report": (window_report_plan, "lineitem"),
    "stats_grouped": (stats_grouped_plan, "lineitem"),
    "stats_first": (stats_first_plan, "lineitem"),
    "stats_kmv": (stats_kmv_plan, "lineitem"),
    "stats_stream": (stats_stream_plan, "lineitem"),
    "partitioned_q1": (partitioned_q1_plan, "lineitem"),
    "q13_right": (lambda: q13_outer_plan("right_outer"), "eight"),
    "q13_full": (lambda: q13_outer_plan("full_outer"), "eight"),
    "not_in": (lambda: not_in_plan(False), "eight"),
    "not_in_null": (lambda: not_in_plan(True), "eight"),
}


def lineitem_tables(blocks: Dict[str, Block]) -> Dict[str, Block]:
    """The lineitem catalog's tables plus lineitem's ship-year partitions."""
    return {**blocks, **ship_year_partitions(blocks["lineitem"])}


__all__ = ["ANALYTICS", "PARTITION_TABLES", "SHIP_YEARS", "lineitem_tables",
           "ship_year_partitions", "rollup_report_plan", "window_report_plan",
           "stats_grouped_plan", "stats_first_plan", "stats_kmv_plan",
           "stats_stream_plan", "partitioned_q1_plan", "q13_outer_plan",
           "not_in_plan"]
