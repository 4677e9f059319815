"""TPC-H Q1, Q3, Q4, Q6, Q7, Q10, Q22 and ORDER BY ... LIMIT plans
(counterpart of ``tiflash_tpu/bench/tpch_queries.py``).

The same plan trees as the reference's, plus ``q7_nation_pairs_plan``
and the 100M-row top-N block of ``bench.py``'s ``topn100m`` config
(``topn_100m_block``, ``topn_100m_plan``).  The other queries come with
later slices of the port.
"""

from __future__ import annotations

import torch

from ..core.block import Block, Column
from ..core.dtypes import INT64
from ..expr.nodes import call, col, lit
from ..ops.aggregate import AggDesc
from ..ops.sort import SortKey
from ..plan import nodes as P


def q1_plan() -> P.PlanNode:
    """Pricing summary report: scan+filter+8-agg group-by."""
    scan = P.TableScan(
        "lineitem",
        columns=[
            "l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate",
        ],
    )
    filt = P.Selection(col("l_shipdate") <= "1998-09-02", scan)
    proj = P.Projection(
        {
            "l_returnflag": col("l_returnflag"),
            "l_linestatus": col("l_linestatus"),
            "l_quantity": col("l_quantity"),
            "l_extendedprice": col("l_extendedprice"),
            "l_discount": col("l_discount"),
            "disc_price": col("l_extendedprice") * (lit(1.0) - col("l_discount")),
            "charge": col("l_extendedprice")
            * (lit(1.0) - col("l_discount"))
            * (lit(1.0) + col("l_tax")),
        },
        filt,
    )
    agg = P.Aggregation(
        keys=["l_returnflag", "l_linestatus"],
        aggs=[
            AggDesc("sum", "l_quantity", "sum_qty"),
            AggDesc("sum", "l_extendedprice", "sum_base_price"),
            AggDesc("sum", "disc_price", "sum_disc_price"),
            AggDesc("sum", "charge", "sum_charge"),
            AggDesc("avg", "l_quantity", "avg_qty"),
            AggDesc("avg", "l_extendedprice", "avg_price"),
            AggDesc("avg", "l_discount", "avg_disc"),
            AggDesc("count", None, "count_order"),
        ],
        child=proj,
    )
    return P.Sort([SortKey("l_returnflag"), SortKey("l_linestatus")], agg)


def q3_plan(agg_slots: int | None = None, rewrite: bool = True) -> P.PlanNode:
    """Shipping priority: 2 joins + group-by + topN.

    With ``rewrite`` (default) the plan goes through
    ``plan.rewrite.eager_aggregation``: the revenue aggregation is pushed
    below the orders join, turning the 3-key post-join aggregation into a
    single-key stream aggregation over the orderkey-clustered lineitem
    scan and a join over its groups."""
    cust = P.Selection(
        col("c_mktsegment") == "BUILDING",
        P.TableScan("customer", columns=["c_custkey", "c_mktsegment"]),
    )
    orders = P.Selection(
        col("o_orderdate") < "1995-03-15",
        P.TableScan("orders", columns=["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"]),
    )
    # custkey is unique on the build side, so the inner join acts as a semi
    j1 = P.Join(
        kind="inner",
        probe_keys=["o_custkey"],
        build_keys=["c_custkey"],
        probe=orders,
        build=cust,
        unique_build=True,
    )
    line = P.Selection(
        col("l_shipdate") > "1995-03-15",
        P.TableScan("lineitem", columns=["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"]),
    )
    j2 = P.Join(
        kind="inner",
        probe_keys=["l_orderkey"],
        build_keys=["o_orderkey"],
        probe=line,
        build=j1,
        unique_build=True,
    )
    proj = P.Projection(
        {
            "l_orderkey": col("l_orderkey"),
            "o_orderdate": col("o_orderdate"),
            "o_shippriority": col("o_shippriority"),
            "revenue_part": col("l_extendedprice") * (lit(1.0) - col("l_discount")),
        },
        j2,
    )
    agg = P.Aggregation(
        keys=["l_orderkey", "o_orderdate", "o_shippriority"],
        aggs=[AggDesc("sum", "revenue_part", "revenue")],
        child=proj,
        num_slots=agg_slots,
    )
    top = P.TopN(
        [SortKey("revenue", desc=True, nulls_first=False), SortKey("o_orderdate")],
        10,
        agg,
    )
    if rewrite:
        from ..plan.rewrite import eager_aggregation, prune_columns

        top = prune_columns(eager_aggregation(top))
    return top


def q4_plan() -> P.PlanNode:
    """Order priority checking: EXISTS semi-join + group-by count."""
    line = P.Selection(
        col("l_commitdate") < col("l_receiptdate"),
        P.TableScan("lineitem", columns=["l_orderkey", "l_commitdate", "l_receiptdate"]),
    )
    orders = P.Selection(
        (col("o_orderdate") >= "1993-07-01") & (col("o_orderdate") < "1993-10-01"),
        P.TableScan("orders", columns=["o_orderkey", "o_orderdate", "o_orderpriority"]),
    )
    semi = P.Join(
        kind="semi", probe_keys=["o_orderkey"], build_keys=["l_orderkey"],
        probe=orders, build=line, output_capacity=1,  # semi: capacity unused
    )
    agg = P.Aggregation(
        keys=["o_orderpriority"], aggs=[AggDesc("count", None, "order_count")],
        child=semi,
    )
    return P.Sort([SortKey("o_orderpriority")], agg)


def q6_plan() -> P.PlanNode:
    """Forecast revenue change: pure scan+filter+scalar agg."""
    scan = P.TableScan(
        "lineitem", columns=["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
    )
    filt = P.Selection(
        (col("l_shipdate") >= "1994-01-01")
        & (col("l_shipdate") < "1995-01-01")
        & (col("l_discount") >= 0.05)
        & (col("l_discount") <= 0.07)
        & (col("l_quantity") < 24.0),
        scan,
    )
    proj = P.Projection({"rev": col("l_extendedprice") * col("l_discount")}, filt)
    return P.Aggregation(keys=[], aggs=[AggDesc("sum", "rev", "revenue")], child=proj)


def _q7_join_graph() -> P.PlanNode:
    """lineitem (shipped 1995-1996) joined to supplier -> nation and to
    orders -> customer -> nation, all unique-build inner joins."""
    supp_n = P.Join(
        kind="inner", probe_keys=["s_nationkey"], build_keys=["n_nationkey"],
        probe=P.TableScan("supplier", columns=["s_suppkey", "s_nationkey"]),
        build=P.Projection({"n_nationkey": col("n_nationkey"),
                            "supp_nation": col("n_name")}, P.TableScan("nation")),
        unique_build=True,
    )
    cust_n = P.Join(
        kind="inner", probe_keys=["c_nationkey"], build_keys=["n_nationkey2"],
        probe=P.TableScan("customer", columns=["c_custkey", "c_nationkey"]),
        build=P.Projection({"n_nationkey2": col("n_nationkey"),
                            "cust_nation": col("n_name")}, P.TableScan("nation")),
        unique_build=True,
    )
    orders_c = P.Join(
        kind="inner", probe_keys=["o_custkey"], build_keys=["c_custkey"],
        probe=P.TableScan("orders", columns=["o_orderkey", "o_custkey"]),
        build=cust_n, unique_build=True,
    )
    line = P.Selection(
        (col("l_shipdate") >= "1995-01-01") & (col("l_shipdate") <= "1996-12-31"),
        P.TableScan("lineitem", columns=[
            "l_orderkey", "l_suppkey", "l_shipdate", "l_extendedprice", "l_discount"]),
    )
    ls = P.Join(kind="inner", probe_keys=["l_suppkey"], build_keys=["s_suppkey"],
                probe=line, build=supp_n, unique_build=True)
    return P.Join(kind="inner", probe_keys=["l_orderkey"], build_keys=["o_orderkey"],
                  probe=ls, build=orders_c, unique_build=True)


def q7_plan() -> P.PlanNode:
    """Volume shipping: 4-join chain, nation-pair filter, group by
    (supp_nation, cust_nation, year)."""
    pair = P.Selection(
        ((col("supp_nation") == "FRANCE") & (col("cust_nation") == "GERMANY"))
        | ((col("supp_nation") == "GERMANY") & (col("cust_nation") == "FRANCE")),
        _q7_join_graph(),
    )
    proj = P.Projection(
        {"supp_nation": col("supp_nation"), "cust_nation": col("cust_nation"),
         "l_year": call("year", col("l_shipdate")),
         "volume": col("l_extendedprice") * (lit(1.0) - col("l_discount"))},
        pair,
    )
    agg = P.Aggregation(
        keys=["supp_nation", "cust_nation", "l_year"],
        aggs=[AggDesc("sum", "volume", "revenue")], child=proj,
    )
    return P.Sort(
        [SortKey("supp_nation"), SortKey("cust_nation"), SortKey("l_year")], agg
    )


def q7_nation_pairs_plan() -> P.PlanNode:
    """Q7's join graph reported over all nation pairs: the same joins,
    shipdate Selection and ``volume`` projection, without the
    FRANCE/GERMANY Selection and without ``l_year``; revenue, average
    volume and line count per (supp_nation, cust_nation).

    It exists because its key domain reaches the ``direct_agg`` kernel:
    each nation key is nullable after the join, so it packs into 26
    slots, and the two give 676, inside the kernel branch's 65..4096."""
    proj = P.Projection(
        {"supp_nation": col("supp_nation"), "cust_nation": col("cust_nation"),
         "volume": col("l_extendedprice") * (lit(1.0) - col("l_discount"))},
        _q7_join_graph(),
    )
    agg = P.Aggregation(
        keys=["supp_nation", "cust_nation"],
        aggs=[AggDesc("sum", "volume", "revenue"),
              AggDesc("avg", "volume", "avg_volume"),
              AggDesc("count", None, "n_lines")],
        child=proj,
    )
    return P.Sort([SortKey("supp_nation"), SortKey("cust_nation")], agg)


def q10_plan(agg_slots=None) -> P.PlanNode:
    """Returned item reporting: join + high-cardinality group-by + topN."""
    line = P.Selection(
        col("l_returnflag") == "R",
        P.TableScan("lineitem", columns=["l_orderkey", "l_extendedprice", "l_discount", "l_returnflag"]),
    )
    orders = P.Selection(
        (col("o_orderdate") >= "1993-10-01") & (col("o_orderdate") < "1994-01-01"),
        P.TableScan("orders", columns=["o_orderkey", "o_custkey", "o_orderdate"]),
    )
    j1 = P.Join(
        kind="inner", probe_keys=["l_orderkey"], build_keys=["o_orderkey"],
        probe=line, build=orders, unique_build=True,
    )
    j2 = P.Join(
        kind="inner", probe_keys=["o_custkey"], build_keys=["c_custkey"],
        probe=j1, build=P.TableScan("customer", columns=["c_custkey", "c_nationkey", "c_acctbal"]),
        unique_build=True,
    )
    proj = P.Projection(
        {"c_custkey": col("o_custkey"), "c_acctbal": col("c_acctbal"),
         "rev": col("l_extendedprice") * (lit(1.0) - col("l_discount"))},
        j2,
    )
    agg = P.Aggregation(
        ["c_custkey", "c_acctbal"], [AggDesc("sum", "rev", "revenue")], proj,
        num_slots=agg_slots,
    )
    return P.TopN([SortKey("revenue", desc=True, nulls_first=False),
                   SortKey("c_custkey")], 20, agg)


def q22_plan() -> P.PlanNode:
    """Global sales opportunity: anti join against orders + scalar stats."""
    cust = P.Selection(col("c_acctbal") > 0.0, P.TableScan("customer", columns=["c_custkey", "c_acctbal"]))
    anti = P.Join(
        kind="anti", probe_keys=["c_custkey"], build_keys=["o_custkey"],
        probe=cust, build=P.TableScan("orders", columns=["o_custkey"]),
        output_capacity=1,
    )
    return P.Aggregation(
        [], [AggDesc("count", None, "numcust"), AggDesc("sum", "c_acctbal", "totacctbal"),
             AggDesc("avg", "c_acctbal", "avgbal")],
        anti,
    )


def sort_topn_plan(limit: int = 100) -> P.PlanNode:
    """ORDER BY ... LIMIT over a big column."""
    scan = P.TableScan("lineitem", columns=["l_orderkey", "l_extendedprice"])
    return P.TopN(
        [SortKey("l_extendedprice", desc=True, nulls_first=False)], limit, scan
    )


TOPN_100M_ROWS = 100_000_000


def topn_100m_block(n: int = TOPN_100M_ROWS, seed: int = 1,
                    device: str = "cuda") -> Block:
    """The table ``big`` of ``bench.py``'s ``topn100m`` config: ``k``, n
    non-negative 63-bit int64 keys from a seeded generator on ``device``,
    and ``v = arange(n)``.  The reference draws ``k`` with
    ``jax.random``; these bits are the port's own."""
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.randint(0, 2 ** 63 - 1, (n,), generator=g, dtype=torch.int64,
                      device=device)
    v = torch.arange(n, dtype=torch.int64, device=device)
    return Block.from_dict({"k": Column(k, None, INT64),
                            "v": Column(v, None, INT64, stats=(0, n - 1))})


def topn_100m_plan(limit: int = 100) -> P.PlanNode:
    """ORDER BY k DESC LIMIT 100 over ``topn_100m_block``."""
    return P.TopN([SortKey("k", desc=True, nulls_first=False)], limit,
                  P.TableScan("big", columns=["k", "v"]))


__all__ = ["q1_plan", "q3_plan", "q4_plan", "q6_plan", "q7_plan",
           "q7_nation_pairs_plan", "q10_plan", "q22_plan", "sort_topn_plan",
           "topn_100m_block", "topn_100m_plan", "TOPN_100M_ROWS"]
