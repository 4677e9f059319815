"""TPC-H's 22 query plans and ORDER BY ... LIMIT (counterpart of
``tiflash_tpu/bench/tpch_queries.py``).

The same plan trees as the reference's builders, plus
``q7_nation_pairs_plan``, Q18's ``min_qty`` (TPC-H's own threshold of
300 makes its wide-decimal HAVING select rows), and the 100M-row top-N
block of ``bench.py``'s ``topn100m`` config (``topn_100m_block``,
``topn_100m_plan``).
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


def q6_plan(date: str = "1994-01-01", date_end: str = "1995-01-01",
            disc_lo: float = 0.05, disc_hi: float = 0.07,
            quantity: float = 24.0) -> P.PlanNode:
    """Forecast revenue change: pure scan+filter+scalar agg.  The
    arguments are TPC-H's substitution parameters (defaults: its
    validation values; DISCOUNT 0.06 gives the 0.05..0.07 window)."""
    scan = P.TableScan(
        "lineitem", columns=["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
    )
    filt = P.Selection(
        (col("l_shipdate") >= date)
        & (col("l_shipdate") < date_end)
        & (col("l_discount") >= disc_lo)
        & (col("l_discount") <= disc_hi)
        & (col("l_quantity") < quantity),
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


def q5_plan() -> P.PlanNode:
    """Local supplier volume: 4-way join chain + group-by (simplified: no
    supplier/nation identity condition beyond the chain)."""
    region = P.Selection(col("r_name") == "ASIA", P.TableScan("region"))
    nation = P.Join(
        kind="inner", probe_keys=["n_regionkey"], build_keys=["r_regionkey"],
        probe=P.TableScan("nation"), build=region, unique_build=True,
    )
    cust = P.Join(
        kind="inner", probe_keys=["c_nationkey"], build_keys=["n_nationkey"],
        probe=P.TableScan("customer", columns=["c_custkey", "c_nationkey"]),
        build=nation, unique_build=True,
    )
    orders = P.Selection(
        (col("o_orderdate") >= "1994-01-01") & (col("o_orderdate") < "1995-01-01"),
        P.TableScan("orders", columns=["o_orderkey", "o_custkey", "o_orderdate"]),
    )
    oc = P.Join(
        kind="inner", probe_keys=["o_custkey"], build_keys=["c_custkey"],
        probe=orders, build=cust, unique_build=True,
    )
    li = P.Join(
        kind="inner", probe_keys=["l_orderkey"], build_keys=["o_orderkey"],
        probe=P.TableScan("lineitem", columns=["l_orderkey", "l_extendedprice", "l_discount"]),
        build=oc, unique_build=True,
    )
    proj = P.Projection(
        {"n_name": col("n_name"),
         "rev": col("l_extendedprice") * (lit(1.0) - col("l_discount"))},
        li,
    )
    agg = P.Aggregation(["n_name"], [AggDesc("sum", "rev", "revenue")], proj)
    return P.Sort([SortKey("revenue", desc=True, nulls_first=False)], agg)


def q12_plan() -> P.PlanNode:
    """Shipping modes: CASE-style conditional counts via -If filters."""
    line = P.Selection(
        (col("l_receiptdate") >= "1994-01-01") & (col("l_receiptdate") < "1995-01-01")
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & col("l_shipmode").in_("MAIL", "SHIP"),
        P.TableScan("lineitem"),
    )
    oj = P.Join(
        kind="inner", probe_keys=["l_orderkey"], build_keys=["o_orderkey"],
        probe=line, build=P.TableScan("orders", columns=["o_orderkey", "o_orderpriority"]),
        unique_build=True,
    )
    proj = P.Projection(
        {"l_shipmode": col("l_shipmode"),
         "is_high": col("o_orderpriority").in_("1-URGENT", "2-HIGH"),
         "is_low": ~col("o_orderpriority").in_("1-URGENT", "2-HIGH")},
        oj,
    )
    agg = P.Aggregation(
        ["l_shipmode"],
        [AggDesc("count", None, "high_line_count", filter_col="is_high"),
         AggDesc("count", None, "low_line_count", filter_col="is_low")],
        proj,
    )
    return P.Sort([SortKey("l_shipmode")], agg)


def q14_plan() -> P.PlanNode:
    """Promotion effect: conditional-sum ratio over a join."""
    line = P.Selection(
        (col("l_shipdate") >= "1995-09-01") & (col("l_shipdate") < "1995-10-01"),
        P.TableScan("lineitem", columns=["l_partkey", "l_extendedprice", "l_discount", "l_shipdate"]),
    )
    pj = P.Join(
        kind="inner", probe_keys=["l_partkey"], build_keys=["p_partkey"],
        probe=line, build=P.TableScan("part", columns=["p_partkey", "p_brand"]),
        unique_build=True,
    )
    proj = P.Projection(
        {"rev": col("l_extendedprice") * (lit(1.0) - col("l_discount")),
         "is_promo": call("like", col("p_brand"), lit("Brand#2%"))},
        pj,
    )
    agg = P.Aggregation(
        [],
        [AggDesc("sum", "rev", "promo_rev", filter_col="is_promo"),
         AggDesc("sum", "rev", "total_rev")],
        proj,
    )
    return P.Projection(
        {"promo_share": col("promo_rev") / col("total_rev")}, agg
    )


def q16_plan() -> P.PlanNode:
    """Supplier relationship: anti join + count_distinct group-by."""
    ps = P.Join(
        kind="inner", probe_keys=["ps_partkey"], build_keys=["p_partkey"],
        probe=P.TableScan("partsupp", columns=["ps_partkey", "ps_suppkey"]),
        build=P.Selection(col("p_size") <= 25, P.TableScan("part", columns=["p_partkey", "p_brand", "p_size"])),
        unique_build=True,
    )
    agg = P.Aggregation(
        ["p_brand"], [AggDesc("count_distinct", "ps_suppkey", "supplier_cnt")],
        ps,
    )
    return P.Sort([SortKey("supplier_cnt", desc=True, nulls_first=False),
                   SortKey("p_brand")], agg)


# The remaining TPC-H shapes: each mirrors the reference's plan
# structure (joins, aggregation, HAVING, CTE and semi/anti nesting) on
# the generated schema.


Q18_MIN_QTY = 21000


def q2_plan() -> P.PlanNode:
    """Minimum-cost supplier: agg-min + join back on (partkey, min cost) —
    the correlated-subquery shape (two-key equality join)."""
    europe_supp = P.Join(
        kind="inner", probe_keys=["s_nationkey"], build_keys=["n_nationkey"],
        probe=P.TableScan("supplier", columns=["s_suppkey", "s_nationkey", "s_acctbal"]),
        build=P.Join(
            kind="inner", probe_keys=["n_regionkey"], build_keys=["r_regionkey"],
            probe=P.TableScan("nation"),
            build=P.Selection(col("r_name") == "EUROPE", P.TableScan("region")),
            unique_build=True,
        ),
        unique_build=True,
    )
    ps = P.Join(
        kind="inner", probe_keys=["ps_suppkey"], build_keys=["s_suppkey"],
        probe=P.TableScan("partsupp"), build=europe_supp, unique_build=True,
    )
    min_cost = P.Aggregation(
        keys=["ps_partkey"], aggs=[AggDesc("min", "ps_supplycost", "min_cost")],
        child=ps,
    )
    # join back: rows achieving the per-part minimum
    best = P.Join(
        kind="inner", probe_keys=["ps_partkey", "ps_supplycost"],
        build_keys=["ps_partkey_m", "min_cost"],
        probe=ps,
        build=P.Projection(
            {"ps_partkey_m": col("ps_partkey"), "min_cost": col("min_cost")},
            min_cost,
        ),
        unique_build=True,
    )
    sized = P.Join(
        kind="inner", probe_keys=["ps_partkey"], build_keys=["p_partkey"],
        probe=best,
        build=P.Selection(col("p_size") == 15,
                          P.TableScan("part", columns=["p_partkey", "p_size", "p_brand"])),
        unique_build=True,
    )
    return P.TopN(
        [SortKey("s_acctbal", desc=True), SortKey("ps_partkey")], 100, sized
    )


def q8_plan() -> P.PlanNode:
    """National market share: conditional-sum ratio per year (sum-If)."""
    brazil = P.Projection(
        {"n_nationkey2": col("n_nationkey"), "supp_nation": col("n_name")},
        P.TableScan("nation"),
    )
    supp_n = P.Join(
        kind="inner", probe_keys=["s_nationkey"], build_keys=["n_nationkey2"],
        probe=P.TableScan("supplier", columns=["s_suppkey", "s_nationkey"]),
        build=brazil, unique_build=True,
    )
    america_cust = P.Join(
        kind="inner", probe_keys=["c_nationkey"], build_keys=["n_nationkey"],
        probe=P.TableScan("customer", columns=["c_custkey", "c_nationkey"]),
        build=P.Join(
            kind="inner", probe_keys=["n_regionkey"], build_keys=["r_regionkey"],
            probe=P.TableScan("nation"),
            build=P.Selection(col("r_name") == "AMERICA", P.TableScan("region")),
            unique_build=True,
        ),
        unique_build=True,
    )
    orders = P.Selection(
        (col("o_orderdate") >= "1995-01-01") & (col("o_orderdate") <= "1996-12-31"),
        P.TableScan("orders", columns=["o_orderkey", "o_custkey", "o_orderdate"]),
    )
    oc = P.Join(kind="inner", probe_keys=["o_custkey"], build_keys=["c_custkey"],
                probe=orders, build=america_cust, unique_build=True)
    part = P.Selection(col("p_brand") == "Brand#34",
                       P.TableScan("part", columns=["p_partkey", "p_brand"]))
    lp = P.Join(kind="inner", probe_keys=["l_partkey"], build_keys=["p_partkey"],
                probe=P.TableScan("lineitem", columns=[
                    "l_orderkey", "l_partkey", "l_suppkey",
                    "l_extendedprice", "l_discount"]),
                build=part, unique_build=True)
    lps = P.Join(kind="inner", probe_keys=["l_suppkey"], build_keys=["s_suppkey"],
                 probe=lp, build=supp_n, unique_build=True)
    full = P.Join(kind="inner", probe_keys=["l_orderkey"], build_keys=["o_orderkey"],
                  probe=lps, build=oc, unique_build=True)
    proj = P.Projection(
        {"o_year": call("year", col("o_orderdate")),
         "volume": col("l_extendedprice") * (lit(1.0) - col("l_discount")),
         "is_brazil": col("supp_nation") == "BRAZIL"},
        full,
    )
    agg = P.Aggregation(
        keys=["o_year"],
        aggs=[AggDesc("sum", "volume", "nation_volume", filter_col="is_brazil"),
              AggDesc("sum", "volume", "total_volume")],
        child=proj,
    )
    share = P.Projection(
        {"o_year": col("o_year"),
         "mkt_share": col("nation_volume") / col("total_volume")},
        agg,
    )
    return P.Sort([SortKey("o_year")], share)


def q9_plan() -> P.PlanNode:
    """Product-type profit: 2-key partsupp join, profit expr, group by
    (nation, year)."""
    supp_n = P.Join(
        kind="inner", probe_keys=["s_nationkey"], build_keys=["n_nationkey"],
        probe=P.TableScan("supplier", columns=["s_suppkey", "s_nationkey"]),
        build=P.Projection({"n_nationkey": col("n_nationkey"),
                            "nation": col("n_name")}, P.TableScan("nation")),
        unique_build=True,
    )
    lp = P.Join(
        kind="inner", probe_keys=["l_partkey"], build_keys=["p_partkey"],
        probe=P.TableScan("lineitem", columns=[
            "l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
            "l_extendedprice", "l_discount"]),
        build=P.Selection(col("p_size") <= 25,
                          P.TableScan("part", columns=["p_partkey", "p_size"])),
        unique_build=True,
    )
    lps = P.Join(
        kind="inner", probe_keys=["l_partkey", "l_suppkey"],
        build_keys=["ps_partkey", "ps_suppkey"],
        probe=lp,
        build=P.TableScan("partsupp",
                          columns=["ps_partkey", "ps_suppkey", "ps_supplycost"]),
        unique_build=True,
    )
    lsn = P.Join(kind="inner", probe_keys=["l_suppkey"], build_keys=["s_suppkey"],
                 probe=lps, build=supp_n, unique_build=True)
    lo = P.Join(kind="inner", probe_keys=["l_orderkey"], build_keys=["o_orderkey"],
                probe=lsn,
                build=P.TableScan("orders", columns=["o_orderkey", "o_orderdate"]),
                unique_build=True)
    proj = P.Projection(
        {"nation": col("nation"), "o_year": call("year", col("o_orderdate")),
         "amount": col("l_extendedprice") * (lit(1.0) - col("l_discount"))
         - col("ps_supplycost") * col("l_quantity")},
        lo,
    )
    agg = P.Aggregation(keys=["nation", "o_year"],
                        aggs=[AggDesc("sum", "amount", "sum_profit")], child=proj)
    return P.Sort([SortKey("nation"), SortKey("o_year", desc=True)], agg)


def q11_plan() -> P.PlanNode:
    """Important stock: per-part value vs a global-fraction threshold
    (scalar aggregate broadcast via cross join + HAVING)."""
    german_ps = P.Join(
        kind="inner", probe_keys=["ps_suppkey"], build_keys=["s_suppkey"],
        probe=P.TableScan("partsupp"),
        build=P.Join(
            kind="inner", probe_keys=["s_nationkey"], build_keys=["n_nationkey"],
            probe=P.TableScan("supplier", columns=["s_suppkey", "s_nationkey"]),
            build=P.Selection(col("n_name") == "GERMANY", P.TableScan("nation")),
            unique_build=True,
        ),
        unique_build=True,
    )
    value_proj = P.Projection(
        {"ps_partkey": col("ps_partkey"),
         "value_part": col("ps_supplycost") * col("ps_availqty")},
        german_ps,
    )
    per_part = P.Aggregation(keys=["ps_partkey"],
                             aggs=[AggDesc("sum", "value_part", "value")],
                             child=value_proj)
    total = P.Aggregation(keys=[],
                          aggs=[AggDesc("sum", "value_part", "total_value")],
                          child=value_proj)
    joined = P.CrossJoin(probe=per_part, build=total)
    having = P.Selection(
        col("value") > col("total_value") * lit(0.0001), joined
    )
    return P.Sort([SortKey("value", desc=True)],
                  P.Projection({"ps_partkey": col("ps_partkey"),
                                "value": col("value")}, having))


def q13_plan(join_capacity: int | None = None) -> P.PlanNode:
    """Customer order-count distribution: LEFT OUTER join + double agg."""
    left = P.Join(
        kind="left", probe_keys=["c_custkey"], build_keys=["o_custkey"],
        probe=P.TableScan("customer", columns=["c_custkey"]),
        build=P.Selection(col("o_orderpriority") != "1-URGENT",
                          P.TableScan("orders", columns=[
                              "o_orderkey", "o_custkey", "o_orderpriority"])),
        output_capacity=join_capacity,
    )
    per_cust = P.Aggregation(keys=["c_custkey"],
                             aggs=[AggDesc("count", "o_orderkey", "c_count")],
                             child=left)
    dist = P.Aggregation(keys=["c_count"],
                         aggs=[AggDesc("count", None, "custdist")],
                         child=per_cust)
    return P.Sort([SortKey("custdist", desc=True), SortKey("c_count", desc=True)], dist)


def q15_plan() -> P.PlanNode:
    """Top supplier: CTE used twice (revenue table + its max)."""
    line = P.Selection(
        (col("l_shipdate") >= "1996-01-01") & (col("l_shipdate") < "1996-04-01"),
        P.TableScan("lineitem", columns=[
            "l_suppkey", "l_shipdate", "l_extendedprice", "l_discount"]),
    )
    revenue = P.Aggregation(
        keys=["l_suppkey"], aggs=[AggDesc("sum", "rev_part", "total_revenue")],
        child=P.Projection(
            {"l_suppkey": col("l_suppkey"),
             "rev_part": col("l_extendedprice") * (lit(1.0) - col("l_discount"))},
            line,
        ),
    )
    max_rev = P.Aggregation(keys=[],
                            aggs=[AggDesc("max", "total_revenue", "max_revenue")],
                            child=P.CTERef("revenue"))
    best = P.Selection(
        col("total_revenue") == col("max_revenue"),
        P.CrossJoin(probe=P.CTERef("revenue"), build=max_rev),
    )
    joined = P.Join(
        kind="inner", probe_keys=["l_suppkey"], build_keys=["s_suppkey"],
        probe=best, build=P.TableScan("supplier", columns=["s_suppkey"]),
        unique_build=True,
    )
    return P.WithCTE(
        defs={"revenue": revenue},
        child=P.Sort([SortKey("s_suppkey")],
                     P.Projection({"s_suppkey": col("l_suppkey"),
                                   "total_revenue": col("total_revenue")}, joined)),
    )


def q17_plan() -> P.PlanNode:
    """Small-quantity-order revenue: per-part avg joined back, correlated
    quantity threshold, scalar sum."""
    line = P.TableScan("lineitem", columns=["l_partkey", "l_quantity", "l_extendedprice"])
    avg_qty = P.Aggregation(keys=["l_partkey"],
                            aggs=[AggDesc("avg", "l_quantity", "avg_qty")],
                            child=line)
    brand = P.Selection(col("p_brand") == "Brand#23",
                        P.TableScan("part", columns=["p_partkey", "p_brand"]))
    lb = P.Join(kind="inner", probe_keys=["l_partkey"], build_keys=["p_partkey"],
                probe=line, build=brand, unique_build=True)
    la = P.Join(kind="inner", probe_keys=["l_partkey"], build_keys=["l_partkey_a"],
                probe=lb,
                build=P.Projection({"l_partkey_a": col("l_partkey"),
                                    "avg_qty": col("avg_qty")}, avg_qty),
                unique_build=True)
    small = P.Selection(col("l_quantity") < col("avg_qty") * lit(0.2), la)
    return P.Aggregation(
        keys=[], aggs=[AggDesc("sum", "l_extendedprice", "total_price")],
        child=small,
    )


def q18_plan(agg_slots: int | None = None,
             min_qty: int = Q18_MIN_QTY) -> P.PlanNode:
    """Large-volume customers: group-by + HAVING, join back, topN.

    ``sum(l_quantity)`` is a decimal(37,2) and ``min_qty`` aligns to its
    scale, so the reference's 21000 selects no order at any scale (no
    order sums past 350.00); ``min_qty=300`` is TPC-H's own threshold."""
    per_order = P.Aggregation(
        keys=["l_orderkey"], aggs=[AggDesc("sum", "l_quantity", "sum_qty")],
        child=P.TableScan("lineitem", columns=["l_orderkey", "l_quantity"]),
        num_slots=agg_slots,
    )
    big = P.Selection(col("sum_qty") > lit(min_qty, None), per_order)
    oj = P.Join(
        kind="inner", probe_keys=["o_orderkey"], build_keys=["l_orderkey"],
        probe=P.TableScan("orders", columns=["o_orderkey", "o_custkey", "o_orderdate"]),
        build=P.Projection({"l_orderkey": col("l_orderkey"),
                            "sum_qty": col("sum_qty")}, big),
        unique_build=True,
    )
    cj = P.Join(kind="inner", probe_keys=["o_custkey"], build_keys=["c_custkey"],
                probe=oj, build=P.TableScan("customer", columns=["c_custkey"]),
                unique_build=True)
    return P.TopN([SortKey("sum_qty", desc=True), SortKey("o_orderdate")], 100, cj)


def q19_plan() -> P.PlanNode:
    """Discounted revenue: disjunctive multi-clause predicate + join."""
    part = P.TableScan("part", columns=["p_partkey", "p_brand", "p_size"])
    lp = P.Join(kind="inner", probe_keys=["l_partkey"], build_keys=["p_partkey"],
                probe=P.TableScan("lineitem", columns=[
                    "l_partkey", "l_quantity", "l_extendedprice",
                    "l_discount", "l_shipmode"]),
                build=part, unique_build=True)
    cond = (
        ((col("p_brand") == "Brand#12") & (col("l_quantity") <= 1100)
         & (col("p_size") <= 5) & (col("l_shipmode") == "AIR"))
        | ((col("p_brand") == "Brand#23") & (col("l_quantity") <= 2000)
           & (col("p_size") <= 10) & (col("l_shipmode") == "SHIP"))
        | ((col("p_brand") == "Brand#34") & (col("l_quantity") <= 3000)
           & (col("p_size") <= 15))
    )
    rev = P.Projection(
        {"rev_part": col("l_extendedprice") * (lit(1.0) - col("l_discount"))},
        P.Selection(cond, lp),
    )
    return P.Aggregation(keys=[], aggs=[AggDesc("sum", "rev_part", "revenue")],
                         child=rev)


def q20_plan() -> P.PlanNode:
    """Potential part promotion: availability vs half the shipped quantity
    (agg join + semi-join chain)."""
    shipped = P.Aggregation(
        keys=["l_partkey", "l_suppkey"],
        aggs=[AggDesc("sum", "l_quantity", "shipped_qty")],
        child=P.Selection(
            (col("l_shipdate") >= "1994-01-01") & (col("l_shipdate") < "1995-01-01"),
            P.TableScan("lineitem", columns=[
                "l_partkey", "l_suppkey", "l_quantity", "l_shipdate"]),
        ),
    )
    ps = P.Join(
        kind="inner", probe_keys=["ps_partkey", "ps_suppkey"],
        build_keys=["l_partkey", "l_suppkey"],
        probe=P.TableScan("partsupp"),
        build=shipped, unique_build=True,
    )
    excess = P.Selection(
        col("ps_availqty") * lit(200, None) > col("shipped_qty"), ps
    )
    supp = P.Join(
        kind="semi", probe_keys=["s_suppkey"], build_keys=["ps_suppkey"],
        probe=P.Join(
            kind="inner", probe_keys=["s_nationkey"], build_keys=["n_nationkey"],
            probe=P.TableScan("supplier", columns=["s_suppkey", "s_nationkey"]),
            build=P.Selection(col("n_name") == "CANADA", P.TableScan("nation")),
            unique_build=True,
        ),
        build=excess,
    )
    return P.Sort([SortKey("s_suppkey")],
                  P.Projection({"s_suppkey": col("s_suppkey")}, supp))


def q21_plan() -> P.PlanNode:
    """Suppliers who kept orders waiting: the EXISTS / NOT-EXISTS pair as
    per-order distinct-supplier counts (multi-distinct agg + join)."""
    line = P.TableScan("lineitem", columns=[
        "l_orderkey", "l_suppkey", "l_commitdate", "l_receiptdate"])
    flagged = P.Projection(
        {"l_orderkey": col("l_orderkey"), "l_suppkey": col("l_suppkey"),
         "is_late": col("l_receiptdate") > col("l_commitdate")},
        line,
    )
    per_order = P.Aggregation(
        keys=["l_orderkey"],
        aggs=[AggDesc("count_distinct", "l_suppkey", "n_supp")],
        child=flagged,
    )
    per_order_late = P.Aggregation(
        keys=["l_orderkey"],
        aggs=[AggDesc("count_distinct", "l_suppkey", "n_late_supp")],
        child=P.Selection(col("is_late"), flagged),
    )
    both = P.Join(
        kind="inner", probe_keys=["l_orderkey"], build_keys=["l_orderkey_b"],
        probe=per_order,
        build=P.Projection({"l_orderkey_b": col("l_orderkey"),
                            "n_late_supp": col("n_late_supp")}, per_order_late),
        unique_build=True,
    )
    target_orders = P.Selection(
        (col("n_supp") > lit(1, None)) & (col("n_late_supp") == lit(1, None)), both
    )
    late_lines = P.Selection(
        col("l_receiptdate") > col("l_commitdate"), line
    )
    culprits = P.Join(
        kind="inner", probe_keys=["l_orderkey"], build_keys=["l_orderkey_t"],
        probe=late_lines,
        build=P.Projection({"l_orderkey_t": col("l_orderkey")}, target_orders),
        unique_build=True,
    )
    per_supp = P.Aggregation(
        keys=["l_suppkey"], aggs=[AggDesc("count", None, "numwait")],
        child=culprits,
    )
    return P.TopN([SortKey("numwait", desc=True), SortKey("l_suppkey")], 100, per_supp)


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


__all__ = ["q1_plan", "q2_plan", "q3_plan", "q4_plan", "q5_plan", "q6_plan",
           "q7_plan", "q7_nation_pairs_plan", "q8_plan", "q9_plan", "q10_plan",
           "q11_plan", "q12_plan", "q13_plan", "q14_plan", "q15_plan",
           "q16_plan", "q17_plan", "q18_plan", "q19_plan", "q20_plan",
           "q21_plan", "q22_plan", "sort_topn_plan", "topn_100m_block",
           "topn_100m_plan", "TOPN_100M_ROWS", "Q18_MIN_QTY"]
