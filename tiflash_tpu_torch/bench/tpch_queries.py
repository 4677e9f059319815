"""TPC-H Q1, Q6 and Q7 plans (counterpart of
``tiflash_tpu/bench/tpch_queries.py``).

The same plan trees as the reference's, plus ``q7_nation_pairs_plan``;
the other queries come with later slices of the port.
"""

from __future__ import annotations

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


__all__ = ["q1_plan", "q6_plan", "q7_plan", "q7_nation_pairs_plan"]
