"""TPC-H Q1 and Q6 plans (counterpart of ``tiflash_tpu/bench/tpch_queries.py``).

The same plan trees as the reference's; the other queries come with
later slices of the port.
"""

from __future__ import annotations

from ..expr.nodes import col, lit
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


__all__ = ["q1_plan", "q6_plan"]
