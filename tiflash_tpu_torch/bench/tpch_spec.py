"""TPC-H queries written with the specification's own expressions, and a
sweep of every ported scalar-function family over lineitem.

The builders of ``bench/tpch_queries.py`` fold ``date 'x' + interval``
into literals and write ``CASE WHEN`` as FILTER aggregates.  The plans
here keep the builders' predicates and constants but write those parts
as the specification (TPC-H 3.0.1, section 2.4) does:

- Q1  ``l_shipdate <= date '1998-12-01' - interval '90' day``;
- Q4  ``o_orderdate < date '1993-07-01' + interval '3' month``;
- Q6  ``l_shipdate < date '1994-01-01' + interval '1' year``;
- Q8  ``extract(year from o_orderdate)`` and
  ``sum(case when nation = 'BRAZIL' then volume else 0 end) / sum(volume)``;
- Q12 ``sum(case when o_orderpriority in ('1-URGENT', '2-HIGH') then 1
  else 0 end)`` and its complement;
- Q14 ``100.00 * sum(case when p_brand like 'Brand#2%' then rev else 0
  end) / sum(rev)``.

``functions_sweep_plan()`` is one Projection over lineitem with a column
or more of each function family (``SWEEP_FAMILIES``); ``SWEEP_ULPS``
states the ulp bound of each column computed by a transcendental
function, every other column is exact.
"""

from __future__ import annotations

import datetime
from dataclasses import replace
from decimal import Decimal as PyDecimal
from typing import Dict, Iterable, Optional

from ..core.dtypes import DATETIME, DURATION, FLOAT64, INT64, UINT64, Decimal
from ..expr.nodes import Expr, call, case_when, cast, col, if_, lit
from ..ops.aggregate import AggDesc
from ..ops.sort import SortKey
from ..plan import nodes as P
from . import tpch_queries as TQ


def _date(y: int, m: int, d: int) -> datetime.date:
    return datetime.date(y, m, d)


def _revenue() -> Expr:
    return col("l_extendedprice") * (lit(1.0) - col("l_discount"))


def q1_spec_plan() -> P.PlanNode:
    sort = TQ.q1_plan()
    agg = sort.child
    proj = agg.child
    filt = P.Selection(
        col("l_shipdate") <= call("date_sub_days", _date(1998, 12, 1), 90),
        proj.child.child)
    return replace(sort, child=replace(agg, child=replace(proj, child=filt)))


def q4_spec_plan() -> P.PlanNode:
    sort = TQ.q4_plan()
    agg = sort.child
    semi = agg.child
    start = _date(1993, 7, 1)
    orders = P.Selection(
        (col("o_orderdate") >= start)
        & (col("o_orderdate") < call("date_add_months", start, 3)),
        semi.probe.child)
    return replace(sort, child=replace(agg, child=replace(semi, probe=orders)))


def q6_spec_plan() -> P.PlanNode:
    agg = TQ.q6_plan()
    proj = agg.child
    start = _date(1994, 1, 1)
    filt = P.Selection(
        (col("l_shipdate") >= start)
        & (col("l_shipdate") < call("date_add_years", start, 1))
        & (col("l_discount") >= 0.05)
        & (col("l_discount") <= 0.07)
        & (col("l_quantity") < 24.0),
        proj.child.child)
    return replace(agg, child=replace(proj, child=filt))


def q8_spec_plan() -> P.PlanNode:
    plan = TQ.q8_plan()
    full = plan.child.child.child.child  # Sort <- share <- agg <- proj
    proj = P.Projection(
        {"o_year": call("extract", "YEAR", col("o_orderdate")),
         "volume": _revenue(),
         "brazil_volume": case_when(
             (col("supp_nation") == "BRAZIL", _revenue()), default=0)},
        full)
    agg = P.Aggregation(
        keys=["o_year"],
        aggs=[AggDesc("sum", "brazil_volume", "nation_volume"),
              AggDesc("sum", "volume", "total_volume")],
        child=proj)
    share = P.Projection(
        {"o_year": col("o_year"),
         "mkt_share": col("nation_volume") / col("total_volume")}, agg)
    return P.Sort([SortKey("o_year")], share)


def q12_spec_plan() -> P.PlanNode:
    plan = TQ.q12_plan()
    oj = plan.child.child.child  # Sort <- agg <- proj
    prio = col("o_orderpriority")
    proj = P.Projection(
        {"l_shipmode": col("l_shipmode"),
         "high": case_when((prio.in_("1-URGENT", "2-HIGH"), 1), default=0),
         "low": case_when(((prio != "1-URGENT") & (prio != "2-HIGH"), 1),
                          default=0)},
        oj)
    agg = P.Aggregation(
        ["l_shipmode"],
        [AggDesc("sum", "high", "high_line_count"),
         AggDesc("sum", "low", "low_line_count")],
        proj)
    return P.Sort([SortKey("l_shipmode")], agg)


def q14_spec_plan() -> P.PlanNode:
    plan = TQ.q14_plan()
    pj = plan.child.child.child  # Projection <- agg <- proj
    proj = P.Projection(
        {"rev": _revenue(),
         "promo_part": case_when(
             (call("like", col("p_brand"), lit("Brand#2%")), _revenue()),
             default=0)},
        pj)
    agg = P.Aggregation(
        [], [AggDesc("sum", "promo_part", "promo_rev"),
             AggDesc("sum", "rev", "total_rev")], proj)
    return P.Projection(
        {"promo_revenue": lit(PyDecimal("100.00")) * col("promo_rev")
         / col("total_rev")}, agg)


# spec query -> (spec builder, the builder it is compared with, whether
# the two yield the same quantity)
SPEC_QUERIES = {
    "q1": (q1_spec_plan, TQ.q1_plan, True),
    "q4": (q4_spec_plan, TQ.q4_plan, True),
    "q6": (q6_spec_plan, TQ.q6_plan, True),
    "q8": (q8_spec_plan, TQ.q8_plan, True),
    "q12": (q12_spec_plan, TQ.q12_plan, True),
    "q14": (q14_spec_plan, TQ.q14_plan, False),
}


# ---------------------------------------------------------------------------
# the function sweep
# ---------------------------------------------------------------------------

# derived inputs, made once below the sweep's Projection
_BASE = {
    "l_orderkey": col("l_orderkey"),
    "l_partkey": col("l_partkey"),
    "l_suppkey": col("l_suppkey"),
    "l_linenumber": col("l_linenumber"),
    "l_quantity": col("l_quantity"),
    "l_extendedprice": col("l_extendedprice"),
    "l_discount": col("l_discount"),
    "l_tax": col("l_tax"),
    "l_shipdate": col("l_shipdate"),
    "l_commitdate": col("l_commitdate"),
    "l_receiptdate": col("l_receiptdate"),
    "l_shipmode": col("l_shipmode"),
    "rev": _revenue(),
    "price_f": cast(col("l_extendedprice"), FLOAT64),
    "disc_f": cast(col("l_discount"), FLOAT64),
    "okey_u": cast(col("l_orderkey"), UINT64),
    "ship_ts": call("date_add_minutes", col("l_shipdate"),
                    col("l_partkey")),
    # NULL on every line number 3
    "ln_null": call("nullif", col("l_linenumber"), 3),
}

SWEEP_FAMILIES: Dict[str, Dict[str, Expr]] = {
    "date_parts": {
        "month": call("month", col("l_shipdate")),
        "day": call("day", col("l_shipdate")),
        "quarter": call("quarter", col("l_shipdate")),
        "dayofweek": call("dayofweek", col("l_shipdate")),
        "dayofyear": call("dayofyear", col("l_shipdate")),
        "week": call("week", col("l_shipdate")),
        "weekofyear": call("weekofyear", col("l_shipdate")),
        "yearweek": call("yearweek", col("l_shipdate")),
        "year_month": call("extract", "YEAR_MONTH", col("l_receiptdate")),
        "hour": call("hour", col("ship_ts")),
        "minute": call("minute", col("ship_ts")),
    },
    "date_arith": {
        "plus_month": call("date_add_months", col("l_shipdate"), 1),
        "minus_30d": call("date_sub", col("l_commitdate"), 30, "DAY"),
        "last_day": call("last_day", col("l_shipdate")),
        "datediff": call("datediff", col("l_receiptdate"), col("l_commitdate")),
        "plus_quarters": call("date_add_quarters", col("ship_ts"),
                              col("l_linenumber")),
        "to_days": call("to_days", col("l_shipdate")),
        "from_days": call("from_days", call("to_days", col("l_receiptdate"))),
        "unix_ts": call("unix_timestamp", col("ship_ts")),
    },
    "int_arith": {
        "okey_mod": call("mod", col("l_orderkey"), 7),
        "okey_div": call("div", col("l_orderkey"), col("l_linenumber") - 4),
        "okey_neg": call("negate", col("l_orderkey")),
        "key_abs": call("abs", col("l_partkey") - col("l_suppkey") * 20),
    },
    "decimal_arith": {
        "qty_mod": call("mod", col("l_quantity"), 7),
        "price_div_qty": call("div", col("l_extendedprice"), col("l_quantity")),
        "disc_neg": call("negate", col("l_discount")),
        "price_abs": call("abs", col("l_extendedprice") - 50000),
    },
    "round": {
        "rev_round": call("round", col("rev"), 2),
        "rev_floor": call("floor", col("rev"), 1),
        "rev_ceil": call("ceil", col("rev"), -1),
        "rev_truncate": call("truncate", col("rev"), 3),
    },
    "casts": {
        "price_double": col("price_f"),
        "qty_int": cast(col("l_quantity"), INT64),
        "disc_dec1": cast(col("l_discount"), Decimal(10, 1)),
        "tax_wide": cast(col("l_tax"), Decimal(30, 6)),
        "ship_datetime": cast(col("l_shipdate"), DATETIME),
        "line_time": cast(col("l_linenumber") * 3111, DURATION),
    },
    "float_math": {
        "price_sqrt": call("sqrt", col("price_f")),
        "price_ln": call("ln", col("price_f")),
        "disc_exp": call("exp", col("disc_f")),
        "price_pow": call("pow", col("price_f"), col("disc_f")),
        "price_sin": call("sin", col("price_f")),
        "price_round": call("round", col("price_f") / 7.0),
    },
    "bits": {
        "okey_and": call("bit_and", col("l_orderkey"), 255),
        "okey_xor_u": call("bit_xor", col("okey_u"), col("l_partkey")),
        "okey_shl": call("shift_left", col("l_orderkey"), col("l_linenumber")),
        "not_u_shr": call("shift_right", call("bit_not", col("okey_u")), 3),
        "part_bits": call("bit_count", col("l_partkey")),
        "not_u_mod": call("mod", call("bit_not", col("okey_u")), 1000),
        "not_u_div": call("div", call("bit_not", col("okey_u")),
                          col("l_linenumber")),
    },
    "nulls": {
        "ln_coalesce": call("coalesce", col("ln_null"), 0),
        "ln_if": if_(call("is_null", col("ln_null")), col("l_quantity"),
                     col("l_tax")),
        "ln_is_null": call("is_null", col("ln_null")),
        "ln_greatest": call("greatest", col("ln_null"), col("l_linenumber") - 1),
        "ln_least": call("least", col("ln_null"), 4),
        "ln_null_eq": call("null_eq", col("ln_null"), 4),
        "mode_case": case_when((col("l_shipmode") == "MAIL", 1),
                               (col("l_linenumber") > 3, 2), default=0),
    },
}

# columns from transcendental functions: their ulp bound between two
# math libraries (CUDA's libdevice, the CPU build's vectorized libm, XLA's
# approximations); every other sweep column is exact
SWEEP_ULPS = {"price_ln": 2, "disc_exp": 2, "price_pow": 4, "price_sin": 2}


def sweep_base_plan() -> P.PlanNode:
    """The sweep's inputs: lineitem's columns and the derived ones."""
    return P.Projection(dict(_BASE), P.TableScan("lineitem"))


def functions_sweep_plan(families: Optional[Iterable[str]] = None
                         ) -> P.PlanNode:
    """One Projection over lineitem with the columns of ``families``
    (every family by default)."""
    exprs: Dict[str, Expr] = {}
    for fam in families or SWEEP_FAMILIES:
        exprs.update(SWEEP_FAMILIES[fam])
    return P.Projection(exprs, sweep_base_plan())


__all__ = ["q1_spec_plan", "q4_spec_plan", "q6_spec_plan", "q8_spec_plan",
           "q12_spec_plan", "q14_spec_plan", "SPEC_QUERIES", "SWEEP_FAMILIES",
           "SWEEP_ULPS", "sweep_base_plan", "functions_sweep_plan"]
