"""String-function plans over TPC-H lineitem.

``strings_sweep_plan()`` is one Projection over lineitem with a column or
more of each string-function family (``STRING_SWEEP_FAMILIES``): case and
trim, lengths, hashes, substrings and pads, CONCAT and CONCAT_WS (the
latter a 3 x 2 x 7 cross LUT over l_returnflag, l_linestatus and
l_shipmode), positions, the regexp and JSON functions, integers to text
from range stats, text back to dates and numbers, date names, the TIME
functions, a CASE of string and numeric branches, EXTRACT from text, and
NULLs made by NULLIF.  Every column is exact: codes, integers, dates,
durations and NULLs.

``ship_month_plan()`` is the monthly shipping report of a BI dashboard::

    SELECT date_format(l_shipdate, '%Y-%m') AS ship_month,
           lower(l_shipmode) AS mode, count(*), sum(l_quantity),
           sum(l_extendedprice), avg(l_discount)
    FROM lineitem GROUP BY 1, 2 ORDER BY 1, 2

Its two string keys take the direct aggregation method over the product
of their dictionaries: at SF1, 79 months of ship dates x 7 modes = 553
slots, the ``direct_agg`` kernel's branch.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from ..core.dtypes import DATETIME, INT64, STRING
from ..expr.nodes import Expr, call, case_when, cast, col
from ..ops.aggregate import AggDesc
from ..ops.sort import SortKey
from ..plan import nodes as P

_LINE_COLUMNS = ("l_returnflag", "l_linestatus", "l_shipmode", "l_linenumber",
                 "l_shipdate", "l_commitdate", "l_receiptdate")

# derived inputs, made once below the sweep's Projection
_BASE = {
    **{c: col(c) for c in _LINE_COLUMNS},
    "ship_ts": call("date_add_minutes", col("l_shipdate"),
                    col("l_linenumber") * 97),
    "mode_json": call("json_object", "mode", col("l_shipmode")),
    "line_text": cast(col("l_linenumber"), STRING),
    "ship_ymd": call("date_format", col("l_shipdate"), "%Y-%m-%d"),
    # NULL on every MAIL line
    "mode_null": call("nullif", col("l_shipmode"), "MAIL"),
}

_MODE = col("l_shipmode")

STRING_SWEEP_FAMILIES: Dict[str, Dict[str, Expr]] = {
    "case_trim": {
        "mode_upper": call("upper", call("lower", _MODE)),
        "mode_lower": call("lower", _MODE),
        "mode_trim": call("trim", call("concat", _MODE, "  ")),
        "mode_ltrim": call("ltrim", call("concat_prefix", _MODE, "  ")),
        "mode_reverse": call("reverse", _MODE),
    },
    "lengths": {
        "mode_length": call("length", _MODE),
        "mode_char_length": call("char_length", _MODE),
        "mode_bit_length": call("bit_length", _MODE),
        "mode_ascii": call("ascii", _MODE),
        "line_length": call("length", col("l_linenumber")),
    },
    "hashes": {
        "mode_md5": call("md5", _MODE),
        "mode_sha1": call("sha1", _MODE),
        "mode_sha2": call("sha2", _MODE, 256),
        "mode_crc32": call("crc32", _MODE),
        "mode_hex": call("hex", _MODE),
    },
    "substrings": {
        "mode_substring": call("substring", _MODE, 2, 3),
        "mode_left": call("left", _MODE, 2),
        "mode_right": call("right", _MODE, 3),
        "flag_repeat": call("repeat", col("l_returnflag"), 3),
        "mode_replace": call("replace", _MODE, "A", "@"),
        "mode_insert": call("insert_str", _MODE, 2, 1, "é"),
        "mode_lpad": call("lpad", _MODE, 10, "*"),
        "status_rpad": call("rpad", col("l_linestatus"), col("l_linenumber"), "xy"),
        "mode_substring_index": call("substring_index",
                                     call("concat", _MODE, " x y"), " ", 2),
    },
    "concat": {
        "mode_concat": call("concat", _MODE, "-", 7),
        "flags_concat_ws": call("concat_ws", "|", col("l_returnflag"),
                                col("l_linestatus"), _MODE),
    },
    "search": {
        "mode_locate": call("locate", "A", _MODE),
        "mode_instr": call("instr", _MODE, "I"),
        "mode_strcmp": call("strcmp", _MODE, "MAIL"),
        "mode_find_in_set": call("find_in_set", _MODE, "AIR,MAIL,SHIP"),
        "mode_field": call("field", _MODE, "RAIL", "TRUCK"),
    },
    "regexp": {
        "mode_regexp_like": call("regexp_like", _MODE, "^[A-M]"),
        "mode_regexp_instr": call("regexp_instr", _MODE, "A"),
        "mode_regexp_substr": call("regexp_substr", _MODE, "[AEIOU]+"),
        "mode_regexp_replace": call("regexp_replace", _MODE, "[AEIOU]", "_"),
    },
    "json": {
        "json_mode": call("json_extract", col("mode_json"), "$.mode"),
        "json_mode_text": call("json_unquote",
                               call("json_extract", col("mode_json"), "$.mode")),
        "json_type": call("json_type", col("mode_json")),
        "json_length": call("json_length", col("mode_json")),
        "json_valid": call("json_valid", col("mode_json")),
        "json_cast": call("cast_as_json", call("json_quote", _MODE)),
    },
    "int_text": {
        "line_char": col("line_text"),
        "line_bin": call("bin", col("l_linenumber")),
        "line_format": call("format", col("l_linenumber") * 1000, 1),
    },
    "text_to": {
        "text_date": call("str_to_date", call("concat", col("line_text"), "-01-1995"),
                          "%m-%d-%Y"),
        "text_bigint": cast(call("concat", col("line_text"), "7"), INT64),
    },
    "date_names": {
        "ship_month": call("date_format", col("l_shipdate"), "%Y-%m"),
        "receipt_text": call("date_format", col("l_receiptdate"), "%W %M %e %Y"),
        "ship_monthname": call("monthname", col("l_shipdate")),
        "commit_dayname": call("dayname", col("l_commitdate")),
    },
    "time": {
        "line_sec_to_time": call("sec_to_time", col("l_linenumber") * 4000),
        "line_maketime": call("maketime", col("l_linenumber"),
                              col("l_linenumber") * 7, 30),
        "ship_timediff": call("timediff", col("ship_ts"),
                              cast(col("l_commitdate"), DATETIME)),
        "ship_to_seconds": call("to_seconds", col("l_shipdate")),
        "ship_addtime": call("addtime", col("ship_ts"),
                             call("sec_to_time", col("l_linenumber") * 1234)),
        "ship_time": call("time", cast(col("l_shipdate"), DATETIME)),
        "ts_time": call("time", col("ship_ts")),
        "ship_receipt_months": call("timestampdiff", "MONTH", col("l_shipdate"),
                                    col("l_receiptdate")),
        "ship_receipt_hours": call("timestampdiff", "HOUR", col("ship_ts"),
                                   col("l_receiptdate")),
    },
    "mixed": {
        "mode_or_line": case_when((col("l_linenumber") > 4, _MODE),
                                  default=col("l_linenumber")),
        "ymd_day": call("extract", "DAY", col("ship_ymd")),
        "ymd_year_month": call("extract", "YEAR_MONTH", col("ship_ymd")),
        "null_upper": call("upper", col("mode_null")),
        "null_length": call("length", col("mode_null")),
        "null_concat_ws": call("concat_ws", ",", col("mode_null"),
                               col("l_returnflag")),
    },
}


def strings_sweep_base_plan() -> P.PlanNode:
    """The sweep's inputs: lineitem's columns and the derived ones."""
    return P.Projection(dict(_BASE), P.TableScan("lineitem"))


def strings_sweep_plan(families: Optional[Iterable[str]] = None) -> P.PlanNode:
    """One Projection over lineitem with the columns of ``families``
    (every family by default)."""
    exprs: Dict[str, Expr] = {}
    for fam in families or STRING_SWEEP_FAMILIES:
        exprs.update(STRING_SWEEP_FAMILIES[fam])
    return P.Projection(exprs, strings_sweep_base_plan())


def ship_month_plan() -> P.PlanNode:
    proj = P.Projection(
        {"ship_month": call("date_format", col("l_shipdate"), "%Y-%m"),
         "mode": call("lower", col("l_shipmode")),
         "l_quantity": col("l_quantity"),
         "l_extendedprice": col("l_extendedprice"),
         "l_discount": col("l_discount")},
        P.TableScan("lineitem"))
    agg = P.Aggregation(
        ["ship_month", "mode"],
        [AggDesc("count", None, "count_order"),
         AggDesc("sum", "l_quantity", "sum_qty"),
         AggDesc("sum", "l_extendedprice", "sum_price"),
         AggDesc("avg", "l_discount", "avg_disc")],
        proj)
    return P.Sort([SortKey("ship_month"), SortKey("mode")], agg)


__all__ = ["STRING_SWEEP_FAMILIES", "strings_sweep_base_plan",
           "strings_sweep_plan", "ship_month_plan"]
