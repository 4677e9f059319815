"""Expression evaluation over a Block.

Counterpart of ``tiflash_tpu/expr/compile.py``.  Evaluation is eager:
each call runs torch operations on the block's tensors.

String predicates against literals (the comparisons and IN) are rewritten
into dictionary-code space (sorted dictionaries make codes
order-preserving).  Literals are typed against the operand they meet: a
date text against a DATE column becomes days since the epoch, a float
against a decimal column becomes an exact decimal mantissa.

Every string function is a host table over a domain: the argument's
dictionary, or the cross product of the argument domains (dictionaries,
value domains, range stats under 4096, capped at 65,536 combinations).
The table is copied to the column's own device once per evaluation and
gathered by code there; the output dictionary is Python's sorted set of
the results.  That covers LIKE/ILIKE, casts to strings, the transform
tables (``_STRING_TRANSFORMS`` ...), the k-ary forms (``lpad``,
``concat_ws``, ``elt``, ``json_object`` ...), DATE_FORMAT over a date's
range stats and the integer-to-string functions over an integer's range
or value domain.  A table entry that is an ``EvalError`` becomes a
per-row mask in ``runtime_errors``, which the fragment compiler folds
into flags over live rows (``plan/compiler.py``).

The call head resolves TiDB aliases, rejects empty calls of functions
that take arguments, and dispatches what the registry cannot type alone:
the string forms above, ROUND and its family over a decimal with a digit
argument, DATE_ADD/SUB by unit, EXTRACT, the query-clock and session
functions and RAND.  ``query_clock`` and ``query_timezone`` pin NOW() and
the session time zone for a scope.
"""

from __future__ import annotations

import bisect
import contextvars
import dataclasses
import datetime
import itertools
import json
import re
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.block import Block, Column
from ..core.dtypes import (
    BOOL,
    DATE,
    ZERO_DT_BASE_US,
    DataType,
    Decimal,
    FLOAT64,
    INT64,
    STRING,
    TypeKind,
    Vector,
    ZeroDateTime,
)
from ..runtime.errors import EngineError, EvalError
from . import regexp_json as _rj
from .functions import (
    _ALIASES,
    _and_validity,
    _civil_from_days,
    _date_days,
    _div_round_half_up,
    _codes,
    _f2i,
    _fdiv,
    _gather,
    _map_string_to_date,
    _map_string_to_datetime,
    _map_string_to_int,
    _map_string_to_string,
    _pow10,
    cast_column,
    dayname_of_string,
    get_function,
    monthname_of_string,
    parse_mysql_time,
    propagate_stats,
    round_decimal_frac,
    round_decimal_frac_dynamic,
)
from .nodes import Call, Cast, ColumnRef, Expr, Literal

_ORDER_CMPS = {"less", "less_or_equals", "greater", "greater_or_equals"}
_EQ_CMPS = {"equals", "not_equals"}

# --- query clock and session time zone ----------------------------------
# NOW()/CURDATE()/RAND() read one timestamp per query; ``run_query`` pins
# it around a run.  Unset, the wall clock is read at each call.
_QUERY_NOW_US: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "tiflash_torch_query_now_us", default=None)
_QUERY_TZ_US: "contextvars.ContextVar[int]" = contextvars.ContextVar(
    "tiflash_torch_query_tz_us", default=0)


def query_now_us() -> int:
    v = _QUERY_NOW_US.get()
    return int(time.time() * 1_000_000) if v is None else int(v)


def query_tz_us() -> int:
    """Session time-zone offset (microseconds east of UTC) of the scope.
    TIMESTAMP (tz-aware DATETIME) columns shift by it at read;
    UNIX_TIMESTAMP and FROM_UNIXTIME convert through it."""
    return int(_QUERY_TZ_US.get())


class _ScopedVar:
    var: contextvars.ContextVar

    def __init__(self, us: int):
        self.us = int(us)

    def __enter__(self):
        self._tok = self.var.set(self.us)
        return self

    def __exit__(self, *exc):
        self.var.reset(self._tok)
        return False


class query_clock(_ScopedVar):
    """``with query_clock(us):`` pins NOW()/CURDATE()/RAND() for the scope."""

    var = _QUERY_NOW_US


class query_timezone(_ScopedVar):
    """``with query_timezone(offset_us):`` sets the session time zone for
    the scope (SET time_zone)."""

    var = _QUERY_TZ_US


def parse_tz_offset_us(spec: str) -> int:
    """Session time-zone text ('+8:00', '-05:30', 'UTC', a named zone) ->
    microseconds east of UTC.  A named zone resolves to its current
    offset.  Raises ValueError on anything else."""
    s = spec.strip().upper()
    if s in ("UTC", "GMT", "SYSTEM", ""):
        return 0
    m = re.match(r"^([+-])(\d{1,2}):(\d{2})$", s)
    if m:
        sign = -1 if m.group(1) == "-" else 1
        return sign * (int(m.group(2)) * 3600
                       + int(m.group(3)) * 60) * 1_000_000
    try:
        import zoneinfo

        off = datetime.datetime.now(
            zoneinfo.ZoneInfo(spec.strip())).utcoffset()
        return int(off.total_seconds() * 1_000_000)
    except Exception:
        raise ValueError(f"unsupported time_zone {spec!r}") from None


_DATE_ADD_UNITS = {
    "DAY": "days", "WEEK": "weeks", "MONTH": "months", "QUARTER": "quarters",
    "YEAR": "years", "HOUR": "hours", "MINUTE": "minutes",
    "SECOND": "seconds", "MICROSECOND": "microseconds",
}

# EXTRACT units: (part function, decimal weight) terms summed
_EXTRACT_PARTS = {
    "YEAR": [("year", 1)],
    "QUARTER": [("quarter", 1)],
    "MONTH": [("month", 1)],
    "WEEK": [("week", 1)],
    "DAY": [("day_of_month", 1)],
    "HOUR": [("hour", 1)],
    "MINUTE": [("minute", 1)],
    "SECOND": [("second", 1)],
    "MICROSECOND": [("microsecond", 1)],
    "YEAR_MONTH": [("year", 100), ("month", 1)],
    "DAY_HOUR": [("day_of_month", 100), ("hour", 1)],
    "DAY_MINUTE": [("day_of_month", 10_000), ("hour", 100), ("minute", 1)],
    "DAY_SECOND": [("day_of_month", 1_000_000), ("hour", 10_000),
                   ("minute", 100), ("second", 1)],
    "HOUR_MINUTE": [("hour", 100), ("minute", 1)],
    "HOUR_SECOND": [("hour", 10_000), ("minute", 100), ("second", 1)],
    "MINUTE_SECOND": [("minute", 100), ("second", 1)],
    "SECOND_MICROSECOND": [("second", 1_000_000), ("microsecond", 1)],
    "MINUTE_MICROSECOND": [("minute", 100_000_000),
                           ("second", 1_000_000), ("microsecond", 1)],
    "HOUR_MICROSECOND": [("hour", 10_000_000_000), ("minute", 100_000_000),
                         ("second", 1_000_000), ("microsecond", 1)],
    "DAY_MICROSECOND": [("day_of_month", 1_000_000_000_000),
                        ("hour", 10_000_000_000), ("minute", 100_000_000),
                        ("second", 1_000_000), ("microsecond", 1)],
}

# functions a call without arguments is legal for (any other is MySQL's
# ERROR 1582 'Incorrect parameter count' at plan time)
_ZERO_ARG_OK = frozenset({
    "now", "sysdate", "current_timestamp", "curdate", "current_date",
    "curtime", "current_time", "utc_timestamp", "utc_date", "utc_time",
    "unix_timestamp", "rand", "uuid", "pi", "connection_id", "database",
    "version", "found_rows", "last_insert_id", "row_count", "user",
    "current_user", "json_object", "json_array", "uuid_short",
    "release_all_locks", "grouping",
})

# cross-product budget of a k-ary LUT (host evaluations and dictionary
# size; combinations, never rows)
_CROSS_LUT_CAP = 65536

# MySQL's GET_FORMAT table
_GET_FORMAT = {
    ("DATE", "USA"): "%m.%d.%Y", ("DATE", "JIS"): "%Y-%m-%d",
    ("DATE", "ISO"): "%Y-%m-%d", ("DATE", "EUR"): "%d.%m.%Y",
    ("DATE", "INTERNAL"): "%Y%m%d",
    ("DATETIME", "USA"): "%Y-%m-%d %H.%i.%s",
    ("DATETIME", "JIS"): "%Y-%m-%d %H:%i:%s",
    ("DATETIME", "ISO"): "%Y-%m-%d %H:%i:%s",
    ("DATETIME", "EUR"): "%Y-%m-%d %H.%i.%s",
    ("DATETIME", "INTERNAL"): "%Y%m%d%H%i%s",
    ("TIME", "USA"): "%h:%i:%s %p", ("TIME", "JIS"): "%H:%i:%s",
    ("TIME", "ISO"): "%H:%i:%s", ("TIME", "EUR"): "%H.%i.%s",
    ("TIME", "INTERNAL"): "%H%i%s",
}

# the session functions' constant texts
_SESSION_TEXT = {
    "version": "8.0.11-TiDB-tiflash-tpu-0.2",
    "database": "default", "schema": "default",
    "user": "root@%", "current_user": "root@%",
}


def infer_literal_dtype(value) -> DataType:
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        return INT64
    if isinstance(value, float):
        return FLOAT64
    if isinstance(value, str):
        return STRING
    if isinstance(value, datetime.datetime):
        return DataType(TypeKind.DATETIME)
    if isinstance(value, datetime.date):
        return DATE
    from decimal import Decimal as _D

    if isinstance(value, _D):
        return Decimal(18, max(0, -value.as_tuple().exponent))
    if isinstance(value, (list, tuple)):
        return Vector(len(value))
    raise TypeError(f"cannot infer literal type for {value!r}")


def _float_to_decimal(value: float) -> Optional[tuple]:
    """(mantissa, scale) if the float has a short exact decimal repr."""
    s = repr(float(value))
    if "e" in s or "E" in s:
        return None
    if "." in s:
        intpart, frac = s.split(".")
        scale = len(frac)
        if scale > 8:
            return None
        return int(intpart + frac), scale
    return int(s), 0


def _literal_us(value) -> int:
    """Datetime literal (text or date/datetime) -> epoch microseconds,
    keeping any time part."""
    if isinstance(value, str):
        value = datetime.datetime.fromisoformat(value.strip())
    if isinstance(value, datetime.date) and \
            not isinstance(value, datetime.datetime):
        value = datetime.datetime(value.year, value.month, value.day)
    return round((value - datetime.datetime(1970, 1, 1)).total_seconds()
                 * 1_000_000)


def _literal_days(value) -> int:
    if isinstance(value, str):
        # a full datetime text against a DATE column truncates its time
        s = value.strip()
        value = (datetime.datetime.fromisoformat(s).date()
                 if (" " in s or "T" in s)
                 else datetime.date.fromisoformat(s))
    if isinstance(value, datetime.datetime):
        value = value.date()
    return (value - datetime.date(1970, 1, 1)).days


def _doc_depth(v) -> int:
    """Nesting depth of a parsed JSON document (iterative: documents may
    nest past the interpreter's recursion limit)."""
    best, stack = 1, [(v, 1)]
    while stack:
        x, k = stack.pop()
        best = max(best, k)
        if isinstance(x, dict):
            stack.extend((c, k + 1) for c in x.values())
        elif isinstance(x, list):
            stack.extend((c, k + 1) for c in x)
    return best


class ExprEvaluator:
    """Evaluates a typed expression tree against one Block.

    ``runtime_errors`` collects (per-row bool mask, message) pairs from
    host tables whose entries are ``EvalError``; the fragment compiler
    drains them after each node."""

    def __init__(self, block: Block):
        self.block = block
        self.n = block.capacity
        self.device = block.device
        self.runtime_errors: list = []

    @classmethod
    def bare(cls, n: int, device) -> "ExprEvaluator":
        """An evaluator with no block, for the LUT methods alone (a string
        function's implicit text of a numeric argument)."""
        ev = cls.__new__(cls)
        ev.block, ev.n, ev.device, ev.runtime_errors = None, int(n), device, []
        return ev

    def _full(self, value, dtype: torch.dtype) -> torch.Tensor:
        return torch.full((self.n,), value, dtype=dtype, device=self.device)

    def evaluate(self, expr: Expr) -> Column:
        if isinstance(expr, ColumnRef):
            c = self.block[expr.name]
            if c.dtype.tz_aware and c.dtype.kind is TypeKind.DATETIME:
                off = query_tz_us()
                if off:
                    # a TIMESTAMP reads in session-local time; the result
                    # is wall time and drops tz_aware, so a later stage
                    # reading it does not shift it again
                    c = Column(
                        c.data + off, c.validity,
                        DataType(TypeKind.DATETIME, c.dtype.nullable),
                        stats=None if c.stats is None else
                        (c.stats[0] + off, c.stats[1] + off),
                        domain=None if c.domain is None
                        else tuple(int(v) + off for v in c.domain),
                        ndv=c.ndv)
            return c
        if isinstance(expr, Literal):
            return self._literal_column(expr, None)
        if isinstance(expr, Call):
            return self._call(expr)
        if isinstance(expr, Cast):
            src = self.evaluate(expr.arg)
            if expr.target.is_string and not src.dtype.is_string \
                    and src.data.ndim == 1:
                return self._cast_to_string_lut(src, expr.target)
            return cast_column(src, expr.target)
        raise TypeError(f"unknown expression node {expr!r}")

    # -- literals ---------------------------------------------------------

    def _literal_column(self, lit: Literal, context: Optional[Column]) -> Column:
        value = lit.value
        if value is None:
            ref = lit.dtype or (context.dtype if context is not None
                                else INT64)
            dt = ref.with_nullable(True)
            return Column(self._full(0, dt.torch_dtype),
                          self._full(False, torch.bool), dt)
        if isinstance(value, (list, tuple)):
            # a query vector: one constant row, broadcast to every row
            vec = torch.tensor(value, dtype=torch.float32, device=self.device)
            return Column(vec.expand(self.n, len(value)), None, Vector(len(value)))
        dt = lit.dtype or infer_literal_dtype(value)
        # contextual re-typing against the other operand
        if context is not None:
            cdt = context.dtype
            if cdt.is_string and isinstance(value, str):
                return self._encode_string_literal(value)
            if cdt.kind is TypeKind.DURATION and isinstance(value, str):
                us = parse_mysql_time(value)
                if us is None:  # an invalid TIME literal is NULL
                    return Column(self._full(0, torch.int64),
                                  self._full(False, torch.bool),
                                  DataType(TypeKind.DURATION, True))
                return Column(self._full(us, torch.int64), None,
                              DataType(TypeKind.DURATION))
            if cdt.is_temporal and isinstance(value, (str, datetime.date)):
                if cdt.kind is TypeKind.DATETIME:
                    us = _literal_us(value)
                    return Column(self._full(us, torch.int64), None,
                                  DataType(TypeKind.DATETIME))
                days = _literal_days(value)
                return Column(self._full(days, torch.int32), None, DATE)
            if cdt.is_numeric and isinstance(value, str):
                # numeric column vs string constant compares as DOUBLE
                mnum = re.match(
                    r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", value)
                return self._literal_column(
                    Literal(float(mnum.group(0)) if mnum else 0.0),
                    context)
            if cdt.is_decimal and isinstance(value, float):
                md = _float_to_decimal(value)
                if md is not None:
                    m, s = md
                    return Column(self._full(m, torch.int64), None,
                                  Decimal(18, s), stats=(m, m))
        if dt.is_string:
            return Column(self._full(0, torch.int32), None, STRING,
                          dictionary=(str(value),))
        from decimal import Decimal as _D

        if isinstance(value, _D):
            import decimal as _dec

            s = max(0, -value.as_tuple().exponent)
            m = int(value.scaleb(s, context=_dec.Context(prec=90)))
            if abs(m) < 2 ** 63:
                return Column(self._full(m, torch.int64), None,
                              Decimal(18, s), stats=(m, m))
            # a wide constant: limbs by the digit count
            t = Decimal(min(len(str(abs(m))), 65), s)
            limbs, mm = [], m
            for _ in range(t.decimal_limbs - 1):
                mm, r = divmod(mm, 10 ** 18)
                limbs.append(r)
            limbs.append(mm)
            data = torch.tensor(limbs[::-1], dtype=torch.int64,
                                device=self.device).expand(self.n, -1)
            return Column(data.contiguous(), None, t)
        if isinstance(value, ZeroDateTime):
            us = ZERO_DT_BASE_US + value.tod_us
            return Column(self._full(us, torch.int64), None,
                          DataType(TypeKind.DATETIME), stats=(us, us))
        if isinstance(value, datetime.datetime):
            us = round((value - datetime.datetime(1970, 1, 1))
                       .total_seconds() * 1e6)
            return Column(self._full(us, torch.int64), None,
                          DataType(TypeKind.DATETIME), stats=(us, us))
        if isinstance(value, datetime.date):
            days = (value - datetime.date(1970, 1, 1)).days
            return Column(self._full(days, torch.int32), None, DATE,
                          stats=(days, days))
        if isinstance(value, int) and not isinstance(value, bool):
            lo, hi = -(2 ** 63), 2 ** 63 - 1
            if dt.kind is TypeKind.UINT64:
                lo, hi = 0, 2 ** 64 - 1
            if not (lo <= value <= hi):
                # past 64 bits: DECIMAL semantics
                return self._literal_column(Literal(_D(value)), context)
            if dt.kind is TypeKind.UINT64:  # filled as int64 bit patterns
                bits = value - 2 ** 64 if value >= 2 ** 63 else value
                return Column(self._full(bits, torch.int64).view(torch.uint64),
                              None, dt, stats=(value, value))
        st = (int(value), int(value)) if isinstance(value, (int, bool)) else None
        return Column(self._full(value, dt.torch_dtype), None, dt, stats=st)

    def _encode_string_literal(self, value: str) -> Column:
        """Literal -> a constant string column in its OWN 1-entry
        dictionary; ``_harmonize_string_args`` merges code spaces."""
        return Column(self._full(0, torch.int32), None, STRING,
                      dictionary=(value,))

    def _harmonize_string_args(self, args):
        """Re-encode all 1-D string arguments into one merged sorted
        dictionary.  Returns (new_args, merged_dictionary or None)."""
        strs = [
            (i, a) for i, a in enumerate(args)
            if a.dtype.is_string and a.data.ndim == 1
        ]
        if not strs:
            return args, None
        dicts = [a.dictionary or () for _, a in strs]
        if all(d == dicts[0] for d in dicts[1:]):
            return args, dicts[0]
        merged = tuple(sorted(set().union(*map(set, dicts))))
        rank = {s: i for i, s in enumerate(merged)}
        new_args = list(args)
        for (i, a), d in zip(strs, dicts):
            if d == merged:
                continue
            lut = torch.tensor([rank[s] for s in d] or [0], dtype=torch.int32,
                               device=self.device)
            data = lut[a.data.clamp(0, len(lut) - 1).long()]
            new_args[i] = Column(data, a.validity, a.dtype, dictionary=merged)
        return new_args, merged

    # -- calls ------------------------------------------------------------

    def _coerce_mixed_branches(self, name: str, args):
        """MySQL's branch-type aggregation for COALESCE/IF/CASE: a string
        branch beside another class, or a temporal one beside a number,
        makes the result a string, so every non-string value branch is
        rendered to its MySQL text over its host-knowable domain.
        Branches of one class pass through."""
        if name == "coalesce":
            vals = range(len(args))
        elif name == "if":
            vals = range(1, len(args))
        elif name == "case_when":
            vals = list(range(1, len(args), 2))
            if len(args) % 2 == 1:
                vals.append(len(args) - 1)
        else:
            return args

        def klass(a):
            if a.dtype.is_string:
                return "s"
            if a.dtype.kind in (TypeKind.DATETIME, TypeKind.DATE,
                                TypeKind.DURATION):
                return "t"
            return "n"

        ks = {klass(args[i]) for i in vals}
        if len(ks) == 1 or ("s" not in ks and ks != {"t", "n"}):
            return args
        new_args = list(args)
        for i in vals:
            if not args[i].dtype.is_string:
                new_args[i] = self._cast_to_string_lut(args[i], STRING)
        return new_args

    def _call(self, call: Call) -> Column:
        # ADDDATE(d, INTERVAL n unit), the 3-argument form, is DATE_ADD
        if call.func in ("adddate", "subdate") and len(call.args) == 3:
            call = Call("date_add" if call.func == "adddate" else "date_sub",
                        call.args)
        orig_name = call.func
        name = _ALIASES.get(call.func, call.func)
        if name != call.func:
            call = Call(name, call.args)
        if not call.args and name not in _ZERO_ARG_OK:
            raise EngineError(
                "Incorrect parameter count in the call to native "
                f"function '{orig_name}'")
        if name in ("like", "ilike"):
            return self._like(call, ci=name == "ilike")
        if name == "pi":
            import math

            return self._literal_column(Literal(math.pi), None)
        res = self._string_form(name, call)
        if res is not None:
            return res
        if (name in ("round", "truncate", "ceil", "floor")
                and len(call.args) == 2):
            target = self.evaluate(call.args[0])
            if target.dtype.is_decimal:
                d_expr = call.args[1]
                if isinstance(d_expr, Literal):
                    return round_decimal_frac(target, int(d_expr.value), name)
                return round_decimal_frac_dynamic(
                    target, self.evaluate(d_expr), name)
            # a non-decimal takes the generic path (d may be a column)
        if name in ("date_add", "date_sub"):
            unit_expr = call.args[2]
            assert isinstance(unit_expr, Literal), \
                "DATE_ADD unit must be a literal"
            unit = str(unit_expr.value).upper()
            if unit not in _DATE_ADD_UNITS:
                raise ValueError(f"unsupported {name} unit {unit!r}")
            return self._call(Call(f"{name}_{_DATE_ADD_UNITS[unit]}",
                                   call.args[:2]))
        if name == "extract":
            return self._extract(call)
        if name in ("now", "current_timestamp", "sysdate", "utc_timestamp",
                    "localtime", "localtimestamp"):
            return Column(self._full(query_now_us(), torch.int64), None,
                          DataType(TypeKind.DATETIME))
        if name in ("curdate", "current_date", "utc_date"):
            return Column(self._full(query_now_us() // 86_400_000_000,
                                     torch.int32), None, DATE)
        if name == "unix_timestamp" and not call.args:
            return Column(self._full(query_now_us() // 1_000_000, torch.int64),
                          None, INT64)
        if name == "rand":
            return self._rand(call)
        res = self._string_transform(name, call)
        if res is not None:
            return res
        # string predicate against literal(s): rewrite to code space
        if name in (_ORDER_CMPS | _EQ_CMPS | {"in"}):
            rewritten = self._maybe_string_predicate(call)
            if rewritten is not None:
                return rewritten
        # evaluate non-literals first so literals get operand context
        ctx: Optional[Column] = None
        evaluated: Dict[int, Column] = {}
        for i, a in enumerate(call.args):
            if not isinstance(a, Literal):
                evaluated[i] = self.evaluate(a)
                if ctx is None:
                    ctx = evaluated[i]
        str_ctx = next(
            (c for c in evaluated.values() if c.dtype.is_string), None
        )
        for i, a in enumerate(call.args):
            if isinstance(a, Literal):
                use = str_ctx if isinstance(a.value, str) and str_ctx is not None else ctx
                evaluated[i] = self._literal_column(a, use)
        args = [evaluated[i] for i in range(len(call.args))]
        args = self._coerce_mixed_branches(name, args)
        args, merged_dict = self._harmonize_string_args(args)
        fn = get_function(name)
        out = fn.infer([a.dtype for a in args])
        res = fn.evaluate(args, out)
        if res.dtype.is_string and res.dictionary is None \
                and merged_dict is not None:
            res = Column(res.data, res.validity, res.dtype,
                         dictionary=merged_dict)
        if res.stats is None:
            st = propagate_stats(name, args, out)
            if st is not None:
                res = Column(res.data, res.validity, res.dtype,
                             res.dictionary, stats=st)
        return res

    def _extract(self, call: Call) -> Column:
        """EXTRACT(unit FROM x): a sum of weighted part functions; over a
        TIME it is signed, composed on the magnitude; a string is parsed
        as a (nullable) DATETIME first."""
        unit_expr = call.args[0]
        assert isinstance(unit_expr, Literal), "EXTRACT unit must be a literal"
        unit = str(unit_expr.value).upper()
        parts = _EXTRACT_PARTS.get(unit)
        if parts is None:
            raise ValueError(f"unsupported EXTRACT unit {unit!r}")
        val = self.evaluate(call.args[1])
        arg_expr = call.args[1]
        if val.dtype.is_string:
            arg_expr = Cast(arg_expr, DataType(TypeKind.DATETIME, True))
        if val.dtype.kind is TypeKind.DURATION:
            us = val.data.to(torch.int64)
            mag = us.abs()
            pv = {
                "hour": torch.div(mag, 3_600_000_000, rounding_mode="floor"),
                "minute": torch.remainder(
                    torch.div(mag, 60_000_000, rounding_mode="floor"), 60),
                "second": torch.remainder(
                    torch.div(mag, 1_000_000, rounding_mode="floor"), 60),
                "microsecond": torch.remainder(mag, 1_000_000),
                "day_of_month": torch.zeros_like(mag),
            }
            acc = None
            for part_fn, weight in parts:
                if part_fn not in pv:
                    raise ValueError(f"EXTRACT {unit} over TIME unsupported")
                term = pv[part_fn] * weight
                acc = term if acc is None else acc + term
            return Column(torch.where(us < 0, -acc, acc), val.validity,
                          DataType(TypeKind.INT64, val.dtype.nullable))
        acc = None
        for part_fn, weight in parts:
            term = Call(part_fn, (arg_expr,))
            if weight != 1:
                term = Call("multiply", (term, Literal(weight)))
            acc = term if acc is None else Call("plus", (acc, term))
        return self._call(acc)

    def _rand(self, call: Call) -> Column:
        """RAND([seed]): uniform doubles in [0, 1) from a generator on the
        block's device, seeded by the literal (else by the query clock).
        The values are not the reference's: it draws from JAX's PRNG."""
        if call.args:
            seed_expr = call.args[0]
            assert isinstance(seed_expr, Literal), "RAND seed must be a literal"
            seed = int(seed_expr.value)
        else:
            seed = query_now_us() & 0x7FFFFFFF
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        data = torch.rand(self.n, generator=gen, dtype=torch.float64,
                          device=self.device)
        return Column(data, None, FLOAT64)

    def _like(self, call: Call, ci: bool = False) -> Column:
        """LIKE/ILIKE: a literal pattern matches each dictionary entry on
        the host, then one gather of the per-code BOOL table; a column
        pattern takes the cross-domain LUT over subject x pattern.  An
        optional third argument is the escape character.  ILIKE folds
        ASCII case only (TiDB's collation), on both sides."""
        target = self.evaluate(call.args[0])
        pat_expr = call.args[1]
        escape = "\\"
        if len(call.args) > 2:
            esc_expr = call.args[2]
            assert isinstance(esc_expr, Literal), "LIKE escape must be a literal"
            v = esc_expr.value
            escape = chr(int(v)) if isinstance(v, int) else str(v)
        fold = _ascii_lower if ci else (lambda s: s)
        if not isinstance(pat_expr, Literal):
            def like_fn(s, p):
                if s is None or p is None:
                    return None
                rx = re.compile(_like_to_regex(fold(str(p)), escape), re.S)
                return rx.fullmatch(fold(str(s))) is not None

            return self._cross_lut_value(call.args[:2], like_fn,
                                         name="like", out_dtype=BOOL)
        regex = re.compile(_like_to_regex(fold(pat_expr.value), escape), re.S)
        d = target.dictionary or ()
        lut = np.array([regex.fullmatch(fold(s)) is not None for s in d]
                       or [False], dtype=bool)
        data = _gather(lut, _codes(target, len(lut)))
        return Column(data, target.validity,
                      DataType(TypeKind.BOOL, target.dtype.nullable))

    # -- string forms the registry cannot type alone -----------------------

    def _string_form(self, name: str, call: Call) -> Optional[Column]:
        """The named string forms: k-ary LUTs, DATE_FORMAT, JSON builders
        and casts, TIMESTAMPDIFF, the session functions.  None for any
        other name."""
        if name == "elt":
            return self._elt(call)
        if name == "concat_ws":
            return self._concat_ws(call)
        if name in ("lpad", "rpad"):
            left = name == "lpad"

            def pad_fn(s, n, p):
                # NULL on a NULL argument, a negative length, or an empty
                # pad where padding is needed; lengths in characters
                if s is None or n is None or p is None:
                    return None
                s, p, n = str(s), str(p), _mysql_int_coerce(n)
                if n < 0:
                    return None
                if len(s) >= n:
                    return s[:n]
                if not p:
                    return None
                pad = (p * n)[: n - len(s)]
                return pad + s if left else s + pad

            return self._cross_lut(call.args, pad_fn, name=name)
        if name == "timestampdiff":
            return self._timestampdiff(call)
        if name == "from_unixtime" and len(call.args) == 2:
            fmt = call.args[1]
            if isinstance(fmt, Literal) and fmt.value is None:
                return self._null_string_column()
            if not isinstance(fmt, Literal):
                raise EngineError(
                    "Argument at index 1 for function fromUnixTime "
                    "must be constant")
            return self.evaluate(
                Call("date_format",
                     (Call("from_unixtime", (call.args[0],)), fmt)))
        if name == "date_format":
            return self._date_format(call)
        if name in ("json_array", "json_object"):
            return self._json_build(call)
        if name == "cast_as_json":
            return self._cast_as_json(call)
        if name in ("curtime", "current_time", "utc_time"):
            tod = query_now_us() % 86_400_000_000
            hh, rem = divmod(tod // 1_000_000, 3600)
            return self._encode_string_literal(
                "%02d:%02d:%02d" % (hh, rem // 60, rem % 60))
        if name == "connection_id":
            return Column(self._full(0, torch.int64), None, INT64)
        if name in _SESSION_TEXT:
            return self._encode_string_literal(_SESSION_TEXT[name])
        if name == "get_format":
            return self._get_format(call)
        if name == "substring_index":
            def ssi_fn(s, d, n):
                if s is None or d is None or n is None:
                    return None
                s, d, n = str(s), str(d), _mysql_int_coerce(n)
                if not d or n == 0:
                    return ""
                parts = s.split(d)
                return d.join(parts[:n] if n > 0 else parts[n:])

            return self._cross_lut(call.args, ssi_fn, name="substring_index")
        return None

    def _get_format(self, call: Call) -> Column:
        """GET_FORMAT(DATE|TIME|DATETIME, locale): the first argument is
        a bare keyword, which the parser leaves as a column reference."""
        a0 = call.args[0]
        if isinstance(a0, ColumnRef) and a0.name.upper() in (
                "DATE", "TIME", "DATETIME", "TIMESTAMP"):
            call = Call(call.func, (Literal(a0.name.upper()), *call.args[1:]))

        def gf_fn(t, loc):
            if t is None or loc is None:
                return None
            t = str(t).upper()
            t = "DATETIME" if t == "TIMESTAMP" else t
            return _GET_FORMAT.get((t, str(loc).upper()))

        if all(isinstance(a, Literal) for a in call.args[:2]):
            fmt = gf_fn(call.args[0].value, call.args[1].value)
            if fmt is None:
                return self._null_string_column()
            return self._encode_string_literal(fmt)
        return self._cross_lut(call.args[:2], gf_fn, name="get_format")

    def _string_transform(self, name: str, call: Call) -> Optional[Column]:
        """A string column (or an integer one, for the integer-to-string
        functions) with literal parameters, through the transform tables;
        the JSON and regexp predicates with column parameters through the
        cross-domain LUT.  None where the call is not of that shape."""
        if name in _STRING_DATE_TRANSFORMS:
            st = self._maybe_string_date_transform(call)
            if st is not None:
                return st
        if name in _INT_STRING_FNS:
            st = self._maybe_int_string_lut(call)
            if st is not None:
                return st
        if name in _STRING_TRANSFORMS:
            st = self._maybe_string_transform(call)
            if st is not None:
                return st
        if name in _STRING_INT_TRANSFORMS:
            st = self._maybe_string_int_transform(call)
            if st is not None:
                return st
        if name not in _STRING_BOOL_TRANSFORMS:
            return None
        st = self._maybe_string_bool_transform(call)
        if st is not None:
            return st
        fn0 = _STRING_BOOL_TRANSFORMS[name][1]
        if name in ("json_contains_path", "json_contains", "json_valid"):
            if name == "json_valid" and len(call.args) == 1:
                a0 = self.evaluate(call.args[0])
                if not a0.dtype.is_string:
                    # only strings hold JSON: constant 0, never NULL
                    fnv = get_function(name)
                    return fnv.evaluate([a0], fnv.infer([a0.dtype]))

            def jc(*vs):
                if name == "json_contains_path":
                    # NULL paths take part in the short-circuit
                    if vs[0] is None or vs[1] is None:
                        return None
                    return fn0(str(vs[0]), str(vs[1]), *vs[2:])
                if any(v is None for v in vs):
                    return None
                return fn0(*[str(v) for v in vs])

            return self._cross_lut_value(call.args, jc, name=name,
                                         out_dtype=BOOL)
        if name == "regexp_like":
            def rl_fn(*vs):
                if any(v is None for v in vs):
                    return None
                return fn0(str(vs[0]), *[str(v) for v in vs[1:]])

            return self._cross_lut_value(call.args, rl_fn, name=name,
                                         out_dtype=BOOL)
        return None

    def _null_string_column(self) -> Column:
        """An all-NULL string column (MySQL's NULL result of a string
        function)."""
        return Column(self._full(0, torch.int32), self._full(False, torch.bool),
                      STRING.with_nullable(True), ("",))

    def _maybe_string_transform(self, call: Call) -> Optional[Column]:
        """A string column with literal parameters -> a dictionary LUT
        transform; all literals fold to a constant."""
        if not call.args:
            return None
        rest = call.args[1:]
        if not all(isinstance(a, Literal) for a in rest):
            return None
        fn = _STRING_TRANSFORMS[call.func]
        params = [a.value for a in rest]
        if isinstance(call.args[0], Literal):
            v0 = call.args[0].value
            if v0 is None or any(p is None for p in params):
                return self._null_string_column()
            res = fn(str(v0), *params)
            if res is None:
                return self._null_string_column()
            return self._encode_string_literal(str(res))
        target = self.evaluate(call.args[0])
        if not target.dtype.is_string:
            return None
        if any(p is None for p in params):  # a NULL parameter -> NULL
            return self._null_string_column()
        return _map_string_to_string(target, lambda s: fn(s, *params),
                                     errors=self.runtime_errors)

    def _literal_params(self, call: Call, col_idx: int):
        """(string column, literal parameter values) of a call whose
        other arguments are all literals, else None."""
        if col_idx >= len(call.args):
            return None
        lits = [a for i, a in enumerate(call.args) if i != col_idx]
        if not all(isinstance(a, Literal) for a in lits):
            return None
        target = self.evaluate(call.args[col_idx])
        if not target.dtype.is_string:
            return None
        return target, [a.value for a in lits]

    @staticmethod
    def _never_null(out: Column) -> Column:
        """IS_IPV4/IS_IPV6 give 0, not NULL, for a NULL input."""
        if out.validity is None:
            return out
        return Column(torch.where(out.validity, out.data,
                                  torch.zeros_like(out.data)),
                      None, out.dtype.with_nullable(False))

    def _maybe_string_int_transform(self, call: Call) -> Optional[Column]:
        """A string column with literal parameters -> INT64 through a
        dictionary LUT (instr, locate, strcmp, find_in_set, field ...)."""
        col_idx, fn = _STRING_INT_TRANSFORMS[call.func]
        got = self._literal_params(call, col_idx)
        if got is None:
            return None
        target, params = got
        if any(p is None for p in params):
            return Column(self._full(0, torch.int64),
                          self._full(False, torch.bool),
                          INT64.with_nullable(True))
        out = _map_string_to_int(target, lambda s: fn(s, *params))
        return self._never_null(out) if call.func in _NEVER_NULL_FNS else out

    def _maybe_string_bool_transform(self, call: Call) -> Optional[Column]:
        """A string column with literal parameters -> BOOL through a
        dictionary LUT (regexp_like, json_valid, is_ipv4 ...)."""
        col_idx, fn = _STRING_BOOL_TRANSFORMS[call.func]
        got = self._literal_params(call, col_idx)
        if got is None:
            return None
        target, params = got
        if any(p is None for p in params) and call.func not in _NEVER_NULL_FNS:
            return Column(self._full(False, torch.bool),
                          self._full(False, torch.bool),
                          BOOL.with_nullable(True))
        out = _map_string_to_int(target, lambda s: fn(s, *params),
                                 kind=TypeKind.BOOL)
        return self._never_null(out) if call.func in _NEVER_NULL_FNS else out

    def _maybe_string_date_transform(self, call: Call) -> Optional[Column]:
        """STR_TO_DATE of a string column with a literal format: a DATE
        LUT, or a DATETIME one when the format has time specifiers."""
        fn = _STRING_DATE_TRANSFORMS[call.func]
        got = self._literal_params(call, 0)
        if got is None:
            return None
        target, params = got
        if params and _rj.format_has_time(str(params[0])):
            return _map_string_to_datetime(
                target, lambda s: _rj.str_to_datetime(s, *params))
        return _map_string_to_date(target, lambda s: fn(s, *params))

    def _elt(self, call: Call) -> Column:
        """ELT(n, s1, s2, ...): an integer index over string literals, one
        clipped gather; out-of-range n is NULL.  Column items take the
        cross-domain LUT."""
        if not all(isinstance(a, Literal) and isinstance(a.value, str)
                   for a in call.args[1:]):
            def elt_fn(n, *items):
                if n is None:
                    return None
                n = int(n)
                if not (1 <= n <= len(items)):
                    return None
                return items[n - 1]

            return self._cross_lut(call.args, elt_fn, name="elt")
        n_col = self.evaluate(call.args[0])
        items = [a.value for a in call.args[1:]]
        d = tuple(sorted(set(items)))
        rank = {s: i for i, s in enumerate(d)}
        lut = np.array([rank[s] for s in items], dtype=np.int32)
        idx = n_col.data.to(torch.int64)
        ok = (idx >= 1) & (idx <= len(items))
        data = _gather(lut, (idx - 1).clamp(0, len(items) - 1))
        v = ok if n_col.validity is None else (n_col.validity & ok)
        return Column(data, v, STRING.with_nullable(True), d)

    def _concat_ws(self, call: Call) -> Column:
        """CONCAT_WS(sep, ...): a literal separator and one string column
        among the pieces take a dictionary LUT; anything else the
        cross-domain LUT.  NULL pieces are skipped, a NULL separator is
        NULL."""
        def ws_fn(sep, *pieces):
            if sep is None:
                return None
            return str(sep).join(str(p) for p in pieces if p is not None)

        sep_a = call.args[0]
        if not (isinstance(sep_a, Literal) and isinstance(sep_a.value, str)):
            return self._cross_lut(call.args, ws_fn, name="concat_ws")
        sep = sep_a.value
        col_idx = [i for i, a in enumerate(call.args[1:], start=1)
                   if not isinstance(a, Literal)]
        lits = {i: a.value for i, a in enumerate(call.args[1:], start=1)
                if isinstance(a, Literal)}
        if len(col_idx) != 1:
            return self._cross_lut(call.args, ws_fn, name="concat_ws")
        target = self.evaluate(call.args[col_idx[0]])
        if not target.dtype.is_string:
            raise ValueError("CONCAT_WS column piece must be a string")
        ci = col_idx[0]

        def joined(col_val):
            pieces = []
            for i in range(1, len(call.args)):
                v = col_val if i == ci else lits[i]
                if v is not None:
                    pieces.append(str(v))
            return sep.join(pieces)

        mapped = [joined(s) for s in target.dictionary or ()]
        null_case = joined(None)
        new_dict = tuple(sorted(set(mapped) | {null_case}))
        rank = {s: i for i, s in enumerate(new_dict)}
        table = np.array([rank[m] for m in mapped] or [rank[null_case]],
                         dtype=np.int32)
        data = _gather(table, _codes(target, len(table)))
        if target.validity is not None:
            data = torch.where(target.validity, data,
                               torch.full_like(data, rank[null_case]))
        return Column(data, None, STRING, new_dict)

    def _timestampdiff(self, call: Call) -> Column:
        """TIMESTAMPDIFF(unit, a, b): whole units from a to b, truncated
        toward zero; the month family adjusts on the day and time of day."""
        unit_a = call.args[0]
        assert isinstance(unit_a, Literal), "TIMESTAMPDIFF unit must be a literal"
        unit = str(unit_a.value).upper()
        if any(isinstance(x, Literal) and x.value is None
               for x in call.args[1:]):
            return Column(self._full(0, torch.int64),
                          self._full(False, torch.bool),
                          DataType(TypeKind.INT64, True))
        a = self.evaluate(call.args[1])
        b = self.evaluate(call.args[2])

        def to_us(c):
            if c.dtype.kind is TypeKind.DATE:
                return c.data.to(torch.int64) * 86_400_000_000
            return c.data.to(torch.int64)

        va = _and_validity([a, b])
        if unit in ("MONTH", "QUARTER", "YEAR"):
            da, db = _date_days(a), _date_days(b)
            ya, ma, dda = _civil_from_days(da)
            yb, mb, ddb = _civil_from_days(db)
            ta = to_us(a) - da * 86_400_000_000
            tb = to_us(b) - db * 86_400_000_000
            m = (yb - ya) * 12 + (mb - ma)
            b_early = (ddb < dda) | ((ddb == dda) & (tb < ta))
            b_late = (ddb > dda) | ((ddb == dda) & (tb > ta))
            m = torch.where((m > 0) & b_early, m - 1, m)
            m = torch.where((m < 0) & b_late, m + 1, m)
            q = {"MONTH": 1, "QUARTER": 3, "YEAR": 12}[unit]
            data = torch.sign(m) * _fdiv(m.abs(), q)
        else:
            unit_us = {
                "MICROSECOND": 1, "SECOND": 1_000_000,
                "MINUTE": 60_000_000, "HOUR": 3_600_000_000,
                "DAY": 86_400_000_000, "WEEK": 7 * 86_400_000_000,
            }[unit]
            diff = to_us(b) - to_us(a)
            data = torch.sign(diff) * _fdiv(diff.abs(), unit_us)
        return Column(data, va, DataType(TypeKind.INT64,
                                         a.dtype.nullable or b.dtype.nullable))

    def _date_format(self, call: Call) -> Column:
        """DATE_FORMAT(date, fmt): the formatted text of every day of the
        column's range stats, one gather."""
        target = self.evaluate(call.args[0])
        fmt_a = call.args[1]
        assert isinstance(fmt_a, Literal), "DATE_FORMAT needs a literal format"
        if fmt_a.value is None:
            return self._null_string_column()
        if target.dtype.kind is not TypeKind.DATE:
            raise ValueError("DATE_FORMAT supports DATE columns (datetime: "
                             "cast to date first)")
        if target.stats is None:
            raise ValueError("DATE_FORMAT needs column range stats")
        lo, hi = int(target.stats[0]), int(target.stats[1])
        if hi - lo > 200_000:
            raise ValueError("DATE_FORMAT day range too wide for LUT")
        epoch = datetime.date(1970, 1, 1)
        mapped = [_rj.format_mysql_date(epoch + datetime.timedelta(days=day),
                                        fmt_a.value)
                  for day in range(lo, hi + 1)]
        new_dict = tuple(sorted(set(mapped))) or ("",)
        rank = {s: i for i, s in enumerate(new_dict)}
        table = np.array([rank[m] for m in mapped] or [0], dtype=np.int32)
        idx = (target.data.to(torch.int64) - lo).clamp(0, len(table) - 1)
        return Column(_gather(table, idx), target.validity,
                      STRING.with_nullable(target.dtype.nullable), new_dict)

    def _domain_codes(self, c: Column, size: int) -> torch.Tensor:
        """Per-row index of each value in the column's sorted value domain
        (int64, clipped into ``size``); BIGINT UNSIGNED searches on
        order-preserving int64 keys."""
        host = np.array(list(c.domain), dtype=c.dtype.physical)
        data = c.data
        if data.dtype == torch.uint64:
            host = host.view(np.int64) ^ np.int64(-2 ** 63)
            data = data.view(torch.int64) ^ (-2 ** 63)
        dom = torch.as_tensor(host, device=data.device).to(data.dtype)
        return torch.searchsorted(dom, data.contiguous()).clamp(0, size - 1)

    def _maybe_int_string_lut(self, call: Call) -> Optional[Column]:
        """BIN/OCT/HEX/FORMAT/CHAR/SPACE ... of a number: a LUT over its
        range stats (span <= 65536) or its value domain.  None for a
        string argument (hex and unhex fall through to the dictionary
        transforms) or an unbounded one."""
        rest = call.args[1:]
        if not all(isinstance(a, Literal) for a in rest):
            return None
        target = self.evaluate(call.args[0])
        if (not (target.dtype.is_integer or target.dtype.is_float
                 or (target.dtype.is_decimal and target.data.ndim == 1))
                or (target.stats is None and target.domain is None)):
            return None
        if target.stats is None and not target.dtype.is_integer:
            return None
        fn_override = None
        if target.dtype.is_decimal:
            if call.func == "format":
                # FORMAT keeps the fraction: a LUT over the exact
                # mantissa domain
                import decimal as _dec

                sc = target.dtype.scale
                base = _INT_STRING_FNS["format"]
                ctx90 = _dec.Context(prec=90)

                def fn_override(v, *p, _b=base, _s=sc, _c=ctx90):
                    return _b(_dec.Decimal(int(v)).scaleb(-_s, _c), *p)

                target = Column(target.data.to(torch.int64), target.validity,
                                INT64.with_nullable(target.dtype.nullable),
                                stats=target.stats, domain=target.domain)
            else:
                q = 10 ** target.dtype.scale
                data = _div_round_half_up(target.data.to(torch.int64),
                                          _pow10(target.dtype.scale))
                st = (int(target.stats[0]) // q - 1,
                      int(target.stats[1]) // q + 1)
                target = Column(data, target.validity,
                                INT64.with_nullable(target.dtype.nullable),
                                stats=st)
        if target.dtype.is_float:
            # MySQL rounds the argument (HEX(255.5) = '100')
            x = target.data.to(torch.float64)
            data = _f2i(torch.where(x >= 0, torch.floor(x + 0.5),
                                    torch.ceil(x - 0.5)), torch.int64)
            target = Column(data, target.validity,
                            INT64.with_nullable(target.dtype.nullable),
                            stats=target.stats)
        fn = fn_override or _INT_STRING_FNS[call.func]
        params = [a.value for a in rest]
        if (target.stats is not None
                and int(target.stats[1]) - int(target.stats[0]) <= 65536):
            lo, hi = int(target.stats[0]), int(target.stats[1])
            dom_vals = range(lo, hi + 1)
            idx = (target.data.to(torch.int64) - lo).clamp(0, hi - lo)
        elif target.domain is not None and len(target.domain) <= 65536:
            dom_vals = [int(v) for v in target.domain]
            idx = self._domain_codes(target, len(dom_vals))
        else:
            raise ValueError(
                f"{call.func} over an integer column needs a proven value "
                "range <= 65536 (dictionary LUT)")
        mapped = [fn(v, *params) for v in dom_vals]
        nulls = np.array([m is None for m in mapped] or [False])
        mapped = ["" if m is None else m for m in mapped]
        new_dict = tuple(sorted(set(mapped))) or ("",)
        rank = {s: i for i, s in enumerate(new_dict)}
        table = np.array([rank[m] for m in mapped] or [0], dtype=np.int32)
        idx = idx.clamp(max=len(table) - 1)
        data = _gather(table, idx)
        validity, nullable = target.validity, target.dtype.nullable
        if nulls.any():
            ok = _gather(~nulls, idx)
            validity = ok if validity is None else (validity & ok)
            nullable = True
        return Column(data, validity, STRING.with_nullable(nullable), new_dict)

    def _cast_to_string_lut(self, src: Column, target: DataType,
                            render=None) -> Column:
        """CAST(x AS CHAR) of a non-string x: MySQL's text of each value of
        the column's host-knowable domain, one gather.  A FLOAT renders at
        float32 precision (the shortest text that round-trips it)."""
        vals, codes = self._col_code_space(src)
        if render is None and src.dtype.kind is TypeKind.FLOAT32:
            vals = [None if v is None else float(str(np.float32(v)))
                    for v in vals]
        render = render or _mysql_value_text
        mapped = [None if v is None else render(v) for v in vals]
        mapped = self._sift_lut_errors(mapped, codes.clamp(0, len(mapped) - 1))
        nulls = np.array([m is None for m in mapped] or [False])
        strs = ["" if m is None else m for m in mapped]
        new_dict = tuple(sorted(set(strs))) or ("",)
        rank = {s: i for i, s in enumerate(new_dict)}
        table = np.asarray([rank[s] for s in strs] or [0], dtype=np.int32)
        idx = codes.clamp(0, len(table) - 1)
        data = _gather(table, idx)
        validity, nullable = src.validity, src.dtype.nullable
        if nulls.any():
            ok = _gather(~nulls, idx)
            validity = ok if validity is None else (validity & ok)
            nullable = True
        return Column(data, validity, target.with_nullable(nullable), new_dict)

    # -- k-ary cross-domain LUT --------------------------------------------

    def _arg_code_space(self, arg):
        """One axis of a k-ary LUT: (host values, per-row int32 codes); a
        literal is a one-value axis with codes None."""
        if isinstance(arg, Literal):
            return [arg.value], None
        return self._col_code_space(self.evaluate(arg))

    def _col_code_space(self, c: Column):
        """(host values, per-row int32 codes) of an evaluated column: its
        dictionary, its bools, its value domain, or its range stats when
        they span under 4096.  A nullable column's last value is None and
        its NULL rows code there.  ValueError for anything else."""
        if c.dtype.is_string:
            vals = list(c.dictionary or ()) or [""]
            codes = c.data.to(torch.int32).clamp(0, len(vals) - 1)
        elif c.dtype.kind is TypeKind.BOOL:
            vals = [0, 1]
            codes = c.data.to(torch.int32)
        elif c.domain is not None and len(c.domain) <= _CROSS_LUT_CAP \
                and c.data.ndim == 1:
            # the domain holds physical values: map them to the values
            # ``fn`` sees for the logical type
            if c.dtype.is_decimal:
                from decimal import Decimal as _D

                vals = [_D(int(x)).scaleb(-c.dtype.scale) for x in c.domain]
            elif c.dtype.kind is TypeKind.DATE:
                epoch = datetime.date(1970, 1, 1)
                vals = [epoch + datetime.timedelta(days=int(x))
                        for x in c.domain]
            elif c.dtype.kind is TypeKind.DATETIME:
                epoch0 = datetime.datetime(1970, 1, 1)
                vals = [epoch0 + datetime.timedelta(microseconds=int(x))
                        for x in c.domain]
            elif c.dtype.is_float:
                vals = [float(x) for x in c.domain]
            else:
                vals = [int(x) for x in c.domain]
            codes = self._domain_codes(c, len(vals)).to(torch.int32)
        elif c.dtype.is_integer and c.stats is not None and \
                int(c.stats[1]) - int(c.stats[0]) < 4096:
            lo = int(c.stats[0])
            vals = list(range(lo, int(c.stats[1]) + 1))
            codes = (c.data.to(torch.int64) - lo).clamp(
                0, len(vals) - 1).to(torch.int32)
        else:
            raise ValueError(
                "cross-domain LUT needs a host-knowable value set "
                "(dictionary / value domain / narrow range stats) — "
                f"got {c.dtype}")
        if c.validity is not None:
            vals = vals + [None]
            codes = torch.where(c.validity, codes,
                                torch.full_like(codes, len(vals) - 1))
        return vals, codes

    def _cross_codes(self, args, name: str):
        """The axes of every argument and each row's combination code
        (row-major; literal axes have size 1)."""
        axes = [self._arg_code_space(a) for a in args]
        total = 1
        for vals, _ in axes:
            total *= len(vals)
        if total > _CROSS_LUT_CAP:
            raise ValueError(f"{name}: cross-domain LUT size {total} "
                             f"exceeds {_CROSS_LUT_CAP}")
        code = None
        for vals, codes in axes:
            k = len(vals)
            if code is not None and k > 1:
                code = code * k
            if codes is not None:
                code = codes if code is None else code + codes
        if code is None:  # every argument a literal
            code = self._full(0, torch.int32)
        return axes, code

    def _sift_lut_errors(self, mapped, idx: torch.Tensor,
                         base_validity=None):
        """The runtime error channel: per distinct ``EvalError`` message
        of a table, the per-row mask of rows whose code lands on it goes
        to ``runtime_errors``; the errors become None in the returned
        table.  ``base_validity`` masks rows whose NULL input makes the
        code meaningless."""
        if not any(isinstance(m, EvalError) for m in mapped):
            return mapped
        by_msg: Dict[str, list] = {}
        for i, m in enumerate(mapped):
            if isinstance(m, EvalError):
                by_msg.setdefault(m.message, []).append(i)
        for msg, idxs in by_msg.items():
            tbl = np.zeros(len(mapped), dtype=bool)
            tbl[idxs] = True
            mask = _gather(tbl, idx)
            if base_validity is not None:
                mask = mask & base_validity
            self.runtime_errors.append((mask, msg))
        return [None if isinstance(m, EvalError) else m for m in mapped]

    def _cross_lut_value(self, args, fn, *, name: str,
                         out_dtype: DataType) -> Column:
        """A cross-domain LUT with a BOOL or integer result (LIKE and the
        regexp and JSON predicates with column parameters)."""
        axes, code = self._cross_codes(args, name)
        mapped = [fn(*combo) for combo in
                  itertools.product(*[v for v, _ in axes])]
        mapped = self._sift_lut_errors(mapped, code.clamp(0, len(mapped) - 1))
        nulls = np.array([m is None for m in mapped] or [False])
        arr = np.asarray([0 if m is None else m for m in mapped] or [0],
                         dtype=out_dtype.physical)
        idx = code.clamp(0, len(arr) - 1)
        data = _gather(arr, idx)
        validity, nullable = None, False
        if nulls.any():
            validity = _gather(~nulls, idx)
            nullable = True
        return Column(data, validity, out_dtype.with_nullable(nullable))

    def _cross_lut(self, args, fn, *, name: str) -> Column:
        """A k-ary string producer over the cross product of the
        arguments' host-enumerable domains: one ``fn`` call per
        combination (never per row), one fused code, one gather.  NULL
        semantics live in ``fn``: it sees None and returns None."""
        axes, code = self._cross_codes(args, name)
        mapped = [fn(*combo) for combo in
                  itertools.product(*[v for v, _ in axes])]
        mapped = self._sift_lut_errors(mapped, code.clamp(0, len(mapped) - 1))
        nulls = np.array([m is None for m in mapped] or [False])
        strs = ["" if m is None else str(m) for m in mapped]
        new_dict = tuple(sorted(set(strs))) or ("",)
        rank = {s: i for i, s in enumerate(new_dict)}
        table = np.asarray([rank[s] for s in strs] or [0], dtype=np.int32)
        idx = code.clamp(0, len(table) - 1)
        data = _gather(table, idx)
        validity, nullable = None, False
        if nulls.any():
            validity = _gather(~nulls, idx)
            nullable = True
        return Column(data, validity, STRING.with_nullable(nullable), new_dict)

    # -- JSON --------------------------------------------------------------

    def _cast_as_json(self, call: Call) -> Column:
        """CAST(x AS JSON): numbers keep their text, BOOL is true/false,
        temporals become quoted strings with a 6-digit fraction, strings
        parse as documents (text that is not one is a per-row runtime
        error), JSON columns normalize, binary strings become base64
        opaques."""
        src = self.evaluate(call.args[0])
        sdt = src.dtype
        if sdt.is_string:
            if sdt.mysql_blob:
                import base64

                def jf(s, _c=sdt.mysql_blob):
                    b = base64.b64encode(
                        s.encode("utf-8", "surrogateescape")).decode()
                    return json.dumps(f"base64:type{_c}:{b}")
            else:
                def jf(s, _isjson=sdt.mysql_json):
                    try:
                        doc = json.loads(s)
                    except Exception:
                        if _isjson:
                            return s
                        return EvalError("Invalid JSON text: The document "
                                         "root must not be followed by other "
                                         "values.")
                    if _doc_depth(doc) > 100:  # MySQL's nesting cap
                        return EvalError("Invalid JSON text: The JSON "
                                         "document exceeds the maximum "
                                         "depth.")
                    return _rj.json_dumps_mysql(doc)
            out = _map_string_to_string(src, jf, errors=self.runtime_errors)
        else:
            def render(v):
                if sdt.kind is TypeKind.BOOL or isinstance(v, bool):
                    return "true" if v else "false"
                if isinstance(v, datetime.datetime):
                    return json.dumps(
                        f"{v.year:04d}-{v.month:02d}-{v.day:02d} "
                        f"{v.hour:02d}:{v.minute:02d}:{v.second:02d}"
                        f".{v.microsecond:06d}")
                if sdt.kind is TypeKind.DURATION:
                    us = int(v)
                    sign = "-" if us < 0 else ""
                    us = abs(us)
                    h, rem = divmod(us // 1_000_000, 3600)
                    mi, s2 = divmod(rem, 60)
                    return json.dumps(f"{sign}{h:02d}:{mi:02d}:{s2:02d}"
                                      f".{us % 1_000_000:06d}")
                if isinstance(v, datetime.date):
                    return json.dumps(_mysql_value_text(v))
                if isinstance(v, float):
                    return json.dumps(v)  # JSON float text keeps '.0'
                return _mysql_value_text(v)

            out = self._cast_to_string_lut(src, STRING, render=render)
        return Column(out.data, out.validity,
                      dataclasses.replace(out.dtype, mysql_json=True),
                      out.dictionary)

    def _json_build(self, call: Call) -> Column:
        """JSON_ARRAY / JSON_OBJECT: literal arguments fold; column
        arguments compose through the cross-domain LUT.  Strings quote,
        numbers and bools inline, JSON columns embed as documents, a SQL
        NULL value is JSON null; a NULL key is a per-row runtime error."""
        args = call.args
        col_idx = [i for i, a in enumerate(args) if not isinstance(a, Literal)]
        is_obj = call.func == "json_object"

        def build(values):
            if not is_obj:
                return _rj.json_dumps_mysql(list(values))
            if len(values) % 2:
                raise ValueError("JSON_OBJECT needs key/value pairs")
            doc = {}
            for i in range(0, len(values), 2):
                k = values[i]
                if k is None:
                    return EvalError("JSON documents may not contain "
                                     "NULL member names.")
                doc[str(k)] = values[i + 1]
            return _rj.json_dumps_mysql(doc)

        if not col_idx:
            v = build([a.value for a in args])
            if isinstance(v, EvalError):
                raise EngineError(v.message)
            return self._encode_string_literal(v)

        json_arg = {i: bool(self.evaluate(args[i]).dtype.mysql_json)
                    for i in col_idx}

        def fn(*vs):
            vals = list(vs)
            for i in col_idx:
                v = vals[i]
                if json_arg[i] and isinstance(v, str):
                    try:
                        vals[i] = json.loads(v)
                    except Exception:
                        pass
            return build(vals)

        return self._cross_lut(args, fn, name=call.func)

    def _maybe_string_predicate(self, call: Call) -> Optional[Column]:
        """Comparisons/IN where one side is a string column and the other(s)
        are string literals: map into dictionary-code space.

        Member literal -> its exact rank; non-member literal -> doubled-code
        trick: column codes * 2 against 2*bisect_left - 1, which sits
        strictly between its neighbours."""
        name = call.func
        args = call.args
        lit_idx = [i for i, a in enumerate(args) if isinstance(a, Literal)
                   and isinstance(a.value, str)]
        col_idx = [i for i, a in enumerate(args) if i not in lit_idx]
        if not lit_idx or len(col_idx) != 1:
            return None
        target = self.evaluate(args[col_idx[0]])
        if not target.dtype.is_string or target.dtype.mysql_json:
            # JSON dictionaries rank by JSON precedence, not by text
            return None
        d = target.dictionary or ()
        intd = DataType(TypeKind.INT32, target.dtype.nullable)

        def code_of(s: str):
            lo = bisect.bisect_left(d, s)
            member = lo < len(d) and d[lo] == s
            return lo, member

        if name == "in":
            codes = []
            for i in lit_idx:
                lo, member = code_of(args[i].value)
                if member:
                    codes.append(lo)
            out_dt = DataType(TypeKind.BOOL, target.dtype.nullable)
            if not codes:
                return Column(self._full(False, torch.bool), target.validity,
                              out_dt)
            acc = None
            for c in codes:
                eq = target.data == c
                acc = eq if acc is None else (acc | eq)
            return Column(acc, target.validity, out_dt)

        lo, member = code_of(args[lit_idx[0]].value)
        if member:
            lhs_data = target.data
            lit_code = lo
        else:
            lhs_data = target.data.to(torch.int32) * 2
            lit_code = 2 * lo - 1
        lhs = Column(lhs_data, target.validity, intd)
        rhs = Column(self._full(lit_code, torch.int32), None,
                     DataType(TypeKind.INT32))
        pair = [lhs, rhs] if col_idx[0] == 0 else [rhs, lhs]
        fn = get_function(name)
        out = fn.infer([c.dtype for c in pair])
        return fn.evaluate(pair, out)


def _mysql_substring(s: str, pos: int, length: Optional[int] = None) -> str:
    """1-based; a negative pos counts from the end; pos 0 is empty."""
    if pos == 0:
        return ""
    if pos > 0:
        start = pos - 1
    else:
        start = len(s) + pos
        if start < 0:
            return ""
    piece = s[start:]
    if length is not None:
        if length <= 0:
            return ""
        piece = piece[:length]
    return piece


# name -> fn(dictionary entry, *literal arguments) -> str | None |
# EvalError: a host LUT over the dictionary, one gather on the device
_STRING_TRANSFORMS = {
    # concat works only as concat(column, literal, ...), as in the
    # reference (ROADMAP, reference limitations)
    "concat": lambda s, *args: "".join([s] + [str(a) for a in args]),
    "concat_prefix": lambda s, prefix: str(prefix) + s,
    "substring": _mysql_substring,
    "left": lambda s, n: s[: max(int(n), 0)],
    "right": lambda s, n: s[-int(n):] if int(n) > 0 else "",
    "replace": lambda s, old, new: s.replace(str(old), str(new)),
    "repeat": lambda s, n: s * max(int(n), 0),
    "insert_str": lambda s, pos, ln, new: (
        s if int(pos) < 1 or int(pos) > len(s)
        else s[: int(pos) - 1] + str(new) + s[int(pos) - 1 + max(int(ln), 0):]
    ),
    "substring_index": lambda s, delim, n: (
        str(delim).join(s.split(str(delim))[: int(n)]) if int(n) > 0
        else (str(delim).join(s.split(str(delim))[int(n):]) if int(n) < 0 else "")
    ),
    # the regexp family
    "regexp_substr": _rj.regexp_substr,
    "regexp_replace": _rj.regexp_replace,
    # JSON
    "json_extract": _rj.json_extract,
    "json_unquote": _rj.json_unquote,
    "json_type": _rj.json_type,
    "json_quote": _rj.json_quote,
    "json_keys": _rj.json_keys,
    # codecs
    "to_base64": _rj.to_base64,
    "from_base64": _rj.from_base64,
    "unhex": _rj.unhex,
    "quote": _rj.quote,
    "soundex": _rj.soundex,
    "conv": _rj.conv,
    "sha2": _rj.sha2,
    # the inet6 family over the hex-string stand-in of VARBINARY
    "inet6_aton": _rj.inet6_aton,
    "inet6_ntoa": _rj.inet6_ntoa,
    # weekday and month names straight from text: partial zero and
    # year-0 dates are storable values no DATE cast carries
    "dayname": dayname_of_string,
    "day_name": dayname_of_string,
    "monthname": monthname_of_string,
    "month_name": monthname_of_string,
}

# functions that give 0 (never NULL) for a NULL input
_NEVER_NULL_FNS = {"is_ipv4", "is_ipv6", "is_ipv4_compat", "is_ipv4_mapped"}

_STRING_INT_TRANSFORMS = {
    # name: (index of the column argument, fn(entry, *literals) -> int);
    # MySQL positions are 1-based, 0 = not found
    "instr": (0, lambda s, needle: s.find(str(needle)) + 1),
    "locate": (1, lambda s, needle: s.find(str(needle)) + 1),
    "position": (1, lambda s, needle: s.find(str(needle)) + 1),
    "strcmp": (0, lambda s, other: (s > str(other)) - (s < str(other))),
    "find_in_set": (0, lambda s, lst: (
        str(lst).split(",").index(s) + 1 if s in str(lst).split(",") else 0)),
    "field": (0, lambda s, *vals: (
        [str(v) for v in vals].index(s) + 1 if s in [str(v) for v in vals] else 0)),
    "regexp_instr": (0, _rj.regexp_instr),
    "json_length": (0, _rj.json_length),
    "json_depth": (0, _rj.json_depth),
    "inet_aton": (0, _rj.inet_aton),
}

_STRING_BOOL_TRANSFORMS = {
    # name: (index of the column argument, fn(entry, *literals) -> bool|None)
    "regexp_like": (0, _rj.regexp_like),
    "json_valid": (0, _rj.json_valid),
    "json_contains_path": (0, _rj.json_contains_path),
    "json_contains": (0, _rj.json_contains),
    "is_ipv4": (0, _rj.is_ipv4),
    "is_ipv6": (0, _rj.is_ipv6),
}

_STRING_DATE_TRANSFORMS = {
    # name: fn(entry, *literals) -> datetime.date | None
    "str_to_date": _rj.str_to_date,
}


def _mysql_value_text(v) -> str:
    """MySQL's CAST(x AS CHAR) text of a host value."""
    import decimal as _dec

    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return str(int(v)) if v == int(v) and abs(v) < 1e16 else repr(v)
    if isinstance(v, _dec.Decimal):
        return str(v)
    if isinstance(v, datetime.datetime):
        s = v.strftime("%Y-%m-%d %H:%M:%S")
        if v.microsecond:
            s += (".%06d" % v.microsecond).rstrip("0")
        return s
    if isinstance(v, datetime.date):
        return v.isoformat()
    return str(v)


def _mysql_int_coerce(v) -> int:
    """MySQL's string -> int: the longest numeric prefix, rounded half
    away from zero; a non-numeric string is 0."""
    if isinstance(v, str):
        m = re.match(r"^\s*[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?", v)
        f = float(m.group(0)) if m else 0.0
        return int(f + 0.5) if f >= 0 else -int(-f + 0.5)
    return int(v)


def _mysql_format_number(v, d: int = 0) -> str:
    import decimal as _dec

    d = max(int(d), 0)
    if isinstance(v, _dec.Decimal):
        # exact: half up at d digits, never through a float
        q = v.quantize(_dec.Decimal(1).scaleb(-d),
                       rounding=_dec.ROUND_HALF_UP,
                       context=_dec.Context(prec=90))
        return f"{q:,.{d}f}"
    return f"{v:,.{d}f}"


def _mysql_make_set(bits: int, *strs) -> str:
    u = bits if bits >= 0 else bits + (1 << 64)
    return ",".join(str(s) for i, s in enumerate(strs) if u & (1 << i))


def _mysql_export_set(bits: int, on, off, sep=",", n=64) -> str:
    u = bits if bits >= 0 else bits + (1 << 64)
    return str(sep).join(
        str(on) if u & (1 << i) else str(off) for i in range(int(n)))


_INT_STRING_FNS = {
    # MySQL's integer -> string functions; a negative prints as its
    # unsigned 64-bit two's complement
    "bin": lambda v: format(v if v >= 0 else v + (1 << 64), "b"),
    "oct": lambda v: format(v if v >= 0 else v + (1 << 64), "o"),
    "hex": lambda v: format(v if v >= 0 else v + (1 << 64), "X"),
    "format": _mysql_format_number,
    "make_set": _mysql_make_set,
    "export_set": _mysql_export_set,
    # past max_allowed_packet (16 MB by default) MySQL returns NULL
    "space": lambda v: None if v > 16777216 else " " * max(int(v), 0),
    "char": _rj.mysql_char,
    "inet_ntoa": _rj.inet_ntoa,
    "unhex": _rj.unhex,
}

_ASCII_LOWER = str.maketrans(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz")


def _ascii_lower(s: str) -> str:
    """ASCII-only case folding (TiDB's ILIKE collation)."""
    return s.translate(_ASCII_LOWER)


def _like_to_regex(pattern: str, escape: str = "\\") -> str:
    """SQL LIKE pattern -> Python regex: ``%`` any run, ``_`` one
    character, ``escape`` makes the next character literal."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


def evaluate_expr(expr: Expr, block: Block) -> Column:
    """``expr`` over ``block``'s rows, as one Column on the block's device."""
    return ExprEvaluator(block).evaluate(expr)


__all__ = ["evaluate_expr", "ExprEvaluator", "infer_literal_dtype", "_float_to_decimal",
           "_literal_days", "_like_to_regex", "query_clock", "query_timezone",
           "query_now_us", "query_tz_us", "parse_tz_offset_us"]
