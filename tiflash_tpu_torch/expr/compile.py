"""Expression evaluation over a Block.

Counterpart of ``tiflash_tpu/expr/compile.py``.  Evaluation is eager:
each call runs torch operations on the block's tensors.

String predicates against literals (the comparisons and IN) are rewritten
into dictionary-code space (sorted dictionaries make codes
order-preserving); ``LIKE`` with a literal pattern matches each entry of
the column's dictionary on the host and gathers the per-code BOOL table
on the column's device.  Literals are typed against the operand they
meet: a date text against a DATE column becomes days since the epoch, a
float against a decimal column becomes an exact decimal mantissa.

The call head resolves TiDB aliases, rejects empty calls of functions
that take arguments, and dispatches what the registry cannot type alone:
ROUND and its family over a decimal with a digit argument, DATE_ADD/SUB
by unit, EXTRACT, the query-clock functions and RAND.  ``query_clock``
and ``query_timezone`` pin NOW() and the session time zone for a scope.

Casts to strings, LIKE with a column pattern and the other host-LUT
string functions come with the string slice of the port.
"""

from __future__ import annotations

import bisect
import contextvars
import datetime
import re
import time
from typing import Dict, Optional

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
    ZeroDateTime,
)
from ..runtime.errors import EngineError
from .functions import (
    _ALIASES,
    _STRING_SLICE,
    cast_column,
    get_function,
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


class ExprEvaluator:
    """Evaluates a typed expression tree against one Block."""

    def __init__(self, block: Block):
        self.block = block
        self.n = block.capacity
        self.device = block.device

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
            if expr.target.is_string and not src.dtype.is_string:
                raise NotImplementedError(
                    f"cast {src.dtype} -> {expr.target} {_STRING_SLICE}")
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
        makes the result a string, which the string slice of the port
        renders.  Branches of one class pass through."""
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
        if len(ks) > 1 and ("s" in ks or ks == {"t", "n"}):
            raise NotImplementedError(
                f"{name} over string and non-string branches renders them "
                f"as text, which {_STRING_SLICE}")
        return args

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
        if name == "pi":
            import math

            return self._literal_column(Literal(math.pi), None)
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
        if name in ("curtime", "current_time", "utc_time"):
            raise NotImplementedError(
                f"{name} makes a string, which {_STRING_SLICE}")
        if name == "unix_timestamp" and not call.args:
            return Column(self._full(query_now_us() // 1_000_000, torch.int64),
                          None, INT64)
        if name == "from_unixtime" and len(call.args) == 2:
            raise NotImplementedError(
                f"from_unixtime with a format {_STRING_SLICE} (date_format)")
        if name == "rand":
            return self._rand(call)
        if name == "like":
            return self._like(call)
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
        TIME it is signed, composed on the magnitude."""
        unit_expr = call.args[0]
        assert isinstance(unit_expr, Literal), "EXTRACT unit must be a literal"
        unit = str(unit_expr.value).upper()
        parts = _EXTRACT_PARTS.get(unit)
        if parts is None:
            raise ValueError(f"unsupported EXTRACT unit {unit!r}")
        val = self.evaluate(call.args[1])
        if val.dtype.is_string:
            raise NotImplementedError(
                f"EXTRACT from a string parses it, which {_STRING_SLICE}")
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
            term = Call(part_fn, (call.args[1],))
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

    def _like(self, call: Call) -> Column:
        """LIKE against a literal pattern: a host match over the column's
        dictionary, then one gather of the per-code BOOL table.  An
        optional third argument is the escape character."""
        target = self.evaluate(call.args[0])
        pat_expr = call.args[1]
        escape = "\\"
        if len(call.args) > 2:
            esc_expr = call.args[2]
            assert isinstance(esc_expr, Literal), "LIKE escape must be a literal"
            v = esc_expr.value
            escape = chr(int(v)) if isinstance(v, int) else str(v)
        if not isinstance(pat_expr, Literal):
            raise NotImplementedError(
                "LIKE with a column pattern is not ported yet: it comes with "
                "the functions slice of the port")
        regex = re.compile(_like_to_regex(pat_expr.value, escape), re.S)
        d = target.dictionary or ()
        lut = torch.tensor([regex.fullmatch(s) is not None for s in d] or [False],
                           dtype=torch.bool, device=self.device)
        data = lut[target.data.clamp(0, lut.shape[0] - 1).long()]
        return Column(data, target.validity,
                      DataType(TypeKind.BOOL, target.dtype.nullable))

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
        if not target.dtype.is_string:
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


__all__ = ["ExprEvaluator", "infer_literal_dtype", "_float_to_decimal",
           "_literal_days", "_like_to_regex", "query_clock", "query_timezone",
           "query_now_us", "query_tz_us", "parse_tz_offset_us"]
