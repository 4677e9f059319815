"""Expression evaluation over a Block: the slice TPC-H's 22 queries reach.

Counterpart of ``tiflash_tpu/expr/compile.py``.  Evaluation is eager:
each call runs torch operations on the block's tensors.

String predicates against literals (the comparisons and IN) are rewritten
into dictionary-code space (sorted dictionaries make codes
order-preserving); ``LIKE`` with a literal pattern matches each entry of
the column's dictionary on the host and gathers the per-code BOOL table
on the column's device.  Literals are typed against the operand they
meet: a date text against a DATE column becomes days since the epoch, a
float against a decimal column becomes an exact decimal mantissa.  Casts,
LIKE with a column pattern and the other host-LUT string functions come
with the functions slice of the port.
"""

from __future__ import annotations

import bisect
import datetime
import re
from typing import Dict, Optional

import torch

from ..core.block import Block, Column
from ..core.dtypes import (
    BOOL,
    DATE,
    DataType,
    Decimal,
    FLOAT64,
    INT64,
    STRING,
    TypeKind,
)
from .functions import get_function
from .nodes import Call, ColumnRef, Expr, Literal

_ORDER_CMPS = {"less", "less_or_equals", "greater", "greater_or_equals"}
_EQ_CMPS = {"equals", "not_equals"}


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
            return self.block[expr.name]
        if isinstance(expr, Literal):
            return self._literal_column(expr, None)
        if isinstance(expr, Call):
            return self._call(expr)
        raise NotImplementedError(
            f"expression {expr!r} is not ported yet: casts come with the "
            "functions slice of the port")

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
            if abs(m) >= 2 ** 63:
                raise NotImplementedError(
                    "wide decimal literals come with the functions slice "
                    "of the port")
            return Column(self._full(m, torch.int64), None, Decimal(18, s),
                          stats=(m, m))
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
            if not (-(2 ** 63) <= value <= 2 ** 63 - 1):
                return self._literal_column(Literal(_D(value)), context)
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

    def _call(self, call: Call) -> Column:
        name = call.func
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
        args, _ = self._harmonize_string_args(args)
        fn = get_function(name)
        out = fn.infer([a.dtype for a in args])
        res = fn.evaluate(args, out)
        if res.stats is None:
            from .functions import propagate_stats

            st = propagate_stats(name, args, out)
            if st is not None:
                res = Column(res.data, res.validity, res.dtype,
                             res.dictionary, stats=st)
        return res

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
           "_literal_days", "_like_to_regex"]
