"""Scalar function registry: the slice TPC-H's 22 queries reach.

Counterpart of ``tiflash_tpu/expr/functions.py``.  Ported here:

- ``plus``/``minus``/``multiply``/``divide`` type inference and
  evaluation on integer, float, narrow (precision <= 18) and wide
  decimal operands, the reference's ``_arith_eval``: wide operands in
  multi-limb arithmetic (``core/wide.py``), decimal division at TiDB's
  result scale (``DIV_PRECISION_INCREMENT``) rounding half up, by exact
  long division wherever the scaled dividend can pass int64, and NULL on
  a zero divisor;
- the six comparisons, wide-decimal operands included (limb-wise, narrow
  and wide operands mixed), ``and``/``or``/``not`` (three-valued logic)
  and ``in`` (MySQL's three-valued rule);
- ``propagate_stats``, which keeps expression columns (revenue =
  extendedprice * (1 - discount)) on the narrow-stored sum path;
- ``_div_round_half_up`` (TiDB decimal rounding, used by avg);
- ``year`` over DATE and DATETIME (TPC-H Q7's ``year(l_shipdate)``).

Every other function, string operands in arithmetic, casts and unsigned
compares raise ``NotImplementedError``: they belong to the functions
slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core import wide as W
from ..core.block import Column
from ..core.dtypes import (
    ZERO_DATE_DAYS,
    DataType,
    Decimal,
    TypeKind,
    common_numeric_type,
)

_LATER = "is not ported yet: it comes with the functions slice of the port"

DIV_PRECISION_INCREMENT = 4  # TiDB div_precision_increment default


def _pow10(k: int) -> int:
    return 10 ** k


def _operand_values(col: Column, out: DataType) -> torch.Tensor:
    """An operand of integer/float arithmetic in the result's physical
    type (the reference's ``cast_column`` to the result type).  A decimal
    operand here meets a float one, so the result is DOUBLE; eager IEEE
    division by 10^scale is correctly rounded."""
    if col.dtype.is_decimal:
        return col.data.to(torch.float64) / float(_pow10(col.dtype.scale))
    return col.data.to(out.torch_dtype)


def _div_round_half_up(num: torch.Tensor, den) -> torch.Tensor:
    """Integer division rounding half away from zero (TiDB decimal), on
    int64 floor division and remainder of the magnitudes."""
    den = torch.as_tensor(den, dtype=num.dtype, device=num.device)
    an, ad = num.abs(), den.abs()
    q = torch.div(an, ad, rounding_mode="floor")
    r = an - q * ad
    q = q + (2 * r >= ad).to(num.dtype)
    sign = torch.sign(num) * torch.sign(den)
    return (sign * q).to(num.dtype)


# ---------------------------------------------------------------------------
# interval propagation (range statistics through expressions)
# ---------------------------------------------------------------------------

_I63 = 2 ** 63


def propagate_stats(name: str, args: Sequence[Column], out: DataType):
    """Conservative [vmin, vmax] for an expression result, or None.

    The ``Column.stats`` invariant survives arithmetic as interval
    arithmetic, mirroring the exact scale transforms ``_arith_eval``
    applies.  Returns None when any endpoint could overflow int64."""
    if out.is_float or out.is_string:
        return None
    ivs = []
    sel = {"if": args[1:], "coalesce": args, "case_when": None}.get(
        name, args if name in ("plus", "minus", "multiply") else ())
    if name == "case_when":
        sel = [a for i, a in enumerate(args) if i % 2 == 1]
        if len(args) % 2 == 1:
            sel.append(args[-1])
    if name in ("abs", "negate", "modulo"):
        if any(a.stats is None or a.data.ndim != 1 for a in args):
            return None
        la, ha = int(args[0].stats[0]), int(args[0].stats[1])
        if name == "abs":
            lo = 0 if la <= 0 <= ha else min(abs(la), abs(ha))
            return (lo, max(abs(la), abs(ha)))
        if name == "negate":
            return (-ha, -la)
        rl, rh = int(args[1].stats[0]), int(args[1].stats[1])
        if rl <= 0:
            return None
        m = rh - 1
        lo = 0 if la >= 0 else -m
        hi = min(m, max(abs(la), abs(ha)))
        return (lo, max(hi, 0)) if la >= 0 else (max(-hi, lo), hi)
    if name not in ("plus", "minus", "multiply", "if", "coalesce",
                    "case_when"):
        return None
    for a in sel:
        if a.stats is None or a.data.ndim != 1:
            return None
        if not (a.dtype.is_integer or a.dtype.is_decimal or a.dtype.is_temporal
                or a.dtype.kind is TypeKind.BOOL):
            return None
        ivs.append((int(a.stats[0]), int(a.stats[1])))
    if name in ("if", "coalesce", "case_when"):
        if any(a.dtype.is_decimal and a.dtype.scale != out.scale for a in sel):
            return None
        lo = min(l for l, _ in ivs)
        hi = max(h for _, h in ivs)
        return (lo, hi) if max(abs(lo), abs(hi)) < _I63 else None
    a, b = args
    (la, ha), (lb, hb) = ivs
    sa = a.dtype.scale if a.dtype.is_decimal else 0
    sb = b.dtype.scale if b.dtype.is_decimal else 0
    if name in ("plus", "minus"):
        fa = _pow10(out.scale - sa) if out.is_decimal else 1
        fb = _pow10(out.scale - sb) if out.is_decimal else 1
        if name == "plus":
            lo, hi = la * fa + lb * fb, ha * fa + hb * fb
        else:
            lo, hi = la * fa - hb * fb, ha * fa - lb * fb
    else:  # multiply
        cands = [x * y for x in (la, ha) for y in (lb, hb)]
        lo, hi = min(cands), max(cands)
        if max(abs(lo), abs(hi)) >= _I63:
            return None  # the int64 product itself may wrap
        extra = (sa + sb) - out.scale if out.is_decimal else 0
        if extra > 0:
            q = _pow10(extra)
            lo, hi = lo // q - 1, hi // q + 1  # half-up rounding slack
    return (lo, hi) if max(abs(lo), abs(hi)) < _I63 else None


# ---------------------------------------------------------------------------
# registry plumbing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Function:
    name: str
    infer: Callable[[Sequence[DataType]], DataType]
    evaluate: Callable[[Sequence[Column], DataType], Column]


REGISTRY: Dict[str, Function] = {}


def register(name: str):
    def deco(cls_or_pair):
        infer, evaluate = cls_or_pair()
        REGISTRY[name] = Function(name, infer, evaluate)
        return cls_or_pair

    return deco


def get_function(name: str) -> Function:
    try:
        return REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"scalar function {name!r} {_LATER} (have: {sorted(REGISTRY)})"
        ) from None


def _and_validity(cols: Sequence[Column]) -> Optional[torch.Tensor]:
    v = None
    for c in cols:
        if c.validity is not None:
            v = c.validity if v is None else (v & c.validity)
    return v


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _arith_infer(op: str):
    def infer(ts: Sequence[DataType]) -> DataType:
        a, b = ts
        if op == "multiply" and (a.is_decimal or b.is_decimal) \
                and not (a.is_float or b.is_float
                         or a.is_string or b.is_string):
            sa = a.scale if a.is_decimal else 0
            sb = b.scale if b.is_decimal else 0
            if a.is_wide_decimal or b.is_wide_decimal:
                prec = min((a.precision or 18) + (b.precision or 18), 38)
            else:
                prec = min(18, (a.precision or 18) + (b.precision or 18))
            return Decimal(prec, sa + sb, a.nullable or b.nullable)
        if op == "divide":
            if a.is_decimal or (a.is_integer and (b.is_decimal or b.is_integer)):
                sa = a.scale if a.is_decimal else 0
                if a.is_wide_decimal:
                    # DivDecimalInferer, capped at the widest precision
                    sb = b.scale if b.is_decimal else 0
                    return Decimal(
                        min(a.precision + sb + DIV_PRECISION_INCREMENT,
                            W.MAX_WIDE_PRECISION),
                        min(sa + DIV_PRECISION_INCREMENT, 30), True)
                return Decimal(18, sa + DIV_PRECISION_INCREMENT, True)
            return DataType(TypeKind.FLOAT64, True)
        return common_numeric_type(a, b)

    return infer


def _align_decimal_pair(a: Column, b: Column) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Bring both operands to int64 mantissas at a common scale."""
    sa = a.dtype.scale if a.dtype.is_decimal else 0
    sb = b.dtype.scale if b.dtype.is_decimal else 0
    s = max(sa, sb)
    da = a.data.to(torch.int64) * _pow10(s - sa)
    db = b.data.to(torch.int64) * _pow10(s - sb)
    return da, db, s


def _as_wide(c: Column, limbs: int = 2) -> torch.Tensor:
    """Column -> L-limb tensor, widening narrow-stored or plain mantissas
    and re-limbing other wides."""
    if c.data.ndim == 2:
        return W.resize_wide(c.data, limbs)[0]
    return W.widen_i64_to(c.data.to(torch.int64), limbs)


def _wide_align(a: Column, b: Column):
    """Both operands as same-limb-count mantissas at the common (max)
    scale; the limb count is the wider operand's.  A wide type may be
    stored narrow (1-D), as ``_wide_rewrite`` leaves sums it proves fit."""
    sa = a.dtype.scale if a.dtype.is_decimal else 0
    sb = b.dtype.scale if b.dtype.is_decimal else 0
    s = max(sa, sb)
    limbs = max(2, a.dtype.decimal_limbs if a.dtype.is_decimal else 0,
                b.dtype.decimal_limbs if b.dtype.is_decimal else 0,
                a.data.shape[-1] if a.data.ndim == 2 else 0,
                b.data.shape[-1] if b.data.ndim == 2 else 0)
    wa, _ = W.wide_scale_up(_as_wide(a, limbs), s - sa)
    wb, _ = W.wide_scale_up(_as_wide(b, limbs), s - sb)
    return wa, wb, s


def _divide_exact(a: Column, b: Column, out: DataType,
                  validity: Optional[torch.Tensor]) -> Column:
    """Decimal division by exact long division (``core/wide.py``), for
    wide operands or a narrow dividend whose scale shift can pass 18
    digits.  The limb count follows the scaled dividend's digits."""
    sa = a.dtype.scale if a.dtype.is_decimal else 0
    sb = b.dtype.scale if b.dtype.is_decimal else 0
    shift = out.scale - sa + sb
    assert shift >= 0, (out.scale, sa, sb)
    L = max(2, -(-((a.dtype.precision or 18) + shift) // 18),
            a.data.shape[-1] if a.data.ndim == 2 else 0,
            b.data.shape[-1] if b.data.ndim == 2 else 0)
    w, _ = W.wide_scale_up(_as_wide(a, L), shift)
    den_w = _as_wide(b, L)
    nonzero = torch.any(den_w != 0, dim=-1)
    one = W.widen_i64_to(torch.ones(den_w.shape[:-1], dtype=torch.int64,
                                    device=den_w.device), L)
    den_w = torch.where(nonzero[..., None], den_w, one)
    data = W.wide_div_wide_round_half_up(w, den_w)
    validity = nonzero if validity is None else (validity & nonzero)
    if out.decimal_limbs >= 2:
        if data.shape[-1] != out.decimal_limbs:
            data, ovf = W.resize_wide(data, out.decimal_limbs)
            # a quotient past the type's precision is NULL (the reference
            # engine errors; a shape-static program cannot throw)
            validity = validity & ~ovf
        return Column(data, validity, out)
    # a quotient past int64 is not flagged here, as in the reference
    val, _fits = W.narrow_i64(W.resize_wide(data, 2)[0])
    return Column(val, validity, out)


def _arith_eval(op: str):
    def evaluate(cols: Sequence[Column], out: DataType) -> Column:
        a, b = cols
        if a.dtype.is_string or b.dtype.is_string:
            raise NotImplementedError(f"string operands of {op} {_LATER}")
        validity = _and_validity([a, b])
        wide_operand = ((a.dtype.is_wide_decimal or b.dtype.is_wide_decimal)
                        and out.is_decimal)
        if wide_operand and op in ("plus", "minus"):
            wa, wb, s = _wide_align(a, b)
            if out.scale > s:
                wa, _ = W.wide_scale_up(wa, out.scale - s)
                wb, _ = W.wide_scale_up(wb, out.scale - s)
            data = W.wide_add(wa, wb) if op == "plus" else W.wide_sub(wa, wb)
            return Column(data, validity, out)
        if wide_operand and op == "multiply":
            sa = a.dtype.scale if a.dtype.is_decimal else 0
            sb = b.dtype.scale if b.dtype.is_decimal else 0
            data, ovf = W.wide_mul(_as_wide(a), _as_wide(b))
            extra = (sa + sb) - out.scale
            if extra > 0:
                p10, _ = W.wide_scale_up(
                    W.widen_i64(torch.ones_like(W.wide_hi(data))), extra)
                data = W.wide_div_wide_round_half_up(data, p10)
            # a product past precision 38 is NULL (the reference engine
            # errors; a shape-static program cannot throw)
            validity = ~ovf if validity is None else (validity & ~ovf)
            return Column(data, validity, out)
        if op == "divide" and out.is_decimal and (
                a.dtype.is_wide_decimal or b.dtype.is_wide_decimal
                or (a.dtype.precision or 18) + out.scale
                - (a.dtype.scale if a.dtype.is_decimal else 0)
                + (b.dtype.scale if b.dtype.is_decimal else 0) > 18):
            return _divide_exact(a, b, out, validity)
        if out.is_decimal:
            if op in ("plus", "minus"):
                da, db, s = _align_decimal_pair(a, b)
                da = da * _pow10(out.scale - s)
                db = db * _pow10(out.scale - s)
                data = da + db if op == "plus" else da - db
            elif op == "multiply":
                sa = a.dtype.scale if a.dtype.is_decimal else 0
                sb = b.dtype.scale if b.dtype.is_decimal else 0
                data = a.data.to(torch.int64) * b.data.to(torch.int64)
                extra = (sa + sb) - out.scale
                if extra > 0:
                    data = _div_round_half_up(data, _pow10(extra))
            else:  # divide: result scale s_a + 4, half up, NULL on /0
                sa = a.dtype.scale if a.dtype.is_decimal else 0
                sb = b.dtype.scale if b.dtype.is_decimal else 0
                num = a.data.to(torch.int64) * _pow10(out.scale - sa + sb)
                den = b.data.to(torch.int64)
                nonzero = den != 0
                data = _div_round_half_up(num, torch.where(nonzero, den,
                                                           torch.ones_like(den)))
                validity = nonzero if validity is None else (validity & nonzero)
            return Column(data, validity, out)
        da, db = _operand_values(a, out), _operand_values(b, out)
        if op == "plus":
            data = da + db
        elif op == "minus":
            data = da - db
        elif op == "multiply":
            data = da * db
        else:  # divide: NULL on a zero divisor
            nonzero = db != 0
            data = da / torch.where(nonzero, db, torch.ones_like(db))
            validity = nonzero if validity is None else (validity & nonzero)
        return Column(data.to(out.torch_dtype), validity, out)

    return evaluate


for _op in ("plus", "minus", "multiply", "divide"):
    register(_op)(lambda _op=_op: (_arith_infer(_op), _arith_eval(_op)))


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

_CMP_FNS = {
    "equals": torch.eq,
    "not_equals": torch.ne,
    "less": torch.lt,
    "less_or_equals": torch.le,
    "greater": torch.gt,
    "greater_or_equals": torch.ge,
}


def _cmp_eval(op: str):
    def evaluate(cols: Sequence[Column], out: DataType) -> Column:
        a, b = cols
        validity = _and_validity(cols)
        if a.dtype.is_string and b.dtype.is_string:
            # literals were encoded into the column's code space by the
            # compile layer; two columns compare only in one dictionary
            if (a.dictionary or ()) != (b.dictionary or ()):
                raise NotImplementedError(
                    f"string compare across dictionaries {_LATER}")
            da, db = a.data, b.data
        elif a.dtype.is_string or b.dtype.is_string:
            raise NotImplementedError(f"mixed string compare {_LATER}")
        elif a.dtype.is_wide_decimal or b.dtype.is_wide_decimal:
            # limb-wise: lower limbs are in [0, 10^18), so (hi, ..., lo)
            # order is lexicographic
            wa, wb, _ = _wide_align(a, b)
            lt = W.wide_cmp_lt(wa, wb)
            eq = W.wide_eq(wa, wb)
            data = {
                "equals": eq,
                "not_equals": ~eq,
                "less": lt,
                "less_or_equals": lt | eq,
                "greater": ~(lt | eq),
                "greater_or_equals": ~lt,
            }[op]
            return Column(data, validity, out)
        elif {a.dtype.kind, b.dtype.kind} == {TypeKind.DATE,
                                              TypeKind.DATETIME}:
            def as_us(c):
                if c.dtype.kind is TypeKind.DATE:
                    return c.data.to(torch.int64) * 86_400_000_000
                return c.data.to(torch.int64)

            da, db = as_us(a), as_us(b)
        elif a.dtype.is_decimal or b.dtype.is_decimal:
            da, db, _ = _align_decimal_pair(a, b)
        elif a.dtype.is_float or b.dtype.is_float:
            da = a.data.to(torch.float64)
            db = b.data.to(torch.float64)
        elif a.dtype.is_unsigned or b.dtype.is_unsigned:
            raise NotImplementedError(f"unsigned compare {_LATER}")
        else:
            da = a.data.to(torch.int64)
            db = b.data.to(torch.int64)
        return Column(_CMP_FNS[op](da, db), validity, out)

    return evaluate


def _cmp_infer(ts: Sequence[DataType]) -> DataType:
    return DataType(TypeKind.BOOL, ts[0].nullable or ts[1].nullable)


for _op in _CMP_FNS:
    register(_op)(lambda _op=_op: (_cmp_infer, _cmp_eval(_op)))


@register("in")
def _in():
    def infer(ts):
        return DataType(TypeKind.BOOL, any(t.nullable for t in ts))

    def evaluate(cols, out):
        # MySQL's three-valued IN: TRUE on a match; otherwise NULL if the
        # probe or any list element is NULL, else FALSE
        a = cols[0]
        acc = None
        some_null = torch.zeros((), dtype=torch.bool, device=a.data.device)
        for c in cols[1:]:
            eq = REGISTRY["equals"].evaluate([a, c], DataType(TypeKind.BOOL))
            hit = eq.data if c.validity is None else (eq.data & c.validity)
            acc = hit if acc is None else (acc | hit)
            if c.validity is not None:
                some_null = some_null | ~c.validity
        validity = acc | ~some_null
        if a.validity is not None:
            validity = validity & a.validity
        return Column(acc, validity, out)

    return infer, evaluate


# ---------------------------------------------------------------------------
# logic (three-valued)
# ---------------------------------------------------------------------------

@register("and")
def _and():
    def infer(ts):
        return DataType(TypeKind.BOOL, any(t.nullable for t in ts))

    def evaluate(cols, out):
        a, b = cols
        va, vb = a.valid_mask(), b.valid_mask()
        ba, bb = a.data.to(torch.bool), b.data.to(torch.bool)
        data = (ba & va) & (bb & vb)  # NULL treated as "not known true"
        # result NULL iff neither side is a known FALSE and some side is NULL
        known_false = (va & ~ba) | (vb & ~bb)
        validity = (va & vb) | known_false
        if a.validity is None and b.validity is None:
            validity = None
        return Column(data, validity, out)

    return infer, evaluate


@register("or")
def _or():
    def infer(ts):
        return DataType(TypeKind.BOOL, any(t.nullable for t in ts))

    def evaluate(cols, out):
        a, b = cols
        va, vb = a.valid_mask(), b.valid_mask()
        da = a.data.to(torch.bool) & va
        db = b.data.to(torch.bool) & vb
        data = da | db
        validity = (va & vb) | data
        if a.validity is None and b.validity is None:
            validity = None
        return Column(data, validity, out)

    return infer, evaluate


@register("not")
def _not():
    def infer(ts):
        return DataType(TypeKind.BOOL, ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        return Column(~a.data.to(torch.bool), a.validity, out)

    return infer, evaluate


# ---------------------------------------------------------------------------
# date/time extraction (epoch-int representation)
# ---------------------------------------------------------------------------

def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(days: torch.Tensor):
    """Epoch days -> (year, month, day): Howard Hinnant's algorithm,
    branch-free and exact over the full int32 range."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _date_days(col: Column) -> torch.Tensor:
    if col.dtype.kind is TypeKind.DATE:
        return col.data.to(torch.int64)
    if col.dtype.kind is TypeKind.DATETIME:
        return _fdiv(col.data, 86_400_000_000)
    raise TypeError(f"expected date/datetime, got {col.dtype}")


def _register_date_part(name: str, part: int):
    def factory():
        def infer(ts):
            return DataType(TypeKind.INT64, ts[0].nullable)

        def evaluate(cols, out):
            (a,) = cols
            days = _date_days(a)
            data = _civil_from_days(days)[part]
            # YEAR/MONTH/DAY of the ZERO date are 0, not NULL (MySQL)
            data = torch.where(days == ZERO_DATE_DAYS, 0, data)
            return Column(data.to(torch.int64), a.validity, out)

        return infer, evaluate

    register(name)(factory)


_register_date_part("year", 0)


__all__ = ["get_function", "propagate_stats", "DIV_PRECISION_INCREMENT",
           "_div_round_half_up", "REGISTRY"]
