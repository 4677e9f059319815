"""Scalar function registry with TiDB-flavored semantics.

Counterpart of ``tiflash_tpu/expr/functions.py``, in eager torch:

- ``cast_column`` for every non-string source and target: decimal,
  float, integer (BIGINT UNSIGNED included), wide decimals, DATE,
  DATETIME and DURATION (MySQL's numeric temporal forms); from a string
  through a LUT over its dictionary (``_cast_string_lut``, MySQL's
  numeric-prefix and lax datetime parses); out of JSON by the unquoted
  text;
- arithmetic ``plus``/``minus``/``multiply``/``divide``/``int_div``/
  ``modulo``, ``negate``, ``abs``: decimals in int64 mantissas or
  multi-limb wides (``core/wide.py``), integer DIV/MOD on uint64
  magnitudes (``INT64_MIN``-safe), NULL on a zero divisor;
- the comparisons, ``null_eq``, ``in``, three-valued logic, ``xor``,
  ``is_*``; ``if``/``coalesce``/``case_when``;
- math: the float unary family, ``atan2``, ``pow``, the round family
  (``round_decimal_frac(_dynamic)`` for a digit argument), ``sign``,
  ``greatest``/``least``/``nullif``, bit operations, shifts, ``bit_count``;
- date parts and date/datetime functions (``date_add_*``, ``datediff``,
  ``week``/``yearweek``, ``from_days``, ``period_*``, ``unix_timestamp``,
  ``from_unixtime``, ``interval``, ``cast_fsp_round`` ...);
- ``propagate_stats``, the reference's interval arithmetic, and beyond
  it the image of ``year`` (so a year-keyed group takes the dense method);
- the string functions of the registry (``upper`` ... ``json_valid``):
  each is a host table over the argument's dictionary (numbers get their
  MySQL text first), copied to the column's device and gathered by code
  (``_map_string_to_string`` and its siblings); an ``EvalError`` entry
  of a table becomes a per-row error mask (``runtime/errors.py``);
- the TIME functions of ``expr/duration.py``.

The string functions named only in the expression compiler (``concat``,
``regexp_*``, ``json_*`` ...) live in ``expr/compile.py``.

What is not a port of the reference's code but of its semantics:

- torch has few ``uint64`` kernels (no ``%``, ``//``, ``+`` or ``<`` on
  the CPU, fewer on CUDA), so BIGINT UNSIGNED values are computed on
  their int64 bit patterns (``_bits``/``_u64``) with unsigned compare,
  divide and convert emulated;
- the reference's ``_barrier_div`` keeps XLA from turning a division by a
  constant into a reciprocal multiply; CUDA torch does the same to a
  division by a host scalar, so ``_div_f64`` divides by a 0-dim tensor
  on the operand's device;
- the reference's ``_float_fmod`` loops per exponent binade because XLA's
  float remainder is inexact; ``torch.fmod`` is exact C fmod.  Denormal
  results differ: the reference flushes them to zero.

The ``vec_*`` functions reduce each (n, dims) float32 row in float32,
as the reference's do, and give float64; their sums add in another order
than XLA's, so they agree within a float32 ulp bound scaled by dims, not
bit for bit.  The batched form is ``ops/vector.py``.  The
grouping functions read the Expand node's ``groupingID`` column
(``ops/expand.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import re
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import wide as W
from ..core.block import Column
from ..core.dtypes import (
    BOOL,
    DURATION_MAX_US,
    FLOAT64,
    STRING,
    ZERO_DATE_DAYS,
    ZERO_DT_BASE_US,
    CivilDate,
    CivilDateTime,
    DataType,
    Decimal,
    TypeKind,
    ZeroDate,
    ZeroDateTime,
    civil_to_days,
    common_numeric_type,
)

DIV_PRECISION_INCREMENT = 4  # TiDB div_precision_increment default

def _pow10(k: int) -> int:
    return 10 ** k


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    """Floor division (the reference's ``//`` on int64)."""
    return torch.div(a, b, rounding_mode="floor")


def _fmod(a: torch.Tensor, b) -> torch.Tensor:
    """Floored remainder (the reference's ``%`` on int64)."""
    return torch.remainder(a, b)


# ---------------------------------------------------------------------------
# unsigned 64-bit on int64 bit patterns
# ---------------------------------------------------------------------------

_I64_MIN = -(2 ** 63)
_U32_MASK = 0xFFFFFFFF


def _bits(t: torch.Tensor) -> torch.Tensor:
    """int64 view of an integer tensor: a uint64 one is reinterpreted
    (mod 2^64), others widen."""
    if t.dtype == torch.uint64:
        return t.view(torch.int64)
    return t.to(torch.int64)


def _u64(bits: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns -> the uint64 tensor with those bits."""
    return bits.contiguous().view(torch.uint64)


def _lsr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 < k < 64."""
    return (a >> k) & ((1 << (64 - k)) - 1)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def _udivmod(a: torch.Tensor, d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned 64-bit quotient and remainder on int64 bit patterns.  A
    zero divisor gives (all ones, a), XLA's unsigned-division result."""
    d = torch.broadcast_to(torch.as_tensor(d, dtype=torch.int64,
                                           device=a.device), a.shape)
    zero = d == 0
    big = d < 0                       # divisor >= 2^63: quotient is 0 or 1
    ds = torch.where(zero | big, torch.ones_like(d), d)
    q = torch.div(_lsr(a, 1), ds, rounding_mode="trunc") << 1
    r = a - q * ds
    fix = ~_ult(r, ds)
    q = q + fix.to(torch.int64)
    r = torch.where(fix, r - ds, r)
    qb = (~_ult(a, d)).to(torch.int64)
    rb = torch.where(qb.bool(), a - d, a)
    q = torch.where(big, qb, q)
    r = torch.where(big, rb, r)
    return (torch.where(zero, torch.full_like(q, -1), q),
            torch.where(zero, a, r))


def _u64_to_f64(bits: torch.Tensor) -> torch.Tensor:
    """Correctly rounded uint64 -> float64: two exact halves, one
    rounding in the sum."""
    hi = _lsr(bits, 32).to(torch.float64)
    lo = (bits & _U32_MASK).to(torch.float64)
    return hi * 4294967296.0 + lo


def _f64_to_u64_bits(x: torch.Tensor) -> torch.Tensor:
    """Integral float64 in [0, 2^64) -> uint64 bit patterns (values at or
    past 2^63 go through their offset from 2^63)."""
    top = x >= 9223372036854775808.0
    low = torch.where(top, x - 9223372036854775808.0, x)
    b = low.to(torch.int64)
    return torch.where(top, b ^ _I64_MIN, b)


_TWO63 = 9223372036854775808.0
_TWO64 = 18446744073709551616.0


def _f2i(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Float -> integer dtype as XLA converts: truncation, saturating at
    the type's range, NaN -> 0 (C leaves both cases undefined, and the
    torch CPU build wraps)."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x.to(torch.float64))
    if dt == torch.uint64:
        b = _f64_to_u64_bits(torch.trunc(x).clamp(0.0, _TWO64 - 2048.0))
        return _u64(torch.where(x >= _TWO64, torch.full_like(b, -1), b))
    if dt == torch.int64:
        v = x.clamp(-_TWO63, _TWO63 - 1024.0).to(torch.int64)
        return torch.where(x >= _TWO63, torch.full_like(v, 2 ** 63 - 1), v)
    info = torch.iinfo(dt)
    return x.clamp(float(info.min), float(info.max)).to(dt)


def _convert(data: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``astype`` with uint64 on either side done on bit patterns, and
    float -> integer saturating (``_f2i``)."""
    if data.dtype == dt:
        return data
    if data.is_floating_point() and not dt.is_floating_point and dt != torch.bool:
        return _f2i(data, dt)
    if dt == torch.uint64:
        return _u64(_bits(data))
    if data.dtype == torch.uint64:
        b = data.view(torch.int64)
        if dt.is_floating_point:
            return _u64_to_f64(b).to(dt)
        return b.to(dt)
    return data.to(dt)


def _div_f64(x: torch.Tensor, den) -> torch.Tensor:
    """x / den correctly rounded (m / 10^s, never m * 10^-s).  The divisor
    goes in as a 0-dim tensor on x's device: CUDA torch turns a division
    by a host scalar into a multiplication by its reciprocal."""
    return x / torch.full((), float(den), dtype=torch.float64, device=x.device)


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


def _resize2(w: torch.Tensor) -> torch.Tensor:
    if w.shape[-1] == 2:
        return w
    return W.resize_wide(w, 2)[0]


def _wide_const(value: int, limbs: int, shape, device) -> torch.Tensor:
    """A host integer as an ``limbs``-limb wide tensor of ``shape``."""
    parts = []
    v = value
    for _ in range(limbs - 1):
        parts.append(v % W.W18)
        v //= W.W18
    parts.append(v)
    return torch.stack([torch.full(tuple(shape), x, dtype=torch.int64,
                                   device=device)
                        for x in reversed(parts)], dim=-1)


# ---------------------------------------------------------------------------
# casts
# ---------------------------------------------------------------------------

def _temporal_out(us: torch.Tensor, ok: torch.Tensor, col: Column,
                  target: DataType) -> Column:
    v = ok if col.validity is None else (col.validity & ok)
    if target.kind is TypeKind.DATE:
        us = _fdiv(us, 86_400_000_000)
    return _temporal_result(us, v, target)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def cast_column(col: Column, target: DataType) -> Column:
    """Numeric/temporal cast, MySQL ``CAST`` semantics; a string source
    parses through a LUT over its dictionary (casts to strings are the
    expression compiler's ``_cast_to_string_lut``)."""
    src = col.dtype
    if (src.kind == target.kind and src.scale == target.scale
            and (not src.is_decimal
                 or src.is_wide_decimal == target.is_wide_decimal)):
        return Column(col.data, col.validity, target, col.dictionary)
    data = col.data
    if src.is_string and src.mysql_json and not target.is_string:
        # out of JSON: a JSON string element converts by its unquoted
        # text, any other document by its own text
        def unquote(s: str) -> str:
            if s.startswith('"') and s.endswith('"'):
                try:
                    v = json.loads(s)
                    if isinstance(v, str):
                        return v
                except Exception:
                    pass
            return s

        col = Column(col.data, col.validity,
                     dataclasses.replace(src, mysql_json=False),
                     tuple(unquote(s) for s in (col.dictionary or ())))
        src = col.dtype
    if src.is_string and not target.is_string:
        return _cast_string_lut(col, target)
    if (target.is_decimal and (target.is_wide_decimal or data.ndim == 2
                               or src.kind is TypeKind.UINT64)) \
            or (src.is_decimal and data.ndim == 2):
        return _cast_wide(col, target)
    if src.kind is TypeKind.DATE and target.kind is TypeKind.DATETIME:
        return Column(data.to(torch.int64) * 86_400_000_000, col.validity,
                      target)
    if src.is_float and target.kind in (TypeKind.DATE, TypeKind.DATETIME):
        whole = _f2i(_round_half_away(data.to(torch.float64)), torch.int64)
        us, ok = _numeric_to_datetime_us(whole)
        return _temporal_out(us, ok, col, target)
    if (src.is_integer or src.kind is TypeKind.BOOL) and \
            target.kind in (TypeKind.DATE, TypeKind.DATETIME):
        # MySQL numeric temporal form: [YY]YYMMDD[HHMMSS]; invalid -> NULL
        us, ok = _numeric_to_datetime_us(_bits(data))
        return _temporal_out(us, ok, col, target)
    if src.is_decimal and target.kind in (TypeKind.DATE, TypeKind.DATETIME) \
            and data.ndim == 1:
        us, ok = _numeric_to_datetime_us(
            _div_round_half_up(data, _pow10(src.scale)))
        return _temporal_out(us, ok, col, target)
    if src.kind is TypeKind.DATETIME and target.kind is TypeKind.DATE:
        return Column(_fdiv(data, 86_400_000_000).to(torch.int32),
                      col.validity, target)
    if src.kind is TypeKind.DURATION or target.kind is TypeKind.DURATION:
        return _cast_duration(col, target)
    if target.is_decimal:
        if src.is_decimal:
            ds = target.scale - src.scale
            if ds > 0:
                data = data * _pow10(ds)
            elif ds < 0:
                data = _div_round_half_up(data, _pow10(-ds))
        elif src.kind in (TypeKind.DATE, TypeKind.DATETIME):
            # MySQL numeric form: YYYYMMDD[HHMMSS][.frac]
            whole, frac = _temporal_numeric_parts(col)
            sc = target.scale
            if sc <= 6:
                data = whole * _pow10(sc) + _div_round_half_up(
                    frac, _pow10(6 - sc))
            else:
                data = whole * _pow10(sc) + frac * _pow10(sc - 6)
        elif src.is_integer or src.kind is TypeKind.BOOL:
            data = _bits(data) * _pow10(target.scale)
        elif src.is_float:
            x = data.to(torch.float64) * float(_pow10(target.scale))
            # MySQL rounds half away from zero
            data = _f2i(_round_half_away(x), torch.int64)
        else:
            raise NotImplementedError(f"cast {src} -> {target}")
        # MySQL saturates at the target's max/min
        if target.precision and target.precision <= 18 and data.ndim == 1:
            lim = 10 ** target.precision - 1
            data = data.clamp(-lim, lim)
    elif target.is_float:
        if src.is_decimal:
            # m / 10^s in float64: correctly rounded (never * 10^-s)
            data = _div_f64(data.to(torch.float64), _pow10(src.scale))
        elif src.kind in (TypeKind.DATE, TypeKind.DATETIME):
            whole, frac = _temporal_numeric_parts(col)
            data = whole.to(torch.float64) + _div_f64(frac.to(torch.float64), 1e6)
        else:
            data = _convert(data, target.torch_dtype)
    elif target.is_integer:
        if src.is_decimal:
            data = _div_round_half_up(data, _pow10(src.scale))
        elif src.is_float:
            data = _convert(_round_half_away(data.to(torch.float64)),
                            target.torch_dtype)
        elif src.kind in (TypeKind.DATE, TypeKind.DATETIME):
            whole, frac = _temporal_numeric_parts(col)
            data = whole + (frac >= 500_000).to(torch.int64)
        else:
            data = _convert(data, target.torch_dtype)
    elif target.kind is TypeKind.BOOL:
        data = (_bits(data) if data.dtype == torch.uint64 else data) != 0
    else:
        raise NotImplementedError(f"cast {src} -> {target}")
    return Column(_convert(data, target.torch_dtype), col.validity, target)


def _cast_wide(col: Column, target: DataType) -> Column:
    """Casts involving multi-limb (precision > 18) decimals.  The target's
    limb count follows its precision (2 for p <= 38, 4 for p <= 65)."""
    src = col.dtype
    data = col.data
    if target.is_decimal:
        tl = max(2, target.decimal_limbs)
        if src.is_decimal:
            if data.ndim == 2:
                w, _ = W.resize_wide(data, tl)
            else:
                w = W.widen_i64_to(data.to(torch.int64), tl)
            ds = target.scale - src.scale
            if ds > 0:
                w, _ = W.wide_scale_up(w, ds)
            elif ds < 0:
                if -ds > 9:
                    raise NotImplementedError(f"wide rescale by 10^{-ds}")
                w = W.wide_div_round_half_up(
                    w, torch.full(w.shape[:-1], 10 ** (-ds), dtype=torch.int64,
                                  device=w.device))
        elif src.is_integer or src.kind is TypeKind.BOOL:
            if src.kind is TypeKind.UINT64:
                q, r = _udivmod(_bits(data), W.W18)
                w, _ = W.resize_wide(W.make_wide(q, r), tl)
            else:
                w = W.widen_i64_to(data.to(torch.int64), tl)
            w, _ = W.wide_scale_up(w, target.scale)
        elif src.kind in (TypeKind.DATE, TypeKind.DATETIME):
            whole, frac = _temporal_numeric_parts(col)
            w, _ = W.wide_scale_up(W.widen_i64_to(whole, tl), target.scale)
            sc = target.scale
            fr = (_div_round_half_up(frac, _pow10(6 - sc)) if sc <= 6
                  else frac * _pow10(min(sc - 6, 12)))
            w = W.wide_add(w, W.widen_i64_to(fr, tl))
        else:
            raise NotImplementedError(f"cast {src} -> {target}")
        # saturate at +-(10^p - 1), the MySQL overflow behavior
        p = target.precision or 18 * tl * 2
        if p < 18 * tl * 2:
            lim = _wide_const(10 ** p - 1, tl, w.shape[:-1], w.device)
            neg_lim = W.wide_neg(lim)
            w = torch.where(W.wide_cmp_lt(lim, w)[..., None], lim, w)
            w = torch.where(W.wide_cmp_lt(w, neg_lim)[..., None], neg_lim, w)
        if target.decimal_limbs >= 2:
            if w.shape[-1] != target.decimal_limbs:
                w, _ = W.resize_wide(w, target.decimal_limbs)
            return Column(w, col.validity, target)
        val, _fits = W.narrow_i64(_resize2(w))  # saturation guarantees fit
        return Column(val, col.validity, target)
    # wide decimal source -> non-decimal target
    if target.is_float:
        f = _div_f64(W.wide_to_f64(data), 10 ** src.scale)
        return Column(f.to(target.torch_dtype), col.validity, target)
    if target.is_integer:
        if src.scale > 9:
            raise NotImplementedError("wide->int with scale > 9")
        w = data if src.scale == 0 else W.wide_div_round_half_up(
            data, torch.full(data.shape[:-1], 10 ** src.scale,
                             dtype=torch.int64, device=data.device))
        val, _ = W.narrow_i64(_resize2(w))
        return Column(_convert(val, target.torch_dtype), col.validity, target)
    raise NotImplementedError(f"cast {src} -> {target}")


def _numeric_to_datetime_us(v: torch.Tensor):
    """MySQL numeric temporal literal [YY]YYMMDD[HHMMSS] -> (epoch us,
    valid mask).  Two-digit years < 70 are 20xx, else 19xx; fields are
    range-checked and the day validated by a civil-date round trip."""
    has_time = v > 99_999_999
    date_part = torch.where(has_time, _fdiv(v, 1_000_000), v)
    time_part = torch.where(has_time, _fmod(v, 1_000_000), torch.zeros_like(v))
    yy = _fdiv(date_part, 10_000)
    two_digit = date_part <= 991_231
    y4 = torch.where(yy < 70, yy + 2000, yy + 1900)
    date_full = torch.where(two_digit, y4 * 10_000 + _fmod(date_part, 10_000),
                            date_part)
    y = _fdiv(date_full, 10_000)
    mo = _fmod(_fdiv(date_full, 100), 100)
    d = _fmod(date_full, 100)
    hh = _fdiv(time_part, 10_000)
    mi = _fmod(_fdiv(time_part, 100), 100)
    ss = _fmod(time_part, 100)
    days = _days_from_civil(y, mo.clamp(1, 12), d.clamp(1, 31))
    ry, rm, rd = _civil_from_days(days)
    ok = ((v > 0) & (mo >= 1) & (mo <= 12) & (d >= 1)
          & (ry == y) & (rm == mo) & (rd == d)
          & (hh < 24) & (mi < 60) & (ss < 60)
          & (y >= 1000) & (y <= 9999))
    us = (days * 86_400_000_000 + hh * 3_600_000_000
          + mi * 60_000_000 + ss * 1_000_000)
    return us, ok


def _temporal_numeric_parts(col: Column):
    """MySQL numeric form of a DATE/DATETIME: (whole YYYYMMDD[HHMMSS],
    fractional microseconds), both int64."""
    if col.dtype.kind is TypeKind.DATE:
        y, m, d = _civil_from_days(col.data.to(torch.int64))
        whole = y * 10_000 + m * 100 + d
        return whole, torch.zeros_like(whole)
    us = col.data.to(torch.int64)
    days = _fdiv(us, 86_400_000_000)
    tod = us - days * 86_400_000_000
    y, m, d = _civil_from_days(days)
    hh = _fdiv(tod, 3_600_000_000)
    mi = _fmod(_fdiv(tod, 60_000_000), 60)
    ss = _fmod(_fdiv(tod, 1_000_000), 60)
    frac = _fmod(tod, 1_000_000)
    whole = ((y * 10_000 + m * 100 + d) * 1_000_000
             + hh * 10_000 + mi * 100 + ss)
    return whole, frac


def _cast_duration(col: Column, target: DataType) -> Column:
    """Duration casts.  The numeric form of a TIME is MySQL's HHMMSS
    packing; DATETIME <-> DURATION goes through the query-clock date and
    the time of day."""
    src = col.dtype
    data = col.data
    if src.kind is TypeKind.DURATION:
        us = data.to(torch.int64)
        neg = us < 0
        mag = us.abs()
        h = _fdiv(mag, 3_600_000_000)
        m = _fmod(_fdiv(mag, 60_000_000), 60)
        s = _fmod(_fdiv(mag, 1_000_000), 60)
        frac = _fmod(mag, 1_000_000)
        packed = h * 10_000 + m * 100 + s
        if target.is_integer:
            out = torch.where(neg, -packed, packed)
            return Column(_convert(out, target.torch_dtype), col.validity,
                          target)
        if target.is_float:
            f = packed.to(torch.float64) + _div_f64(frac.to(torch.float64), 1e6)
            out = torch.where(neg, -f, f)
            return Column(out.to(target.torch_dtype), col.validity, target)
        if target.is_decimal:
            sc = target.scale
            if sc <= 6:
                mant = packed * _pow10(sc) + _fdiv(frac, _pow10(6 - sc))
            else:
                mant = packed * _pow10(sc) + frac * _pow10(sc - 6)
            return Column(torch.where(neg, -mant, mant), col.validity, target)
        if target.kind is TypeKind.DATETIME:
            # CAST(time AS DATETIME): anchored on the query-clock date
            from .compile import query_now_us

            day0 = (query_now_us() // 86_400_000_000) * 86_400_000_000
            return Column(day0 + us, col.validity, target)
        if target.kind is TypeKind.BOOL:
            return Column(us != 0, col.validity, target)
        raise NotImplementedError(f"cast {src} -> {target}")
    # -> DURATION
    if src.kind is TypeKind.DATETIME:
        us = data.to(torch.int64)
        tod = us - _fdiv(us, 86_400_000_000) * 86_400_000_000
        return Column(tod, col.validity, target)
    if src.kind is TypeKind.DATE:
        return Column(torch.zeros_like(data, dtype=torch.int64), col.validity,
                      target)
    if src.is_integer or src.is_decimal or src.is_float:
        # numeric HHMMSS[.frac] -> duration
        if src.is_decimal:
            sc = src.scale
            whole = torch.sign(data) * _fdiv(data.abs(), _pow10(sc))
            fr = _fmod(data.abs(), _pow10(sc))
            frac_us = (fr * _pow10(6 - sc) if sc <= 6
                       else _fdiv(fr, _pow10(sc - 6)))
            num = _div_f64(data.to(torch.float64), _pow10(sc))
        elif src.is_float:
            num = data.to(torch.float64)
            whole = torch.trunc(num).to(torch.int64)
            frac_us = (torch.remainder(num.abs(), 1.0) * 1e6 + 0.5).to(
                torch.int64)
        else:
            whole = _bits(data)
            frac_us = torch.zeros_like(whole)
            num = whole.to(torch.float64)
        neg = num < 0
        mag = whole.abs()
        h = _fdiv(mag, 10_000)
        m = _fmod(_fdiv(mag, 100), 100)
        s = _fmod(mag, 100)
        ok = (m < 60) & (s < 60)
        us = h * 3_600_000_000 + m * 60_000_000 + s * 1_000_000 + frac_us
        us = torch.where(neg, -us, us).clamp(-DURATION_MAX_US, DURATION_MAX_US)
        v = ok if col.validity is None else (col.validity & ok)
        return Column(us, v, target.with_nullable(True))
    raise NotImplementedError(f"cast {src} -> {target}")


def parse_mysql_time(s: str):
    """'[-][D ]HH:MM:SS[.f]', 'HH:MM', 'SS' or numeric 'HHMMSS' -> signed
    microseconds clamped to the TIME range, or None when unparseable (a
    literal's host parse, MySQL's TIME grammar)."""
    s = s.strip()
    m = re.match(
        r"^([+-]?)(?:(\d+)\s+)?(\d+)(?::(\d{1,2})(?::(\d{1,2}))?)?"
        r"(?:\.(\d{1,6}))?$", s)
    if not m:
        return None
    sign = -1 if m.group(1) == "-" else 1
    days = int(m.group(2) or 0)
    if m.group(4) is None:
        # a bare number reads as [HH]MMSS
        n = int(m.group(3))
        h, mm, ss = n // 10_000, (n // 100) % 100, n % 100
        if days:
            h += days * 24
    else:
        h = days * 24 + int(m.group(3))
        mm = int(m.group(4))
        ss = int(m.group(5) or 0)
    if mm >= 60 or ss >= 60:
        return None
    frac = int((m.group(6) or "0").ljust(6, "0"))
    us = sign * (((h * 60 + mm) * 60 + ss) * 1_000_000 + frac)
    return max(-DURATION_MAX_US, min(DURATION_MAX_US, us))


_PUNCT = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")

# zone designator suffix: Z, +HH, +HHMM or +HH:MM
_TZ_SUFFIX_RE = re.compile(r"(Z|[+-]\d{2}(?::\d{2}|\d{2})?)$")


def _split_datetime_fields(body: str):
    """Digit runs separated by punctuation; a space or 'T' is legal only
    after the third run (the date/time gap), any separator after the
    fifth.  None on an illegal character."""
    runs = []
    i = 0
    n = len(body)
    while i < n:
        j = i
        while j < n and body[j].isdigit():
            j += 1
        if j == i:
            return None
        runs.append(body[i:j])
        k = j
        while k < n and not body[k].isdigit():
            c = body[k]
            ok = (c in _PUNCT
                  or (len(runs) == 3 and (c == "T" or c.isspace()))
                  or len(runs) > 5)
            if not ok:
                return None
            k += 1
        if k < n and k == j and j < n:
            return None
        i = k
    return runs


# one compact digit run: MySQL's numeric datetime widths (YYYYMMDD[HHMMSS]
# and the two-digit-year forms; the last field may be one digit)
_COMPACT_LAYOUTS = {14: (4, 2, 2, 2, 2, 2), 12: (2, 2, 2, 2, 2, 2),
                    11: (2, 2, 2, 2, 2, 1), 10: (2, 2, 2, 2, 2),
                    9: (2, 2, 2, 2, 1), 8: (4, 2, 2), 7: (2, 2, 2, 1),
                    6: (2, 2, 2), 5: (2, 2, 1)}


def mysql_str_to_datetime(s: str, fields_only: bool = False):
    """String -> datetime.datetime under MySQL's lax datetime grammar:

        text     :=  fields [ '.' digits ] [ zone ]
        zone     :=  'Z' | ('+'|'-') HH [ ':' MM | MM ]
        fields   :=  digit runs split by punctuation (space/'T' only in
                     the date/time gap), or one compact run laid out by
                     its length (two-digit years < 70 are 20xx)

    A trailing '.digits' or bare '+HH' that would be a fraction or a zone
    is taken as the next field while the text lacks a full date and time
    ('2020.01.01' parses its '.01' as the day).  A '.xxx' tail of a
    compact DATE is a compact TIME; of a 9/10-digit compact, the seconds.
    Zones apply only to full datetimes and shift into UTC.  Returns None
    where MySQL yields NULL; ``fields_only`` returns the raw civil fields
    (month and day may be 0)."""
    s = s.strip()
    if not s:
        return None

    # zone suffix
    tz_sign = tz_hour = tz_minute = ""
    tz_sep = False
    has_tz = False
    body = s
    m = _TZ_SUFFIX_RE.search(s)
    if m and m.start() > 0:
        g = m.group(1)
        has_tz = True
        if g != "Z":
            tz_sign = g[0]
            tz_hour = g[1:3]
            rest = g[3:]
            tz_sep = rest.startswith(":")
            tz_minute = rest.lstrip(":")
        e = m.start()
        while e > 0 and s[e - 1] in _PUNCT:
            e -= 1
        body = s[:e]

    # trailing fraction
    frac_str = ""
    dot = max((i for i in range(len(body) - 1, -1, -1)
               if body[i] in _PUNCT and body[i] not in "+-"),
              default=-1)
    if dot > 0 and body[dot] == ".":
        tail = body[dot + 1:]
        if not tail.isdigit() and tail:
            return None  # garbage after the fraction digits
        frac_str = tail
        fi = dot
        while fi > 0 and body[fi - 1] in _PUNCT:
            fi -= 1
        body = body[:fi]

    # field runs
    body = body.strip()
    if not body or not body[0].isdigit():
        return None
    runs = _split_datetime_fields(body)
    if runs is None:
        return None

    # the fraction or a bare zone become fields of an incomplete text
    complete = len(runs) > 5 or (len(runs) == 1 and len(runs[0]) > 4)
    if frac_str and not complete:
        runs.append(frac_str)
        frac_str = ""
    if has_tz and tz_sign and not complete \
            and (not tz_minute or tz_sep):
        runs.append(tz_hour)
        if tz_minute:
            runs.append(tz_minute)
        has_tz = False

    def adjust_year(y):
        if 0 <= y <= 69:
            return 2000 + y
        if 70 <= y <= 99:
            return 1900 + y
        return y

    year = month = day = hour = minute = second = 0
    hhmmss = False
    n = len(runs)
    if n == 1:
        d0 = runs[0]
        ld = len(d0)
        widths = _COMPACT_LAYOUTS.get(ld)
        if widths is None:
            return None
        vals, p = [], 0
        for w in widths:
            vals.append(int(d0[p:p + w]))
            p += w
        vals += [0] * (6 - len(vals))
        year, month, day, hour, minute, second = vals
        if ld not in (14, 8):
            year = adjust_year(year)
        if ld in (14, 12, 11):
            hhmmss = True
        if ld in (5, 6, 8) and frac_str:
            # '.xxx' after a compact DATE is a compact TIME
            t = frac_str
            if len(t) <= 2:
                hour = int(t)
            elif len(t) <= 4:
                hour, minute = int(t[:2]), int(t[2:4])
            else:
                hour, minute, second = (int(t[:2]), int(t[2:4]),
                                        int(t[4:6]))
            frac_str = ""
        if ld in (9, 10) and frac_str:
            # '.xx' after [YY]YYMMDDHHMM supplies the seconds
            second = int(frac_str[:2]) if frac_str[:2].isdigit() else 0
            frac_str = ""
    elif n == 2 or n == 0:
        return None
    else:
        try:
            fields = [int(x) for x in runs[:6]]
        except ValueError:
            return None
        fields += [0] * (6 - len(fields))
        year, month, day, hour, minute, second = fields
        if n >= 6:
            hhmmss = True
        if len(runs[0]) <= 2:
            # all-zero fields keep year 0 ('0-0-0' is the zero date);
            # anything else reads a two-digit year
            if (year, month, day, hour, minute, second) != (0,) * 6 \
                    or frac_str:
                year = adjust_year(year)

    # fraction to microseconds (fsp 6, round half up)
    micro, bump = 0, False
    if hhmmss and frac_str:
        digits = frac_str[:7]
        v = int(digits)
        if len(digits) <= 6:
            micro = v * 10 ** (6 - len(digits))
        else:
            v = (v + 5) // 10
            if v >= 10 ** 6:
                bump = True
                micro = 0
            else:
                micro = v

    # range checks and zero dates
    if not (hour <= 23 and minute <= 59 and second <= 59):
        return None
    if fields_only:
        if month > 12 or day > 31 or year > 9999:
            return None
        return (year, month, day, hour, minute, second, micro)
    if year == 0 and month == 0 and day == 0:
        # the zero date: a storable value, time of day kept
        tod = ((hour * 3600 + minute * 60 + second) * 1_000_000 + micro)
        return ZeroDateTime(tod + (1_000_000 if bump else 0))
    if not (1 <= month <= 12 and 1 <= day <= 31 and year <= 9999):
        return None
    try:
        res = datetime.datetime(year, month, day, hour, minute, second, micro)
    except ValueError:
        # year 0 with a real month and day is valid data outside
        # python's datetime range
        if year == 0 and day <= _days_in_month(year, month):
            return CivilDateTime(year, month, day, hour, minute, second,
                                 micro)
        return None
    if bump:
        res += datetime.timedelta(seconds=1)

    if has_tz:
        if not hhmmss:
            return None  # zones only qualify full datetimes
        dh = int(tz_hour) if tz_hour else 0
        dm = int(tz_minute) if tz_minute else 0
        if dh > 14 or dm > 59 or (dh == 14 and dm != 0) \
                or (tz_sign == "-" and dh == 0 and dm == 0):
            return None  # MySQL's zone range: -14:00 .. +14:00
        off = dh * 3600 + dm * 60
        if tz_sign == "-":
            off = -off
        res -= datetime.timedelta(seconds=off)  # normalize to UTC
    return res


_WEEKDAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                  "Friday", "Saturday"]
_MONTH_FULL_NAMES = ["January", "February", "March", "April", "May",
                     "June", "July", "August", "September", "October",
                     "November", "December"]


def _days_in_month(y: int, mo: int) -> int:
    leap = y % 4 == 0 and (y % 100 != 0 or (y % 400 == 0 and y != 0))
    return [31, 29 if leap else 28, 31, 30, 31, 30,
            31, 31, 30, 31, 30, 31][mo - 1]


def dayname_of_string(s: str):
    """DAYNAME over raw text: partial zero dates ('0000-01-00') have no
    weekday unless month and day are real."""
    f = mysql_str_to_datetime(s, fields_only=True)
    if f is None:
        return None
    y, mo, d = f[:3]
    if mo == 0 or d == 0 or d > _days_in_month(y, mo):
        return None
    return _WEEKDAY_NAMES[(civil_to_days(y, mo, d) + 4) % 7]


def monthname_of_string(s: str):
    f = mysql_str_to_datetime(s, fields_only=True)
    if f is None or f[1] == 0:
        return None
    if f[2] > _days_in_month(f[0], f[1]):
        return None
    return _MONTH_FULL_NAMES[f[1] - 1]


def _gather(table: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """A host table copied to ``idx``'s device, gathered by ``idx``
    (already clipped into the table)."""
    return torch.as_tensor(table, device=idx.device)[idx.long()]


def _codes(col: Column, size: int) -> torch.Tensor:
    """A string column's codes clipped into a table of ``size`` entries:
    dead and NULL rows may carry any code."""
    return col.data.clamp(0, max(size - 1, 0))


def _cast_string_lut(col: Column, target: DataType) -> Column:
    """CAST(string AS numeric/temporal) over the dictionary: a host parse
    of each entry, one gather.  MySQL coercion: the longest numeric prefix
    parses ('12abc' -> 12), a non-numeric string is 0, an invalid date is
    NULL, a fraction rounds half away from zero into an integer."""
    num_rx = re.compile(r"^\s*[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")
    d = col.dictionary or ()
    enum_vals = col.dtype.enum_values

    def parse_num(s: str) -> float:
        if enum_vals is not None:
            # an ENUM's numeric value is its 1-based declaration index ('' = 0)
            return float(enum_vals.index(s) + 1) if s in enum_vals else 0.0
        m = num_rx.match(s)
        return float(m.group(0)) if m else 0.0

    nulls = np.zeros(max(len(d), 1), dtype=bool)
    if target.kind in (TypeKind.DATE, TypeKind.DATETIME):
        vals = np.zeros(max(len(d), 1), dtype=np.int64)
        epoch = datetime.datetime(1970, 1, 1)
        for i, s in enumerate(d):
            t = mysql_str_to_datetime(s)
            if t is None:
                nulls[i] = True
            elif isinstance(t, ZeroDateTime):
                vals[i] = (ZERO_DATE_DAYS if target.kind is TypeKind.DATE
                           else ZERO_DT_BASE_US + t.tod_us)
            elif isinstance(t, CivilDateTime):
                vals[i] = (t.epoch_days if target.kind is TypeKind.DATE
                           else t.epoch_us)
            elif target.kind is TypeKind.DATE:
                vals[i] = (t.date() - epoch.date()).days
            else:
                vals[i] = round((t - epoch).total_seconds() * 1_000_000)
    elif target.kind is TypeKind.DURATION:
        vals = np.zeros(max(len(d), 1), dtype=np.int64)
        for i, s in enumerate(d):
            us = parse_mysql_time(s)
            if us is None:
                nulls[i] = True
            else:
                vals[i] = us
    else:
        fvals = np.array([parse_num(s) for s in d] or [0.0], dtype=np.float64)
        if target.is_decimal:
            vals = np.round(fvals * 10 ** target.scale).astype(np.int64)
        elif target.is_float:
            vals = fvals
        elif target.kind is TypeKind.BOOL:
            vals = fvals != 0
        else:  # round half away from zero (MySQL CAST('3.6') = 4)
            vals = (np.sign(fvals) * np.floor(np.abs(fvals) + 0.5)).astype(
                np.int64)
    host = np.asarray(vals, dtype=target.physical)
    idx = _codes(col, len(host))
    if host.dtype == np.uint64:  # gathered as int64 bit patterns
        data = _u64(_gather(host.view(np.int64), idx))
    else:
        data = _gather(host, idx)
    validity = col.validity
    nullable = target.nullable or col.dtype.nullable
    if nulls.any():
        ok = _gather(~nulls, _codes(col, len(nulls)))
        validity = ok if validity is None else (validity & ok)
        nullable = True
    return Column(data, validity, target.with_nullable(nullable))


def _round_wide_to_integral(m: torch.Tensor, scale: int, name: str,
                            out: DataType) -> torch.Tensor:
    """FLOOR/CEIL/ROUND/TRUNCATE of a multi-limb decimal mantissa to an
    integral decimal.  ``wide_divmod`` truncates toward zero, so floor
    and ceil adjust by one when a remainder exists; ROUND is half away
    from zero (MySQL)."""
    L = m.shape[-1]
    if scale == 0:
        q = m
    else:
        den = _wide_const(10 ** scale, L, m.shape[:-1], m.device)
        q, r = W.wide_divmod(m, den)
        rnz = torch.any(r != 0, dim=-1)
        neg = m[..., 0] < 0
        one = torch.zeros_like(q)
        one[..., -1] = 1
        if name == "floor":
            q = torch.where((neg & rnz)[..., None], W.wide_sub(q, one), q)
        elif name == "ceil":
            q = torch.where((~neg & rnz)[..., None], W.wide_add(q, one), q)
        elif name == "round":
            # half away from zero: |r|*2 >= den bumps |q| by one
            r2 = W.wide_add(r, r)
            up = ~W.wide_cmp_lt(r2, den) & rnz
            bump = torch.where(neg[..., None], W.wide_neg(one), one)
            q = torch.where(up[..., None], W.wide_add(q, bump), q)
        # truncate: wide_divmod already truncates toward zero
    want = out.decimal_limbs
    if want != L:
        q, _ = W.resize_wide(q, want)
    return q


# ---------------------------------------------------------------------------
# interval propagation (range statistics through expressions)
# ---------------------------------------------------------------------------

_I63 = 2 ** 63


def propagate_stats(name: str, args: Sequence[Column], out: DataType):
    """Conservative [vmin, vmax] for an expression result, or None.

    The ``Column.stats`` invariant survives arithmetic as interval
    arithmetic, mirroring the exact scale transforms ``_arith_eval``
    applies, and through ``year`` (``_year_image``).  Returns None when
    any endpoint could overflow int64."""
    if out.is_float or out.is_string:
        return None
    if name == "year":
        return _year_image(args[0])
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


def _year_image(a: Column):
    """``year`` is monotone in the day number: a DATE or DATETIME span
    [lo, hi] maps to [year(lo), year(hi)], widened to take in 0 where the
    ZERO date, whose year is 0, lies in the span."""
    if a.stats is None or a.data.ndim != 1 \
            or a.dtype.kind not in (TypeKind.DATE, TypeKind.DATETIME):
        return None
    ends = torch.tensor([int(a.stats[0]), int(a.stats[1])], dtype=torch.int64)
    days = _date_days(Column(ends, None, a.dtype))
    lo, hi = (int(y) for y in _civil_from_days(days)[0])
    if int(days[0]) <= ZERO_DATE_DAYS <= int(days[1]):
        lo, hi = min(lo, 0), max(hi, 0)
    return lo, hi


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
        raise KeyError(f"scalar function {name!r} not registered "
                       f"(have: {sorted(REGISTRY)})") from None


def _and_validity(cols: Sequence[Column]) -> Optional[torch.Tensor]:
    v = None
    for c in cols:
        if c.validity is not None:
            v = c.validity if v is None else (v & c.validity)
    return v


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _uint64_magnitude(c: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """(|x| as uint64 bits in int64, x < 0) for any integer column; the
    negation wraps, so |INT64_MIN| is 2^63's bit pattern.  Unsigned
    columns pass through."""
    if c.dtype.is_unsigned:
        d = _bits(c.data)
        return d, torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    d = c.data.to(torch.int64)
    neg = d < 0
    return torch.where(neg, -d, d), neg


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
        if op == "int_div":
            if a.is_decimal or b.is_decimal or a.is_float or b.is_float:
                # MySQL DIV always yields BIGINT (unsigned if either is)
                k = TypeKind.UINT64 if (a.is_unsigned or b.is_unsigned) \
                    else TypeKind.INT64
                return DataType(k, True)
            return common_numeric_type(a, b).with_nullable(True)
        if op == "modulo":
            if (a.is_decimal or b.is_decimal) and not (
                    a.is_float or b.is_float or a.is_string or b.is_string):
                # |r| < |b| at the common scale; the precision carries
                # the operands' full integer part
                scale = max(a.scale, b.scale)
                ip = max((a.precision or 19) - a.scale,
                         (b.precision or 19) - b.scale)
                return Decimal(min(65, ip + scale), scale, True)
            return common_numeric_type(a, b).with_nullable(True)
        return common_numeric_type(a, b)

    return infer


def _align_decimal_pair(a: Column, b: Column) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Bring both operands to int64 mantissas at a common scale."""
    sa = a.dtype.scale if a.dtype.is_decimal else 0
    sb = b.dtype.scale if b.dtype.is_decimal else 0
    s = max(sa, sb)
    da = _bits(a.data) * _pow10(s - sa)
    db = _bits(b.data) * _pow10(s - sb)
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


def _scaled_bound(c: Column, shift: int) -> Optional[int]:
    """A bound on |mantissa * 10^shift| over c's valid rows, from its range
    stats or its decimal precision; None where neither bounds it."""
    if c.data.ndim != 1 or c.dtype.kind is TypeKind.UINT64:
        return None
    if c.stats is not None:
        m = max(abs(int(c.stats[0])), abs(int(c.stats[1])))
    elif c.dtype.is_decimal and c.dtype.precision <= 18:
        m = _pow10(c.dtype.precision) - 1
    else:
        return None
    return m * _pow10(shift)


def _div_mod_in_int64(op: str, a: Column, b: Column, sa: int, sb: int, s: int,
                      out: DataType, validity) -> Optional[Column]:
    """Decimal DIV/MOD in one int64 truncating division, where both
    operands at the common scale provably fit int64: the same quotient and
    remainder as the long division, without its limb passes.  None where
    the bounds do not prove it."""
    ba, bb = _scaled_bound(a, s - sa), _scaled_bound(b, s - sb)
    if ba is None or bb is None or max(ba, bb) >= _I63 or out.scale != s \
            and op == "modulo":
        return None
    da = _bits(a.data) * _pow10(s - sa)
    db = _bits(b.data) * _pow10(s - sb)
    nonzero = db != 0
    safe = torch.where(nonzero, db, torch.ones_like(db))
    q = torch.div(da, safe, rounding_mode="trunc")
    validity = nonzero if validity is None else (validity & nonzero)
    if op == "int_div":
        return Column(_convert(q, out.torch_dtype), validity, out)
    r = da - q * safe  # the dividend's sign
    if out.decimal_limbs >= 2:
        r = W.widen_i64_to(r, out.decimal_limbs)
    return Column(_convert(r, out.torch_dtype), validity, out)


def _decimal_div_mod(op: str, a: Column, b: Column, out: DataType,
                     validity: Optional[torch.Tensor]) -> Column:
    """Exact decimal DIV/MOD: same-scale mantissas through the truncating
    wide division (MySQL ``1.4 DIV 0.5`` = 2; MOD keeps the dividend's
    sign at the common scale)."""
    sa = a.dtype.scale if a.dtype.is_decimal else 0
    sb = b.dtype.scale if b.dtype.is_decimal else 0
    s = max(sa, sb)
    narrow = _div_mod_in_int64(op, a, b, sa, sb, s, out, validity)
    if narrow is not None:
        return narrow
    # limbs must hold each operand after the scale-up to s
    pa = (a.dtype.precision or 19) - sa + s
    pb = (b.dtype.precision or 19) - sb + s
    if max(pa, pb) > 65:
        raise NotImplementedError(
            f"{op}: scaled operand precision {max(pa, pb)} > 65")
    L = max(2, -(-pa // 18), -(-pb // 18),
            a.data.shape[-1] if a.data.ndim == 2 else 0,
            b.data.shape[-1] if b.data.ndim == 2 else 0)

    def widen_op(c: Column):
        # BIGINT UNSIGNED above 2^63 stays exact through its uint64 digits
        if c.dtype.kind is TypeKind.UINT64 and c.data.ndim == 1:
            hi, lo = _udivmod(_bits(c.data), W.W18)
            pad = [torch.zeros_like(hi)] * (L - 2)
            return torch.stack(pad + [hi, lo], dim=-1)
        return _as_wide(c, L)

    wa, _ = W.wide_scale_up(widen_op(a), s - sa)
    wb, _ = W.wide_scale_up(widen_op(b), s - sb)
    nonzero = torch.any(wb != 0, dim=-1)
    one_w = W.widen_i64_to(torch.ones(wb.shape[:-1], dtype=torch.int64,
                                      device=wb.device), L)
    wb = torch.where(nonzero[..., None], wb, one_w)
    q, r = W.wide_divmod(wa, wb)
    validity = nonzero if validity is None else (validity & nonzero)

    def narrow(w):
        if w.shape[-1] != 2:
            w, ovf = W.resize_wide(w, 2)
            val, fits = W.narrow_i64(w)
            return val, fits & ~ovf
        return W.narrow_i64(w)

    if op == "int_div":
        val, fits = narrow(q)
        return Column(_convert(val, out.torch_dtype), validity & fits, out)
    # remainder: magnitude at scale s, the dividend's sign
    r = torch.where((wa[..., 0] < 0)[..., None], W.wide_neg(r), r)
    if out.scale > s:
        r, _ = W.wide_scale_up(r, out.scale - s)
    if out.is_decimal and out.decimal_limbs >= 2:
        if r.shape[-1] != out.decimal_limbs:
            r, _ = W.resize_wide(r, out.decimal_limbs)
        return Column(r, validity, out)
    val, fits = narrow(r)
    return Column(_convert(val, out.torch_dtype), validity & fits, out)


def _arith_eval(op: str):
    def evaluate(cols: Sequence[Column], out: DataType) -> Column:
        a, b = cols
        # string operands: DOUBLE arithmetic on the numeric-prefix parse
        if a.dtype.is_string:
            a = cast_column(a, DataType(TypeKind.FLOAT64, True))
        if b.dtype.is_string:
            b = cast_column(b, DataType(TypeKind.FLOAT64, True))
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
        if op in ("int_div", "modulo") \
                and (a.dtype.is_decimal or b.dtype.is_decimal) \
                and not (a.dtype.is_float or b.dtype.is_float):
            return _decimal_div_mod(op, a, b, out, validity)
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
                data = _bits(a.data) * _bits(b.data)
                extra = (sa + sb) - out.scale
                if extra > 0:
                    data = _div_round_half_up(data, _pow10(extra))
            elif op == "divide":  # result scale s_a + 4, half up, NULL on /0
                sa = a.dtype.scale if a.dtype.is_decimal else 0
                sb = b.dtype.scale if b.dtype.is_decimal else 0
                num = _bits(a.data) * _pow10(out.scale - sa + sb)
                den = _bits(b.data)
                nonzero = den != 0
                data = _div_round_half_up(num, torch.where(
                    nonzero, den, torch.ones_like(den)))
                validity = nonzero if validity is None else (validity & nonzero)
            else:
                raise NotImplementedError(op)
            return Column(data, validity, out)
        if (op in ("int_div", "modulo") and out.is_integer
                and a.dtype.is_integer and b.dtype.is_integer):
            # MySQL MOD/DIV at the 64-bit boundaries: divide the uint64
            # magnitudes, then reapply the sign (the dividend's for MOD,
            # the XOR for DIV).  INT64_MIN-safe, and BIGINT UNSIGNED
            # values above 2^63 stay exact
            ua, neg_a = _uint64_magnitude(a)
            ub, neg_b = _uint64_magnitude(b)
            nonzero = ub != 0
            q, r = _udivmod(ua, torch.where(nonzero, ub, torch.ones_like(ub)))
            if op == "modulo":
                res, neg = r, neg_a
            else:
                res, neg = q, neg_a ^ neg_b
            data = torch.where(neg, -res, res)
            validity = nonzero if validity is None else (validity & nonzero)
            return Column(_convert(data, out.torch_dtype), validity, out)
        if op == "int_div" and not (a.dtype.is_integer and b.dtype.is_integer):
            # float DIV: divide in f64, truncate to the integer result
            f64 = DataType(TypeKind.FLOAT64, False)
            fa = cast_column(a, f64).data
            fb = cast_column(b, f64).data
            nonzero = fb != 0
            data = torch.trunc(fa / torch.where(nonzero, fb, torch.ones_like(fb)))
            validity = nonzero if validity is None else (validity & nonzero)
            return Column(_convert(data, out.torch_dtype), validity, out)
        # float / integer paths
        da = cast_column(a, out.with_nullable(False)).data
        db = cast_column(b, out.with_nullable(False)).data
        unsigned = da.dtype == torch.uint64
        if unsigned:  # uint64 arithmetic wraps like int64's
            da, db = _bits(da), _bits(db)
        if op == "plus":
            data = da + db
        elif op == "minus":
            data = da - db
        elif op == "multiply":
            data = da * db
        elif op == "divide":
            nonzero = db != 0
            data = da / torch.where(nonzero, db, torch.ones_like(db))
            validity = nonzero if validity is None else (validity & nonzero)
        elif op in ("int_div", "modulo"):
            nonzero = db != 0
            safe = torch.where(nonzero, db, torch.ones_like(db))
            if op == "int_div":
                data = (torch.trunc(da / safe) if da.is_floating_point()
                        else torch.div(da, safe, rounding_mode="trunc"))
            else:  # the dividend's sign: exact C fmod
                data = torch.fmod(da, safe)
            validity = nonzero if validity is None else (validity & nonzero)
        else:
            raise NotImplementedError(op)
        if unsigned:
            data = _u64(data)
        return Column(_convert(data, out.torch_dtype), validity, out)

    return evaluate


for _op in ("plus", "minus", "multiply", "divide", "int_div", "modulo"):
    register(_op)(lambda _op=_op: (_arith_infer(_op), _arith_eval(_op)))


@register("negate")
def _negate():
    def infer(ts):
        if ts[0].is_unsigned:
            # -BIGINT UNSIGNED is signed (values <= 2^63 fit int64)
            return DataType(TypeKind.INT64, ts[0].nullable)
        return ts[0]

    def evaluate(cols, out):
        (a,) = cols
        if a.dtype.is_unsigned:
            return Column(-_bits(a.data), a.validity, out)
        # a multi-limb mantissa negates limb by limb, as in the reference
        return Column(-a.data, a.validity, out)

    return infer, evaluate


@register("abs")
def _abs():
    def infer(ts):
        return ts[0]

    def evaluate(cols, out):
        (a,) = cols
        if a.data.dtype == torch.uint64:
            return Column(a.data, a.validity, out)
        return Column(a.data.abs(), a.validity, out)

    return infer, evaluate


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


def _remap_to_merged_dict(a: Column, b: Column):
    """Two string columns' codes in one merged sorted dictionary, so code
    comparisons are exact across dictionaries (host LUTs, one gather
    each)."""
    da_ = a.dictionary or ()
    db_ = b.dictionary or ()
    if da_ == db_:
        return a.data, b.data
    rank = {s: i for i, s in enumerate(sorted(set(da_) | set(db_)))}

    def remap(col, src):
        table = np.array([rank[s] for s in src] or [0], dtype=np.int32)
        return _gather(table, _codes(col, len(src)))

    return remap(a, da_), remap(b, db_)


def _cmp_eval(op: str):
    def evaluate(cols: Sequence[Column], out: DataType) -> Column:
        a, b = cols
        validity = _and_validity(cols)
        if a.dtype.is_string and b.dtype.is_string:
            # literals were encoded into the column's code space by the
            # compile layer; two columns compare in a merged dictionary
            da, db = _remap_to_merged_dict(a, b)
        elif a.dtype.is_string or b.dtype.is_string:
            # a string against a number or a temporal: MySQL casts the
            # string side, to DOUBLE or to the temporal type
            s, o = (a, b) if a.dtype.is_string else (b, a)
            if o.dtype.kind in (TypeKind.DATE, TypeKind.DATETIME,
                                TypeKind.DURATION):
                sc = cast_column(s, o.dtype.with_nullable(True))
            else:
                sc = cast_column(s, FLOAT64.with_nullable(s.dtype.nullable))
            pair = [sc, b] if a.dtype.is_string else [a, sc]
            return evaluate(pair, out)
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
            da = _convert(a.data, torch.float64)
            db = _convert(b.data, torch.float64)
        elif (a.dtype.kind is TypeKind.UINT64
              and b.dtype.kind is TypeKind.UINT64):
            # unsigned order: flip the sign bit, compare signed
            da = _bits(a.data) ^ _I64_MIN
            db = _bits(b.data) ^ _I64_MIN
        else:
            da = _bits(a.data)
            db = _bits(b.data)
        return Column(_CMP_FNS[op](da, db), validity, out)

    return evaluate


def _cmp_infer(ts: Sequence[DataType]) -> DataType:
    return DataType(TypeKind.BOOL, ts[0].nullable or ts[1].nullable)


for _op in _CMP_FNS:
    register(_op)(lambda _op=_op: (_cmp_infer, _cmp_eval(_op)))


@register("null_eq")
def _null_eq():
    """MySQL ``<=>``: NULL <=> NULL is TRUE, NULL <=> x is FALSE, never
    NULL."""

    def infer(ts):
        return DataType(TypeKind.BOOL, False)

    def evaluate(cols, out):
        a, b = cols
        eq = _cmp_eval("equals")(cols, BOOL).data
        av, bv = a.valid_mask(), b.valid_mask()
        return Column(torch.where(av & bv, eq, ~av & ~bv), None, out)

    return infer, evaluate


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
            eq = REGISTRY["equals"].evaluate([a, c], BOOL)
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

def _truth(c: Column) -> torch.Tensor:
    d = c.data
    if d.dtype == torch.uint64:
        d = d.view(torch.int64)
    return d.to(torch.bool)


@register("and")
def _and():
    def infer(ts):
        return DataType(TypeKind.BOOL, any(t.nullable for t in ts))

    def evaluate(cols, out):
        a, b = cols
        va, vb = a.valid_mask(), b.valid_mask()
        ba, bb = _truth(a), _truth(b)
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
        data = (_truth(a) & va) | (_truth(b) & vb)
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
        return Column(~_truth(a), a.validity, out)

    return infer, evaluate


@register("xor")
def _logical_xor():
    def infer(ts):
        return DataType(TypeKind.BOOL, ts[0].nullable or ts[1].nullable)

    def evaluate(cols, out):
        a, b = cols
        return Column(_truth(a) ^ _truth(b), _and_validity(cols), out)

    return infer, evaluate


def _register_is(name: str, fn):
    """IS NULL / IS TRUE ... : never NULL themselves."""

    def factory():
        def infer(ts):
            return BOOL

        def evaluate(cols, out):
            (a,) = cols
            return Column(fn(a), None, out)

        return infer, evaluate

    register(name)(factory)


_register_is("is_null", lambda a: ~a.valid_mask())
_register_is("is_not_null", lambda a: a.valid_mask())
_register_is("is_true", lambda a: _truth(a) & a.valid_mask())
_register_is("is_false", lambda a: ~_truth(a) & a.valid_mask())
_register_is("is_not_true", lambda a: ~(_truth(a) & a.valid_mask()))
_register_is("is_not_false", lambda a: ~(~_truth(a) & a.valid_mask()))


# ---------------------------------------------------------------------------
# conditionals
# ---------------------------------------------------------------------------

def _unify_branch_types(ts: List[DataType]) -> DataType:
    t = ts[0]
    for u in ts[1:]:
        if u.kind != t.kind or u.scale != t.scale:
            t = common_numeric_type(t, u)
    return t.with_nullable(any(x.nullable for x in ts))


def _pick(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where`` over rows, limb rows included; uint64 on bit patterns."""
    if a.dtype == torch.uint64:
        return _u64(_pick(cond, a.view(torch.int64), b.view(torch.int64)))
    if a.ndim == 2:
        cond = cond[:, None]
    return torch.where(cond, a, b)


@register("if")
def _if():
    def infer(ts):
        return _unify_branch_types([ts[1], ts[2]])

    def evaluate(cols, out):
        c, a, b = cols
        cond = _truth(c) & c.valid_mask()  # NULL condition -> else
        av = cast_column(a, out.with_nullable(a.dtype.nullable))
        bv = cast_column(b, out.with_nullable(b.dtype.nullable))
        data = _pick(cond, av.data, bv.data)
        if av.validity is None and bv.validity is None:
            validity = None
        else:
            validity = torch.where(cond, av.valid_mask(), bv.valid_mask())
        return Column(data, validity, out)

    return infer, evaluate


@register("coalesce")
def _coalesce():
    def infer(ts):
        t = _unify_branch_types(list(ts))
        return t.with_nullable(all(x.nullable for x in ts))

    def evaluate(cols, out):
        casted = [cast_column(c, out.with_nullable(c.dtype.nullable))
                  for c in cols]
        data = casted[-1].data
        validity = casted[-1].valid_mask()
        for c in reversed(casted[:-1]):
            ok = c.valid_mask()
            data = _pick(ok, c.data, data)
            validity = ok | validity
        if not out.nullable:
            validity = None
        return Column(data, validity, out)

    return infer, evaluate


@register("case_when")
def _case_when():
    def infer(ts):
        vals = [ts[i] for i in range(1, len(ts), 2)]
        if len(ts) % 2 == 1:  # trailing default
            vals.append(ts[-1])
            return _unify_branch_types(vals)
        return _unify_branch_types(vals).with_nullable(True)

    def evaluate(cols, out):
        has_default = len(cols) % 2 == 1
        n = cols[0].data.shape[0]
        dev = cols[0].data.device
        if has_default:
            d = cast_column(cols[-1], out.with_nullable(cols[-1].dtype.nullable))
            data, validity = d.data, d.valid_mask()
            pairs = cols[:-1]
        else:
            shape = (n, out.decimal_limbs) if out.decimal_limbs >= 2 else (n,)
            data = torch.zeros(shape, dtype=out.torch_dtype, device=dev)
            validity = torch.zeros(n, dtype=torch.bool, device=dev)
            pairs = cols
        for i in reversed(range(0, len(pairs), 2)):
            c, v = pairs[i], pairs[i + 1]
            cond = _truth(c) & c.valid_mask()
            vv = cast_column(v, out.with_nullable(v.dtype.nullable))
            data = _pick(cond, vv.data, data)
            validity = torch.where(cond, vv.valid_mask(), validity)
        return Column(data, validity if out.nullable else None, out)

    return infer, evaluate


# ---------------------------------------------------------------------------
# date/time extraction (epoch-int representation)
# ---------------------------------------------------------------------------

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


def _days_from_civil(y, m, d):
    """Inverse of ``_civil_from_days`` (Hinnant)."""
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _date_days(col: Column) -> torch.Tensor:
    if col.dtype.kind is TypeKind.DATE:
        return col.data.to(torch.int64)
    if col.dtype.kind is TypeKind.DATETIME:
        return _fdiv(col.data, 86_400_000_000)
    raise TypeError(f"expected date/datetime, got {col.dtype}")


def _zero_date_rows(a: Column) -> torch.Tensor:
    """True where the row holds the ZERO date sentinel."""
    return _date_days(a) == ZERO_DATE_DAYS


def _register_date_part(name: str, part: int):
    def factory():
        def infer(ts):
            return DataType(TypeKind.INT64, ts[0].nullable)

        def evaluate(cols, out):
            (a,) = cols
            data = _civil_from_days(_date_days(a))[part]
            # YEAR/MONTH/DAY of the ZERO date are 0, not NULL (MySQL)
            data = torch.where(_zero_date_rows(a), 0, data)
            return Column(data.to(torch.int64), a.validity, out)

        return infer, evaluate

    register(name)(factory)


_register_date_part("year", 0)
_register_date_part("month", 1)
_register_date_part("day_of_month", 2)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

# MySQL: sqrt of a negative and log of a non-positive are NULL
_NULL_ON_NONFINITE = ("sqrt", "log", "log2", "log10", "ln")


def _f64(c: Column) -> torch.Tensor:
    return cast_column(c, FLOAT64).data


def _register_float_unary(name: str, fn):
    null_bad = name in _NULL_ON_NONFINITE

    def factory():
        def infer(ts):
            return DataType(TypeKind.FLOAT64, ts[0].nullable)

        def evaluate(cols, out):
            (a,) = cols
            data = fn(_f64(a))
            if not null_bad:
                return Column(data, a.validity, out)
            bad = ~torch.isfinite(data)
            v = ~bad if a.validity is None else (a.validity & ~bad)
            return Column(torch.where(bad, torch.zeros_like(data), data), v,
                          FLOAT64.with_nullable(True))

        return infer, evaluate

    register(name)(factory)


_PI = 3.141592653589793


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 square root.  CUDA's is; the CPU build's
    vectorized one may miss by an ulp, so on the CPU the root is taken in
    complex128, which is exact (negative inputs give NaN, zeros keep
    their sign)."""
    if x.is_cuda:
        return torch.sqrt(x)
    r = torch.sqrt(x.to(torch.complex128)).real
    r = torch.where(x == 0, x, r)
    return torch.where(x < 0, torch.full_like(r, float("nan")), r)

for _n, _fn in (
        ("sqrt", _sqrt), ("exp", torch.exp), ("ln", torch.log),
        ("log", torch.log), ("log2", torch.log2), ("exp2", torch.exp2),
        ("log10", torch.log10), ("sin", torch.sin), ("cos", torch.cos),
        ("tan", torch.tan),
        # the reference's constants: x * (pi / 180) and x * (180 / pi)
        ("radians", lambda x: x * (_PI / 180)),
        ("degrees", lambda x: x * (180 / _PI)),
        ("asin", torch.asin), ("acos", torch.acos), ("atan", torch.atan),
        ("cot", lambda x: 1.0 / torch.tan(x)), ("sinh", torch.sinh),
        ("cosh", torch.cosh), ("tanh", torch.tanh)):
    _register_float_unary(_n, _fn)


def _register_float_binary(name: str, fn):
    def factory():
        def infer(ts):
            return DataType(TypeKind.FLOAT64, ts[0].nullable or ts[1].nullable)

        def evaluate(cols, out):
            a, b = cols
            return Column(fn(_f64(a), _f64(b)), _and_validity(cols), out)

        return infer, evaluate

    register(name)(factory)


_register_float_binary("atan2", torch.atan2)
_register_float_binary("pow", torch.pow)


# float ROUND is half to even, as the reference's rint; decimal ROUND is
# half away from zero
_ROUND_FLOAT_FNS = {
    "round": torch.round,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "truncate": torch.trunc,
}

# 10^k mod 2^64 as int64 bit patterns, k = 0..64 (10^k for k >= 64 is
# 0 mod 2^64): the reference's wrapping integer powers
_POW10_BITS = [((10 ** k) % 2 ** 64) - (2 ** 64 if (10 ** k) % 2 ** 64 >= 2 ** 63
                                        else 0) for k in range(65)]
# 10.0^d for d = -307..307, as the host's pow gives them
_POW10_F64 = [10.0 ** d for d in range(-307, 308)]


def _pow10_bits(k: torch.Tensor) -> torch.Tensor:
    lut = torch.tensor(_POW10_BITS, dtype=torch.int64, device=k.device)
    return lut[k.clamp(0, 64).long()]


def round_decimal_frac(col: Column, d: int, mode: str, out=None) -> Column:
    """ROUND/TRUNCATE/FLOOR/CEIL(decimal, d) with a literal digit count:
    the result scale is part of the type."""
    s = col.dtype.scale
    new_scale = max(min(int(d), s), 0)
    out = out or Decimal(col.dtype.precision, new_scale, col.dtype.nullable)
    shift = s - new_scale if int(d) >= 0 else s - new_scale - int(d)
    if shift <= 0:
        return Column(col.data, col.validity, out)
    if shift > col.dtype.precision:
        # the rounding position is past every digit: exactly 0
        return Column(torch.zeros_like(col.data), col.validity, out)
    if col.data.ndim == 2:
        data = _round_wide_to_integral(col.data, shift, mode, out)
        back = -int(d) if int(d) < 0 else 0
        while back > 0:
            data, _ = W.wide_mul_pow10(data, min(back, 9))
            back -= 9
        return Column(data, col.validity, out)
    m = col.data.to(torch.int64)
    q = _pow10(shift)
    if mode == "round":
        data = _div_round_half_up(m, q)
    elif mode == "floor":
        data = _fdiv(m, q)
    elif mode == "ceil":
        data = -_fdiv(-m, q)
    else:
        data = torch.sign(m) * _fdiv(m.abs(), q)
    if int(d) < 0:  # rounded past the point: scale the integer back up
        data = data * _pow10(-int(d))
    return Column(data, col.validity, out)


def round_decimal_frac_dynamic(col: Column, d_col: Column,
                               mode: str) -> Column:
    """ROUND/TRUNCATE/FLOOR/CEIL(decimal, d) with a per-row digit count:
    the result keeps the input scale and zeroes the mantissa below digit
    k = scale - d.  int64 and two-limb mantissas (precision <= 36)."""
    s, prec = col.dtype.scale, col.dtype.precision
    out = Decimal(prec, s, True)
    validity = _and_validity([col, d_col])
    d = d_col.data.to(torch.int64).clamp(-80, 80)
    k = (s - d).clamp(0, prec + 2)
    dead = k > prec  # 10^k / 2 > |m|: rounds to exactly 0

    def carry_of(r2, q, neg, rnz):
        if mode == "round":
            return r2 >= q
        if mode == "truncate":
            return torch.zeros_like(neg)
        if mode == "floor":
            return neg & rnz
        return ~neg & rnz  # ceil

    zero = torch.zeros((), dtype=torch.int64, device=d.device)
    if col.data.ndim == 1:
        m = col.data.to(torch.int64)
        neg = m < 0
        mag = m.abs()
        q = _pow10_bits(k.clamp(max=18))
        r = _fmod(mag, q)
        c = carry_of(r * 2, q, neg, r > 0)
        mag2 = mag - r + torch.where(c, q, zero)
        mag2 = torch.where(dead, zero, mag2)
        return Column(torch.where(neg, -mag2, mag2), validity, out)
    if col.data.shape[-1] != 2:
        raise NotImplementedError("variable-digit ROUND above precision 36")
    top, lo = col.data[..., 0], col.data[..., 1]
    neg = top < 0
    mhi = torch.where(neg, -top - (lo > 0).to(torch.int64), top)
    mlo = torch.where(neg & (lo > 0), W.W18 - lo, lo)
    # k <= 18: round inside the low limb (10^18 is divisible by 10^k)
    qa = _pow10_bits(k.clamp(0, 18))
    ra = _fmod(mlo, qa)
    ca = carry_of(ra * 2, qa, neg, ra > 0)
    lo_a = mlo - ra + torch.where(ca, qa, zero)
    hi_a = mhi + (lo_a >= W.W18).to(torch.int64)
    lo_a = torch.where(lo_a >= W.W18, zero, lo_a)
    # 18 < k <= 36: round inside the high limb
    qb = _pow10_bits((k - 18).clamp(1, 18))
    rb = _fmod(mhi, qb)
    rnz_b = (rb > 0) | (mlo > 0)
    cb = carry_of(rb * 2, qb, neg, rnz_b)
    hi_b = mhi - rb + torch.where(cb, qb, zero)
    in_a = k <= 18
    hi2 = torch.where(in_a, hi_a, hi_b)
    lo2 = torch.where(in_a, lo_a, zero)
    hi2 = torch.where(dead, zero, hi2)
    lo2 = torch.where(dead, zero, lo2)
    top2 = torch.where(neg, -hi2 - (lo2 > 0).to(torch.int64), hi2)
    lo3 = torch.where(neg & (lo2 > 0), W.W18 - lo2, lo2)
    return Column(torch.stack([top2, lo3], dim=-1), validity, out)


def _round_unsigned(u: torch.Tensor, q: torch.Tensor, name: str) -> torch.Tensor:
    """ROUND/FLOOR/CEIL/TRUNCATE of uint64 bit patterns to a multiple of
    q (uint64 bits), wrapping mod 2^64 as the reference's uint64 does."""
    if name == "round":
        u = u + _lsr(q, 1)
    elif name == "ceil":
        u = u + q - 1
    return _udivmod(u, q)[0] * q


def _register_round_family(name: str):
    def factory():
        def infer(ts):
            t = ts[0]
            if t.is_decimal:
                # the 1-argument form is a scale-0 decimal; the digit form
                # is typed by the compile dispatcher (round_decimal_frac)
                return Decimal(t.precision, 0, t.nullable)
            if t.is_float or t.is_string:
                return DataType(TypeKind.FLOAT64, t.nullable)
            if t.is_unsigned:
                return DataType(TypeKind.UINT64, t.nullable)
            return DataType(TypeKind.INT64, t.nullable)

        def evaluate(cols, out):
            a = cols[0]
            if a.dtype.is_string:  # MySQL rounds a string as a DOUBLE
                a = cast_column(a, DataType(TypeKind.FLOAT64, True))
            d_col = cols[1] if len(cols) > 1 else None
            validity = _and_validity([a] + list(cols[1:]))
            if a.dtype.is_decimal:
                if d_col is not None:
                    raise NotImplementedError(
                        "ROUND(decimal, d) goes through the compile "
                        "dispatcher (round_decimal_frac)")
                if a.data.ndim == 2:
                    data = _round_wide_to_integral(a.data, a.dtype.scale,
                                                   name, out)
                    return Column(data, validity, out)
                q = _pow10(a.dtype.scale)
                m = a.data.to(torch.int64)
                if name == "round":
                    data = _div_round_half_up(m, q)
                elif name == "floor":
                    data = _fdiv(m, q)
                elif name == "ceil":
                    data = -_fdiv(-m, q)
                else:
                    data = torch.sign(m) * _fdiv(m.abs(), q)
                return Column(data, validity, out)
            fn = _ROUND_FLOAT_FNS[name]
            if a.dtype.is_float:
                x = a.data.to(torch.float64)
                if d_col is None:
                    return Column(fn(x), validity, out)
                # 10^d from a host table of the host's pow (d is a whole
                # number; |d| past 307 moves no double), and where x * 10^d
                # overflows the rounding is a no-op
                dd = _convert(d_col.data, torch.float64).clamp(-307.0, 307.0)
                lut = torch.tensor(_POW10_F64, dtype=torch.float64,
                                   device=x.device)
                f = lut[(torch.round(dd) + 307).long()]
                s = x * f
                return Column(torch.where(torch.isfinite(s), fn(s) / f, x),
                              validity, out)
            # integer argument: only a negative d changes the value
            if out.is_unsigned:
                u = _bits(a.data)
                if d_col is None:
                    return Column(_u64(u), validity, out)
                nd = (-d_col.data.to(torch.int64)).clamp(min=0)
                return Column(_u64(_round_unsigned(u, _pow10_bits(nd), name)),
                              validity, out)
            m = _bits(a.data)
            if d_col is None:
                return Column(m, validity, out)
            # on uint64 magnitudes: |INT64_MIN| wraps in a signed abs
            neg = m < 0
            mag = torch.where(neg, -m, m)
            dd = d_col.data.to(torch.int64).clamp(-100, 100)
            q = _pow10_bits((-dd).clamp(0, 19))
            dead = -dd > 19  # 10^20 > 2^64: rounds to 0
            if name in ("round", "truncate"):
                mag2 = _round_unsigned(mag, q, name)
            else:  # floor and ceil move the magnitude by the sign
                up = neg if name == "floor" else ~neg
                mag2 = torch.where(up, _round_unsigned(mag, q, "ceil"),
                                   _round_unsigned(mag, q, "truncate"))
            mag2 = torch.where(dead, torch.zeros_like(mag2), mag2)
            data = torch.where(neg, -mag2, mag2)
            return Column(_convert(data, out.torch_dtype), validity, out)

        return infer, evaluate

    register(name)(factory)


for _n in ("round", "floor", "ceil", "truncate"):
    _register_round_family(_n)


@register("sign")
def _sign_fn():
    def infer(ts):
        return DataType(TypeKind.INT64, ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        if a.data.dtype == torch.uint64:
            data = (_bits(a.data) != 0).to(torch.int64)
        else:
            data = torch.sign(a.data).to(torch.int64)
        return Column(data, a.validity, out)

    return infer, evaluate


def _extreme(cols, out, take_max: bool) -> Column:
    casted = [cast_column(c, out.with_nullable(False)).data for c in cols]
    unsigned = casted[0].dtype == torch.uint64
    if unsigned:  # unsigned order on bit patterns: flip the sign bit
        casted = [_bits(c) ^ _I64_MIN for c in casted]
    data = casted[0]
    for c in casted[1:]:
        data = torch.maximum(data, c) if take_max else torch.minimum(data, c)
    if unsigned:
        data = _u64(data ^ _I64_MIN)
    return Column(data, _and_validity(cols), out)


@register("greatest")
def _greatest():
    def infer(ts):
        t = ts[0]
        for u in ts[1:]:
            t = common_numeric_type(t, u)
        return t.with_nullable(any(x.nullable for x in ts))

    return infer, lambda cols, out: _extreme(cols, out, True)


@register("least")
def _least():
    return (REGISTRY["greatest"].infer,
            lambda cols, out: _extreme(cols, out, False))


@register("nullif")
def _nullif():
    def infer(ts):
        return ts[0].with_nullable(True)

    def evaluate(cols, out):
        a, _ = cols
        eq = REGISTRY["equals"].evaluate(list(cols), BOOL.with_nullable(True))
        neq = ~(eq.data & eq.valid_mask())
        validity = neq if a.validity is None else (a.validity & neq)
        return Column(a.data, validity, out, a.dictionary)

    return infer, evaluate


# ---------------------------------------------------------------------------
# vector distances (the reference's vec_* family): per-row float32
# reductions over (n, dims) rows, cast to float64 at the end
# ---------------------------------------------------------------------------

def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: the float64 root (``_sqrt``)
    rounded once more to float32 is exact for float32 inputs."""
    return _sqrt(x.double()).float()


def _cosine32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    norms = _sqrt32((x * x).sum(1)) * _sqrt32((y * y).sum(1))
    return 1.0 - (x * y).sum(1) / torch.clamp_min(norms, 1e-30)


def _register_vec_distance(name: str, fn, guard=None):
    def factory():
        def infer(ts):
            if not (ts[0].is_vector and ts[1].is_vector):
                raise TypeError(f"{name} needs two vector arguments")
            if ts[0].precision != ts[1].precision:
                raise ValueError(f"{name}: dimension mismatch "
                                 f"{ts[0].precision} vs {ts[1].precision}")
            nullable = ts[0].nullable or ts[1].nullable or guard is not None
            return DataType(TypeKind.FLOAT64, nullable)

        def evaluate(cols, out):
            x, y = (c.data.float() for c in cols)
            validity = _and_validity(cols)
            if guard is not None:
                ok = guard(x, y)
                validity = ok if validity is None else (validity & ok)
            return Column(fn(x, y).double(), validity, out)

        return infer, evaluate

    register(name)(factory)


_register_vec_distance("vec_l2_distance",
                       lambda x, y: _sqrt32(((x - y) ** 2).sum(1)))
_register_vec_distance("vec_l1_distance",
                       lambda x, y: torch.abs(x - y).sum(1))
_register_vec_distance("vec_negative_inner_product",
                       lambda x, y: -(x * y).sum(1))
# a zero-norm operand gives NULL (cosine distance is undefined there)
_register_vec_distance("vec_cosine_distance", _cosine32,
                       guard=lambda x, y: ((x * x).sum(1) > 0) & ((y * y).sum(1) > 0))


@register("vec_l2_norm")
def _vec_l2_norm():
    def infer(ts):
        if not ts[0].is_vector:
            raise TypeError("vec_l2_norm needs a vector argument")
        return DataType(TypeKind.FLOAT64, ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        x = a.data.float()
        return Column(_sqrt32((x * x).sum(1)).double(), a.validity, out)

    return infer, evaluate


@register("vec_dims")
def _vec_dims():
    def infer(ts):
        if not ts[0].is_vector:
            raise TypeError("vec_dims needs a vector argument")
        return DataType(TypeKind.INT64, ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        dims = torch.full((a.data.shape[0],), a.data.shape[1], dtype=torch.int64,
                          device=a.data.device)
        return Column(dims, a.validity, out)

    return infer, evaluate


def _register_grouping(name: str, per_mark):
    """GROUPING() over the Expand node's gid column (the reference's
    ``FunctionsGrouping.h`` ModeBitAnd / ModeNumericCmp).  The arguments
    after the gid column are the per-column grouping marks; the result
    packs one bit per mark (1 = the column is aggregated, NULL-filled)."""

    def factory():
        def infer(ts):
            return DataType(TypeKind.INT64, False)

        def evaluate(cols, out):
            gid = cols[0].data.to(torch.int64)
            res = torch.zeros_like(gid)
            for c in cols[1:]:
                res = res * 2 + per_mark(gid, c.data.to(torch.int64)).to(torch.int64)
            return Column(res, None, out)

        return infer, evaluate

    register(name)(factory)


_register_grouping("grouping_bit_and", lambda gid, m: (gid & m) == 0)
_register_grouping("grouping_cmp", lambda gid, m: gid <= m)


@register("grouping")
def _grouping():
    """The single-mark ModeNumericSet form: 1 when the gid is not one of
    the grouping ids where the column is materialized (the Expand node's
    ids are 1-based and sequential)."""

    def infer(ts):
        return DataType(TypeKind.INT64, False)

    def evaluate(cols, out):
        gid = cols[0].data.to(torch.int64)
        member = torch.zeros(gid.shape, dtype=torch.bool, device=gid.device)
        for c in cols[1:]:
            member = member | (gid == c.data.to(torch.int64))
        return Column((~member).to(torch.int64), None, out)

    return infer, evaluate


# ---------------------------------------------------------------------------
# bit operations: BIGINT UNSIGNED results on int64 bit patterns
# ---------------------------------------------------------------------------

def _u64_operand(t: torch.Tensor) -> torch.Tensor:
    """The reference's ``astype(uint64)`` of an operand, as int64 bits:
    integers wrap, floats saturate (``_f2i``)."""
    if t.is_floating_point():
        return _bits(_f2i(t, torch.uint64))
    return _bits(t)


def _shift_right(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by per-row 0 <= k < 64."""
    k1 = k.clamp(min=1)
    mask = (torch.ones_like(k1) << (64 - k1)) - 1
    return torch.where(k == 0, a, (a >> k1) & mask)


def _register_bitop(name: str, fn, unary: bool = False, shift: bool = False):
    """MySQL bit operators return BIGINT UNSIGNED: operands are taken as
    uint64 bit patterns; a shift count outside [0, 64) gives 0, and
    ``>>`` is logical."""

    def factory():
        def infer(ts):
            return DataType(TypeKind.UINT64, any(t.nullable for t in ts))

        def evaluate(cols, out):
            if unary:
                (a,) = cols
                return Column(_u64(fn(_u64_operand(a.data))), a.validity, out)
            a, b = cols
            au = _u64_operand(a.data)
            if shift:
                bs = _bits(b.data)
                res = fn(au, bs.clamp(0, 63))
                res = torch.where((bs < 0) | (bs >= 64), torch.zeros_like(res),
                                  res)
            else:
                res = fn(au, _u64_operand(b.data))
            return Column(_u64(res), _and_validity(cols), out)

        return infer, evaluate

    register(name)(factory)


_register_bitop("bit_and", torch.bitwise_and)
_register_bitop("bit_or", torch.bitwise_or)
_register_bitop("bit_xor", torch.bitwise_xor)
_register_bitop("bit_not", torch.bitwise_not, unary=True)
_register_bitop("shift_left", torch.bitwise_left_shift, shift=True)
_register_bitop("shift_right", _shift_right, shift=True)


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 (SWAR; torch has no population count)."""
    x = x - (_lsr(x, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (_lsr(x, 2) & 0x3333333333333333)
    x = (x + _lsr(x, 4)) & 0x0F0F0F0F0F0F0F0F
    return _lsr(x * 0x0101010101010101, 56)


@register("bit_count")
def _bit_count():
    def infer(ts):
        return DataType(TypeKind.INT64, ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        return Column(_popcount64(_bits(_convert(a.data, torch.int64))),
                      a.validity, out)

    return infer, evaluate


@register("cast_fsp_round")
def _cast_fsp_round():
    """Round a DATETIME/DURATION to a fractional-second precision (the
    fsp of CAST(x AS TIME(n)/DATETIME(n))); the digit count is a literal
    0..6."""

    def infer(ts):
        return ts[0]

    def evaluate(cols, out):
        a, f = cols
        if f.stats is None or f.stats[0] != f.stats[1]:
            raise ValueError("cast_fsp_round fsp must be a literal")
        fsp = int(f.stats[0])
        if not 0 <= fsp <= 6:
            raise ValueError(f"fsp {fsp} out of range")
        q = 10 ** (6 - fsp)
        if q == 1:
            return Column(a.data, a.validity, out)
        us = a.data.to(torch.int64)
        mag = _fdiv(us.abs() + q // 2, q) * q
        return Column(torch.where(us < 0, -mag, mag), a.validity, out)

    return infer, evaluate


@register("interval")
def _interval_fn():
    """MySQL INTERVAL(N, a, b, ...): how many of the ascending arguments
    are <= N; -1 when N is NULL (MySQL's own rule, not SQL NULL)."""

    def infer(ts):
        return DataType(TypeKind.INT64, False)

    def evaluate(cols, out):
        n = cols[0]
        nv = _convert(n.data, torch.float64)
        acc = torch.zeros(n.data.shape[0], dtype=torch.int64,
                          device=n.data.device)
        for c in cols[1:]:
            le = _convert(c.data, torch.float64) <= nv
            if c.validity is not None:
                le = le & c.validity
            acc = acc + le.to(torch.int64)
        if n.validity is not None:
            acc = torch.where(n.validity, acc, torch.full_like(acc, -1))
        return Column(acc, None, out)

    return infer, evaluate


# ---------------------------------------------------------------------------
# date and datetime functions (days / microseconds since the epoch)
# ---------------------------------------------------------------------------

# results outside 0001-01-01 .. 9999-12-31 are NULL, zero dates excepted
_DATE_DAYS_MIN = -719162          # 0001-01-01
_DATE_DAYS_MAX = 2932896          # 9999-12-31
_DT_US_MIN = _DATE_DAYS_MIN * 86_400_000_000
_DT_US_MAX = (_DATE_DAYS_MAX + 1) * 86_400_000_000 - 1


def _temporal_range_valid(data: torch.Tensor, validity, kind) -> torch.Tensor:
    if kind is TypeKind.DATETIME:
        ok = (data >= _DT_US_MIN) & (data <= _DT_US_MAX)
        # zero datetimes ('0000-00-00 HH:MM:SS') are storable values
        ok = ok | ((data >= ZERO_DT_BASE_US)
                   & (data < ZERO_DT_BASE_US + 86_400_000_000))
    else:
        ok = (data >= _DATE_DAYS_MIN) & (data <= _DATE_DAYS_MAX)
        ok = ok | (data == ZERO_DATE_DAYS)
    return ok if validity is None else (validity & ok)


def _temporal_result(data: torch.Tensor, v: torch.Tensor, out: DataType) -> Column:
    """Days or microseconds -> an ``out`` column, 0 under NULL (DATE is
    int32)."""
    data = torch.where(v, data, torch.zeros_like(data))
    if out.kind is TypeKind.DATE:
        data = data.to(torch.int32)
    return Column(data, v, out)


def _register_day_shift(name: str, sign: int, unit_days: int):
    """DATE_ADD/SUB by days or weeks; a DATETIME keeps its time of day."""

    def factory():
        def infer(ts):
            return DataType(ts[0].kind, True)

        def evaluate(cols, out):
            a, n = cols
            shift = _bits(n.data) * (sign * unit_days)
            if a.dtype.kind is TypeKind.DATETIME:
                us = a.data.to(torch.int64) + shift * 86_400_000_000
                v = _temporal_range_valid(us, _and_validity(cols),
                                          TypeKind.DATETIME)
                return _temporal_result(us, v, out)
            days = _date_days(a) + shift
            v = _temporal_range_valid(days, _and_validity(cols), TypeKind.DATE)
            return _temporal_result(days, v, out)

        return infer, evaluate

    register(name)(factory)


_register_day_shift("date_add_days", 1, 1)
_register_day_shift("date_sub_days", -1, 1)
_register_day_shift("date_add_weeks", 1, 7)
_register_day_shift("date_sub_weeks", -1, 7)


@register("datediff")
def _datediff():
    def infer(ts):
        return DataType(TypeKind.INT64, ts[0].nullable or ts[1].nullable)

    def evaluate(cols, out):
        a, b = cols
        return Column(_date_days(a) - _date_days(b), _and_validity(cols), out)

    return infer, evaluate


def _register_date_fn(name: str, fn):
    """Day-number functions: NULL on the ZERO date."""

    def factory():
        def infer(ts):
            return DataType(TypeKind.INT64, True)

        def evaluate(cols, out):
            (a,) = cols
            zero = _zero_date_rows(a)
            v = ~zero if a.validity is None else (a.validity & ~zero)
            days = torch.where(zero, torch.zeros((), dtype=torch.int64,
                                                 device=zero.device),
                               _date_days(a))
            return Column(fn(days).to(torch.int64), v, out)

        return infer, evaluate

    register(name)(factory)


def _ones(t: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(t)


def _dayofweek(days):
    return _fmod(days + 4, 7) + 1  # 1 = Sunday


def _dayofyear(days):
    y, m, d = _civil_from_days(days)
    return days - _days_from_civil(y, _ones(m), _ones(d)) + 1


def _quarter(days):
    _, m, _ = _civil_from_days(days)
    return _fdiv(m + 2, 3)


def _to_days(days):
    return days + 719528  # MySQL TO_DAYS epoch offset


def _iso_week_of_dec31(y):
    dec31 = _days_from_civil(y, torch.full_like(y, 12), torch.full_like(y, 31))
    return _fdiv(_dayofyear(dec31) - (_fmod(dec31 + 3, 7) + 1) + 10, 7)


def _weekofyear(days):
    """ISO 8601 week number (MySQL WEEKOFYEAR, WEEK mode 3)."""
    y, _, _ = _civil_from_days(days)
    isowd = _fmod(days + 3, 7) + 1  # 1 = Monday
    week0 = _fdiv(_dayofyear(days) - isowd + 10, 7)
    # this year's week 53, when invalid, is week 1 of the next year
    wk53_valid = _iso_week_of_dec31(y) >= 53
    week = torch.where((week0 >= 53) & ~wk53_valid, _ones(week0), week0)
    # week 0 is the previous year's last week (which may be 53)
    return torch.where(week0 < 1, _iso_week_of_dec31(y - 1), week)


def _last_day(days):
    y, m, _ = _civil_from_days(days)
    ny = y + (m == 12).to(torch.int64)
    nm = torch.where(m == 12, _ones(m), m + 1)
    return _days_from_civil(ny, nm, _ones(m)) - 1


def _week_mode0(days):
    """MySQL WEEK(d), mode 0: weeks start on Sunday; week 1 is the first
    with a Sunday of the year, earlier days are week 0."""
    y, _, _ = _civil_from_days(days)
    jan1 = _days_from_civil(y, _ones(y), _ones(y))
    first_sunday_doy = 1 + _fmod(6 - _fmod(jan1 + 3, 7), 7)
    doy = days - jan1 + 1
    return torch.where(doy < first_sunday_doy, torch.zeros_like(doy),
                       _fdiv(doy - first_sunday_doy, 7) + 1)


def _yearweek_mode0(days):
    y, _, _ = _civil_from_days(days)
    week = _week_mode0(days)
    # week 0 belongs to the previous year's last week
    py = y - 1
    pjan1 = _days_from_civil(py, _ones(py), _ones(py))
    pfs = 1 + _fmod(6 - _fmod(pjan1 + 3, 7), 7)
    pweek = _fdiv(days - pjan1 + 1 - pfs, 7) + 1
    return torch.where(week > 0, y * 100 + week, py * 100 + pweek)


for _n, _fn in (("day_of_week", _dayofweek), ("day_of_year", _dayofyear),
                ("quarter", _quarter), ("to_days", _to_days),
                ("week_of_year", _weekofyear),
                ("weekday", lambda days: _fmod(days + 3, 7)),  # 0 = Monday
                ("week", _week_mode0), ("yearweek", _yearweek_mode0)):
    _register_date_fn(_n, _fn)


def _register_time_part(name: str, divisor: int, modulus: int):
    """Sub-day parts of a DATETIME; a DURATION's are of its magnitude, and
    its hour is not reduced mod 24 (HOUR('272:59:59') = 272)."""

    def factory():
        def infer(ts):
            return DataType(TypeKind.INT64, ts[0].nullable)

        def evaluate(cols, out):
            (a,) = cols
            us = a.data.to(torch.int64)
            if a.dtype.kind is TypeKind.DURATION:
                data = _fdiv(us.abs(), divisor)
                if name != "hour":
                    data = _fmod(data, modulus)
                return Column(data, a.validity, out)
            day = 86_400_000_000
            us = torch.where(us < 0, us + (_fdiv(-us, day) + 1) * day, us)
            return Column(_fmod(_fdiv(us, divisor), modulus), a.validity, out)

        return infer, evaluate

    register(name)(factory)


_register_time_part("hour", 3_600_000_000, 24)
_register_time_part("minute", 60_000_000, 60)
_register_time_part("second", 1_000_000, 60)
_register_time_part("microsecond", 1, 1_000_000)


def _local_epoch_us(a: Column) -> torch.Tensor:
    """A DATE/DATETIME read as session-local time -> UTC epoch us."""
    from .compile import query_tz_us

    if a.dtype.kind is TypeKind.DATE:
        return a.data.to(torch.int64) * 86_400_000_000 - query_tz_us()
    return a.data.to(torch.int64) - query_tz_us()


@register("unix_timestamp")
def _unix_timestamp():
    def infer(ts):
        return DataType(TypeKind.INT64, ts[0].nullable)

    def evaluate(cols, out):
        from .compile import query_tz_us

        (a,) = cols
        if a.dtype.kind is TypeKind.DATE:
            data = a.data.to(torch.int64) * 86_400 - query_tz_us() // 1_000_000
        else:
            data = _fdiv(_local_epoch_us(a), 1_000_000)
        return Column(data, a.validity, out)

    return infer, evaluate


@register("unix_timestamp_decimal")
def _unix_timestamp_decimal():
    """UNIX_TIMESTAMP of a DATETIME with fractional seconds: DECIMAL(18,6)
    of the tz-shifted epoch microseconds."""

    def infer(ts):
        return Decimal(18, 6, True)

    def evaluate(cols, out):
        (a,) = cols
        return Column(_local_epoch_us(a), a.validity, out)

    return infer, evaluate


@register("from_unixtime")
def _from_unixtime():
    def infer(ts):
        return DataType(TypeKind.DATETIME, ts[0].nullable)

    def evaluate(cols, out):
        from .compile import query_tz_us

        (a,) = cols
        return Column(_bits(a.data) * 1_000_000 + query_tz_us(), a.validity,
                      out)

    return infer, evaluate


@register("date")
def _date_part_fn():
    def infer(ts):
        return DataType(TypeKind.DATE, ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        return Column(_date_days(a).to(torch.int32), a.validity, out)

    return infer, evaluate


@register("last_day")
def _last_day_fn():
    def infer(ts):
        return DataType(TypeKind.DATE, ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        return Column(_last_day(_date_days(a)).to(torch.int32), a.validity, out)

    return infer, evaluate


def _register_from_days(name: str, mpp: bool):
    """FROM_DAYS: both forms give the ZERO date below day 366; past
    9999-12-31 (day 3652424) the MPP form is NULL, while the coprocessor
    form runs on to day 3652499 and gives the ZERO date after it."""

    def factory():
        def infer(ts):
            return DataType(TypeKind.DATE, True)

        def evaluate(cols, out):
            (a,) = cols
            n = _bits(a.data)
            days = n - 719528  # inverse of TO_DAYS
            hi = 3_652_424 if mpp else 3_652_499
            zero = (n < 366) if mpp else ((n < 366) | (n > hi))
            days = torch.where(zero, torch.full_like(days, ZERO_DATE_DAYS),
                               days)
            v = a.validity
            if mpp:
                bad = n > hi
                v = ~bad if v is None else (v & ~bad)
                days = torch.where(bad, torch.zeros_like(days), days)
            return Column(days.to(torch.int32), v, out)

        return infer, evaluate

    register(name)(factory)


_register_from_days("from_days", True)
_register_from_days("from_days_cop", False)


@register("makedate")
def _makedate():
    def infer(ts):
        return DataType(TypeKind.DATE, True)  # a day of year < 1 is NULL

    def evaluate(cols, out):
        y, doy = cols
        yy, dd = _bits(y.data), _bits(doy.data)
        days = _days_from_civil(yy, _ones(yy), _ones(yy)) + dd - 1
        ok = dd >= 1
        v = _and_validity(cols)
        v = ok if v is None else (v & ok)
        return Column(days.to(torch.int32), v, out)

    return infer, evaluate


@register("time_to_sec")
def _time_to_sec():
    def infer(ts):
        return DataType(TypeKind.INT64, ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        us = a.data.to(torch.int64)
        if a.dtype.kind is TypeKind.DATE:
            data = torch.zeros_like(us)
        elif a.dtype.kind is TypeKind.DURATION:
            # signed, truncated toward zero (TIME_TO_SEC('-01:00') = -3600)
            data = torch.sign(us) * _fdiv(us.abs(), 1_000_000)
        else:
            us = us - _fdiv(us, 86_400_000_000) * 86_400_000_000
            data = _fdiv(us, 1_000_000)
        return Column(data, a.validity, out)

    return infer, evaluate


def _period_to_months(p: torch.Tensor) -> torch.Tensor:
    """MySQL period YYMM/YYYYMM -> linear months (two-digit years: 70 and
    up are 19xx, else 20xx)."""
    y, m = _fdiv(p, 100), _fmod(p, 100)
    y = torch.where(y < 70, y + 2000, torch.where(y < 100, y + 1900, y))
    return y * 12 + m - 1


@register("period_add")
def _period_add():
    def infer(ts):
        return DataType(TypeKind.INT64, ts[0].nullable or ts[1].nullable)

    def evaluate(cols, out):
        p, n = cols
        months = _period_to_months(_bits(p.data)) + _bits(n.data)
        period = _fdiv(months, 12) * 100 + _fmod(months, 12) + 1
        return Column(period, _and_validity(cols), out)

    return infer, evaluate


@register("period_diff")
def _period_diff():
    def evaluate(cols, out):
        p1, p2 = cols
        d = (_period_to_months(_bits(p1.data))
             - _period_to_months(_bits(p2.data)))
        return Column(d, _and_validity(cols), out)

    return REGISTRY["period_add"].infer, evaluate


def _add_months_days(days: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Month arithmetic, clamping the day (Jan 31 + 1 month = Feb 28/29)."""
    y, m, d = _civil_from_days(days)
    tot = y * 12 + (m - 1) + n
    ny = _fdiv(tot, 12)
    nm = tot - ny * 12 + 1
    start = _days_from_civil(ny, nm, _ones(nm))
    nxt = _days_from_civil(ny + (nm == 12).to(torch.int64),
                           torch.where(nm == 12, _ones(nm), nm + 1), _ones(nm))
    return start + torch.minimum(d, nxt - start) - 1


def _register_add_months(name: str, sign: int, unit_months: int):
    def factory():
        def infer(ts):
            return DataType(ts[0].kind, True)

        def evaluate(cols, out):
            a, n = cols
            months = _bits(n.data) * (sign * unit_months)
            days = _date_days(a)
            # clamped so the civil math stays in its domain; the range
            # check NULLs whatever left the window
            new_days = _add_months_days(days, months.clamp(-240_000, 240_000))
            # landing in year 0 gives the ZERO date, time of day kept
            zero = _civil_from_days(new_days)[0] == 0
            if a.dtype.kind is TypeKind.DATETIME:
                tod = a.data.to(torch.int64) - days * 86_400_000_000
                us = torch.where(zero, ZERO_DT_BASE_US + tod,
                                 new_days * 86_400_000_000 + tod)
                v = _temporal_range_valid(us, _and_validity(cols),
                                          TypeKind.DATETIME)
                return _temporal_result(us, v, out)
            new_days = torch.where(zero, torch.full_like(new_days,
                                                         ZERO_DATE_DAYS),
                                   new_days)
            v = _temporal_range_valid(new_days, _and_validity(cols),
                                      TypeKind.DATE)
            return _temporal_result(new_days, v, out)

        return infer, evaluate

    register(name)(factory)


for _u, _k in (("months", 1), ("years", 12), ("quarters", 3)):
    _register_add_months(f"date_add_{_u}", 1, _k)
    _register_add_months(f"date_sub_{_u}", -1, _k)


def _register_us_shift(name: str, sign: int, unit_us: int):
    """DATE_ADD/SUB by hours or finer: the result is a DATETIME."""

    def factory():
        def infer(ts):
            return DataType(TypeKind.DATETIME, True)

        def evaluate(cols, out):
            a, n = cols
            if a.dtype.kind is TypeKind.DATETIME:
                base = a.data.to(torch.int64)
            else:
                base = _date_days(a) * 86_400_000_000
            us = base + _bits(n.data) * (sign * unit_us)
            v = _temporal_range_valid(us, _and_validity(cols),
                                      TypeKind.DATETIME)
            return _temporal_result(us, v, out)

        return infer, evaluate

    register(name)(factory)


for _u, _k in (("hours", 3_600_000_000), ("minutes", 60_000_000),
               ("seconds", 1_000_000), ("microseconds", 1)):
    _register_us_shift(f"date_add_{_u}", 1, _k)
    _register_us_shift(f"date_sub_{_u}", -1, _k)


# ---------------------------------------------------------------------------
# string functions: host tables over the dictionary, one gather on the
# column's device
# ---------------------------------------------------------------------------

def _lut_validity(col: Column, nulls: np.ndarray):
    """AND a per-entry NULL table into the column's validity.  Returns
    (validity or None, result nullable)."""
    if not nulls.any():
        return col.validity, col.dtype.nullable
    not_null = _gather(~nulls, _codes(col, len(nulls)))
    v = not_null if col.validity is None else (col.validity & not_null)
    return v, True


def _map_string_to_string(col: Column, fn, null_result=None,
                          errors=None) -> Column:
    """Host LUT over the dictionary; ``fn`` returns a string, None (SQL
    NULL) or an ``EvalError``.  ``null_result`` is the value SQL-NULL
    input rows get instead of NULL.  Each distinct error message becomes
    a per-row mask appended to ``errors`` (an evaluator's
    ``runtime_errors``) as (mask, message); without a sink errors are
    NULL.  The output dictionary is Python's sorted set of the results."""
    from ..runtime.errors import EvalError

    d = col.dictionary or ()
    mapped = [fn(s) for s in d]
    if any(isinstance(m, EvalError) for m in mapped):
        if errors is not None:
            by_msg: dict = {}
            for i, m in enumerate(mapped):
                if isinstance(m, EvalError):
                    by_msg.setdefault(m.message, []).append(i)
            idx = _codes(col, len(mapped))
            for msg, idxs in by_msg.items():
                tbl = np.zeros(max(len(mapped), 1), dtype=bool)
                tbl[idxs] = True
                mask = _gather(tbl, idx)
                if col.validity is not None:
                    mask = mask & col.validity
                errors.append((mask, msg))
        mapped = [None if isinstance(m, EvalError) else m for m in mapped]
    nulls = np.array([m is None for m in mapped] or [False])
    mapped = ["" if m is None else m for m in mapped]
    pool = set(mapped)
    if null_result is not None:
        pool.add(null_result)
    new_dict = tuple(sorted(pool)) or ("",)
    rank = {s: i for i, s in enumerate(new_dict)}
    table = np.array([rank[m] for m in mapped] or [0], dtype=np.int32)
    data = _gather(table, _codes(col, len(table)))
    validity, nullable = _lut_validity(col, nulls)
    if null_result is not None and col.validity is not None:
        data = torch.where(col.validity, data,
                           torch.full_like(data, rank[null_result]))
        bad = _gather(nulls, _codes(col, len(nulls)))
        validity = col.validity & ~bad | ~col.validity
        nullable = True
    return Column(data, validity, STRING.with_nullable(nullable), new_dict)


def _map_string_to_int(col: Column, fn,
                       kind: TypeKind = TypeKind.INT64) -> Column:
    d = col.dictionary or ()
    mapped = [fn(s) for s in d]
    nulls = np.array([m is None for m in mapped] or [False])
    table = np.array([0 if m is None else int(m) for m in mapped] or [0],
                     dtype=np.int64)
    data = _gather(table, _codes(col, len(table)))
    validity, nullable = _lut_validity(col, nulls)
    if kind is TypeKind.BOOL:
        data = data.to(torch.bool)
    return Column(data, validity, DataType(kind, nullable))


def _register_string_unary(name: str, fn, to_int: bool = False):
    def factory():
        def infer(ts):
            if to_int:
                return DataType(TypeKind.INT64, ts[0].nullable)
            return STRING.with_nullable(ts[0].nullable)

        def evaluate(cols, out):
            (a,) = cols
            if not a.dtype.is_string:
                # MySQL coerces: LENGTH(123) = 3, ASCII(123) = 49
                a = _coerce_string_arg(a)
            if to_int:
                return _map_string_to_int(a, fn)
            return _map_string_to_string(a, fn)

        return infer, evaluate

    register(name)(factory)


def _coerce_string_arg(a: Column) -> Column:
    """Implicit numeric/temporal -> string coercion for a string function:
    the engine's MySQL text over the column's host-knowable domain, on
    the column's device."""
    from .compile import ExprEvaluator

    return ExprEvaluator.bare(a.data.shape[0], a.data.device) \
        ._cast_to_string_lut(a, STRING)


def _hash_hex(algo: str):
    return lambda s: hashlib.new(algo, s.encode()).hexdigest()


_register_string_unary("upper", str.upper)
_register_string_unary("lower", str.lower)
_register_string_unary("reverse", lambda s: s[::-1])
_register_string_unary("ltrim", str.lstrip)
_register_string_unary("rtrim", str.rstrip)
_register_string_unary("trim", str.strip)
# LENGTH counts UTF-8 bytes, CHAR_LENGTH characters
_register_string_unary("length", lambda s: len(s.encode("utf-8")), to_int=True)
_register_string_unary("char_length", len, to_int=True)
_register_string_unary("ascii", lambda s: ord(s[0]) if s else 0, to_int=True)
_register_string_unary("bit_length", lambda s: 8 * len(s.encode()), to_int=True)
_register_string_unary("crc32", lambda s: zlib.crc32(s.encode()), to_int=True)
_register_string_unary("md5", _hash_hex("md5"))
_register_string_unary("sha1", _hash_hex("sha1"))
_register_string_unary("hex", lambda s: s.encode().hex().upper())
# MySQL ORD: the leading character's UTF-8 bytes, big-endian
_register_string_unary(
    "ord", lambda s: int.from_bytes(s[0].encode(), "big") if s else 0,
    to_int=True)


def _map_string_to_date(col: Column, fn) -> Column:
    """Host LUT dictionary -> epoch-day DATE column; ``fn`` returns a
    ``datetime.date``, a zero or civil date, or None (SQL NULL)."""
    epoch = datetime.date(1970, 1, 1)
    mapped = [fn(s) for s in (col.dictionary or ())]
    nulls = np.array([m is None for m in mapped] or [False])

    def days(m):
        if m is None:
            return 0
        if isinstance(m, datetime.date):
            return (m - epoch).days
        if isinstance(m, ZeroDate):
            return ZERO_DATE_DAYS
        if isinstance(m, CivilDate):  # partial zero dates included
            return m.epoch_days
        raise TypeError(f"unexpected date value {m!r}")

    table = np.array([days(m) for m in mapped] or [0], dtype=np.int32)
    data = _gather(table, _codes(col, len(table)))
    validity, nullable = _lut_validity(col, nulls)
    return Column(data, validity, DataType(TypeKind.DATE, nullable))


def _map_string_to_datetime(col: Column, fn) -> Column:
    """Host LUT dictionary -> epoch-microsecond DATETIME column; ``fn``
    returns a ``datetime.datetime`` or None."""
    epoch = datetime.datetime(1970, 1, 1)
    mapped = [fn(s) for s in (col.dictionary or ())]
    nulls = np.array([m is None for m in mapped] or [False])
    table = np.array(
        [0 if m is None else round((m - epoch).total_seconds() * 1_000_000)
         for m in mapped] or [0], dtype=np.int64)
    data = _gather(table, _codes(col, len(table)))
    validity, nullable = _lut_validity(col, nulls)
    return Column(data, validity, DataType(TypeKind.DATETIME, nullable))


def _register_part_name(name: str, part_fn_name: str, names_list):
    """MONTHNAME/DAYNAME of a date: the part number into a constant sorted
    dictionary of names; part 0 (the zero date) has no name and is NULL."""
    sorted_dict = tuple(sorted(names_list))
    rank = np.array([sorted_dict.index(n) for n in names_list], dtype=np.int32)

    def factory():
        def infer(ts):
            return STRING.with_nullable(ts[0].nullable)

        def evaluate(cols, out):
            part = get_function(part_fn_name).evaluate(
                cols, DataType(TypeKind.INT64, cols[0].dtype.nullable))
            idx = (part.data - 1).clamp(0, len(names_list) - 1)
            v = part.data >= 1
            if part.validity is not None:
                v = v & part.validity
            return Column(_gather(rank, idx), v, out, sorted_dict)

        return infer, evaluate

    register(name)(factory)


for _n in ("month_name", "monthname"):
    _register_part_name(_n, "month", _MONTH_FULL_NAMES)
# MySQL dayofweek: 1 = Sunday .. 7 = Saturday
for _n in ("day_name", "dayname"):
    _register_part_name(_n, "dayofweek", _WEEKDAY_NAMES)


@register("json_valid")
def _json_valid():
    """For a non-string argument: only strings hold JSON text, so the
    result is 0 and never NULL (string columns take the dictionary LUT in
    ``expr/compile.py``)."""

    def infer(ts):
        return DataType(TypeKind.BOOL, False)

    def evaluate(cols, out):
        (a,) = cols
        return Column(torch.zeros(a.data.shape[:1], dtype=torch.bool,
                                  device=a.data.device), None, out)

    return infer, evaluate


# ---------------------------------------------------------------------------
# TiDB-name aliases (of registered targets only)
# ---------------------------------------------------------------------------

_ALIASES = {
    "ifnull": "coalesce",
    "nulleq": "null_eq",
    "istrue": "is_true",
    "isfalse": "is_false",
    "mod": "modulo",
    "power": "pow",
    "lcase": "lower",
    "ucase": "upper",
    "substr": "substring",
    "character_length": "char_length",
    "dayofweek": "day_of_week",
    "dayofyear": "day_of_year",
    "dayofmonth": "day_of_month",
    "weekofyear": "week_of_year",
    "ceiling": "ceil",
    "eq": "equals",
    "ne": "not_equals",
    "lt": "less",
    "le": "less_or_equals",
    "gt": "greater",
    "ge": "greater_or_equals",
    "plus_int": "plus",
    "isnull": "is_null",
    "div": "int_div",
    "intdiv": "int_div",
    "regexp": "regexp_like",
    "rlike": "regexp_like",
    "mid": "substring",
    "octet_length": "length",
    "insert": "insert_str",
    "adddate": "date_add_days",
    "subdate": "date_sub_days",
    "sha": "sha1",
    "day": "day_of_month",
    "add_months": "date_add_months",
    "bit_neg": "bit_not",
    "json_array_length": "json_length",
}
for _alias, _target in _ALIASES.items():
    if _alias not in REGISTRY and _target in REGISTRY:
        REGISTRY[_alias] = REGISTRY[_target]


from . import duration as _duration  # noqa: E402,F401  (registers TIME fns)

__all__ = ["REGISTRY", "get_function", "cast_column", "Function",
           "DIV_PRECISION_INCREMENT", "propagate_stats", "round_decimal_frac",
           "round_decimal_frac_dynamic", "parse_mysql_time"]
