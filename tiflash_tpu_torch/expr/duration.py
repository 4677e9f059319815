"""MySQL TIME (duration) functions.

Counterpart of ``tiflash_tpu/expr/duration.py``.  A DURATION column is
int64 signed microseconds, clamped to MySQL's TIME range +-838:59:59, so
comparisons, sorts and joins on durations are the plain int64 paths.
The reference's ``//`` on int64 floors: here ``_fdiv``
(``torch.div(..., rounding_mode="floor")``).

``any_value`` is the identity outside aggregation; ``time_format`` is
registered as the reference registers it, a guard whose type inference
raises.
"""

from __future__ import annotations

import torch

from ..core.block import Column
from ..core.dtypes import DURATION_MAX_US, DataType, TypeKind
from .functions import _and_validity, _f2i, _fdiv, register

_DAY_US = 86_400_000_000


def _clamp_dur(us: torch.Tensor) -> torch.Tensor:
    return us.clamp(-DURATION_MAX_US, DURATION_MAX_US)


def _dur(nullable: bool) -> DataType:
    return DataType(TypeKind.DURATION, nullable)


def _seconds_us(c: Column) -> torch.Tensor:
    """A seconds argument as int64 microseconds: a float truncates, a
    decimal rescales to 6 digits (floor past 6)."""
    if c.dtype.is_float:
        return _f2i(c.data.to(torch.float64) * 1e6, torch.int64)
    if c.dtype.is_decimal:
        sc = c.dtype.scale
        if sc <= 6:
            return c.data.to(torch.int64) * (10 ** (6 - sc))
        return _fdiv(c.data.to(torch.int64), 10 ** (sc - 6))
    return c.data.to(torch.int64) * 1_000_000


@register("maketime")
def _maketime():
    """MAKETIME(h, m, s): m or s outside [0, 60) is NULL; |h| past the
    TIME range clamps."""

    def infer(ts):
        return _dur(True)

    def evaluate(cols, out):
        h, m, s = cols
        hv = h.data.to(torch.int64)
        mv = m.data.to(torch.int64)
        s_us = _seconds_us(s)
        if s.dtype.is_decimal:
            s_ok = (s.data >= 0) & (s.data < 60 * (10 ** s.dtype.scale))
        else:
            s_ok = (s.data >= 0) & (s.data < 60)
        ok = (mv >= 0) & (mv < 60) & s_ok
        mag = hv.abs() * 3_600_000_000 + mv * 60_000_000 + s_us
        us = _clamp_dur(torch.where(hv < 0, -mag, mag))
        v = _and_validity(cols)
        v = ok if v is None else (v & ok)
        return Column(us, v, out)

    return infer, evaluate


@register("sec_to_time")
def _sec_to_time():
    def infer(ts):
        return _dur(ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        return Column(_clamp_dur(_seconds_us(a)), a.validity, out)

    return infer, evaluate


def _to_us(c: Column) -> torch.Tensor:
    if c.dtype.kind is TypeKind.DATE:
        return c.data.to(torch.int64) * _DAY_US
    return c.data.to(torch.int64)


@register("timediff")
def _timediff():
    """TIMEDIFF(a, b) of two datetimes or two durations; arguments of
    different kinds are rejected at type inference (MySQL gives NULL)."""

    def infer(ts):
        a, b = ts
        same = (
            a.kind is b.kind
            or (a.kind in (TypeKind.DATE, TypeKind.DATETIME)
                and b.kind in (TypeKind.DATE, TypeKind.DATETIME))
        )
        if not same:
            raise TypeError(f"timediff argument kinds differ: {a} vs {b}")
        return _dur(a.nullable or b.nullable)

    def evaluate(cols, out):
        a, b = cols
        return Column(_clamp_dur(_to_us(a) - _to_us(b)), _and_validity(cols),
                      out)

    return infer, evaluate


def _register_addsubtime(name: str, sign: int):
    def factory():
        def infer(ts):
            a, b = ts
            if b.kind is not TypeKind.DURATION:
                raise TypeError(f"{name}: second argument must be TIME, got {b}")
            nullable = a.nullable or b.nullable
            if a.kind in (TypeKind.DATE, TypeKind.DATETIME):
                return DataType(TypeKind.DATETIME, nullable)
            if a.kind is TypeKind.DURATION:
                return _dur(nullable)
            raise TypeError(f"{name}: unsupported first argument {a}")

        def evaluate(cols, out):
            a, b = cols
            res = _to_us(a) + sign * b.data.to(torch.int64)
            if out.kind is TypeKind.DURATION:
                res = _clamp_dur(res)
            return Column(res, _and_validity(cols), out)

        return infer, evaluate

    register(name)(factory)


_register_addsubtime("addtime", 1)
_register_addsubtime("subtime", -1)


@register("time")
def _time_fn():
    """TIME(datetime): the time of day as a duration (>= 0)."""

    def infer(ts):
        return _dur(ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        if a.dtype.kind is TypeKind.DURATION:
            return Column(a.data, a.validity, out)
        us = a.data.to(torch.int64)
        if a.dtype.kind is TypeKind.DATE:
            us = torch.zeros_like(us)
        else:
            us = us - _fdiv(us, _DAY_US) * _DAY_US
        return Column(us, a.validity, out)

    return infer, evaluate


@register("to_seconds")
def _to_seconds():
    """TO_SECONDS(date/datetime): seconds since year 0 (TO_DAYS * 86400 +
    the time of day)."""

    def infer(ts):
        return DataType(TypeKind.INT64, ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        if a.dtype.kind is TypeKind.DATE:
            secs = (a.data.to(torch.int64) + 719_528) * 86_400
        else:
            us = a.data.to(torch.int64)
            days = _fdiv(us, _DAY_US)
            tod = _fdiv(us - days * _DAY_US, 1_000_000)
            secs = (days + 719_528) * 86_400 + tod
        return Column(secs, a.validity, out)

    return infer, evaluate


@register("any_value")
def _any_value():
    """ANY_VALUE(x): the identity on the row path."""

    def infer(ts):
        return ts[0]

    def evaluate(cols, out):
        return cols[0]

    return infer, evaluate


@register("time_format")
def _time_format_guard():
    # registered so the name resolves, as in the reference, whose
    # compiler has no body for it either
    def infer(ts):
        raise NotImplementedError("time_format is compiled in compile.py")

    def evaluate(cols, out):
        raise NotImplementedError

    return infer, evaluate


def duration_components(us: torch.Tensor):
    """(negative, h, m, s, frac_us) of signed microseconds; the parts are
    of the magnitude (MySQL HOUR('-10:10:10') = 10)."""
    neg = us < 0
    mag = us.abs()
    h = _fdiv(mag, 3_600_000_000)
    m = torch.remainder(_fdiv(mag, 60_000_000), 60)
    s = torch.remainder(_fdiv(mag, 1_000_000), 60)
    f = torch.remainder(mag, 1_000_000)
    return neg, h, m, s, f


__all__ = ["duration_components"]
