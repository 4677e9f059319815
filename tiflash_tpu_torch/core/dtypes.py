"""Logical data types of the PyTorch port.

Counterpart of ``tiflash_tpu/core/dtypes.py``: every logical type maps to
one fixed-width physical dtype, nullability rides a separate validity
mask, strings are dictionary-encoded int32 codes.  Decimals with
precision <= 18 are int64 mantissas; wide decimals (precision > 18) are
typed wide and stored either as a 1-D int64 mantissa when statistics
prove it fits ("narrow-stored") or as ``(n, L)`` int64 limbs
(``core/wide.py``).

Changes from the reference: ``torch_dtype`` in place of ``jnp_dtype``;
of the MySQL-specific type flags ``tz_aware`` (TIMESTAMP), ``mysql_json``
and ``mysql_blob`` are here; ENUM and YEAR are not, as no table of the
port has such a column.  The
zero-date sentinels and the host-side civil-date helpers and values
(``CivilDate``, ``ZeroDate`` ...) are the reference's.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class TypeKind(enum.Enum):
    INT8 = "i8"
    INT16 = "i16"
    INT32 = "i32"
    INT64 = "i64"
    UINT8 = "u8"
    UINT32 = "u32"
    UINT64 = "u64"
    FLOAT32 = "f32"
    FLOAT64 = "f64"
    BOOL = "bool"
    DECIMAL = "decimal"  # int64 mantissa, fixed scale
    DATE = "date"  # int32 days since 1970-01-01
    DATETIME = "datetime"  # int64 microseconds since epoch
    DURATION = "duration"  # int64 signed microseconds (MySQL TIME)
    STRING = "string"  # int32 dictionary codes
    VECTOR = "vector"  # (n, dims) float32 rows


_PHYSICAL = {
    TypeKind.INT8: np.int8,
    TypeKind.INT16: np.int16,
    TypeKind.INT32: np.int32,
    TypeKind.INT64: np.int64,
    TypeKind.UINT8: np.uint8,
    TypeKind.UINT32: np.uint32,
    TypeKind.UINT64: np.uint64,
    TypeKind.FLOAT32: np.float32,
    TypeKind.FLOAT64: np.float64,
    TypeKind.BOOL: np.bool_,
    TypeKind.DECIMAL: np.int64,
    TypeKind.DATE: np.int32,
    TypeKind.DATETIME: np.int64,
    TypeKind.DURATION: np.int64,
    TypeKind.STRING: np.int32,
    TypeKind.VECTOR: np.float32,
}

_TORCH = {
    TypeKind.INT8: torch.int8,
    TypeKind.INT16: torch.int16,
    TypeKind.INT32: torch.int32,
    TypeKind.INT64: torch.int64,
    TypeKind.UINT8: torch.uint8,
    TypeKind.UINT32: torch.uint32,
    TypeKind.UINT64: torch.uint64,
    TypeKind.FLOAT32: torch.float32,
    TypeKind.FLOAT64: torch.float64,
    TypeKind.BOOL: torch.bool,
    TypeKind.DECIMAL: torch.int64,
    TypeKind.DATE: torch.int32,
    TypeKind.DATETIME: torch.int64,
    TypeKind.DURATION: torch.int64,
    TypeKind.STRING: torch.int32,
    TypeKind.VECTOR: torch.float32,
}

_INTEGER_KINDS = {
    TypeKind.INT8,
    TypeKind.INT16,
    TypeKind.INT32,
    TypeKind.INT64,
    TypeKind.UINT8,
    TypeKind.UINT32,
    TypeKind.UINT64,
}

_FLOAT_KINDS = {TypeKind.FLOAT32, TypeKind.FLOAT64}


@dataclasses.dataclass(frozen=True)
class DataType:
    """A logical column type (hashable, compared by value)."""

    kind: TypeKind
    nullable: bool = False
    # Decimal parameters (kind == DECIMAL only).
    precision: int = 0
    scale: int = 0
    # MySQL TIMESTAMP semantics (kind == DATETIME only): values are stored
    # as UTC microseconds and shift into the session time zone at column
    # read (``expr/compile.py``, ``query_timezone``).
    tz_aware: bool = False
    # JSON columns ride the STRING representation (normalized text); the
    # flag makes JSON builders embed the value as a document, not a quoted
    # string, and casts out of JSON unquote a JSON string first
    mysql_json: bool = False
    # binary string families carry their MySQL field-type code (BLOB=252,
    # BINARY=254 ...); CAST(AS JSON) renders them as base64 opaques
    mysql_blob: int = 0

    # ---- physical representation ----
    @property
    def physical(self) -> np.dtype:
        return np.dtype(_PHYSICAL[self.kind])

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH[self.kind]

    # ---- classification ----
    @property
    def is_integer(self) -> bool:
        return self.kind in _INTEGER_KINDS

    @property
    def is_float(self) -> bool:
        return self.kind in _FLOAT_KINDS

    @property
    def is_unsigned(self) -> bool:
        return self.kind in (TypeKind.UINT8, TypeKind.UINT32,
                             TypeKind.UINT64)

    @property
    def is_decimal(self) -> bool:
        return self.kind is TypeKind.DECIMAL

    @property
    def is_wide_decimal(self) -> bool:
        """Precision > 18: multi-limb base-10^18 mantissa (core/wide.py)."""
        return self.kind is TypeKind.DECIMAL and self.precision > 18

    @property
    def decimal_limbs(self) -> int:
        """Physical limb count: 1 (p<=18), 2 (p<=38), 4 (p<=65)."""
        if self.precision <= 18:
            return 1
        return 2 if self.precision <= 38 else 4

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float or self.is_decimal

    @property
    def is_string(self) -> bool:
        return self.kind is TypeKind.STRING

    @property
    def is_temporal(self) -> bool:
        return self.kind in (TypeKind.DATE, TypeKind.DATETIME)

    @property
    def is_vector(self) -> bool:
        """VECTOR Float32: column data is (n, dims) float32, ``precision``
        holds ``dims``."""
        return self.kind is TypeKind.VECTOR

    def with_nullable(self, nullable: bool = True) -> "DataType":
        return dataclasses.replace(self, nullable=nullable)

    def __repr__(self) -> str:  # compact, e.g. Decimal(15,2)? / i64
        if self.kind is TypeKind.DECIMAL:
            base = f"Decimal({self.precision},{self.scale})"
        elif self.kind is TypeKind.VECTOR:
            base = f"Vector({self.precision})"
        else:
            base = self.kind.value
        return base + ("?" if self.nullable else "")


INT8 = DataType(TypeKind.INT8)
INT16 = DataType(TypeKind.INT16)
INT32 = DataType(TypeKind.INT32)
INT64 = DataType(TypeKind.INT64)
UINT8 = DataType(TypeKind.UINT8)
UINT32 = DataType(TypeKind.UINT32)
UINT64 = DataType(TypeKind.UINT64)
FLOAT32 = DataType(TypeKind.FLOAT32)
FLOAT64 = DataType(TypeKind.FLOAT64)
BOOL = DataType(TypeKind.BOOL)
DATE = DataType(TypeKind.DATE)
DATETIME = DataType(TypeKind.DATETIME)
DURATION = DataType(TypeKind.DURATION)
STRING = DataType(TypeKind.STRING)


# MySQL TIME range: +-838:59:59.000000
DURATION_MAX_US = 3_020_399_000_000

# MySQL's ZERO date ('0000-00-00') as stored days since the epoch: a
# sentinel far below any civil date the engine produces.  A zero DATETIME
# keeps its time of day: it lives in [ZERO_DT_BASE_US, + one day).
ZERO_DATE_DAYS = -3_650_000
ZERO_DT_BASE_US = ZERO_DATE_DAYS * 86_400_000_000
# PARTIAL zero dates ('2012-00-00') pack into a sentinel day range below
# any civil date (year-0 dates bottom out at -719468); the whole range
# sorts below real dates, as in the reference.
PARTIAL_ZERO_BASE = -30_000_000


def partial_zero_days(y: int, m: int, d: int) -> int:
    return PARTIAL_ZERO_BASE + (y * 13 + m) * 32 + d


def partial_zero_civil(days: int):
    ym, d = divmod(days - PARTIAL_ZERO_BASE, 32)
    y, m = divmod(ym, 13)
    return y, m, d


def is_partial_zero_days(v: int) -> bool:
    return PARTIAL_ZERO_BASE <= v < PARTIAL_ZERO_BASE + 10_000 * 13 * 32


def _trunc_div(a: int, b: int) -> int:
    """C integer division (toward zero), which Hinnant's civil
    algorithms assume."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def civil_to_days(y: int, m: int, d: int) -> int:
    """Proleptic-Gregorian (y, m, d) -> days since 1970-01-01 for any
    year (python's datetime covers only 1..9999)."""
    y -= m <= 2
    era = _trunc_div(y if y >= 0 else y - 399, 400)
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def days_to_civil(days: int):
    """Inverse of ``civil_to_days``."""
    z = days + 719468
    era = _trunc_div(z if z >= 0 else z - 146096, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


class CivilDate:
    """A DATE outside python's year 1..9999, by its civil fields."""

    def __init__(self, y: int, m: int, d: int):
        self.y, self.m, self.d = y, m, d

    @property
    def epoch_days(self) -> int:
        if self.m == 0 or self.d == 0:
            # partial zero date: civil math would alias it
            return partial_zero_days(self.y, self.m, self.d)
        return civil_to_days(self.y, self.m, self.d)

    def __repr__(self):
        return f"{self.y:04d}-{self.m:02d}-{self.d:02d}"

    __str__ = __repr__

    def __eq__(self, other):
        return (isinstance(other, CivilDate)
                and (other.y, other.m, other.d) == (self.y, self.m, self.d))

    def __hash__(self):
        return hash(("civil", self.y, self.m, self.d))


class CivilDateTime(CivilDate):
    """A DATETIME outside python's year range."""

    def __init__(self, y, m, d, hh=0, mi=0, ss=0, us=0):
        super().__init__(y, m, d)
        self.hh, self.mi, self.ss, self.us = hh, mi, ss, us

    @property
    def epoch_us(self) -> int:
        tod = ((self.hh * 3600 + self.mi * 60 + self.ss) * 1_000_000
               + self.us)
        return self.epoch_days * 86_400_000_000 + tod

    def __repr__(self):
        base = (f"{self.y:04d}-{self.m:02d}-{self.d:02d} "
                f"{self.hh:02d}:{self.mi:02d}:{self.ss:02d}")
        return base + (f".{self.us:06d}" if self.us else "")

    __str__ = __repr__

    def __eq__(self, other):
        return isinstance(other, CivilDateTime) and str(other) == str(self)

    def __hash__(self):
        return hash(("civildt", str(self)))


class ZeroDate:
    """Host-side value of '0000-00-00' (storable, distinct from NULL)."""

    def __repr__(self):
        return "0000-00-00"

    __str__ = __repr__

    def __eq__(self, other):
        return isinstance(other, ZeroDate)

    def __hash__(self):
        return hash("0000-00-00")


class ZeroDateTime:
    """Host-side value of '0000-00-00 HH:MM:SS[.ffffff]'."""

    def __init__(self, tod_us: int = 0):
        self.tod_us = int(tod_us)

    def __repr__(self):
        t = self.tod_us
        h, t = divmod(t, 3_600_000_000)
        m, t = divmod(t, 60_000_000)
        s, us = divmod(t, 1_000_000)
        base = f"0000-00-00 {h:02d}:{m:02d}:{s:02d}"
        return base + (f".{us:06d}" if us else "")

    __str__ = __repr__

    def __eq__(self, other):
        return isinstance(other, ZeroDateTime) and other.tod_us == self.tod_us

    def __hash__(self):
        return hash(("0000-00-00", self.tod_us))


def Decimal(precision: int, scale: int, nullable: bool = False) -> DataType:
    if precision > 65:
        raise NotImplementedError(
            "Decimal precision > 65 (beyond MySQL's maximum)"
        )
    return DataType(TypeKind.DECIMAL, nullable=nullable, precision=precision, scale=scale)


def Vector(dims: int, nullable: bool = False) -> DataType:
    """VECTOR Float32 with a fixed dimension count."""
    if dims <= 0:
        raise ValueError("vector dims must be positive")
    return DataType(TypeKind.VECTOR, nullable=nullable, precision=dims)


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Result type of arithmetic between two numeric types (TiDB subset)."""
    nullable = a.nullable or b.nullable
    if a.is_string or b.is_string:
        return DataType(TypeKind.FLOAT64, nullable)
    if a.is_float or b.is_float:
        return DataType(TypeKind.FLOAT64, nullable)
    if a.is_decimal or b.is_decimal:
        # add/sub keep the max scale; mul adjusts explicitly
        scale = max(a.scale, b.scale)
        cap = 38 if (a.is_wide_decimal or b.is_wide_decimal) else 18
        prec = min(cap, max(a.precision - a.scale, b.precision - b.scale) + scale + 1)
        return Decimal(prec, scale, nullable)
    unsigned = {TypeKind.UINT8, TypeKind.UINT32, TypeKind.UINT64}
    if a.kind in unsigned and b.kind in unsigned:
        return DataType(TypeKind.UINT64, nullable)
    return DataType(TypeKind.INT64, nullable)


def comparison_result_type(a: DataType, b: DataType) -> DataType:
    return DataType(TypeKind.BOOL, a.nullable or b.nullable)


__all__ = [
    "TypeKind", "DataType", "Decimal", "Vector",
    "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT32", "UINT64",
    "FLOAT32", "FLOAT64", "BOOL", "DATE", "DATETIME", "DURATION", "STRING",
    "common_numeric_type", "comparison_result_type", "DURATION_MAX_US",
    "ZERO_DATE_DAYS", "ZERO_DT_BASE_US", "PARTIAL_ZERO_BASE",
    "partial_zero_days", "partial_zero_civil", "is_partial_zero_days",
    "civil_to_days", "days_to_civil", "CivilDate", "CivilDateTime",
    "ZeroDate", "ZeroDateTime",
]
