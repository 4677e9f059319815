"""Logical data types of the PyTorch port.

Counterpart of ``tiflash_tpu/core/dtypes.py``: every logical type maps to
one fixed-width physical dtype, nullability rides a separate validity
mask, strings are dictionary-encoded int32 codes.  Decimals with
precision <= 18 are int64 mantissas; wide decimals (precision > 18) are
typed wide and stored either as a 1-D int64 mantissa when statistics
prove it fits ("narrow-stored") or as ``(n, L)`` int64 limbs
(``core/wide.py``).

Changes from the reference: ``torch_dtype`` in place of ``jnp_dtype``;
the MySQL-specific type flags (time zone, ENUM, YEAR, JSON, BLOB) and
the civil-date helpers come with the functions slice of the port.
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


# MySQL's ZERO date ('0000-00-00') as stored days since the epoch: a
# sentinel far below any civil date the engine produces
ZERO_DATE_DAYS = -3_650_000


def Decimal(precision: int, scale: int, nullable: bool = False) -> DataType:
    if precision > 65:
        raise NotImplementedError(
            "Decimal precision > 65 (beyond MySQL's maximum)"
        )
    return DataType(TypeKind.DECIMAL, nullable=nullable, precision=precision, scale=scale)


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


__all__ = [
    "TypeKind", "DataType", "Decimal",
    "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT32", "UINT64",
    "FLOAT32", "FLOAT64", "BOOL", "DATE", "DATETIME", "DURATION", "STRING",
    "common_numeric_type", "ZERO_DATE_DAYS",
]
