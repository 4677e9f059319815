"""Typed expression tree (ported verbatim from ``tiflash_tpu/expr/nodes.py``).

A plain typed AST; ``expr/compile.py`` evaluates it eagerly against a
Block of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from ..core.dtypes import DataType


class Expr:
    dtype: DataType

    # convenience builders so tests/plans read naturally
    def _bin(self, op: str, other: "Expr | Any") -> "Call":
        return Call(op, (self, lift(other)))

    def __add__(self, o):
        return self._bin("plus", o)

    def __sub__(self, o):
        return self._bin("minus", o)

    def __mul__(self, o):
        return self._bin("multiply", o)

    def __truediv__(self, o):
        return self._bin("divide", o)

    def __mod__(self, o):
        return self._bin("modulo", o)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("equals", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin("not_equals", o)

    def __lt__(self, o):
        return self._bin("less", o)

    def __le__(self, o):
        return self._bin("less_or_equals", o)

    def __gt__(self, o):
        return self._bin("greater", o)

    def __ge__(self, o):
        return self._bin("greater_or_equals", o)

    def __and__(self, o):
        return self._bin("and", o)

    def __or__(self, o):
        return self._bin("or", o)

    def __invert__(self):
        return Call("not", (self,))

    def is_null(self):
        return Call("is_null", (self,))

    def in_(self, *values):
        return Call("in", (self,) + tuple(lift(v) for v in values))

    def __hash__(self):
        return id(self)


@dataclasses.dataclass(eq=False)
class ColumnRef(Expr):
    """Reference to an input column by name; dtype resolved at bind time.

    ``qual`` carries a table/alias qualifier (``t1.a``) when the source
    text had one — the engine resolves by ``name`` alone; qualifiers
    matter only to front-ends joining aliased tables (reftest ON-joins).
    """

    name: str
    dtype: Optional[DataType] = None
    qual: Optional[str] = None

    def __repr__(self):
        return f"col({self.name})"


@dataclasses.dataclass(eq=False)
class Literal(Expr):
    value: Any
    dtype: Optional[DataType] = None  # inferred at bind time if None

    def __repr__(self):
        return f"lit({self.value!r})"


@dataclasses.dataclass(eq=False)
class Call(Expr):
    func: str
    args: Tuple[Expr, ...]
    dtype: Optional[DataType] = None  # inferred at bind time

    def __repr__(self):
        return f"{self.func}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(eq=False)
class Cast(Expr):
    """Explicit cast to a target type (``tidb_cast`` analog)."""

    arg: Expr
    target: DataType = None  # type: ignore[assignment]

    def __repr__(self):
        return f"cast({self.arg!r} as {self.target!r})"


def cast(arg, target: DataType) -> Cast:
    return Cast(lift(arg), target)


def col(name: str) -> ColumnRef:
    return ColumnRef(name)


def lit(value: Any, dtype: Optional[DataType] = None) -> Literal:
    return Literal(value, dtype)


def lift(x) -> Expr:
    return x if isinstance(x, Expr) else Literal(x)


def call(func: str, *args) -> Call:
    return Call(func, tuple(lift(a) for a in args))


def if_(cond, then, else_) -> Call:
    return Call("if", (lift(cond), lift(then), lift(else_)))


def case_when(*pairs, default=None) -> Call:
    """case_when((cond1, val1), (cond2, val2), ..., default=...)"""
    args = []
    for c, v in pairs:
        args.append(lift(c))
        args.append(lift(v))
    if default is not None:
        args.append(lift(default))
    return Call("case_when", tuple(args))


__all__ = [
    "Expr",
    "ColumnRef",
    "Literal",
    "Call",
    "Cast",
    "col",
    "lit",
    "lift",
    "call",
    "cast",
    "if_",
    "case_when",
]
