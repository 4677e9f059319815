"""Plan IR: the node kinds TPC-H's 22 queries run.

Counterpart of ``tiflash_tpu/plan/nodes.py``: TableScan, Selection,
AddColumns, Projection, Aggregation, Join, CrossJoin, TopN, Sort, Limit,
WithCTE and CTERef, with the same fields, ``children`` and ``pretty()``.
Runtime filters, windows, unions and exchanges come with later slices of
the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from ..expr.nodes import Expr
from ..ops.aggregate import AggDesc
from ..ops.sort import SortKey


class PlanNode:
    children: Tuple["PlanNode", ...] = ()

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        head = f"{pad}{self.describe()}"
        return "\n".join([head] + [c.pretty(indent + 1) for c in self.children])

    def describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class TableScan(PlanNode):
    """Leaf: reads a table from the catalog."""

    table: str
    columns: Optional[Sequence[str]] = None
    children: Tuple[PlanNode, ...] = ()

    def describe(self):
        cols = "*" if self.columns is None else ",".join(self.columns)
        return f"TableScan({self.table}: {cols})"


@dataclasses.dataclass
class Selection(PlanNode):
    """Filter — stays lazy as a selection mask."""

    cond: Expr
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        return f"Selection({self.cond})"


@dataclasses.dataclass
class Projection(PlanNode):
    """Column computation / renaming."""

    exprs: Dict[str, Expr]
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        return f"Projection({', '.join(self.exprs)})"


@dataclasses.dataclass
class Aggregation(PlanNode):
    """Aggregation.  ``num_slots`` caps group capacity for the sort method
    (bounded-output contract); ``mode`` is the distributed tag."""

    keys: Sequence[str]
    aggs: Sequence[AggDesc]
    child: PlanNode = None  # type: ignore[assignment]
    num_slots: Optional[int] = None
    mode: Optional[str] = None

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        a = ", ".join(f"{x.func}({x.arg or '*'})->{x.name}" for x in self.aggs)
        m = f" [{self.mode}]" if self.mode else ""
        return f"Aggregation(keys={list(self.keys)}; {a}){m}"


@dataclasses.dataclass
class Join(PlanNode):
    """Hash join.  children = (probe, build).  ``unique_build`` selects
    the 1:N fast path; ``output_capacity`` sizes the N:M expansion.
    ``rf_id`` (a runtime filter published by the build side) and
    ``build_payload`` (the build columns to emit; None = all) are the
    reference's fields."""

    kind: str
    probe_keys: Sequence[str]
    build_keys: Sequence[str]
    probe: PlanNode = None  # type: ignore[assignment]
    build: PlanNode = None  # type: ignore[assignment]
    unique_build: bool = False
    output_capacity: Optional[int] = None
    rf_id: Optional[str] = None
    build_payload: Optional[Sequence[str]] = None

    def __post_init__(self):
        self.children = (self.probe, self.build)

    def describe(self):
        return (
            f"Join({self.kind}; probe={list(self.probe_keys)} "
            f"build={list(self.build_keys)}"
            + (" unique" if self.unique_build else "")
            + ")"
        )


@dataclasses.dataclass
class TopN(PlanNode):
    """ORDER BY ... LIMIT: the first ``limit`` rows in sort order."""

    sort_keys: Sequence[SortKey]
    limit: int
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        ks = ", ".join(f"{k.name}{' desc' if k.desc else ''}" for k in self.sort_keys)
        return f"TopN({ks}; limit={self.limit})"


@dataclasses.dataclass
class Sort(PlanNode):
    sort_keys: Sequence[SortKey]
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        ks = ", ".join(f"{k.name}{' desc' if k.desc else ''}" for k in self.sort_keys)
        return f"Sort({ks})"


@dataclasses.dataclass
class Limit(PlanNode):
    limit: int
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        return f"Limit({self.limit})"


@dataclasses.dataclass
class AddColumns(PlanNode):
    """Append computed columns, keeping every existing column."""

    exprs: Dict[str, Expr]
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        return f"AddColumns({', '.join(self.exprs)})"


@dataclasses.dataclass
class CrossJoin(PlanNode):
    """Cartesian product; ``output_capacity`` sizes its expansion."""

    probe: PlanNode = None  # type: ignore[assignment]
    build: PlanNode = None  # type: ignore[assignment]
    output_capacity: Optional[int] = None

    def __post_init__(self):
        self.children = (self.probe, self.build)

    def describe(self):
        return "CrossJoin"


@dataclasses.dataclass
class WithCTE(PlanNode):
    """CTE definitions, each run once, before ``child``, and shared by
    every CTERef of that name below it."""

    defs: Dict[str, PlanNode]
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = tuple(self.defs.values()) + (self.child,)

    def describe(self):
        return f"WithCTE({list(self.defs)})"


@dataclasses.dataclass
class CTERef(PlanNode):
    """Consumer of a named CTE (leaf)."""

    name: str
    children: Tuple[PlanNode, ...] = ()

    def describe(self):
        return f"CTERef({self.name})"


__all__ = ["PlanNode", "TableScan", "Selection", "Projection", "Aggregation",
           "Join", "CrossJoin", "TopN", "Sort", "Limit", "AddColumns",
           "WithCTE", "CTERef"]
