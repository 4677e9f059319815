"""The fused aggregation's cases, as tables made with numpy from a seed
and plans built for either package.

The shapes of the fusing cases of ``tests/test_torch_stream_fuse.py`` (a
Q1-like group-by with and without NULLs, two keys with an IN filter, a
string compare against a literal outside the dictionary, a literal
outside the int31 range, an empty selection, a keyless Q6-like sum, a
column wider than 2^31), plus a table whose ``sel`` is set, a key
domain whose layout takes the kernel's shared-memory regime and a bare
``count(*)`` (a program that reads no array).  Each case
is ``(table spec, plan builder)`` at any row count: ``columns(n, seed)``
gives ``{name: (values, DataType, validity)}`` and ``sel``, which
``numpy_tables`` turns into ``blocks_from_numpy``'s input (dictionary
codes and min/max stats of the valid rows, as the reference's
``column_from_numpy`` makes them).  A plan builder takes a namespace with
the package's ``E`` (expression nodes), ``P`` (plan nodes) and
``AggDesc``, so a test can build the same plan in both packages.

Used by ``tests/test_torch_tile_program.py``,
``tests/test_torch_tile_codegen.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.dtypes import DATE, DataType, Decimal, STRING
from ..expr import nodes as _E
from ..ops.aggregate import AggDesc as _AggDesc
from ..plan import nodes as _P

# the port's namespace for the plan builders
TORCH = types.SimpleNamespace(E=_E, P=_P, AggDesc=_AggDesc)

Spec = Tuple[Dict[str, tuple], Optional[np.ndarray]]


def _mktable(n: int, seed: int, nulls: bool = False, sel: bool = False,
             wide_grp: int = 0) -> Spec:
    rng = np.random.default_rng(seed)
    groups = (["aa", "bb", "cc", "dd"] if not wide_grp
              else [f"g{i:02d}" for i in range(wide_grp)])
    grp = np.asarray(groups)[rng.integers(0, len(groups), n)]
    qty = rng.integers(1, 51, size=n) * 100          # Decimal(15,2)
    price = rng.integers(90_000, 10_500_000, size=n)  # Decimal(15,2)
    disc = rng.integers(0, 11, size=n)                # Decimal(15,2) 0.00-0.10
    day = rng.integers(9000, 11000, size=n)           # DATE days
    flag = np.asarray(["X", "Y"])[rng.integers(0, 2, n)]
    vd = rng.random(n) > 0.3 if nulls else None
    vq = rng.random(n) > 0.2 if nulls else None
    cols = {
        "grp": (grp, STRING, None),
        "qty": (qty, Decimal(15, 2, nullable=nulls), vq),
        "price": (price, Decimal(15, 2), None),
        "disc": (disc, Decimal(15, 2, nullable=nulls), vd),
        "day": (day, DATE, None),
        "flag": (flag, STRING, None),
    }
    return cols, (rng.random(n) > 0.3 if sel else None)


def _wide_table(n: int, seed: int) -> Spec:
    rng = np.random.default_rng(seed)
    big = rng.integers(1 << 47, 1 << 48, size=n)
    grp = np.asarray(["aa", "bb", "cc"])[rng.integers(0, 3, n)]
    return {"grp": (grp, STRING, None), "big": (big, Decimal(17, 2), None)}, None


def q1_like(m, keys=("grp",)):
    E, P = m.E, m.P
    disc_price = E.Call("multiply", (
        E.ColumnRef("price"),
        E.Call("minus", (E.Literal(1), E.ColumnRef("disc"))),
    ))
    proj = P.Projection(
        exprs={
            "grp": E.ColumnRef("grp"),
            "qty": E.ColumnRef("qty"),
            "price": E.ColumnRef("price"),
            "disc": E.ColumnRef("disc"),
            "dp": disc_price,
        },
        child=P.Selection(
            cond=E.Call("less_or_equals", (E.ColumnRef("day"),
                                           E.Literal("1998-09-20"))),
            child=P.TableScan("t"),
        ),
    )
    return P.Aggregation(
        keys=list(keys),
        aggs=[
            m.AggDesc("sum", "qty", "sum_qty"),
            m.AggDesc("sum", "dp", "sum_dp"),
            m.AggDesc("avg", "price", "avg_price"),
            m.AggDesc("avg", "disc", "avg_disc"),
            m.AggDesc("count", "disc", "cnt_disc"),
            m.AggDesc("count", None, "cnt"),
        ],
        child=proj,
    )


def _agg_over(m, keys, aggs, cond):
    E, P = m.E, m.P
    child = P.TableScan("t")
    if cond is not None:
        child = P.Selection(cond=cond(E), child=child)
    return P.Aggregation(keys=keys, aggs=[m.AggDesc(*a) for a in aggs], child=child)


def two_keys_in_filter(m):
    return _agg_over(
        m, ["grp", "flag"], [("sum", "price", "s"), ("count", None, "c")],
        lambda E: E.Call("and", (
            E.Call("in", (E.ColumnRef("grp"), E.Literal("aa"),
                          E.Literal("cc"), E.Literal("zz"))),
            E.Call("greater", (E.ColumnRef("qty"), E.Literal(10))),
        )))


def string_nonmember(m):
    return _agg_over(
        m, ["flag"], [("count", None, "c")],
        lambda E: E.Call("greater_or_equals", (E.ColumnRef("grp"), E.Literal("bz"))))


def static_out_of_range(m):
    return _agg_over(
        m, ["grp"], [("sum", "qty", "s")],
        lambda E: E.Call("less", (E.ColumnRef("price"), E.Literal(10 ** 13))))


def empty_selection(m):
    return _agg_over(
        m, ["grp"], [("sum", "qty", "s"), ("count", None, "c")],
        lambda E: E.Call("greater", (E.ColumnRef("qty"), E.Literal(10 ** 9))))


def keyless_q6_like(m):
    E, P = m.E, m.P
    revenue = E.Call("multiply", (E.ColumnRef("price"), E.ColumnRef("disc")))
    return P.Aggregation(
        keys=[],
        aggs=[m.AggDesc("sum", "rev", "revenue"), m.AggDesc("count", None, "c")],
        child=P.Projection(
            exprs={"rev": revenue},
            child=P.Selection(
                cond=E.Call("and", (
                    E.Call("greater_or_equals", (E.ColumnRef("disc"), E.Literal(0.02))),
                    E.Call("less", (E.ColumnRef("qty"), E.Literal(30))),
                )),
                child=P.TableScan("t"),
            ),
        ),
    )


def wide_sum(m):
    return _agg_over(m, ["grp"], [("sum", "big", "s"), ("avg", "big", "a"),
                                  ("count", None, "n")], None)


def count_star(m):
    """A bare ``count(*)``: the program reads no array."""
    return _agg_over(m, [], [("count", None, "c")], None)


@dataclasses.dataclass(frozen=True)
class FuseCase:
    name: str
    columns: Callable[[int, int], Spec]   # (n, seed) -> spec
    plan: Callable                        # package namespace -> plan
    seed: int
    n: int                                # rows in the CPU tests


CASES: List[FuseCase] = [
    FuseCase("q1_like", lambda n, s: _mktable(n, s), q1_like, 0, 1000),
    FuseCase("q1_like_nulls", lambda n, s: _mktable(n, s, nulls=True), q1_like, 3, 1000),
    FuseCase("two_keys_in_filter", lambda n, s: _mktable(n, s), two_keys_in_filter, 5, 1000),
    FuseCase("string_nonmember", lambda n, s: _mktable(n, s), string_nonmember, 6, 1000),
    FuseCase("static_out_of_range", lambda n, s: _mktable(n, s), static_out_of_range, 7, 1000),
    FuseCase("empty_selection", lambda n, s: _mktable(n, s), empty_selection, 8, 1000),
    FuseCase("keyless_q6_like", lambda n, s: _mktable(n, s), keyless_q6_like, 9, 1000),
    FuseCase("flush_chunking", lambda n, s: _mktable(n, s), q1_like, 12, 5 * 8192 - 7),
    FuseCase("wide_column", _wide_table, wide_sum, 4, 1 << 12),
    FuseCase("sel", lambda n, s: _mktable(n, s, nulls=True, sel=True), q1_like, 13, 1000),
    FuseCase("shared_layout", lambda n, s: _mktable(n, s, wide_grp=40), q1_like, 14, 2000),
    FuseCase("count_star", lambda n, s: _mktable(n, s), count_star, 15, 1000),
]


def case(name: str) -> FuseCase:
    return next(c for c in CASES if c.name == name)


def _column(values, dt: DataType, validity) -> dict:
    desc = {"kind": dt.kind.name, "precision": dt.precision, "scale": dt.scale,
            "nullable": dt.nullable}
    valid = None if validity is None else np.asarray(validity, dtype=bool)
    if dt.is_string:
        dictionary, codes = np.unique(np.asarray(values, dtype=str), return_inverse=True)
        return {"data": codes.astype(np.int32), "validity": valid, "dtype": desc,
                "dictionary": tuple(str(s) for s in dictionary), "stats": None,
                "domain": None, "ndv": None}
    data = np.asarray(values, dtype=dt.physical)
    live = data if valid is None else data[valid]
    stats = (int(live.min()), int(live.max())) if live.size else None
    return {"data": data, "validity": valid, "dtype": desc, "dictionary": None,
            "stats": stats, "domain": None, "ndv": None}


def numpy_tables(spec: Spec) -> Dict[str, dict]:
    """``{"t": ...}`` in ``storage.catalog.blocks_from_numpy``'s format."""
    cols, sel = spec
    return {"t": {"names": tuple(cols), "columns": [_column(*c) for c in cols.values()],
                  "sel": sel, "clustered_by": ()}}


__all__ = ["CASES", "FuseCase", "case", "numpy_tables", "q1_like", "TORCH"]
