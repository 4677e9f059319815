"""The fuzzers' random plan trees and tables, drawn for the port with
numpy and ``tiflash_tpu_torch`` alone.

Two generators:

- the reference fuzzer's (``tests/test_fuzz_plans.py``), written here
  against the port's classes and drawing from the same
  ``np.random.Generator`` in the same order: ``reference_plan(seed)``
  (``_tables`` and ``_build_plan`` over ``default_rng(1000 + seed)``),
  ``reference_window(seed)`` (``5000 + seed``) and
  ``reference_grouping_sets(seed)`` (``7000 + seed``).  Each gives the
  port's form of the reference's tree and the reference's tables
  (``tests/test_torch_plan_oracle.py`` holds them equal);
- the port's fuzzer (``tests/test_torch_fuzz_plans.py``): ``build_plan``
  over a package namespace ``Ns``, so that one seed builds the same tree
  in either package, and ``port_plan(seed)`` with its tables
  (``port_tables``).

Each draw is a ``Draw``: the port's plan, its shape, the ``PyTable``s and
their schemas.  ``norm`` and ``judge`` compare an engine's rows with the
oracle's as the reference's fuzzer does; ``assert_same_rows`` holds two
engine runs to the float rule (exact, doubles within 1e-12 relative).

``chip_smoke.py`` loads this file by path, on a machine without jax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

from tiflash_tpu_torch.core import dtypes as TD
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.ops import sort as TS
from tiflash_tpu_torch.ops.window import WindowDesc
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.testing import oracle as O
from tiflash_tpu_torch.testing.plan_oracle import execute_plan_oracle


@dataclasses.dataclass
class Draw:
    plan: TP.PlanNode
    shape: str                        # agg, topn, limit, plain, window, grouping_sets
    tables: Dict[str, O.PyTable]
    schemas: Dict[str, Dict[str, TD.DataType]]


# ---- the reference fuzzer's draws (tests/test_fuzz_plans.py) ----------------

VAL_COL = "v"
SCHEMA = {
    "a": TD.INT64,
    "b": TD.INT32.with_nullable(True),
    "s": TD.STRING.with_nullable(True),
    "v": TD.INT64,
    "f": TD.FLOAT64.with_nullable(True),
    "d": TD.Decimal(10, 2, nullable=True),
}
R_SCHEMA = {"k": TD.INT64, "w": TD.INT64.with_nullable(True)}


def _ref_pred(rng):
    c = rng.choice(["lt", "ge", "eq_str", "null", "and"])
    if c == "lt":
        return TE.call("less", TE.col("a"), TE.lit(int(rng.integers(-40, 40))))
    if c == "ge":
        return TE.call("greater_or_equals", TE.col("v"),
                       TE.lit(int(rng.integers(-40, 40))))
    if c == "eq_str":
        return TE.call("not_equals", TE.col("s"), TE.lit("aa"))
    if c == "null":
        return TE.call("is_not_null", TE.col("b"))
    return TE.call("and", _ref_pred(rng), _ref_pred(rng))


def _ref_proj(rng):
    exprs = {n: TE.col(n) for n in SCHEMA}
    pick = rng.choice(["arith", "cond", "strfn", "cast_fi", "cast_if"])
    if pick == "arith":
        exprs["x"] = TE.call("plus", TE.call("multiply", TE.col("a"), TE.lit(3)),
                             TE.col("v"))
    elif pick == "cond":
        exprs["x"] = TE.call("if", TE.call("less", TE.col("a"), TE.lit(0)),
                             TE.col("v"), TE.call("negate", TE.col("v")))
    elif pick == "cast_fi":
        exprs["x"] = TE.cast(TE.col("f"), TD.INT64.with_nullable(True))
    elif pick == "cast_if":
        exprs["x"] = TE.cast(TE.col("a"), TD.FLOAT64)
    else:
        exprs["x"] = TE.call("length", TE.col("s"))
    return exprs


def _ref_aggs(rng, has_x):
    A = TA.AggDesc
    pool = [A("sum", VAL_COL, "sv"), A("count", None, "c"), A("min", "b", "mb"),
            A("max", VAL_COL, "mx"), A("avg", "f", "af"),
            A("count_distinct", "b", "cd"), A("bit_or", VAL_COL, "bo"),
            A("sum", "d", "sd"), A("min", "d", "md"), A("avg", "d", "ad")]
    if has_x:
        pool.append(A("sum", "x", "sx"))
    n = int(rng.integers(2, 5))
    idx = rng.choice(len(pool), size=n, replace=False)
    return [pool[i] for i in idx]


def _ref_build_plan(rng):
    node = TP.TableScan("t")
    has_x = False
    if rng.random() < 0.7:
        node = TP.Selection(_ref_pred(rng), node)
    if rng.random() < 0.5:
        node = TP.Projection(_ref_proj(rng), node)
        has_x = True
    joined = False
    if rng.random() < 0.5:
        kind = str(rng.choice(["inner", "left_outer", "semi", "anti",
                               "right_outer", "full_outer"]))
        node = TP.Join(kind=kind, probe_keys=["a"], build_keys=["k"],
                       probe=node, build=TP.TableScan("r"), output_capacity=4000)
        joined = kind in ("inner", "left_outer", "right_outer", "full_outer")
    shape = str(rng.choice(["agg", "topn", "limit", "plain"]))
    if shape == "agg":
        keys = [str(rng.choice(["s", "b"] if not joined else ["s", "b", "w"]))]
        node = TP.Aggregation(keys=keys, aggs=_ref_aggs(rng, has_x), child=node)
    elif shape == "topn":
        nf = [None, True, False][int(rng.integers(0, 3))]
        keys = [TS.SortKey(VAL_COL, desc=bool(rng.integers(0, 2)), nulls_first=nf),
                TS.SortKey("a", desc=bool(rng.integers(0, 2)))]
        node = TP.TopN(keys, int(rng.integers(1, 40)), node)
    elif shape == "limit":
        node = TP.Limit(int(rng.integers(1, 60)), node)
    return node, shape


def _ref_tables(rng):
    n = int(rng.integers(60, 220))
    t = O.random_pytable(rng, n, SCHEMA, int_range=(-50, 50),
                         str_pool=("aa", "bb", "cc", "", "dd"))
    r = O.random_pytable(rng, int(rng.integers(10, 60)), R_SCHEMA,
                         int_range=(-50, 50))
    return {"t": t, "r": r}


def _ref_window(rng, node):
    pool = [WindowDesc("row_number", "rn"),
            WindowDesc("rank", "rk"),
            WindowDesc("dense_rank", "dr"),
            WindowDesc("sum", "ws", arg=VAL_COL),
            WindowDesc("min", "wm", arg=VAL_COL,
                       frame=(int(rng.integers(0, 4)), int(rng.integers(0, 4)))),
            WindowDesc("lag", "lg", arg=VAL_COL, offset=1),
            WindowDesc("lead", "ld", arg=VAL_COL, offset=2, default=0)]
    n = int(rng.integers(2, 5))
    idx = rng.choice(len(pool), size=n, replace=False)
    part = [str(rng.choice(["s", "b"]))]
    if rng.random() < 0.35:
        order1 = [TS.SortKey(str(rng.choice([VAL_COL, "b"])),
                             desc=bool(rng.integers(0, 2)))]
        funcs = [WindowDesc("sum", "rs", arg=VAL_COL,
                            frame=(int(rng.integers(0, 6)), int(rng.integers(0, 6))),
                            frame_type="range"),
                 WindowDesc("rank", "rk")]
        return TP.Window(part, order1, funcs, node)
    order = [TS.SortKey(str(rng.choice([VAL_COL, "b"])), desc=bool(rng.integers(0, 2))),
             TS.SortKey("a", desc=False)]
    return TP.Window(part, order, [pool[i] for i in idx], node)


REF_SCHEMAS = {"t": SCHEMA, "r": R_SCHEMA}
REF_PLAN_SEEDS = range(60)
REF_WINDOW_SEEDS = range(16)
REF_GROUPING_SEEDS = range(10)


def reference_plan(seed: int) -> Draw:
    """``test_fuzz_plan_matches_oracle``'s tree and tables for ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    tables = _ref_tables(rng)
    plan, shape = _ref_build_plan(rng)
    return Draw(plan, shape, tables, REF_SCHEMAS)


def reference_window(seed: int) -> Draw:
    """``test_fuzz_window_matches_oracle``'s tree and tables for ``seed``."""
    rng = np.random.default_rng(5000 + seed)
    tables = _ref_tables(rng)
    node = TP.TableScan("t")
    if rng.random() < 0.5:
        node = TP.Selection(_ref_pred(rng), node)
    return Draw(_ref_window(rng, node), "window", tables, REF_SCHEMAS)


def reference_grouping_sets(seed: int) -> Draw:
    """``test_fuzz_grouping_sets_matches_oracle``'s tree and tables."""
    rng = np.random.default_rng(7000 + seed)
    tables = _ref_tables(rng)
    node = TP.TableScan("t")
    if rng.random() < 0.6:
        node = TP.Selection(_ref_pred(rng), node)
    sets = [["s", "b"], ["s"], []]
    if rng.random() < 0.5:
        sets = [["b"], []]
    node = TP.Expand(sets, node)
    keys = sorted({k for s in sets for k in s}) + ["groupingID"]
    plan = TP.Aggregation(keys=keys, aggs=[
        TA.AggDesc("sum", VAL_COL, "sv"), TA.AggDesc("count", None, "c")], child=node)
    return Draw(plan, "grouping_sets", tables, REF_SCHEMAS)


# ---- the port fuzzer's draws (tests/test_torch_fuzz_plans.py) ---------------

def _schema(D):
    return {
        "a": D.INT64,
        "b": D.INT32.with_nullable(True),
        "s": D.STRING.with_nullable(True),
        "v": D.INT64,
        "f": D.FLOAT64.with_nullable(True),
        "d": D.Decimal(10, 2, nullable=True),
        "dt": D.DATE.with_nullable(True),
    }


def _r_schema(D):
    return {"k": D.INT64, "w": D.INT64.with_nullable(True)}


class Ns:
    """One package's builders: expressions, plan nodes, AggDesc,
    SortKey and types."""

    def __init__(self, E, P, A, S, D):
        self.E, self.P, self.A, self.S, self.D = E, P, A, S, D


TNS = Ns(TE, TP, TA, TS, TD)


def _rand_pred(rng, N):
    E = N.E
    c = rng.choice(["lt", "ge", "eq_str", "null", "and", "year", "coalesce"])
    if c == "lt":
        return E.call("less", E.col("a"), E.lit(int(rng.integers(-40, 40))))
    if c == "ge":
        return E.call("greater_or_equals", E.col("v"),
                      E.lit(int(rng.integers(-40, 40))))
    if c == "eq_str":
        return E.call("not_equals", E.col("s"), E.lit("aa"))
    if c == "null":
        return E.call("is_not_null", E.col("b"))
    if c == "year":
        return E.call("greater", E.call("month", E.col("dt")),
                      E.lit(int(rng.integers(1, 12))))
    if c == "coalesce":
        return E.call("less", E.call("coalesce", E.col("b"), E.col("v")),
                      E.lit(int(rng.integers(-40, 40))))
    return E.call("and", _rand_pred(rng, N), _rand_pred(rng, N))


PROJECTIONS = ("arith", "cond", "cast_fi", "cast_if", "negate", "case",
               "coalesce", "date_part", "cast_dec", "date_add", "length")


def _rand_proj(rng, N):
    E, D = N.E, N.D
    exprs = {n: E.col(n) for n in _schema(D)}
    pick = rng.choice(PROJECTIONS)
    if pick == "arith":
        x = E.call("plus", E.call("multiply", E.col("a"), E.lit(3)), E.col("v"))
    elif pick == "cond":
        x = E.call("if", E.call("less", E.col("a"), E.lit(0)),
                   E.col("v"), E.call("negate", E.col("v")))
    elif pick == "cast_fi":
        x = E.cast(E.col("f"), D.INT64.with_nullable(True))
    elif pick == "cast_if":
        x = E.cast(E.col("a"), D.FLOAT64)
    elif pick == "negate":
        x = E.call("negate", E.col("d"))
    elif pick == "case":
        x = E.case_when((E.call("less", E.col("b"), E.lit(0)), E.col("v")),
                        (E.call("is_null", E.col("s")), E.lit(7)),
                        default=E.call("mod", E.col("a"), E.lit(5)))
    elif pick == "coalesce":
        x = E.call("coalesce", E.col("b"), E.col("a"))
    elif pick == "date_part":
        x = E.call("plus", E.call("year", E.col("dt")),
                   E.call("day_of_week", E.col("dt")))
    elif pick == "cast_dec":
        x = E.cast(E.col("d"), D.Decimal(12, 1, nullable=True))
    elif pick == "length":
        x = E.call("length", E.col("s"))
    else:
        x = E.call("datediff", E.call("date_add_months", E.col("dt"),
                                      E.col("a")), E.col("dt"))
    exprs["x"] = x
    return exprs


def _rand_aggs(rng, N, has_x):
    A = N.A.AggDesc
    pool = [A("sum", "v", "sv"), A("count", None, "c"), A("min", "b", "mb"),
            A("max", "v", "mx"), A("avg", "f", "af"),
            A("count_distinct", "b", "cd"), A("bit_or", "v", "bo"), A("sum", "d", "sd"),
            A("min", "d", "md"), A("avg", "d", "ad")]
    if has_x:
        pool.append(A("sum", "x", "sx"))
    idx = rng.choice(len(pool), size=int(rng.integers(2, 5)), replace=False)
    return [pool[i] for i in idx]


def build_plan(seed: int, N: Ns):
    """The same random tree for either package (one seed, one draw order)."""
    rng = np.random.default_rng(2000 + seed)
    P = N.P
    node = P.TableScan("t")
    has_x = False
    if rng.random() < 0.7:
        node = P.Selection(_rand_pred(rng, N), node)
    if rng.random() < 0.6:
        node = P.Projection(_rand_proj(rng, N), node)
        has_x = True
    joined = False
    if rng.random() < 0.5:
        kind = str(rng.choice(["inner", "left_outer", "semi", "anti",
                               "right_outer", "full_outer"]))
        node = P.Join(kind=kind, probe_keys=["a"], build_keys=["k"],
                      probe=node, build=P.TableScan("r"), output_capacity=4000)
        joined = kind in ("inner", "left_outer", "right_outer", "full_outer")
    shape = str(rng.choice(["agg", "topn", "limit", "plain"]))
    if shape == "agg":
        keys = [str(rng.choice(["s", "b"] if not joined else ["s", "b", "w"]))]
        node = P.Aggregation(keys=keys, aggs=_rand_aggs(rng, N, has_x),
                             child=node)
    elif shape == "topn":
        nf = [None, True, False][int(rng.integers(0, 3))]
        keys = [N.S.SortKey("v", desc=bool(rng.integers(0, 2)), nulls_first=nf),
                N.S.SortKey("a", desc=bool(rng.integers(0, 2)))]
        node = P.TopN(keys, int(rng.integers(1, 40)), node)
    elif shape == "limit":
        node = P.Limit(int(rng.integers(1, 60)), node)
    return node, shape


PORT_SEEDS = range(40)
PORT_SCHEMAS = {"t": _schema(TD), "r": _r_schema(TD)}


def port_tables(seed: int, random_pytable=O.random_pytable, D=TD) -> Dict[str, O.PyTable]:
    """The port fuzzer's tables for ``seed``, drawn by ``random_pytable``
    over package ``D``'s types (the port's by default)."""
    rng = np.random.default_rng(3000 + seed)
    t = random_pytable(rng, int(rng.integers(60, 220)), _schema(D),
                       int_range=(-50, 50), str_pool=("aa", "bb", "cc", "", "dd"))
    r = random_pytable(rng, int(rng.integers(10, 60)), _r_schema(D),
                       int_range=(-50, 50))
    return {"t": t, "r": r}


def port_plan(seed: int) -> Draw:
    plan, shape = build_plan(seed, TNS)
    return Draw(plan, shape, port_tables(seed), PORT_SCHEMAS)


GENERATORS = {
    "reference_plan": (reference_plan, REF_PLAN_SEEDS),
    "reference_window": (reference_window, REF_WINDOW_SEEDS),
    "reference_grouping_sets": (reference_grouping_sets, REF_GROUPING_SEEDS),
    "port_plan": (port_plan, PORT_SEEDS),
}


def all_draws():
    """(generator, seed, Draw) for every seed of every generator: 126 trees."""
    for gen, (fn, seeds) in GENERATORS.items():
        for seed in seeds:
            yield gen, seed, fn(seed)


# ---- the two kernels' query shapes over generated data ----------------------
#
# The fuzz tables carry no statistics (``pytable_to_block`` ->
# ``column_from_numpy`` sets none), so they reach neither kernel.  These
# tables are built as the catalog builds its own
# (``storage/catalog.py:column_from_arrays``: range statistics, int32
# shadows, sorted dictionaries), and the oracle reads the same values
# back from the CPU block.

FAMILY_ROWS = 200_000
FAMILY_SEEDS = range(5)


def family_catalog(columns: Dict[str, tuple]):
    """``{name: (data, DataType, validity, dictionary)}`` -> a catalog
    holding them as table ``t``."""
    from tiflash_tpu_torch.storage.catalog import Catalog, column_from_arrays

    cat = Catalog()
    cat.register("t", {n: column_from_arrays(*c) for n, c in columns.items()})
    return cat


def _day(days: int) -> str:
    return str(np.datetime64(days, "D"))


def family_a(seed: int, n: int = FAMILY_ROWS):
    """The fused stream kernel's shape: TPC-H Q1's on random data.  Two
    string keys of 2-8 values each (their product at most 40, 24 with
    NULLs), DECIMAL(15,2) quantity, price,
    discount and tax (quantity and discount nullable on odd seeds), a
    DATE range predicate, ``price * (1 - disc)`` and ``price * (1 -
    disc) * (1 + tax)``, Q1's eight aggregates, sorted by the keys.
    Returns (plan, catalog)."""
    rng = np.random.default_rng(9000 + seed)
    nulls = seed % 2 == 1
    # slots x limbs stays inside the fused kernel's accumulator
    # (``stream_fuse.MAX_PLANES`` = 240, the reference's too): Q1's fields
    # take 6 limbs, 10 with the NULL counts
    k1 = int(rng.integers(2, 9))
    k2 = int(rng.integers(2, 1 + min(8, (24 if nulls else 40) // k1)))
    dec = TD.Decimal(15, 2)
    ndec = TD.Decimal(15, 2, nullable=nulls)
    cols = {
        "rf": (rng.integers(0, k1, n).astype(np.int32), TD.STRING, None,
               tuple("ABCDEFGH"[:k1])),
        "ls": (rng.integers(0, k2, n).astype(np.int32), TD.STRING, None,
               tuple("NOPQRSTU"[:k2])),
        "qty": (rng.integers(1, 51, n) * 100, ndec,
                rng.random(n) > 0.1 if nulls else None, None),
        "price": (rng.integers(90_000, 10_500_000, n), dec, None, None),
        "disc": (rng.integers(0, 11, n), ndec,
                 rng.random(n) > 0.2 if nulls else None, None),
        "tax": (rng.integers(0, 9, n), dec, None, None),
        "ship": (rng.integers(8036, 10561, n).astype(np.int32), TD.DATE, None, None),
    }
    lo = int(rng.integers(8036, 9000))
    hi = lo + int(rng.integers(600, 1500))
    E, col, lit = TE, TE.col, TE.lit
    one_minus = E.call("minus", lit(1), col("disc"))
    disc_price = E.call("multiply", col("price"), one_minus)
    proj = TP.Projection({
        "rf": col("rf"), "ls": col("ls"), "qty": col("qty"), "price": col("price"),
        "disc": col("disc"), "disc_price": disc_price,
        "charge": E.call("multiply", disc_price, E.call("plus", lit(1), col("tax"))),
    }, TP.Selection(E.call("and", E.call("greater_or_equals", col("ship"), lit(_day(lo))),
                           E.call("less", col("ship"), lit(_day(hi)))),
                    TP.TableScan("t")))
    A = TA.AggDesc
    agg = TP.Aggregation(["rf", "ls"], [
        A("sum", "qty", "sum_qty"), A("sum", "price", "sum_base_price"),
        A("sum", "disc_price", "sum_disc_price"), A("sum", "charge", "sum_charge"),
        A("avg", "qty", "avg_qty"), A("avg", "price", "avg_price"),
        A("avg", "disc", "avg_disc"), A("count", None, "count_order")], proj)
    return TP.Sort([TS.SortKey("rf"), TS.SortKey("ls")], agg), family_catalog(cols)


def family_b(seed: int, n: int = FAMILY_ROWS):
    """The direct_agg kernel's shape, as Q7-pairs': GROUP BY one key of
    about 1,000 values behind a DATE range predicate keeping about a third
    of the rows, summing an INT64 and a DECIMAL(15,2) column (nullable on
    odd seeds) with their averages and counts.  The key is a dictionary
    string: a static key domain comes only from a dictionary or a BOOL
    (``ops/aggregate.py:key_domain_size``, the reference's too), and
    about 1,000 slots lie inside the kernel's 65-4096.  Returns (plan,
    catalog)."""
    rng = np.random.default_rng(9500 + seed)
    domain = int(rng.integers(900, 1100))
    nulls = seed % 2 == 1
    cols = {
        "g": (rng.integers(0, domain, n).astype(np.int32), TD.STRING, None,
              tuple(f"k{i:04d}" for i in range(domain))),
        "v": (rng.integers(-10 ** 12, 10 ** 12, n), TD.INT64, None, None),
        "amt": (rng.integers(0, 10 ** 9, n), TD.Decimal(15, 2, nullable=nulls),
                rng.random(n) > 0.15 if nulls else None, None),
        "day": (rng.integers(9000, 10500, n).astype(np.int32), TD.DATE, None, None),
    }
    lo = int(rng.integers(9000, 10000))
    E, col, lit = TE, TE.col, TE.lit
    sel = TP.Selection(E.call("and", E.call("greater_or_equals", col("day"), lit(_day(lo))),
                              E.call("less", col("day"), lit(_day(lo + 500)))),
                       TP.TableScan("t"))
    A = TA.AggDesc
    plan = TP.Aggregation(["g"], [
        A("sum", "v", "sum_v"), A("sum", "amt", "sum_amt"), A("avg", "amt", "avg_amt"),
        A("avg", "v", "avg_v"), A("count", "amt", "n_amt"), A("count", None, "n")], sel)
    return plan, family_catalog(cols)


FAMILIES = {"a_stream_tile": family_a, "b_direct_agg": family_b}
FAMILY_KERNEL = {"a_stream_tile": "stream_tile", "b_direct_agg": "direct_agg"}


# ---- the judge --------------------------------------------------------------

# spellings the engine resolves to the oracle's names (the function
# registry's aliases, ``tiflash_tpu_torch/expr/functions.py``) that the
# oracle's own alias table lacks, as the reference's does: the port
# fuzzer's CASE draws ``mod``
ENGINE_ALIASES = {"mod": "modulo"}


def oracle_plan(x):
    """Plan ``x`` (of either package's classes) with every function
    spelled as the oracle names it."""
    if isinstance(x, (list, tuple)):
        return type(x)(oracle_plan(v) for v in x)
    if isinstance(x, dict):
        return {k: oracle_plan(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        fields = {f.name: oracle_plan(getattr(x, f.name))
                  for f in dataclasses.fields(x) if f.init}
        if type(x).__name__ == "Call":
            fields["func"] = ENGINE_ALIASES.get(x.func, x.func)
        return type(x)(**fields)
    return x


def oracle_rows(d: Draw) -> O.PyTable:
    """The oracle's answer for draw ``d``."""
    return execute_plan_oracle(oracle_plan(d.plan), d.tables)


# ---- comparisons ------------------------------------------------------------

FLOAT_COLS = ("af", "f", "x", "sx", "ad")


def norm(table, float_cols=FLOAT_COLS):
    """The reference fuzzer's ``_norm``: rows over the sorted column names,
    the float columns and Decimal averages rounded to 6 places, sorted."""
    cols = sorted(table.keys())
    rows = []
    for i in range(len(table[cols[0]]) if cols else 0):
        row = []
        for c in cols:
            v = table[c][i]
            if c in float_cols and v is not None:
                v = round(float(v), 6)
            if hasattr(v, "as_tuple"):  # Decimal avg results
                v = round(float(v), 6)
            row.append((v is None, v if v is not None else 0))
        rows.append(tuple(row))
    return sorted(rows)


def n_rows(table) -> int:
    return len(next(iter(table.values()), []))


def judge(got: O.PyTable, want: O.PyTable, shape: str, what: str) -> str:
    """The engine's rows against the oracle's, as the reference's fuzzer
    judges them: a LIMIT keeps any subset of its rows, so by row count
    only; else ``norm``.  Where ``norm`` differs, the float columns are
    compared within ``assert_tables_equal``'s own 1e-9 instead (``norm``
    rounds to 6 places, and two float sums on either side of a rounding
    boundary round apart).  Returns how it judged: ``count``, ``norm`` or
    ``approx``; raises when the rows differ."""
    if shape == "limit":
        assert n_rows(got) == n_rows(want), (n_rows(got), n_rows(want), what)
        return "count"
    if norm(got) == norm(want):
        return "norm"
    floats = {c for c, vs in want.items()
              if c in FLOAT_COLS or any(isinstance(v, float) for v in vs)}
    O.assert_tables_equal(got, want, approx_cols=floats)
    return "approx"


def _rows(table):
    """Rows as tuples over the sorted column names, in an order that does
    not depend on the float columns' last bits."""
    cols = sorted(table)
    rows = [tuple(table[c][i] for c in cols)
            for i in range(len(table[cols[0]]) if cols else 0)]

    def key(row):
        return tuple((v is None, float(f"{v:.9g}") if isinstance(v, float)
                      else (0 if v is None else v)) for v in row)

    return sorted(rows, key=key)


def _same_value(a, b) -> bool:
    """Exact, but doubles within 1e-12 relative: two float sums may add in
    another order."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-300)
    return a == b


def assert_same_rows(got, want, what):
    """Two engine results (``to_pylists()`` or ``PyTable``s) hold the same
    rows in any order, under the float rule."""
    g, w = _rows(got), _rows(want)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want), what)
    assert len(g) == len(w), what
    for rg, rw in zip(g, w):
        assert all(_same_value(a, b) for a, b in zip(rg, rw)), (rg, rw, what)


__all__ = ["Draw", "reference_plan", "reference_window", "reference_grouping_sets",
           "port_plan", "port_tables", "build_plan", "Ns", "TNS", "GENERATORS",
           "all_draws", "oracle_plan", "oracle_rows", "norm", "judge", "assert_same_rows", "SCHEMA", "R_SCHEMA"]

