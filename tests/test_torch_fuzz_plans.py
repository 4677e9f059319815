"""Differential plan fuzzing: the port's ``run_query`` against the JAX
package's on seeded random plan trees over random tables with NULLs.

The vocabulary is the reference fuzzer's (``tests/test_fuzz_plans.py``):
Selection, Projection, Join (every kind the reference's fuzzer draws,
right and full outer since the analytic slice), Aggregation (with
``bit_or`` since that slice), TopN and Limit over the same schema, plus
the functions slice's
scalar functions: ``if``, ``negate``, ``case_when``, ``coalesce``, casts
and date parts over a DATE column.  Every tree builds
once for each package from one seed.  Results compare as sorted rows:
exact, but doubles within 1e-12 relative (the float sums of the two
packages may add in another order).  A LIMIT keeps any subset
of its rows, so LIMIT plans run without the plan rewrites (which may
move a LIMIT, ``tiflash_tpu/plan/rewrite.py:238``) against the
reference's ``compile_fragment`` and compare their row counts only.
"""

import math

import numpy as np
import pytest

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.ops import aggregate as JA
from tiflash_tpu.ops import sort as JS
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.compiler import compile_fragment as j_compile
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.testing import oracle as O

from tiflash_tpu_torch.core import dtypes as TD
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.ops import sort as TS
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks


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


JNS = Ns(JE, JP, JA, JS, JD)
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


def _tables(seed: int):
    rng = np.random.default_rng(3000 + seed)
    t = O.random_pytable(rng, int(rng.integers(60, 220)), _schema(JD),
                         int_range=(-50, 50),
                         str_pool=("aa", "bb", "cc", "", "dd"))
    r = O.random_pytable(rng, int(rng.integers(10, 60)), _r_schema(JD),
                         int_range=(-50, 50))
    j_blocks = {"t": O.pytable_to_block(t, _schema(JD)),
                "r": O.pytable_to_block(r, _r_schema(JD))}
    return j_blocks, blocks_from_numpy(export_blocks(j_blocks), "cpu")


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
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w), what
    for rg, rw in zip(g, w):
        assert all(_same_value(a, b) for a, b in zip(rg, rw)), (rg, rw, what)


SEEDS = range(40)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_plan_matches_reference(seed):
    j_blocks, t_blocks = _tables(seed)
    j_plan, shape = build_plan(seed, JNS)
    t_plan, t_shape = build_plan(seed, TNS)
    assert t_shape == shape and t_plan.pretty() == j_plan.pretty()
    if shape == "limit":
        want, _ = j_compile(j_plan)(j_blocks)
        got, _ = t_run(t_plan, t_blocks, plan_rewrites=False)
        assert int(got.num_rows()) == int(want.num_rows()), j_plan.pretty()
        return
    want, _ = j_run(j_plan, j_blocks)
    got, _ = t_run(t_plan, t_blocks)
    assert [repr(c.dtype) for c in got.columns] == \
        [repr(c.dtype) for c in want.columns], j_plan.pretty()
    assert_same_rows(got.to_pylists(), want.to_pylists(), j_plan.pretty())


def test_fuzz_vocabulary_reaches_every_projection_and_shape():
    """The seeds above draw every projection of the slice and every plan
    shape at least once."""
    shapes, picks = set(), set()
    for seed in SEEDS:
        plan, shape = build_plan(seed, TNS)
        shapes.add(shape)
        node = plan
        while True:
            if isinstance(node, TP.Projection):
                picks.add(repr(node.exprs["x"]).split("(")[0])
            if not node.children:
                break
            node = node.children[0]
    assert shapes == {"agg", "topn", "limit", "plain"}
    assert {"if", "negate", "case_when", "coalesce", "cast", "plus",
            "datediff", "length"} <= picks, picks
