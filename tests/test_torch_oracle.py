"""The port's judges (``tiflash_tpu_torch/testing/oracle.py``) against the
reference's (``tiflash_tpu/testing/oracle.py``), function by function.

Every input is python values made from a seed: ``random_pytable`` over
the reference fuzzer's schemas (``tests/test_fuzz_plans.py``) and the
port fuzzer's, the reference's draws of predicates, projections and
window frames, one case per join kind, NULL-first and NULL-last sorts.
Each port function gives the reference's result: the same column names
in the same order, the same row count, every value ``_py_eq`` to the
reference's and of the same type.  The port's ``random_pytable`` gives
equal tables from one seed and leaves the generator where the
reference's does.
"""

import datetime
from decimal import Decimal

import numpy as np
import pytest

import test_fuzz_plans as RF
import torch_plan_draw as DRAW
from test_torch_fuzz_analytic import to_port
from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.ops.window import WindowDesc as JWindowDesc
from tiflash_tpu.testing import oracle as RO

from tiflash_tpu_torch.core import dtypes as TD
from tiflash_tpu_torch.testing import oracle as PO


def same_table(got, want):
    """``got`` (the port's) equals ``want`` (the reference's), in order."""
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for i, (x, y) in enumerate(zip(got[name], want[name])):
            assert type(x).__name__ == type(y).__name__, (name, i, x, y)
            assert RO._py_eq(x, y), (name, i, x, y)


def _wide_schema(D):
    return {"i8": D.INT8, "u32": D.UINT32.with_nullable(True), "bo": D.BOOL,
            "dt": D.DATE.with_nullable(True), "ts": D.DATETIME, "f32": D.FLOAT32,
            "vec": D.Vector(3, nullable=True), "dec": D.Decimal(20, 4),
            "s": D.STRING.with_nullable(True)}


SCHEMAS = {
    "reference_t": (RF.SCHEMA, DRAW.SCHEMA, {"int_range": (-50, 50),
                                            "str_pool": ("aa", "bb", "cc", "", "dd")}),
    "reference_r": (RF.R_SCHEMA, DRAW.R_SCHEMA, {"int_range": (-50, 50)}),
    "port_t": (DRAW._schema(JD), DRAW._schema(TD), {}),
    "wide": (_wide_schema(JD), _wide_schema(TD), {"null_prob": 0.3}),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_random_pytable_same_draws(schema, seed):
    j_schema, t_schema, kw = SCHEMAS[schema]
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    n = int(np.random.default_rng(seed + 100).integers(20, 90))
    want = RO.random_pytable(rng_j, n, j_schema, **kw)
    got = PO.random_pytable(rng_t, n, t_schema, **kw)
    same_table(got, want)
    assert got == want
    assert rng_t.random() == rng_j.random()   # the same number of draws


def _tables(seed: int):
    return RF._tables(np.random.default_rng(1000 + seed))


JOIN_KINDS = ["inner", "left", "left_outer", "right", "right_outer", "full", "full_outer",
              "semi", "anti", "left_outer_semi", "left_outer_semi_null_aware"]


@pytest.mark.parametrize("kind", JOIN_KINDS)
def test_o_join_each_kind(kind):
    for seed in range(3):
        tables = _tables(seed)
        left, right = tables["t"], tables["r"]
        for lk, rk in ((["a"], ["k"]), (["b"], ["w"]), (["a", "b"], ["k", "w"])):
            want = RO.o_join(left, right, lk, rk, kind=kind)
            same_table(PO.o_join(left, right, lk, rk, kind=kind), want)
    # a build side whose keys collide with the probe's names takes the suffix
    t = {"a": [1, 2, None, 2], "x": [1, 2, 3, 4]}
    r = {"a": [2, 2, None, 5], "x": [7, 8, 9, 10]}
    same_table(PO.o_join(t, r, ["a"], ["a"], kind=kind, suffix="_b"),
               RO.o_join(t, r, ["a"], ["a"], kind=kind, suffix="_b"))


@pytest.mark.parametrize("build", ["with_null", "without_null", "empty"])
def test_o_anti_null_aware(build):
    tables = _tables(4)
    left, right = tables["t"], dict(tables["r"])
    if build == "without_null":
        keep = [i for i, w in enumerate(right["w"]) if w is not None]
        right = {k: [v[i] for i in keep] for k, v in right.items()}
    elif build == "empty":
        right = {k: [] for k in right}
    else:
        assert any(w is None for w in right["w"])
    for lk, rk in ((["b"], ["w"]), (["a"], ["k"]), (["a", "b"], ["k", "w"])):
        same_table(PO.o_anti_null_aware(left, right, lk, rk),
                   RO.o_anti_null_aware(left, right, lk, rk))


@pytest.mark.parametrize("nulls_first", [None, True, False])
@pytest.mark.parametrize("desc", [False, True])
def test_o_sort_null_order(desc, nulls_first):
    t = _tables(5)["t"]
    for keys in ([("b", desc, nulls_first)], [("s", desc, nulls_first), ("a", not desc)],
                 [("f", desc, nulls_first), ("d", desc)], [("v", desc)]):
        for limit in (None, 7):
            want = RO.o_sort(t, keys, limit=limit)
            same_table(PO.o_sort(t, keys, limit=limit), want)


def _window_cases():
    """The frames and functions ``_rand_window`` draws (ROWS min frames,
    RANGE sum frames over one key either way, the running sum, ranks,
    lag and lead with a default), and the rest ``o_window`` takes."""
    W = JWindowDesc
    order2 = [("v", False), ("a", False)]
    cases = {}
    for prec in range(4):
        for foll in range(0, 4, 3):
            cases[f"rows_min_{prec}_{foll}"] = (
                ["s"], order2, [W("min", "wm", arg="v", frame=(prec, foll))])
    for key, desc in (("v", False), ("v", True), ("b", False), ("b", True)):
        for prec, foll in ((0, 0), (2, 5), (5, 1)):
            cases[f"range_sum_{key}_{int(desc)}_{prec}_{foll}"] = (
                ["b"], [(key, desc)],
                [W("sum", "rs", arg="v", frame=(prec, foll), frame_type="range"),
                 W("rank", "rk")])
    cases["ranks_running"] = (["s"], [("b", True), ("a", False)], [
        W("row_number", "rn"), W("rank", "rk"), W("dense_rank", "dr"),
        W("sum", "ws", arg="v"), W("lag", "lg", arg="v", offset=1),
        W("lead", "ld", arg="v", offset=2, default=0)])
    cases["distribution"] = (["b"], [("s", False)], [
        W("percent_rank", "pr"), W("cume_dist", "cd"), W("ntile", "nt", offset=3),
        W("first_value", "fv", arg="d"), W("last_value", "lv", arg="d")])
    cases["nth_value"] = (["s"], order2, [
        W("nth_value", "n2", arg="f", offset=2),
        W("nth_value", "n3", arg="v", offset=3, frame=(1, None))])
    cases["running_aggs"] = (["s"], [("b", False)], [
        W("count", "c"), W("count", "cb", arg="b"), W("avg", "ad", arg="d"),
        W("min", "mf", arg="f"), W("max", "mx", arg="v"), W("avg", "af", arg="f")])
    cases["framed_aggs"] = ([], order2, [
        W("count", "c", frame=(None, 1)), W("avg", "ad", arg="d", frame=(2, None)),
        W("max", "mx", arg="b", frame=(1, 1)), W("sum", "sf", arg="f", frame=(3, 0))])
    cases["unordered"] = (["b"], [], [W("sum", "ws", arg="v"), W("row_number", "rn")])
    return cases


WINDOW_CASES = _window_cases()


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_o_window_frames(case):
    part, order, funcs = WINDOW_CASES[case]
    for seed in (6, 7):
        t = _tables(seed)["t"]
        want = RO.o_window(t, part, order, funcs)
        same_table(PO.o_window(t, part, order, to_port(funcs)), want)


AGG_CASES = {
    "counts": [("count", None, "c"), ("count", "b", "cb"), ("count_distinct", "s", "cd"),
               ("approx_count_distinct", "b", "ad")],
    "sums": [("sum", "v", "sv"), ("sum", "d", "sd"), ("sum", "f", "sf"),
             ("first", "s", "fs")],
    "min_max": [("min", "b", "mb"), ("max", "s", "xs"), ("min", "d", "md"),
                ("max", "f", "xf")],
    "avg": [("avg", "v", "av"), ("avg", "d", "ad"), ("avg", "f", "af")],
    "variance": [("var_pop", "v", "vp"), ("var_samp", "b", "vs"),
                 ("stddev_pop", "f", "sp"), ("stddev_samp", "d", "ss")],
    "bits": [("bit_and", "b", "ba"), ("bit_or", "v", "bo"), ("bit_xor", "a", "bx")],
    "group_concat": [("group_concat", "s", "g1", None, 3, "|"),
                     ("group_concat", "s", "g2", None, 0, ",", True)],
    "filtered": [("count", None, "c", "flag"), ("sum", "v", "sv", "flag"),
                 ("avg", "d", "ad", "flag")],
}


@pytest.mark.parametrize("keys", [[], ["s"], ["b", "s"]])
@pytest.mark.parametrize("aggs", sorted(AGG_CASES))
def test_o_aggregate(aggs, keys):
    t = dict(_tables(8)["t"])
    t["flag"] = [None if v is None else v > 0 for v in t["b"]]
    spec = AGG_CASES[aggs]
    same_table(PO.o_aggregate(t, keys, spec), RO.o_aggregate(t, keys, spec))
    empty = {k: [] for k in t}
    same_table(PO.o_aggregate(empty, keys, spec), RO.o_aggregate(empty, keys, spec))


def test_o_aggregate_wide_decimals_stay_exact():
    big = Decimal("9" * 60 + ".12345")
    t = {"k": [1, 1, 2], "x": [big, big, -big]}
    aggs = [("sum", "x", "s"), ("avg", "x", "a")]
    same_table(PO.o_aggregate(t, ["k"], aggs), RO.o_aggregate(t, ["k"], aggs))
    assert PO.o_aggregate(t, ["k"], aggs)["s"][0] == PO._CTX.add(big, big)


@pytest.mark.parametrize("seed", range(10))
def test_o_filter_o_project_eval_expr_table(seed):
    """The reference fuzzer's predicates and projections, drawn from one
    seed and mapped onto the port's expression classes."""
    rng = np.random.default_rng(11_000 + seed)
    t = _tables(seed)["t"]
    for _ in range(4):
        pred = RF._rand_pred(rng)
        same_table(PO.o_filter(t, to_port(pred)), RO.o_filter(t, pred))
        proj = RF._rand_proj(rng)
        same_table(PO.o_project(t, to_port(proj)), RO.o_project(t, proj))
        assert PO.eval_expr_table(to_port(pred), t) == RO.eval_expr_table(pred, t)


@pytest.mark.parametrize("sets", [[["s", "b"], ["s"], []], [["b"], []], [["a"]]])
def test_o_expand(sets):
    t = _tables(9)["t"]
    same_table(PO.o_expand(t, sets), RO.o_expand(t, sets))
    same_table(PO.o_expand(t, sets, "gid"), RO.o_expand(t, sets, "gid"))


def test_o_cross_join():
    tables = _tables(10)
    left = {k: v[:12] for k, v in tables["t"].items()}
    right = {**tables["r"], "a": list(range(len(tables["r"]["k"])))}
    same_table(PO.o_cross_join(left, right), RO.o_cross_join(left, right))
    same_table(PO.o_cross_join(left, right, suffix="_x"),
               RO.o_cross_join(left, right, suffix="_x"))
    none = {k: [] for k in right}
    same_table(PO.o_cross_join(left, none), RO.o_cross_join(left, none))


def test_sort_pytable_and_rev():
    t = _tables(11)["t"]
    t["dt"] = [datetime.date(1992, 1, 1) + datetime.timedelta(days=int(a) % 40)
               for a in t["a"]]
    same_table(PO.sort_pytable(t), RO.sort_pytable(t))
    vals = [3, 1, 2, 2, 5]
    assert (sorted(vals, key=PO._Rev) == sorted(vals, key=RO._Rev)
            == sorted(vals, reverse=True))
    assert PO._Rev(2) == PO._Rev(2) and not PO._Rev(2) < PO._Rev(3)


def test_assert_tables_equal_agrees():
    t = _tables(12)["t"]
    shuffled = {k: v[::-1] for k, v in t.items()}
    for fn in (PO.assert_tables_equal, RO.assert_tables_equal):
        fn(shuffled, t)
        fn(t, t, ordered=True)
        with pytest.raises(AssertionError):
            fn(shuffled, t, ordered=True)
        off = dict(t, v=[x + 1 for x in t["v"]])
        with pytest.raises(AssertionError):
            fn(off, t)
        nudged = dict(t, f=[None if x is None else x * (1 + 1e-10) for x in t["f"]])
        fn(nudged, t, approx_cols=("f",))
        with pytest.raises(AssertionError):
            fn(dict(t, f=[None if x is None else x + 0.5 for x in t["f"]]), t,
               approx_cols=("f",))


def test_the_judge_half_is_ported():
    """Every judge of the reference's oracle has its port, under the same
    name, and the decimal context is the reference's."""
    names = ["sort_pytable", "assert_tables_equal", "eval_expr_table", "o_filter",
             "o_project", "o_aggregate", "_o_aggregate_inner", "o_join", "o_sort",
             "o_expand", "o_cross_join", "o_anti_null_aware", "o_window", "_Rev",
             "random_pytable", "_py_eq"]
    for n in names:
        assert callable(getattr(PO, n)) and callable(getattr(RO, n)), n
    assert (PO._CTX.prec, PO._CTX.rounding) == (RO._CTX.prec, RO._CTX.rounding) \
        == (90, "ROUND_HALF_UP")
    assert set(RO.__all__) <= set(PO.__all__)


def test_package_root_exports_the_reference_types():
    """``tiflash_tpu_torch`` re-exports the logical types at its root, as
    ``tiflash_tpu/__init__.py`` does."""
    import tiflash_tpu
    import tiflash_tpu_torch

    names = ["DataType", "Decimal", "TypeKind", "BOOL", "DATE", "DATETIME", "FLOAT32",
             "FLOAT64", "INT8", "INT16", "INT32", "INT64", "STRING", "UINT8", "UINT32",
             "UINT64", "Block", "Column", "column_from_numpy"]
    from tiflash_tpu_torch.core import block as TB

    for n in names:
        assert hasattr(tiflash_tpu, n), n
        assert getattr(tiflash_tpu_torch, n) is getattr(TD if hasattr(TD, n) else TB, n), n
    for n in names[3:16]:
        assert repr(getattr(tiflash_tpu_torch, n)) == repr(getattr(tiflash_tpu, n)), n
    assert repr(tiflash_tpu_torch.Decimal(12, 3, nullable=True)) == \
        repr(tiflash_tpu.Decimal(12, 3, nullable=True))


def test_judge_takes_the_float_tolerance_only_where_norm_rounds_apart():
    """``judge`` compares as the reference's fuzzer (``_norm``: floats to 6
    places); two float sums on either side of a rounding boundary fall
    back to ``assert_tables_equal``'s 1e-9, and a real difference still
    raises."""
    want = {"k": [1, 2], "af": [0.12345649999999999, 2.5], "sv": [3, 4]}
    same = {"k": [2, 1], "af": [2.5, 0.12345649999999999], "sv": [4, 3]}
    assert DRAW.judge(same, want, "agg", "same") == "norm"
    apart = dict(want, af=[0.1234565000000001, 2.5])
    assert DRAW.norm(apart) != DRAW.norm(want)
    assert DRAW.judge(apart, want, "agg", "apart") == "approx"
    with pytest.raises(AssertionError):
        DRAW.judge(dict(want, af=[0.1234566, 2.5]), want, "agg", "off")
    with pytest.raises(AssertionError):
        DRAW.judge(dict(want, sv=[3, 5]), want, "agg", "off")
    assert DRAW.judge({"k": [9, 9]}, {"k": [1, 2]}, "limit", "limit") == "count"
    with pytest.raises(AssertionError):
        DRAW.judge({"k": [9]}, {"k": [1, 2]}, "limit", "limit")
