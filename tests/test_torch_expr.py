"""Expression evaluation, decimal helpers and wide arithmetic: the PyTorch
port against the JAX package on the same inputs (tolerance zero).

Covers the known hard spots of the port: date and decimal literal
encoding against their operand, TiDB half-up division on int64 floor
division, three-valued logic, string predicates in dictionary-code space,
and the fused path's int32 tile arithmetic staying int32.
"""

import datetime
from decimal import Decimal as _D

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiflash_tpu.core import wide as JW
from tiflash_tpu.core.block import Block, column_from_numpy
from tiflash_tpu.core.dtypes import BOOL, DATE, INT64, STRING, Decimal
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.expr.compile import ExprEvaluator as JEval
from tiflash_tpu.expr.functions import _div_round_half_up as j_div
from tiflash_tpu.ops import stream_fuse as JSF

from tiflash_tpu_torch.core import wide as TW
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.expr.compile import ExprEvaluator as TEval
from tiflash_tpu_torch.expr.compile import _float_to_decimal, _literal_days
from tiflash_tpu_torch.expr.functions import _div_round_half_up as t_div
from tiflash_tpu_torch.ops import stream_fuse as TSF
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 300


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(5)
    blk = Block.from_dict({
        "i": column_from_numpy(rng.integers(-50, 50, N), INT64),
        "q": column_from_numpy(rng.integers(100, 5000, N), Decimal(15, 2)),
        "disc": column_from_numpy(rng.integers(0, 11, N), Decimal(15, 2, nullable=True),
                                  validity=rng.random(N) > 0.3),
        "day": column_from_numpy(rng.integers(8700, 10500, N), DATE),
        "s": column_from_numpy(rng.choice(["b", "d", "f"], N).tolist(), STRING),
        "s2": column_from_numpy(rng.choice(["a", "d", "z"], N).tolist(), STRING),
        "flag": column_from_numpy(rng.random(N) > 0.5, BOOL.with_nullable(),
                                  validity=rng.random(N) > 0.2),
    })
    return blk, blocks_from_numpy(export_blocks({"t": blk}), "cpu")["t"]


EXPRS = {
    "date_literal": lambda E: E.col("day") <= "1998-09-02",
    "date_literal_flipped": lambda E: E.Call("greater", (E.lit("1995-01-01"), E.col("day"))),
    "datetime_text_vs_date": lambda E: E.col("day") >= "1994-01-01 10:00:00",
    "float_vs_decimal": lambda E: E.col("disc") >= 0.05,
    "int_vs_decimal": lambda E: E.col("q") < 24,
    "float_vs_int": lambda E: E.col("i") < 24.5,
    "decimal_expr": lambda E: E.col("q") * (E.lit(1.0) - E.col("disc")),
    "decimal_chain": lambda E: E.col("q") * (E.lit(1.0) - E.col("disc")) * (E.lit(1.0) + E.col("disc")),
    "decimal_plus_int": lambda E: E.col("q") + 7,
    "int_arith": lambda E: E.col("i") * E.col("i") - 3,
    "float_arith": lambda E: E.col("i") - 2.5,
    "and_nulls": lambda E: (E.col("flag")) & (E.col("disc") >= 0.02),
    "or_nulls": lambda E: (E.col("flag")) | (E.col("disc") < 0.02),
    "not_nulls": lambda E: ~E.col("flag"),
    "string_member": lambda E: E.col("s") == "d",
    "string_nonmember": lambda E: E.col("s") < "c",
    "string_flipped": lambda E: E.Call("less_or_equals", (E.lit("e"), E.col("s"))),
    "string_in": lambda E: E.col("s").in_("b", "f", "zz"),
    "string_in_none": lambda E: E.col("s").in_("zz"),
    "null_literal": lambda E: E.col("i") + E.lit(None),
    "string_col_vs_col": lambda E: E.col("s") < E.col("s2"),
    "decimal_object_literal": lambda E: E.col("q") >= E.lit(_D("10.50")),
    "date_object_literal": lambda E: E.col("day") < E.lit(datetime.date(1995, 3, 15)),
}

LITERALS = [7, -3, True, 2.5, "abc", None, _D("-12.345"),
            datetime.date(1996, 2, 29), datetime.datetime(1996, 2, 29, 10, 30)]


@pytest.mark.parametrize("value", LITERALS, ids=repr)
def test_bare_literal_matches_reference(blocks, value):
    jb, tb = blocks
    j = JEval(jb).evaluate(JE.lit(value))
    t = TEval(tb).evaluate(TE.lit(value))
    assert repr(t.dtype) == repr(j.dtype)
    assert t.stats == j.stats and t.dictionary == j.dictionary
    assert t.to_pylist() == j.to_pylist()


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_evaluate_matches_reference(blocks, name):
    jb, tb = blocks
    j = JEval(jb).evaluate(EXPRS[name](JE))
    t = TEval(tb).evaluate(EXPRS[name](TE))
    assert repr(t.dtype) == repr(j.dtype)
    assert t.stats == j.stats
    assert t.to_pylist() == j.to_pylist()
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


def test_literal_encodings():
    assert _literal_days("1998-09-02") == 10471
    assert _literal_days("1970-01-01 23:59:59") == 0
    assert _float_to_decimal(0.05) == (5, 2)
    assert _float_to_decimal(1.0) == (10, 1)
    assert _float_to_decimal(24.0) == (240, 1)
    assert _float_to_decimal(1e-20) is None


def test_div_round_half_up_matches_reference():
    rng = np.random.default_rng(9)
    num = rng.integers(-(10 ** 15), 10 ** 15, 4000)
    num[:8] = [0, 5, -5, 15, -15, 25, -25, 1]
    den = rng.integers(1, 1000, 4000) * rng.choice([-1, 1], 4000)
    den[:8] = 10
    want = np.asarray(j_div(jnp.asarray(num), jnp.asarray(den)))
    got = t_div(torch.as_tensor(num), torch.as_tensor(den))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert t_div(torch.tensor([5, -5, 4, -4]), 10).tolist() == [1, -1, 0, 0]


def test_wide_helpers_match_reference():
    rng = np.random.default_rng(2)
    x = rng.integers(-(2 ** 62), 2 ** 62, 500)
    c = rng.integers(1, 10 ** 9, 500)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    jw, tw = JW.widen_i64(jx), TW.widen_i64(tx)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for k in (0, 7, 25, 31, 56):
        a, ao = JW.wide_mul_pow2(jw, k)
        b, bo = TW.wide_mul_pow2(tw, k)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(bo.numpy(), np.asarray(ao))
    for k in (0, 4, 9):
        np.testing.assert_array_equal(TW.wide_mul_pow10(tw, k)[0].numpy(),
                                      np.asarray(JW.wide_mul_pow10(jw, k)[0]))
    np.testing.assert_array_equal(TW.wide_neg(tw).numpy(), np.asarray(JW.wide_neg(jw)))
    np.testing.assert_array_equal(TW.wide_add(tw, TW.wide_neg(tw)).numpy(),
                                  np.asarray(JW.wide_add(jw, JW.wide_neg(jw))))
    np.testing.assert_array_equal(
        TW.wide_div_round_half_up(tw, torch.as_tensor(c)).numpy(),
        np.asarray(JW.wide_div_round_half_up(jw, jnp.asarray(c))))
    digits = [rng.integers(-(10 ** 15), 10 ** 15, 500) for _ in range(3)]
    a, ao = JW.renorm_digits([jnp.asarray(d) for d in digits], limbs=2)
    b, bo = TW.renorm_digits([torch.as_tensor(d) for d in digits], limbs=2)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(bo.numpy(), np.asarray(ao))
    assert TW.wide_to_host_ints(tw.numpy()) == [int(v) for v in x]


def test_fused_tile_arithmetic_stays_int32(blocks):
    """Part builders run on int32 tiles and must give the reference's
    int32 values (torch keeps int32 against Python scalars)."""
    jb, tb = blocks
    expr = lambda E: E.col("q") * (E.lit(1.0) - E.col("disc")) * (E.lit(1.0) + E.col("disc"))
    jt = JSF.compile_term(expr(JE), jb)
    tt = TSF.compile_term(expr(TE), tb)
    assert [(p.shift, p.sign, p.lo, p.hi, p.valid_cols) for p in tt.parts] == \
        [(p.shift, p.sign, p.lo, p.hi, p.valid_cols) for p in jt.parts]
    rng = np.random.default_rng(1)
    host = {"q": rng.integers(100, 5000, N).astype(np.int32),
            "disc": rng.integers(0, 11, N).astype(np.int32),
            "disc__v": (rng.random(N) > 0.3).astype(np.int32)}
    jtile = {k: jnp.asarray(v) for k, v in host.items()}
    ttile = {k: torch.as_tensor(v) for k, v in host.items()}
    for jp, tp in zip(jt.parts, tt.parts):
        want = np.asarray(JSF._part_value(jp, jtile, (N,)))
        got = TSF._part_value(tp, ttile, ttile["q"])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
