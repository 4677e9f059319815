"""The k-ary cross-domain LUTs (lpad/rpad/elt/concat_ws with column
arguments) and the integer value-domain LUTs of the port against the JAX
package, on the inputs of ``tests/test_cross_lut.py``: tolerance zero,
dictionaries compared as tuples, and the runtime-error masks (a NULL
JSON_OBJECT key) equal."""

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as JD
from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
from tiflash_tpu.expr import compile as JC
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.testing import oracle as O

from test_torch_strings import assert_same_column, assert_same_errors
from tiflash_tpu_torch.expr import compile as TC
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

SCHEMA = {
    "n": JD.INT64.with_nullable(True),
    "s": JD.STRING.with_nullable(True),
    "p": JD.STRING.with_nullable(True),
}


def _both(jb):
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    table = O.random_pytable(
        rng, 200, SCHEMA, int_range=(-3, 9),
        str_pool=("ab", "", "xyz", "杭州", "0", "12", "-4", "é"))
    return _both(O.pytable_to_block(table, SCHEMA))


def check(make, blocks):
    jb, tb = blocks
    jev, tev = JC.ExprEvaluator(jb), TC.ExprEvaluator(tb)
    assert_same_column(jev.evaluate(make(JE)), tev.evaluate(make(TE)))
    assert_same_errors(jev.runtime_errors, tev.runtime_errors)


CASES = {
    "lpad_cols": lambda E: E.call("lpad", E.col("s"), E.col("n"), E.col("p")),
    "rpad_cols": lambda E: E.call("rpad", E.col("s"), E.col("n"), E.col("p")),
    "lpad_lit_len": lambda E: E.call("lpad", E.col("s"), 5, E.col("p")),
    "rpad_empty_pad": lambda E: E.call("rpad", E.col("s"), E.col("n"), ""),
    "elt_columns": lambda E: E.call("elt", E.col("n"), E.col("s"), E.col("p"), "zz"),
    "concat_ws_col_sep": lambda E: E.call("concat_ws", E.col("p"), E.col("s"), "L"),
    "concat_ws_two_cols": lambda E: E.call("concat_ws", "-", E.col("s"),
                                           E.col("p"), "t"),
    "substring_index_cols": lambda E: E.call("substring_index", E.col("s"),
                                             E.col("p"), E.col("n")),
    "get_format_col": lambda E: E.call("get_format", "DATE", E.col("p")),
    "json_object_cols": lambda E: E.call("json_object", E.col("p"), E.col("n")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_lut_functions(case, data):
    check(CASES[case], data)


@pytest.mark.parametrize("c", ["h", "i"])
def test_unhex_string_and_int(c):
    table = {"h": ["61626364", "GG", None, "E38195E38289", "7", ""],
             "i": [3039, -1, 61626364, None, 313233, 0]}
    schema = {"h": JD.STRING.with_nullable(True), "i": JD.INT64.with_nullable(True)}
    check(lambda E: E.call("unhex", E.col(c)),
          _both(O.pytable_to_block(table, schema)))


@pytest.mark.parametrize("fname", ["bin", "hex", "oct"])
def test_int_value_domain_lut(fname):
    """bin/hex/oct over a low-NDV column whose [min, max] span is ~2^63:
    the value-domain LUT (a searchsorted on the card)."""
    vals = [0, 1, -1, 2 ** 62, -(2 ** 62), 44, None, 2 ** 62]
    blocks = _both(O.pytable_to_block({"v": vals}, {"v": JD.INT64.with_nullable(True)}))
    assert blocks[1]["v"].domain is not None
    check(lambda E: E.call(fname, E.col("v")), blocks)


@pytest.mark.parametrize("fname", ["bin", "hex"])
def test_uint64_value_domain_lut(fname):
    """A BIGINT UNSIGNED domain above 2^63 searches on order-preserving
    int64 keys."""
    vals = np.array([0, 1, 2 ** 64 - 1, 2 ** 63, 5, 2 ** 63 + 7], dtype=np.uint64)
    jb = JBlock.from_dict({"u": column_from_numpy(vals, JD.UINT64)})
    check(lambda E: E.call(fname, E.col("u")), _both(jb))


def test_cross_lut_cap_enforced():
    """Two 400-value domains crossed with bin's would need a 16M-entry
    LUT: both packages refuse with the same message."""
    n = 5000
    rng = np.random.default_rng(7)
    jb = JBlock.from_dict({
        "a": column_from_numpy(rng.integers(0, 400, n).tolist(), JD.INT64),
        "b": column_from_numpy(rng.integers(0, 400, n).tolist(), JD.INT64),
    })
    jb, tb = _both(jb)

    def make(E):
        return E.call("lpad", "x", E.col("a"), E.call("bin", E.col("b")))

    with pytest.raises(ValueError) as je:
        JC.ExprEvaluator(jb).evaluate(make(JE))
    with pytest.raises(ValueError) as te:
        TC.ExprEvaluator(tb).evaluate(make(TE))
    assert str(te.value) == str(je.value)
