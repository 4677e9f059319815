"""``CAST`` between every pair of non-string types, the port against the
JAX package on one seeded block with NULLs and edge values (tolerance
zero: float results are the same IEEE doubles, decimal -> double divides
the mantissa by 10^scale correctly rounded).  A pair the reference does
not cast raises in both packages.  Casts to strings render MySQL's text
over the column's host-knowable domain, as the reference does
(``tests/test_torch_strings.py`` holds the casts from strings).

Also here: decimal literals of 2^63 and more (multi-limb constants) and
BIGINT UNSIGNED literals, alone and in arithmetic and comparisons.
"""

import datetime
from decimal import Decimal as PyDecimal

import jax
import numpy as np
import pytest

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.core.block import Block as JBlock, Column as JColumn, column_from_numpy
from tiflash_tpu.expr import compile as JC
from tiflash_tpu.expr import nodes as JE

from tiflash_tpu_torch.core import dtypes as TD
from tiflash_tpu_torch.expr import compile as TC
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 48
DAY_US = 86_400_000_000
CLOCK_US = 1_700_000_123_456_789


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _limbs(values, L):
    out = np.zeros((len(values), L), dtype=np.int64)
    for i, v in enumerate(values):
        for j in range(L - 1, 0, -1):
            v, out[i, j] = divmod(v, 10 ** 18)
        out[i, 0] = v
    return out


def _edges(rand, edges):
    rand = list(rand)
    rand[:len(edges)] = edges
    return rand


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(9)
    valid = lambda: rng.random(N) > 0.15  # noqa: E731
    i = _edges(rng.integers(-10 ** 6, 10 ** 6, N),
               [0, 1, -1, -(2 ** 63), 2 ** 63 - 1, 20200229, 19991231235959,
                991231, 700101, 123, 20201301, 235959, -15, 99999999])
    u = _edges(rng.integers(0, 2 ** 63, N, dtype=np.uint64),
               [0, 1, 2 ** 64 - 1, 2 ** 63, 20200229, 10 ** 19, 123456])
    m = _edges(rng.integers(-10 ** 9, 10 ** 9, N),
               [0, 5, -5, 12345, -12355, 2020022912, 99999999999, 105, -150])
    w = _edges([int(x) * 10 ** 12 + int(y) for x, y in zip(
        rng.integers(-10 ** 12, 10 ** 12, N), rng.integers(0, 10 ** 12, N))],
        [0, 5, -5, 10 ** 25 + 5000, -(10 ** 25) - 5000, 202002290000,
         12345678901234567890])
    f = _edges(rng.random(N) * 200 - 100,
               [0.0, -0.0, 0.5, -0.5, 2.5, -2.5, 1.1, 20200229.4, 123.456,
                99.995, 1e15 + 0.5, 235959.5])
    dt = _edges(rng.integers(_days(1992, 1, 1), _days(1998, 12, 31), N),
                [_days(2000, 2, 29), -719162, 2932896, 0, -1, _days(2024, 2, 29)])
    ts = _edges([d * DAY_US + int(t) for d, t in zip(
        rng.integers(_days(1960, 1, 1), _days(2030, 1, 1), N),
        rng.integers(0, DAY_US, N))],
        [0, -1, (2932896 + 1) * DAY_US - 1, -719162 * DAY_US,
         _days(2000, 2, 29) * DAY_US + 43_200_500_000])
    du = _edges(rng.integers(-3_020_399_000_000, 3_020_399_000_000, N),
                [0, -1, 3_020_399_000_000, 3_723_456_789, -3_723_456_789,
                 500_000])
    cols = {
        "INT64": column_from_numpy(np.array(i, np.int64), JD.INT64),
        "INT32": column_from_numpy(rng.integers(-10 ** 5, 10 ** 5, N).astype(np.int32),
                                   JD.INT32.with_nullable(True), validity=valid()),
        "UINT64": column_from_numpy(np.array(u, np.uint64), JD.UINT64),
        "DEC15_2": column_from_numpy(np.array(m, np.int64), JD.Decimal(15, 2, True),
                                     validity=valid()),
        "DEC30_4": JColumn(jax.numpy.asarray(_limbs(w, 2)),
                           jax.numpy.asarray(valid()), JD.Decimal(30, 4, True)),
        "FLOAT64": column_from_numpy(np.array(f), JD.FLOAT64.with_nullable(True),
                                     validity=valid()),
        "FLOAT32": column_from_numpy(rng.random(N).astype(np.float32) * 100,
                                     JD.FLOAT32),
        "BOOL": column_from_numpy(rng.random(N) > 0.5, JD.BOOL.with_nullable(True),
                                  validity=valid()),
        "DATE": column_from_numpy(np.array(dt, np.int32), JD.DATE.with_nullable(True),
                                  validity=valid()),
        "DATETIME": column_from_numpy(np.array(ts, np.int64), JD.DATETIME),
        "DURATION": column_from_numpy(np.array(du, np.int64),
                                      JD.DURATION.with_nullable(True), validity=valid()),
    }
    jb = JBlock.from_dict(cols)
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


def _targets(D):
    return {
        "INT64": D.INT64, "INT32": D.INT32, "UINT64": D.UINT64,
        "DEC18_4": D.Decimal(18, 4), "DEC10_1": D.Decimal(10, 1),
        "DEC12_0": D.Decimal(12, 0), "DEC30_6": D.Decimal(30, 6),
        "DEC50_2": D.Decimal(50, 2), "FLOAT64": D.FLOAT64,
        "FLOAT32": D.FLOAT32, "BOOL": D.BOOL, "DATE": D.DATE,
        "DATETIME": D.DATETIME, "DURATION": D.DURATION,
    }


SOURCES = ["INT64", "INT32", "UINT64", "DEC15_2", "DEC30_4", "FLOAT64",
           "FLOAT32", "BOOL", "DATE", "DATETIME", "DURATION"]
TARGETS = list(_targets(TD))
# a wide decimal's limbs combine into a double in two roundings in the
# port; XLA may fuse them into one multiply-add: within 1 ulp
ULPS = {("DEC30_4", "FLOAT64"): 1, ("DEC30_4", "FLOAT32"): 1}


def _same(j, t, ulps=0):
    assert repr(t.dtype) == repr(j.dtype)
    jv = None if j.validity is None else np.asarray(j.validity)
    tv = None if t.validity is None else t.validity.numpy()
    assert (jv is None) == (tv is None)
    if jv is not None:
        np.testing.assert_array_equal(tv, jv)
    if ulps:
        a = np.asarray(j.data, dtype=np.float64)
        b = t.data.numpy().astype(np.float64)
        ok = np.ones(len(a), bool) if jv is None else jv
        np.testing.assert_array_max_ulp(a[ok], b[ok], maxulp=ulps)
        return
    assert t.to_pylist() == j.to_pylist()


def _eval_both(blocks, make, ulps=0):
    jb, tb = blocks
    jerr = terr = None
    try:
        with JC.query_clock(CLOCK_US):
            j = jax.jit(lambda b: JC.ExprEvaluator(b).evaluate(make(JE, JD)))(jb)
    except (NotImplementedError, ValueError, TypeError) as e:
        jerr = e
    try:
        with TC.query_clock(CLOCK_US):
            t = TC.ExprEvaluator(tb).evaluate(make(TE, TD))
    except (NotImplementedError, ValueError, TypeError) as e:
        terr = e
    assert (jerr is None) == (terr is None), (jerr, terr)
    if jerr is None:
        _same(j, t, ulps)
    return jerr


# the pairs the reference does not cast (wide decimals to BOOL and the
# temporals, floats and TIME to wide decimals, BOOL and DATE with TIME)
REFERENCE_RAISES = {
    ("DEC30_4", "BOOL"), ("DEC30_4", "DATE"), ("DEC30_4", "DATETIME"),
    ("DEC30_4", "DURATION"), ("FLOAT64", "DEC30_6"), ("FLOAT64", "DEC50_2"),
    ("FLOAT32", "DEC30_6"), ("FLOAT32", "DEC50_2"), ("BOOL", "DURATION"),
    ("DURATION", "DEC30_6"), ("DURATION", "DEC50_2"), ("DURATION", "DATE")}


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("source", SOURCES)
def test_cast_matches_reference(blocks, source, target):
    err = _eval_both(
        blocks, lambda E, D: E.cast(E.col(source), _targets(D)[target]),
        ULPS.get((source, target), 0))
    assert (err is not None) == ((source, target) in REFERENCE_RAISES), err


@pytest.mark.parametrize("source", ["INT64", "DATE", "FLOAT64"])
def test_string_casts_name_the_string_slice(blocks, source):
    """CAST(x AS CHAR), which the string slice brought: MySQL's text over
    the column's value domain, equal to the reference's."""
    assert _eval_both(blocks, lambda E, D: E.cast(E.col(source), D.STRING)) is None


WIDE_LITERALS = {
    "alone": lambda E: E.lit(PyDecimal("123456789012345678901234567890.12")),
    "negative": lambda E: E.lit(PyDecimal("-9223372036854775808")),
    "four_limbs": lambda E: E.lit(PyDecimal("1" * 50 + ".5")),
    "plus_column": lambda E: E.col("DEC15_2") + E.lit(PyDecimal("98765432109876543210.5")),
    "compare": lambda E: E.col("DEC30_4") < E.lit(PyDecimal("10000000000000000000000000.1")),
    "in_list": lambda E: E.col("INT64").in_(1, 18446744073709551616),
    "int_past_64_bits": lambda E: E.lit(2 ** 64 + 3),
    "unsigned": lambda E: E.lit(2 ** 64 - 1, E.UINT64) if hasattr(E, "UINT64")
    else None,
}


@pytest.mark.parametrize("name", sorted(WIDE_LITERALS))
def test_wide_and_unsigned_literals_match_reference(blocks, name):
    def make(E, D):
        if name == "unsigned":
            return E.call("bit_xor", E.lit(2 ** 64 - 1, D.UINT64), E.col("UINT64"))
        return WIDE_LITERALS[name](E)

    assert _eval_both(blocks, make) is None


def test_bridge_carries_every_non_string_type_bit_for_bit(blocks):
    """FLOAT64/32, UINT64 above 2^63, DATETIME, DURATION, wide decimals
    and NULLs cross ``export_blocks`` -> ``blocks_from_numpy`` unchanged."""
    jb, tb = blocks
    for name, jc in zip(jb.names, jb.columns):
        tc = tb[name]
        assert repr(tc.dtype) == repr(jc.dtype), name
        want = np.asarray(jc.data)
        got = tc.data.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
        if jc.validity is None:
            assert tc.validity is None, name
        else:
            assert tc.validity.numpy().tolist() == np.asarray(jc.validity).tolist()
