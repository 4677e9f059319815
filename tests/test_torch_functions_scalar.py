"""The non-string scalar functions of the port against the JAX package,
one case per function name (aliases included), on one seeded block with
NULLs and the edge values: INT64_MIN and INT64_MAX, zero divisors,
negative MOD and DIV operands, 2^64-1 and 2^63 unsigned, Feb 29, month
ends, 0001-01-01, 9999-12-31, the ZERO date and datetime, and floats in a
denormal-free range.

Integers, decimals, dates, datetimes, durations and bools match bit for
bit, as do floats from IEEE-exact operations (negation, rounding,
ROUND with a digit count, square root, the casts).  Floats from the
transcendental functions hold within the ulp bound stated beside each in
``ULPS``: XLA's CPU approximations and the CPU libm torch calls differ
there, and ``tiflash_tpu/testing/oracle.py`` (Python ``math``) decides
which is nearer when they do.
"""

import datetime
import math

import jax
import numpy as np
import pytest
import torch

from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
from tiflash_tpu.core.dtypes import (BOOL, DATE, DATETIME, DURATION, FLOAT64,
                                     INT64, UINT64, ZERO_DATE_DAYS,
                                     ZERO_DT_BASE_US, Decimal)
from tiflash_tpu.core.block import Column as JColumn
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.expr import compile as JC
from tiflash_tpu.expr.functions import REGISTRY as J_REGISTRY

from tiflash_tpu_torch.expr import compile as TC
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.expr.functions import REGISTRY as T_REGISTRY
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 64
I64_MIN, I64_MAX = -(2 ** 63), 2 ** 63 - 1
DAY_US = 86_400_000_000
# the names the port registered before this slice
OLD_NAMES = {"and", "or", "not", "in", "equals", "not_equals", "less",
             "less_or_equals", "greater", "greater_or_equals", "plus",
             "minus", "multiply", "divide", "year"}


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _limbs(values, L):
    out = np.zeros((len(values), L), dtype=np.int64)
    for i, v in enumerate(values):
        for j in range(L - 1, 0, -1):
            v, out[i, j] = divmod(v, 10 ** 18)
        out[i, 0] = v
    return out


def _with_edges(rand, edges):
    rand = list(rand)
    rand[:len(edges)] = edges
    return rand


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(6)
    nulls = lambda p=0.15: rng.random(N) > p  # noqa: E731
    i = _with_edges(rng.integers(-10 ** 6, 10 ** 6, N),
                    [0, 1, -1, 7, -7, I64_MIN, I64_MAX, 10, -10, 123456789,
                     -5, 5, I64_MIN, 45, -45, 99])
    j = _with_edges(rng.integers(-5, 6, N),
                    [3, 0, 2, -3, 3, -1, -1, 0, -3, 1000, 2, -2, 7, 10, -10, 4])
    k = _with_edges(rng.integers(-2, 66, N),
                    [0, 1, 63, 64, -1, 2, 3, 12, 13, 24, 36, 50, 5, 1, 2, 3])
    u = _with_edges(rng.integers(0, 2 ** 63, N, dtype=np.uint64),
                    [0, 1, 2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 10, 2 ** 64 - 7,
                     12345, 99, 5])
    m = _with_edges(rng.integers(-10 ** 9, 10 ** 9, N),
                    [0, 12345, -12355, 5, -5, 50, -50, 150, -250, 99999,
                     -99999, 1, 10 ** 12, -10 ** 12])
    n = _with_edges(rng.integers(-10 ** 6, 10 ** 6, N),
                    [7, 0, 30000, -7000, 5000, 3, 0, 1, 2, 999])
    w = _with_edges([int(x) * 10 ** 12 + int(y) for x, y in zip(
        rng.integers(-10 ** 12, 10 ** 12, N), rng.integers(0, 10 ** 12, N))],
        [0, 5, -5, 10 ** 25 + 5000, -(10 ** 25) - 5000, 12345678901234567890])
    f = _with_edges(rng.random(N) * 200 - 100,
                    [0.0, -0.0, 0.5, -0.5, 2.5, -2.5, 1e-3, 1.5, 123.456,
                     -99.995, 1e15 + 0.5, 3.0])
    g = rng.random(N) * 9.9 + 0.1
    h = _with_edges(rng.random(N) * 2 - 1, [1.0, -1.0, 0.0, 0.5])
    dt = _with_edges(rng.integers(_days(1992, 1, 1), _days(1998, 12, 31), N),
                     [_days(2000, 2, 29), _days(2001, 2, 28), _days(2020, 1, 31),
                      _days(1999, 12, 31), -719162, 2932896, ZERO_DATE_DAYS,
                      0, -1, _days(2024, 2, 29), _days(1992, 1, 1),
                      _days(2021, 1, 3), _days(2020, 12, 31), _days(2010, 1, 1),
                      _days(2005, 1, 2), _days(1998, 12, 1)])
    tod = rng.integers(0, DAY_US, N)
    ts = [d * DAY_US + int(t) for d, t in zip(
        rng.integers(_days(1960, 1, 1), _days(2030, 1, 1), N), tod)]
    ts = _with_edges(ts, [0, -1, ZERO_DT_BASE_US + 3_723_000_001,
                          (2932896 + 1) * DAY_US - 1, -719162 * DAY_US,
                          _days(2000, 2, 29) * DAY_US + 12 * 3_600_000_000,
                          _days(2020, 1, 31) * DAY_US + 999_999,
                          _days(1969, 12, 31) * DAY_US + 500_000])
    du = _with_edges(rng.integers(-3_020_399_000_000, 3_020_399_000_000, N),
                     [0, -1, 3_020_399_000_000, -3_020_399_000_000,
                      3_723_456_789, -3_723_456_789, 500_000, -500_000])
    p = _with_edges(rng.integers(197001, 203012, N),
                    [199912, 200001, 9912, 7001, 6912, 101, 200012, 199901])
    yr = _with_edges(rng.integers(1, 9999, N), [2000, 1900, 2024, 1, 9999])
    doy = _with_edges(rng.integers(-2, 400, N), [60, 366, 0, 1, 365, -1])
    fd = _with_edges(rng.integers(0, 3_700_000, N),
                     [0, 365, 366, 730_000, 3_652_424, 3_652_425, 3_652_499,
                      3_652_500, 719528])
    cols = {
        "i": column_from_numpy(np.array(i, dtype=np.int64), INT64),
        "j": column_from_numpy(np.array(j, dtype=np.int64),
                               INT64.with_nullable(True), validity=nulls()),
        "k": column_from_numpy(np.array(k, dtype=np.int64), INT64),
        "u": column_from_numpy(np.array(u, dtype=np.uint64), UINT64),
        "m": column_from_numpy(np.array(m, dtype=np.int64),
                               Decimal(15, 2, True), validity=nulls()),
        "n": column_from_numpy(np.array(n, dtype=np.int64), Decimal(10, 4)),
        "w": JColumn(jax.numpy.asarray(_limbs(w, 2)),
                     jax.numpy.asarray(nulls()), Decimal(30, 4, True)),
        "f": column_from_numpy(np.array(f), FLOAT64.with_nullable(True),
                               validity=nulls(0.1)),
        "g": column_from_numpy(g, FLOAT64),
        "h": column_from_numpy(np.array(h), FLOAT64),
        "b": column_from_numpy(rng.random(N) > 0.5, BOOL.with_nullable(True),
                               validity=nulls()),
        "dt": column_from_numpy(np.array(dt, dtype=np.int32),
                                DATE.with_nullable(True), validity=nulls(0.1)),
        "ts": column_from_numpy(np.array(ts, dtype=np.int64),
                                DATETIME.with_nullable(True), validity=nulls(0.1)),
        "du": column_from_numpy(np.array(du, dtype=np.int64), DURATION),
        "p": column_from_numpy(np.array(p, dtype=np.int64), INT64),
        "p2": column_from_numpy(np.array(p[::-1], dtype=np.int64), INT64),
        "yr": column_from_numpy(np.array(yr, dtype=np.int64), INT64),
        "doy": column_from_numpy(np.array(doy, dtype=np.int64), INT64),
        "fd": column_from_numpy(np.array(fd, dtype=np.int64), INT64),
        "secs": column_from_numpy(rng.integers(-10 ** 9, 4 * 10 ** 9, N), INT64),
    }
    jb = JBlock.from_dict(cols)
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


def C(name, *args):
    """A call whose arguments are column names (str) or literals (lit)."""
    return lambda E: E.call(name, *[E.col(a) if isinstance(a, str) else a.value
                                    for a in args])


class lit:
    def __init__(self, value):
        self.value = value


# case id -> expression builder; the id's first word is the function name
CASES = {
    # arithmetic
    "negate i": C("negate", "i"), "negate m": C("negate", "m"),
    "negate u": C("negate", "u"), "negate w": C("negate", "w"),
    "negate f": C("negate", "f"),
    "abs i": C("abs", "i"), "abs m": C("abs", "m"), "abs f": C("abs", "f"),
    "abs u": C("abs", "u"),
    "modulo i j": C("modulo", "i", "j"), "modulo m n": C("modulo", "m", "n"),
    "modulo u j": C("modulo", "u", "j"), "modulo i u": C("modulo", "i", "u"),
    "modulo f g": C("modulo", "f", "g"), "modulo m j": C("modulo", "m", "j"),
    "mod i 7": C("mod", "i", lit(7)),
    "int_div i j": C("int_div", "i", "j"), "int_div m n": C("int_div", "m", "n"),
    "int_div u j": C("int_div", "u", "j"), "int_div f g": C("int_div", "f", "g"),
    "int_div w n": C("int_div", "w", "n"),
    "div i -1": C("div", "i", lit(-1)), "intdiv i 3": C("intdiv", "i", lit(3)),
    "plus_int i j": C("plus_int", "i", "j"),
    # comparisons
    "null_eq j 3": C("null_eq", "j", lit(3)), "null_eq m n": C("null_eq", "m", "n"),
    "nulleq j k": C("nulleq", "j", "k"),
    "eq i j": C("eq", "i", "j"), "ne u u": C("ne", "u", "u"),
    "lt m n": C("lt", "m", "n"), "le dt ts": C("le", "dt", "ts"),
    "gt f i": C("gt", "f", "i"), "ge u i": C("ge", "u", "i"),
    # logic
    "is_null j": C("is_null", "j"), "is_null i": C("is_null", "i"),
    "isnull f": C("isnull", "f"),
    "is_not_null m": C("is_not_null", "m"),
    "is_true b": C("is_true", "b"), "is_true f": C("is_true", "f"),
    "istrue j": C("istrue", "j"),
    "is_false b": C("is_false", "b"), "isfalse j": C("isfalse", "j"),
    "is_not_true b": C("is_not_true", "b"), "is_not_false b": C("is_not_false", "b"),
    "xor b j": C("xor", "b", "j"),
    # control flow
    "if b i j": C("if", "b", "i", "j"), "if b m i": C("if", "b", "m", "i"),
    "if b dt dt": C("if", "b", "dt", "dt"), "if j f m": C("if", "j", "f", "m"),
    "coalesce j i": C("coalesce", "j", "i"), "coalesce m n": C("coalesce", "m", "n"),
    "coalesce j j": C("coalesce", "j", "j"),
    "ifnull f g": C("ifnull", "f", "g"),
    "case_when default": lambda E: E.case_when((E.col("b"), E.col("m")),
                                               (E.col("j") > 0, E.col("n")),
                                               default=E.col("i")),
    "case_when no default": lambda E: E.case_when((E.col("b"), E.col("dt")),
                                                  (E.col("i") > 0, E.col("dt"))),
    # math
    **{f"{fn} f": C(fn, "f") for fn in (
        "sqrt", "ln", "log", "log2", "log10", "sin", "cos", "tan", "radians",
        "degrees", "atan", "cot", "tanh")},
    **{f"{fn} g": C(fn, "g") for fn in ("exp", "exp2", "sinh", "cosh")},
    "asin h": C("asin", "h"), "acos h": C("acos", "h"),
    "sqrt m": C("sqrt", "m"), "ln i": C("ln", "i"), "exp j": C("exp", "j"),
    "atan2 f g": C("atan2", "f", "g"), "pow g h": C("pow", "g", "h"),
    "power g 2": C("power", "g", lit(2)),
    "round f": C("round", "f"), "floor f": C("floor", "f"),
    "ceil f": C("ceil", "f"), "ceiling f": C("ceiling", "f"),
    "truncate f 0": C("truncate", "f", lit(0)),
    "round m": C("round", "m"), "floor m": C("floor", "m"),
    "ceil m": C("ceil", "m"), "truncate m 0": C("truncate", "m", lit(0)),
    "round m 1": C("round", "m", lit(1)), "round m -1": C("round", "m", lit(-1)),
    "round m -30": C("round", "m", lit(-30)),
    "floor m 1": C("floor", "m", lit(1)), "ceil m -2": C("ceil", "m", lit(-2)),
    "truncate m 1": C("truncate", "m", lit(1)),
    "round m k": C("round", "m", "k"), "truncate m k": C("truncate", "m", "k"),
    "round w": C("round", "w"), "floor w": C("floor", "w"),
    "ceil w": C("ceil", "w"), "round w 2": C("round", "w", lit(2)),
    "round w -3": C("round", "w", lit(-3)), "round w k": C("round", "w", "k"),
    "round i -2": C("round", "i", lit(-2)), "truncate i -1": C("truncate", "i", lit(-1)),
    "floor i -1": C("floor", "i", lit(-1)), "ceil i -3": C("ceil", "i", lit(-3)),
    "round i j": C("round", "i", "j"), "round i": C("round", "i"),
    "round u -3": C("round", "u", lit(-3)), "ceil u -1": C("ceil", "u", lit(-1)),
    "truncate u -19": C("truncate", "u", lit(-19)), "floor u": C("floor", "u"),
    "round f 2": C("round", "f", lit(2)), "round f -1": C("round", "f", lit(-1)),
    "truncate f j": C("truncate", "f", "j"),
    "sign i": C("sign", "i"), "sign f": C("sign", "f"), "sign m": C("sign", "m"),
    "sign u": C("sign", "u"),
    "greatest i j 3": C("greatest", "i", "j", lit(3)),
    "greatest m n": C("greatest", "m", "n"), "greatest f i": C("greatest", "f", "i"),
    "greatest u u": C("greatest", "u", "u"),
    "least i j": C("least", "i", "j"), "least m n": C("least", "m", "n"),
    "least dt dt": C("least", "dt", "dt"),
    "nullif i 7": C("nullif", "i", lit(7)), "nullif j k": C("nullif", "j", "k"),
    "nullif m n": C("nullif", "m", "n"),
    # bits
    "bit_and i j": C("bit_and", "i", "j"), "bit_and u i": C("bit_and", "u", "i"),
    "bit_or i k": C("bit_or", "i", "k"), "bit_xor u j": C("bit_xor", "u", "j"),
    "bit_not i": C("bit_not", "i"), "bit_not u": C("bit_not", "u"),
    "bit_neg j": C("bit_neg", "j"),
    "shift_left i k": C("shift_left", "i", "k"), "shift_left u j": C("shift_left", "u", "j"),
    "shift_right i k": C("shift_right", "i", "k"),
    "shift_right u k": C("shift_right", "u", "k"),
    "bit_count i": C("bit_count", "i"), "bit_count u": C("bit_count", "u"),
    "bit_count j": C("bit_count", "j"),
    # date parts
    "year dt": C("year", "dt"), "year ts": C("year", "ts"),
    "month dt": C("month", "dt"), "month ts": C("month", "ts"),
    "day_of_month dt": C("day_of_month", "dt"), "day ts": C("day", "ts"),
    "dayofmonth dt": C("dayofmonth", "dt"),
    "hour ts": C("hour", "ts"), "hour du": C("hour", "du"),
    "minute ts": C("minute", "ts"), "minute du": C("minute", "du"),
    "second ts": C("second", "ts"), "second du": C("second", "du"),
    "microsecond ts": C("microsecond", "ts"), "microsecond du": C("microsecond", "du"),
    # date and datetime functions
    "date_add_days dt j": C("date_add_days", "dt", "j"),
    "date_add_days ts k": C("date_add_days", "ts", "k"),
    "date_sub_days dt k": C("date_sub_days", "dt", "k"),
    "adddate dt 1": C("adddate", "dt", lit(1)),
    "subdate ts j": C("subdate", "ts", "j"),
    "date_add_weeks dt j": C("date_add_weeks", "dt", "j"),
    "date_sub_weeks ts k": C("date_sub_weeks", "ts", "k"),
    "date_add_months dt k": C("date_add_months", "dt", "k"),
    "date_add_months dt 1": C("date_add_months", "dt", lit(1)),
    "date_sub_months ts j": C("date_sub_months", "ts", "j"),
    "add_months dt 13": C("add_months", "dt", lit(13)),
    "date_add_years dt j": C("date_add_years", "dt", "j"),
    "date_sub_years dt 2020": C("date_sub_years", "dt", lit(2020)),
    "date_sub_years ts 1969": C("date_sub_years", "ts", lit(1969)),
    "date_add_quarters ts k": C("date_add_quarters", "ts", "k"),
    "date_sub_quarters dt j": C("date_sub_quarters", "dt", "j"),
    "date_add_hours dt k": C("date_add_hours", "dt", "k"),
    "date_sub_hours ts secs": C("date_sub_hours", "ts", "secs"),
    "date_add_minutes ts secs": C("date_add_minutes", "ts", "secs"),
    "date_sub_minutes dt j": C("date_sub_minutes", "dt", "j"),
    "date_add_seconds ts secs": C("date_add_seconds", "ts", "secs"),
    "date_sub_seconds ts k": C("date_sub_seconds", "ts", "k"),
    "date_add_microseconds ts i": C("date_add_microseconds", "ts", "i"),
    "date_sub_microseconds dt secs": C("date_sub_microseconds", "dt", "secs"),
    "datediff dt ts": C("datediff", "dt", "ts"), "datediff ts dt": C("datediff", "ts", "dt"),
    "day_of_week dt": C("day_of_week", "dt"), "dayofweek ts": C("dayofweek", "ts"),
    "day_of_year dt": C("day_of_year", "dt"), "dayofyear ts": C("dayofyear", "ts"),
    "quarter dt": C("quarter", "dt"), "to_days dt": C("to_days", "dt"),
    "to_days ts": C("to_days", "ts"),
    "week_of_year dt": C("week_of_year", "dt"), "weekofyear ts": C("weekofyear", "ts"),
    "weekday dt": C("weekday", "dt"), "week dt": C("week", "dt"),
    "week ts": C("week", "ts"), "yearweek dt": C("yearweek", "dt"),
    "yearweek ts": C("yearweek", "ts"),
    "last_day dt": C("last_day", "dt"), "last_day ts": C("last_day", "ts"),
    "makedate yr doy": C("makedate", "yr", "doy"),
    "from_days fd": C("from_days", "fd"), "from_days_cop fd": C("from_days_cop", "fd"),
    "period_add p j": C("period_add", "p", "j"),
    "period_diff p p2": C("period_diff", "p", "p2"),
    "unix_timestamp ts": C("unix_timestamp", "ts"),
    "unix_timestamp dt": C("unix_timestamp", "dt"),
    "unix_timestamp_decimal ts": C("unix_timestamp_decimal", "ts"),
    "from_unixtime secs": C("from_unixtime", "secs"),
    "date ts": C("date", "ts"), "date dt": C("date", "dt"),
    "time_to_sec ts": C("time_to_sec", "ts"), "time_to_sec du": C("time_to_sec", "du"),
    "time_to_sec dt": C("time_to_sec", "dt"),
    "interval i": C("interval", "i", lit(-100), lit(0), lit(7), lit(10 ** 6)),
    "interval j": C("interval", "j", "k", lit(2)),
    "cast_fsp_round ts 3": C("cast_fsp_round", "ts", lit(3)),
    "cast_fsp_round du 0": C("cast_fsp_round", "du", lit(0)),
    "cast_fsp_round du 6": C("cast_fsp_round", "du", lit(6)),
    # the compile dispatcher
    "extract YEAR dt": C("extract", lit("YEAR"), "dt"),
    "extract YEAR_MONTH ts": C("extract", lit("YEAR_MONTH"), "ts"),
    "extract DAY_MICROSECOND ts": C("extract", lit("DAY_MICROSECOND"), "ts"),
    "extract WEEK dt": C("extract", lit("WEEK"), "dt"),
    "extract HOUR_SECOND du": C("extract", lit("HOUR_SECOND"), "du"),
    "extract MICROSECOND du": C("extract", lit("MICROSECOND"), "du"),
    "date_add dt k MONTH": C("date_add", "dt", "k", lit("MONTH")),
    "date_sub ts j HOUR": C("date_sub", "ts", "j", lit("hour")),
    "adddate dt 2 YEAR": C("adddate", "dt", lit(2), lit("YEAR")),
    "now": C("now"), "curdate": C("curdate"), "unix_timestamp": C("unix_timestamp"),
    "pi": C("pi"),
}

# the ulp bound of each transcendental function (XLA's approximations
# against the CPU libm torch calls); everything else is bit-exact
ULPS = {"exp": 1, "exp2": 4, "ln": 1, "log": 1, "log2": 1, "log10": 1,
        "sin": 1, "cos": 1, "tan": 2, "cot": 2, "asin": 1, "acos": 1,
        "atan": 1, "atan2": 1, "sinh": 2, "cosh": 4, "tanh": 7, "pow": 1,
        "power": 1}

CLOCK_US = 1_700_000_123_456_789


def _eval_both(blocks, make):
    jb, tb = blocks
    with JC.query_clock(CLOCK_US):
        j = jax.jit(lambda b: JC.ExprEvaluator(b).evaluate(make(JE)))(jb)
    with TC.query_clock(CLOCK_US):
        t = TC.ExprEvaluator(tb).evaluate(make(TE))
    return j, t


def _ulp_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of float64 (0 for equal values,
    NaNs included)."""
    ia = a.view(np.int64).astype(object)
    ib = b.view(np.int64).astype(object)
    key = lambda x: x if x >= 0 else -(2 ** 63) - x  # noqa: E731
    gap = np.array([abs(key(x) - key(y)) for x, y in zip(ia, ib)], dtype=object)
    both_nan = np.isnan(a) & np.isnan(b)
    gap[both_nan] = 0
    return gap


def _stats(c):
    return None if c.stats is None else tuple(int(x) for x in c.stats)


def assert_same_column(j, t, ulps=0):
    assert repr(t.dtype) == repr(j.dtype)
    # range stats choose the aggregation method downstream
    assert _stats(t) == _stats(j)
    jv = None if j.validity is None else np.asarray(j.validity)
    tv = None if t.validity is None else t.validity.numpy()
    assert (jv is None) == (tv is None)
    if jv is not None:
        np.testing.assert_array_equal(tv, jv)
    if t.dtype.is_float and ulps:
        valid = np.ones(N, bool) if jv is None else jv
        a, b = np.asarray(j.data)[valid], t.data.numpy()[valid]
        gap = _ulp_gap(a, b)
        assert max(gap, default=0) <= ulps, (max(gap), a, b)
        return
    assert t.to_pylist() == j.to_pylist() or (
        t.dtype.is_float and np.array_equal(
            np.asarray(j.data)[np.asarray(j.valid_mask())],
            t.data.numpy()[t.valid_mask().numpy()], equal_nan=True))


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_reference(blocks, case):
    j, t = _eval_both(blocks, CASES[case])
    assert_same_column(j, t, ULPS.get(case.split()[0], 0))


def test_every_new_function_has_a_case():
    """Each name of the functions slice has a case here; the string
    slice's names have theirs in ``test_torch_strings.py`` and
    ``test_torch_duration.py``, the analytic slice's grouping functions
    in ``test_torch_function_registry.py``."""
    from test_torch_function_registry import GROUPING_NAMES
    from test_torch_strings import REGISTRY_NAMES
    from test_torch_duration import DURATION_NAMES

    named = {c.split()[0] for c in CASES}
    new = (set(T_REGISTRY) - OLD_NAMES - set(REGISTRY_NAMES) - set(DURATION_NAMES)
           - set(GROUPING_NAMES))
    assert len(new) == 123
    assert sorted(new - named) == []
    assert named - {"extract", "date_add", "date_sub", "now", "curdate", "pi"} \
        <= set(J_REGISTRY)


def test_transcendentals_nearer_oracle_where_they_differ(blocks):
    """Where the two packages' doubles differ, Python's ``math`` (the
    oracle of ``tiflash_tpu/testing/oracle.py``) is within one ulp of the
    port's value."""
    jb, tb = blocks
    fns = {"exp": math.exp, "ln": math.log, "sin": math.sin, "cos": math.cos,
           "tan": math.tan, "atan": math.atan, "sinh": math.sinh,
           "tanh": math.tanh, "log10": math.log10, "cosh": math.cosh,
           "exp2": lambda v: 2.0 ** v, "sqrt": math.sqrt}
    for name, fn in fns.items():
        arg = "g" if name in ("exp", "sinh", "cosh", "exp2") else "f"
        j, t = _eval_both(blocks, C(name, arg))
        valid = t.valid_mask().numpy()
        x = tb[arg].data.numpy()[valid]
        port = t.data.numpy()[valid]
        want = np.array([fn(v) if v >= 0 or name != "sqrt" else math.nan
                         for v in x])
        if name == "sqrt":
            want = np.where(np.isnan(want), 0.0, want)
        assert max(_ulp_gap(port, want), default=0) <= (name != "sqrt"), name


def test_rand_is_seeded_uniform_and_never_null(blocks):
    _, tb = blocks
    a = TC.ExprEvaluator(tb).evaluate(TE.call("rand", 7))
    b = TC.ExprEvaluator(tb).evaluate(TE.call("rand", 7))
    c = TC.ExprEvaluator(tb).evaluate(TE.call("rand", 8))
    assert a.validity is None and repr(a.dtype) == "f64"
    assert torch.equal(a.data, b.data) and not torch.equal(a.data, c.data)
    assert float(a.data.min()) >= 0.0 and float(a.data.max()) < 1.0


def test_query_timezone_shifts_timestamps_and_unix_time(blocks):
    """A tz-aware DATETIME reads in session-local time, and UNIX_TIMESTAMP
    and FROM_UNIXTIME convert through the offset, in both packages."""
    import dataclasses

    jb, tb = blocks
    off = TC.parse_tz_offset_us("+08:00")
    assert off == JC.parse_tz_offset_us("+08:00") == 8 * 3_600_000_000
    jts = jb["ts"]
    jb2 = JBlock.from_dict({"ts": dataclasses.replace(
        jts, dtype=dataclasses.replace(jts.dtype, tz_aware=True))})
    tb2 = blocks_from_numpy(export_blocks({"t": jb2}), "cpu")["t"]
    assert tb2["ts"].dtype.tz_aware
    for make in (lambda E: E.col("ts"), C("unix_timestamp", "ts"),
                 C("hour", "ts"), lambda E: E.call(
                     "from_unixtime", E.call("unix_timestamp", E.col("ts")))):
        with JC.query_timezone(off):
            j = jax.jit(lambda b: JC.ExprEvaluator(b).evaluate(make(JE)))(jb2)
        with TC.query_timezone(off):
            t = TC.ExprEvaluator(tb2).evaluate(make(TE))
        assert_same_column(j, t)


def test_empty_call_and_string_paths_raise(blocks):
    """An empty call of a function that takes arguments raises; the
    string paths the string slice brought (CURTIME's text, COALESCE of a
    TIME and an integer as text) equal the reference's."""
    _, tb = blocks
    from tiflash_tpu_torch.runtime.errors import EngineError

    with pytest.raises(EngineError, match="parameter count.*'ceiling'"):
        TC.ExprEvaluator(tb).evaluate(TE.call("ceiling"))
    for make in (C("curtime"), C("coalesce", "du", "j")):
        j, t = _eval_both(blocks, make)
        assert t.dtype.is_string and t.dictionary == tuple(j.dictionary)
        assert_same_column(j, t)
