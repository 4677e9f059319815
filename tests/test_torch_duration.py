"""The TIME functions (``expr/duration.py``) of the port against the JAX
package, tolerance zero, over one seeded block: durations negative and at
the +-838:59:59 bounds, seconds past the TIME range as integers, floats
and decimals, minutes and seconds outside [0, 60), datetimes before the
epoch, dates, and NULLs.  ``time_format`` is a guard in both."""

import datetime

import numpy as np
import pytest

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
from tiflash_tpu.expr import compile as JC
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.expr.functions import get_function as j_get

from test_torch_strings import assert_same_column
from tiflash_tpu_torch.expr import compile as TC
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.expr.functions import get_function as t_get
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 48
MAX_US = 3_020_399_000_000
DAY_US = 86_400_000_000

DURATION_NAMES = ["maketime", "sec_to_time", "timediff", "addtime", "subtime",
                  "time", "to_seconds", "any_value", "time_format"]


def _edges(rand, edges):
    rand = np.array(rand)
    rand[:len(edges)] = edges
    return rand


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(29)
    valid = lambda: rng.random(N) > 0.1  # noqa: E731
    du = _edges(rng.integers(-MAX_US, MAX_US, N),
                [0, -1, MAX_US, -MAX_US, 3_723_456_789, -3_723_456_789, 500_000,
                 -500_000, MAX_US - 1])
    du2 = _edges(rng.integers(-MAX_US, MAX_US, N), [MAX_US, -MAX_US, 1, -1, 0])
    secs = _edges(rng.integers(-4_000_000, 4_000_000, N),
                  [0, -1, 3_020_399, -3_020_399, 3_020_400, -3_020_400, 59, 86_400])
    fsecs = _edges(rng.random(N) * 8e6 - 4e6, [0.5, -0.5, 3_020_399.9999999,
                                               -3_020_400.5, 1.000001, 59.999])
    dsecs = _edges(rng.integers(-10 ** 10, 10 ** 10, N), [5, -5, 3_020_399_999,
                                                          -3_020_400_001])
    hh = _edges(rng.integers(-900, 900, N), [838, -838, 839, -839, 0, 1, -1])
    mm = _edges(rng.integers(-3, 63, N), [59, 60, -1, 0, 30])
    ss = _edges(rng.integers(-3, 63, N), [59, 60, -1, 0, 59])
    fss = _edges(rng.random(N) * 70 - 5, [59.5, 60.0, -0.1, 0.0, 12.25])
    dss = _edges(rng.integers(-1000, 70_000, N), [59_999, 60_000, -1, 0])
    day0 = (datetime.date(1965, 1, 1) - datetime.date(1970, 1, 1)).days
    ts = rng.integers(day0 * DAY_US, -day0 * DAY_US, N)
    ts2 = ts + rng.integers(-40 * DAY_US, 40 * DAY_US, N)
    dt = rng.integers(day0, -day0, N).astype(np.int32)
    cols = {
        "du": column_from_numpy(du.astype(np.int64), JD.DURATION.with_nullable(True),
                                valid()),
        "du2": column_from_numpy(du2.astype(np.int64), JD.DURATION),
        "secs": column_from_numpy(secs.astype(np.int64), JD.INT64.with_nullable(True),
                                  valid()),
        "fsecs": column_from_numpy(fsecs, JD.FLOAT64),
        "dsecs": column_from_numpy(dsecs.astype(np.int64), JD.Decimal(15, 3)),
        "d8": column_from_numpy(dsecs.astype(np.int64), JD.Decimal(18, 8)),
        "hh": column_from_numpy(hh.astype(np.int64), JD.INT64),
        "mm": column_from_numpy(mm.astype(np.int64), JD.INT64.with_nullable(True),
                                valid()),
        "ss": column_from_numpy(ss.astype(np.int64), JD.INT64),
        "fss": column_from_numpy(fss, JD.FLOAT64),
        "dss": column_from_numpy(dss.astype(np.int64), JD.Decimal(8, 3)),
        "ts": column_from_numpy(ts.astype(np.int64), JD.DATETIME),
        "ts2": column_from_numpy(ts2.astype(np.int64), JD.DATETIME.with_nullable(True),
                                 valid()),
        "dt": column_from_numpy(dt, JD.DATE.with_nullable(True), valid()),
    }
    jb = JBlock.from_dict(cols)
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


def C(name, *cols):
    return lambda E: E.call(name, *[E.col(c) for c in cols])


CASES = {
    "maketime int": C("maketime", "hh", "mm", "ss"),
    "maketime float": C("maketime", "hh", "mm", "fss"),
    "maketime decimal": C("maketime", "hh", "ss", "dss"),
    "sec_to_time int": C("sec_to_time", "secs"),
    "sec_to_time float": C("sec_to_time", "fsecs"),
    "sec_to_time decimal": C("sec_to_time", "dsecs"),
    "sec_to_time scale 8": C("sec_to_time", "d8"),
    "timediff durations": C("timediff", "du", "du2"),
    "timediff datetimes": C("timediff", "ts", "ts2"),
    "timediff date datetime": C("timediff", "dt", "ts"),
    "addtime datetime": C("addtime", "ts", "du"),
    "addtime date": C("addtime", "dt", "du2"),
    "addtime durations": C("addtime", "du", "du2"),
    "subtime datetime": C("subtime", "ts2", "du2"),
    "subtime durations": C("subtime", "du", "du2"),
    "time datetime": C("time", "ts"), "time date": C("time", "dt"),
    "time duration": C("time", "du"),
    "time of cast": lambda E: E.call("time", E.cast(E.col("dt"), E.DATETIME)),
    "to_seconds date": C("to_seconds", "dt"),
    "to_seconds datetime": C("to_seconds", "ts2"),
    "any_value duration": C("any_value", "du"),
    "any_value int": C("any_value", "secs"),
    "extract HOUR_SECOND": lambda E: E.call("extract", "HOUR_SECOND",
                                            E.call("sec_to_time", E.col("secs"))),
    "hour of maketime": lambda E: E.call("hour", E.call("maketime", E.col("hh"),
                                                        E.col("mm"), E.col("ss"))),
    "cast time int": lambda E: E.cast(E.call("timediff", E.col("du"), E.col("du2")),
                                      E.INT64),
}


class _Mod:
    def __init__(self, mod, D):
        self.__dict__.update(mod.__dict__)
        self.DATETIME, self.INT64 = D.DATETIME, D.INT64


@pytest.mark.parametrize("case", sorted(CASES))
def test_time_function_matches_reference(blocks, case):
    from tiflash_tpu_torch.core import dtypes as TD

    jb, tb = blocks
    j = JC.ExprEvaluator(jb).evaluate(CASES[case](_Mod(JE, JD)))
    t = TC.ExprEvaluator(tb).evaluate(CASES[case](_Mod(TE, TD)))
    assert_same_column(j, t)


def test_every_time_name_has_a_case():
    named = {c.split()[0] for c in CASES}
    assert set(DURATION_NAMES) - named == {"time_format"}


def test_time_format_and_mixed_timediff_refuse_alike(blocks):
    from tiflash_tpu_torch.core import dtypes as TD

    jb, tb = blocks
    for get, D in ((j_get, JD), (t_get, TD)):
        with pytest.raises(NotImplementedError,
                           match="time_format is compiled in compile.py"):
            get("time_format").infer([D.DURATION, D.STRING])
        with pytest.raises(TypeError, match="timediff argument kinds differ"):
            get("timediff").infer([D.DURATION, D.DATETIME])
        with pytest.raises(TypeError, match="second argument must be TIME"):
            get("addtime").infer([D.DATETIME, D.INT64])
