"""The front end's host layer, port against reference: ``column_from_numpy``
(data, validity, dictionary, range stats, int32 shadow, exact domain),
``oracle.pytable_to_block`` / ``block_to_pytable`` (decimals up to 65
digits, zero and year-0 dates, zero datetimes, JSON order, vectors),
``eval_expr_row`` over rows of python values, and ``evaluate_expr``
(a 100-deep CASE included) on the same seeded rows."""

import dataclasses
import datetime
from decimal import Decimal as D

import numpy as np
import pytest

from tiflash_tpu.core import block as JB
from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.expr import compile as JC
from tiflash_tpu.testing import oracle as JO
from tiflash_tpu.testing import reftest as JR

from tiflash_tpu_torch.core import block as TB
from tiflash_tpu_torch.core import dtypes as TD
from tiflash_tpu_torch.expr import compile as TC
from tiflash_tpu_torch.testing import oracle as TO
from tiflash_tpu_torch.testing import reftest as TR

from torch_sql_parity import canon

# (name, dtype name, values) — the same values for both packages
COLUMNS = [
    ("i32", "INT32", [3, -7, None, 3, 2 ** 31 - 1]),
    ("i64", "INT64", [-(2 ** 63), 0, 5, None, 2 ** 63 - 1]),
    ("u64", "UINT64", [0, 2 ** 64 - 1, None, 7, 2 ** 63]),
    ("u8", "UINT8", [0, 255, 1, 1, None]),
    ("f64", "FLOAT64", [0.5, -1e300, None, float("inf"), 3.0]),
    ("f32", "FLOAT32", [1.5, -2.25, 0.0, None, 7.0]),
    ("b", "BOOL", [True, False, None, True, True]),
    ("s", "STRING", ["b", "a", None, "", "b"]),
    ("d", "DATE", [datetime.date(2020, 2, 29), "zero", None, "civil0",
                   datetime.date(1969, 12, 31)]),
    ("dt", "DATETIME", [datetime.datetime(2020, 1, 2, 3, 4, 5, 6), "zerodt", None,
                        datetime.datetime(1900, 1, 1), "civildt"]),
    ("du", "DURATION", [0, -3_600_000_000, None, 3020399000000, 1]),
]


def _dtype(pkg, name, values):
    return getattr(pkg, name).with_nullable(any(v is None for v in values))


def _host(pkg, values):
    out = []
    for v in values:
        if v == "zero":
            v = pkg.ZeroDate()
        elif v == "civil0":
            v = pkg.CivilDate(0, 1, 1)
        elif v == "zerodt":
            v = pkg.ZeroDateTime(3_723_000_000)
        elif v == "civildt":
            v = pkg.CivilDateTime(0, 2, 3, 4, 5, 6, 7)
        out.append(v)
    return out


def _tables():
    schemas, tables = {}, {}
    for pkg, key in ((JD, "j"), (TD, "t")):
        schemas[key] = {n: _dtype(pkg, t, v) for n, t, v in COLUMNS}
        tables[key] = {n: _host(pkg, v) for n, _, v in COLUMNS}
    for key, pkg in (("j", JD), ("t", TD)):
        schemas[key]["dec"] = pkg.Decimal(65, 30, nullable=True)
        tables[key]["dec"] = [D("12345678901234567890123456789012345.123456789012345678901234567890"),
                              D("-0.000000000000000000000000000001"), None, D(0), D("1.5")]
        schemas[key]["d2"] = pkg.Decimal(12, 2)
        tables[key]["d2"] = [D("0.01"), D("-9999999999.99"), D(0), D("1.50"), D("2")]
        schemas[key]["j"] = dataclasses.replace(pkg.STRING, mysql_json=True)
        tables[key]["j"] = ['{"a": 1}', "[1, 2]", "2", '"x"', "true"]
    return schemas, tables


def _canon_table(t):
    return {n: [canon(v) for v in vals] for n, vals in t.items()}


def test_pytable_round_trip():
    schemas, tables = _tables()
    jblk = JO.pytable_to_block(tables["j"], schemas["j"])
    tblk = TO.pytable_to_block(tables["t"], schemas["t"], "cpu")
    assert tblk.names == jblk.names
    for jc, tc in zip(jblk.columns, tblk.columns):
        assert np.array_equal(tc.data.numpy().view(np.asarray(jc.data).dtype),
                              np.asarray(jc.data)), tc.dtype
        assert (tc.validity is None) == (jc.validity is None)
        if tc.validity is not None:
            assert np.array_equal(tc.validity.numpy(), np.asarray(jc.validity))
        assert tc.dictionary == jc.dictionary
        assert tc.stats == jc.stats and tc.domain == jc.domain, tc.dtype
        if jc.narrow32 is None:
            assert tc.narrow32 is None
        else:   # the reference pads its shadow to the kernel's step
            n = tc.data.shape[0]
            assert np.array_equal(tc.narrow32.numpy(), np.asarray(jc.narrow32)[:n])
    got = _canon_table(TO.block_to_pytable(tblk))
    assert got == _canon_table(JO.block_to_pytable(jblk))
    assert got == _canon_table(tables["t"])


def test_column_from_numpy_vectors_and_big_domains():
    rng = np.random.default_rng(3)
    for pkg_j, pkg_t in ((JD.Vector(4), TD.Vector(4)),):
        vals = [tuple(float(x) for x in rng.normal(size=4)) for _ in range(5)] + [None]
        jc = JB.column_from_numpy(vals, pkg_j.with_nullable(True))
        tc = TB.column_from_numpy(vals, pkg_t.with_nullable(True), device="cpu")
        assert np.array_equal(tc.data.numpy(), np.asarray(jc.data))
        assert np.array_equal(tc.validity.numpy(), np.asarray(jc.validity))
    for hi, has_domain in ((10_000, True), (10 ** 9, False)):
        # 5000 draws: under 4096 distinct values of 10,000, over of 10^9
        big = [int(x) for x in rng.integers(0, hi, 5000)]
        jc = JB.column_from_numpy(big, JD.INT64)
        tc = TB.column_from_numpy(big, TD.INT64, device="cpu")
        assert tc.domain == jc.domain and tc.stats == jc.stats
        assert (jc.domain is not None) == has_domain
    floats = [float(x) for x in rng.normal(size=300)]
    jc = JB.column_from_numpy(floats, JD.FLOAT64)
    tc = TB.column_from_numpy(floats, TD.FLOAT64, device="cpu")
    assert tc.stats == jc.stats and tc.domain == jc.domain


ROW_EXPRS = [
    "i32 + 1", "i64 div 3", "u64 > 5", "f64 * 2", "s like 'b%'", "coalesce(s, 'none')",
    "case when i32 > 0 then 'pos' else 'neg' end", "d2 * 2 + 1", "dec is null",
    "year(d)", "date_add(d, interval 1 day)", "concat(s, '-x')", "length(s)",
    "i32 in (3, 5)", "not (i32 = 3)", "if(b, 1, 0)", "abs(i32)", "round(f32)",
    "substring(s, 1, 1)", "upper(s)",
]


@pytest.mark.parametrize("sql", ROW_EXPRS)
def test_eval_expr_row(sql):
    """The port's copy of the front end's host evaluator, row by row, gives
    the reference's values (or raises as it does)."""
    schemas, tables = _tables()
    expr_j = JR._rewrite(JR.SqlParser(sql).parse_expr())
    expr_t = TR._rewrite(TR.SqlParser(sql).parse_expr())
    for i in range(5):
        rows = {k: {n: tables[k][n][i] for n in tables[k]} for k in ("j", "t")}
        want = got = None
        try:
            want = ("ok", canon(JO.eval_expr_row(expr_j, rows["j"])))
        except Exception as e:
            want = ("raises", type(e).__name__)
        try:
            got = ("ok", canon(TO.eval_expr_row(expr_t, rows["t"])))
        except Exception as e:
            got = ("raises", type(e).__name__)
        assert got == want, (sql, i)


def _deep_case(depth: int) -> str:
    e = "-1"
    for k in range(depth - 1, -1, -1):
        e = f"case when i32 = {k} then {k * 3} else {e} end"
    return e


@pytest.mark.parametrize("sql", [
    "i32 * 2 + 1", "s", "coalesce(s, 'z')", "d2 + 1", "year(d)", _deep_case(100)])
def test_evaluate_expr(sql):
    """``evaluate_expr`` over one block: the same column as the
    reference's (the generated-column path of the session)."""
    schemas, tables = _tables()
    keep = ["i32", "s", "d2", "d"]
    jblk = JO.pytable_to_block({n: tables["j"][n] for n in keep},
                               {n: schemas["j"][n] for n in keep})
    tblk = TO.pytable_to_block({n: tables["t"][n] for n in keep},
                               {n: schemas["t"][n] for n in keep}, "cpu")
    jcol = JC.evaluate_expr(JR._rewrite(JR.SqlParser(sql).parse_expr()), jblk)
    tcol = TC.evaluate_expr(TR._rewrite(TR.SqlParser(sql).parse_expr()), tblk)
    j = JO.block_to_pytable(JB.Block(names=("r",), columns=(jcol,)))["r"]
    t = TO.block_to_pytable(TB.Block(names=("r",), columns=(tcol,)))["r"]
    assert [canon(v) for v in t] == [canon(v) for v in j]
    assert tcol.dtype.kind.name == jcol.dtype.kind.name
