"""The SQL front end, port against reference (1 of 4): DDL of every type
the parser maps (signed and unsigned integers, decimals up to
``decimal(65,30)``, strings, DATE, DATETIME(fsp), TIMESTAMP under
``SET time_zone``, TIME(fsp), JSON, ENUM, YEAR, floats) and the DML
(INSERT ... VALUES / SELECT / SET, generated columns, ALTER TABLE ADD /
MODIFY COLUMN, DELETE, transactions).

Each script of ``tests/sql_cases`` runs through the reference's
``RefTestSession()`` and the port's ``RefTestSession(device="cpu")``
(``torch_sql_parity.run_both``): per statement the same rows, the same
exception (class and message), the same ``checked`` and ``unsupported``;
each recorded table holds in both.
"""

import datetime
from decimal import Decimal

from torch_sql_parity import _no_failpoints_left  # noqa: F401
from torch_sql_parity import TR, case_text, expect_clean, run_both


def test_types_script(tmp_path, monkeypatch):
    ref, _, _, _ = run_both(case_text("types.test"), tmp_path, monkeypatch)
    assert len(ref) == 44
    assert expect_clean(ref) == 22
    # the TIMESTAMP column reads back shifted by the session's zone
    (shifted,) = [r["rows"] for r in ref
                  if r["stmt"] == "set time_zone = '+08:00'; select id, ts, dt from t_ts order by id"]
    assert shifted == [[[1, datetime.datetime(2020, 1, 1, 8), datetime.datetime(2020, 1, 1, 8)],
                        [2, datetime.datetime(2020, 7, 1, 7, 30),
                         datetime.datetime(2020, 6, 30, 23, 30)]]]


def test_dml_script(tmp_path, monkeypatch):
    ref, _, _, _ = run_both(case_text("dml.test"), tmp_path, monkeypatch)
    assert len(ref) == 32
    checked = expect_clean(
        ref, errors=("insert into dst values ('x'",),
        unsupported=("select count(*) from dst",))
    assert checked == 11
    # INSERT ... SELECT read its rows back from the engine
    assert [r["rows"] for r in ref if r["stmt"].startswith("insert into dst select")] == [
        [[["a", Decimal("4.50"), 3, 30], ["b", Decimal("3.00"), 2, 50],
          ["c", Decimal("-4.00"), 1, None], ["d", None, 1, None]]]]


def test_session_results_and_device():
    """``results`` holds each SELECT's rows; the session runs on the
    device it is given and nowhere else."""
    s = TR.RefTestSession(device="cpu")
    assert str(s.device) == "cpu"
    s.run_statement("create table t (a int, b decimal(10,2))", None)
    s.run_statement("insert into t values (1, 2.50), (2, NULL)", None)
    s.run_statement("select a, b from t order by a", ["a\tb", "1\t2.50", "2\tNULL"])
    s.run_statement("select a from t where a > 5", None)
    assert s.checked == 2 and not s.unsupported
    assert s.results == [[[1, Decimal("2.50")], [2, None]], []]
    assert TR.RefTestSession().device.type == "cuda"
