"""The SQL front end, port against reference (3 of 4): IN, NOT IN,
EXISTS, scalar, quantified (ANY/ALL) and correlated subqueries, derived
tables and row-constructor IN (``subquery.test``); windows, ROLLUP with
GROUPING(), UNION / UNION ALL, a CTE and recursive CTEs
(``analytic.test``), and the windows again through the distributed
switch.  See ``test_torch_sql_session_a.py`` for what is compared.
"""

from torch_sql_parity import _no_failpoints_left  # noqa: F401
from torch_sql_parity import case_text, expect_clean, run_both


def test_subquery_script(tmp_path, monkeypatch):
    ref, _, _, _ = run_both(case_text("subquery.test"), tmp_path, monkeypatch)
    assert len(ref) == 25
    assert expect_clean(ref) == 19


def test_analytic_script(tmp_path, monkeypatch):
    ref, _, _, _ = run_both(case_text("analytic.test"), tmp_path, monkeypatch)
    assert len(ref) == 16
    assert expect_clean(ref) == 13
    (fib,) = [r["rows"] for r in ref if "recursive fib" in r["stmt"]]
    assert [v for (v,) in fib[0]] == [0, 1, 1, 2, 3, 5, 8, 13, 21, 34]


def test_analytic_script_distributed(tmp_path, monkeypatch):
    ref, _, jsess, tsess = run_both(case_text("analytic.test"), tmp_path, monkeypatch,
                                    distributed=True)
    assert expect_clean(ref) == 13
    assert tsess.distributed_runs == jsess.distributed_runs == 6
