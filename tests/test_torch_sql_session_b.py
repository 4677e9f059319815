"""The SQL front end, port against reference (2 of 4): WHERE, GROUP BY,
HAVING, ORDER BY, LIMIT, DISTINCT, CASE nested 100 deep and constant
SELECTs (``select.test``); inner, left, right, self and cross joins with
ON conditions, equi joins on the engine's Join and non-equi outer joins on
the host nested loop that ``oracle.eval_expr_row`` evaluates
(``joins.test``), and the joins again through the distributed switch.
See ``test_torch_sql_session_a.py`` for what is compared.
"""

from torch_sql_parity import _no_failpoints_left  # noqa: F401
from torch_sql_parity import TR, case_text, expect_clean, run_both


def test_select_script(tmp_path, monkeypatch):
    ref, _, _, _ = run_both(case_text("select.test"), tmp_path, monkeypatch)
    assert len(ref) == 21
    assert expect_clean(ref) == 18
    (deep,) = [r["rows"] for r in ref if r["stmt"].startswith("select a, case when a = 0")]
    assert deep == [[[0, 0], [50, 150], [99, 297], [100, -1]]]


def test_joins_script(tmp_path, monkeypatch):
    ref, _, _, _ = run_both(case_text("joins.test"), tmp_path, monkeypatch)
    assert len(ref) == 19
    assert expect_clean(ref) == 13


def test_joins_take_the_host_loop(monkeypatch):
    """The non-equi outer joins are the ones that reach the host nested
    loop, and it evaluates their ON conditions with the port's
    ``eval_expr_row``."""
    from tiflash_tpu_torch.testing import oracle as O

    calls = []
    real = O.eval_expr_row

    def spy(expr, row):
        calls.append(expr)
        return real(expr, row)

    monkeypatch.setattr(O, "eval_expr_row", spy)
    s = TR.RefTestSession(device="cpu")
    s.run_statement("create table l (a int, b int)", None)
    s.run_statement("create table r (c int, d int)", None)
    s.run_statement("insert into l values (1, 10), (2, 20), (3, NULL)", None)
    s.run_statement("insert into r values (1, 5), (2, 25)", None)
    s.run_statement("select a, c from l join r on a = c order by a",
                    ["a\tc", "1\t1", "2\t2"])
    assert calls == []
    s.run_statement("select a, c from l left join r on b > d order by a, c",
                    ["a\tc", "1\t1", "2\t1", "3\tNULL"])
    # one evaluation of the ON condition per (left, right) pair
    assert sum(getattr(e, "func", None) == "greater" for e in calls) == 6
    assert s.checked == 2


def test_joins_script_distributed(tmp_path, monkeypatch):
    ref, _, jsess, tsess = run_both(case_text("joins.test"), tmp_path, monkeypatch,
                                    distributed=True)
    assert expect_clean(ref) == 13
    assert tsess.distributed_runs == jsess.distributed_runs == 9
