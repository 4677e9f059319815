"""The SQL front end, port against reference (4 of 4): runtime errors as
recorded ERROR lines (plain and ``{#REGEXP}``), errors no table records,
DBGInvoke failpoints that throw before and after the run, a pause past
the alarm and ``hang_in_execution`` (both cancelled by the front end's
0.5 s watchdog, not slept through), and statements outside the surface
(``errors.test``); the subqueries again through the distributed switch;
the ``SOURCE`` statement and ``run_test_file`` on a corpus-shaped tree.
See ``test_torch_sql_session_a.py`` for what is compared.
"""

import time

import pytest

from torch_sql_parity import _no_failpoints_left  # noqa: F401
from torch_sql_parity import TR, case_text, expect_clean, run_both


def test_errors_script(tmp_path, monkeypatch):
    t0 = time.perf_counter()
    ref, port, _, _ = run_both(case_text("errors.test"), tmp_path, monkeypatch)
    assert len(ref) == 34
    checked = expect_clean(
        ref, errors=("where id = 2", "select min(id)", "update e1", "show tables"),
        unsupported=("(select id from e1)", "nosuchfunction", "nosuchtable"))
    assert checked == 14
    assert [r["error"][0] for r in port if r["error"]] == [
        "EngineError", "FailPointError", "Unsupported", "Unsupported"]
    # two watchdog cancels in each package, nothing near the 15 s pause
    assert time.perf_counter() - t0 < 120


def test_subquery_script_distributed(tmp_path, monkeypatch):
    ref, _, jsess, tsess = run_both(case_text("subquery.test"), tmp_path, monkeypatch,
                                    distributed=True)
    assert expect_clean(ref) == 19
    assert tsess.distributed_runs == jsess.distributed_runs == 12


def test_source_and_run_test_file(tmp_path):
    """A ``.test`` file under ``fullstack-test/`` runs through
    ``run_test_file`` on the device named; its SOURCE path is relative to
    the ``tests/`` directory above ``fullstack-test``."""
    root = tmp_path / "tests"
    (root / "fullstack-test" / "expr").mkdir(parents=True)
    (root / "schema").mkdir()
    (root / "schema" / "t.sql").write_text(
        "-- a schema file\ncreate table t (a int, b varchar(4));\n"
        "insert into t values (1, 'x'), (2, 'y');\n")
    f = root / "fullstack-test" / "expr" / "source.test"
    f.write_text("mysql> source schema/t.sql\n"
                 "mysql> select b from t where a = 2\n"
                 "+------+\n| b    |\n+------+\n| y    |\n+------+\n")
    assert TR.tests_root_of(str(f)) == str(root)
    assert TR.run_test_file(str(f), device="cpu") == 1
    with pytest.raises(TR.Unsupported, match="source file missing"):
        TR.RefTestSession(device="cpu").run_statement("source schema/t.sql", None)


def test_limit_and_multi_distinct_under_the_distributed_switch(monkeypatch):
    """Two recorded differences from the reference under
    ``TIFLASH_REFTEST_DISTRIBUTED=1``.  The reference's ``run_query``
    rewrites a LIMIT with ``prune_columns``, which swaps ``Limit``'s
    fields, so a LIMIT over an aggregation is unsupported there; the port
    answers it.  And the reference's ``split_aggregation`` splits
    COUNT(DISTINCT) over two different arguments by hashing rows on both
    (a value then lands on several shards and counts twice); the port
    splits by argument only when there is one, else gathers the rows."""
    from tiflash_tpu.testing import reftest as JR

    monkeypatch.setenv("TIFLASH_REFTEST_DISTRIBUTED", "1")
    stmts = ["create table t (a int, b varchar(4))",
             "insert into t values (1, 'x'), (1, 'y'), (2, 'x'), (3, NULL), (3, 'y')"]
    limit = ("select a, count(*) from t group by a limit 5",
             ["a\tcount(*)", "1\t2", "2\t1", "3\t2"])
    distinct = ("select count(distinct a), count(distinct b) from t",
                ["h1\th2", "3\t2"])
    j, t = JR.RefTestSession(), TR.RefTestSession(device="cpu")
    for s in stmts:
        j.run_statement(s, None)
        t.run_statement(s, None)
    t.run_statement(*limit)
    t.run_statement(*distinct)
    assert t.checked == 2 and not t.unsupported and t.distributed_runs == 2
    j.run_statement(*limit)
    assert "NotImplementedError" in j.unsupported[-1]
    with pytest.raises(AssertionError, match="unmatched row"):
        j.run_statement(*distinct)
