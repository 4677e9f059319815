"""Helpers of the SQL front end's parity tests (``tests/test_torch_sql_*.py``):
one ``.test``-format script through the reference's ``RefTestSession()``
and the port's ``RefTestSession(device="cpu")``, compared statement by
statement.

A script is the corpus's text: ``mysql> <statement>`` lines, each
followed by its recorded table where the answer is plain by hand (both
sessions check it), and ``=> DBGInvoke __enable_fail_point(...)`` lines.
``parse_test_file`` of both packages splits it; the two splits must be
equal.  For each statement the record holds the exception (class name,
message), the statement's ``checked`` and ``unsupported`` increments, and
every row set the session read back from the engine (``_block_rows``,
spied in both modules: a SELECT's rows, an INSERT ... SELECT's rows).
One session per script: each reference statement is a JAX compile.
"""

import datetime
import pathlib
from decimal import Decimal

import pytest

from tiflash_tpu.runtime.failpoint import FailPoint as JFailPoint
from tiflash_tpu.testing import reftest as JR

from tiflash_tpu_torch.runtime.failpoint import FailPoint as TFailPoint
from tiflash_tpu_torch.testing import reftest as TR

CASES_DIR = pathlib.Path(__file__).parent / "sql_cases"


def canon(v):
    """A value comparable across the packages: each package's own
    temporal classes (``ZeroDate``, ``CivilDateTime`` ...) become (class
    name, text); python's values stay as they are."""
    if type(v).__module__.startswith(("tiflash_tpu.", "tiflash_tpu_torch.")):
        return (type(v).__name__, str(v))
    assert v is None or isinstance(v, (bool, int, float, str, Decimal,
                                       datetime.date, datetime.datetime)), type(v)
    return v


def parse_script(text: str, tmp_path, name: str = "script.test"):
    """Both packages' ``parse_test_file`` of ``text``; they must agree."""
    path = tmp_path / name
    path.write_text(text)
    ref = JR.parse_test_file(str(path))
    port = TR.parse_test_file(str(path))
    assert port == ref
    return ref


def run_session(module, session, statements, monkeypatch) -> list:
    """Run ``statements`` through ``session`` of ``module``; one record per
    statement."""
    seen = []
    real = module._block_rows

    def spy(block):
        rows = real(block)
        seen.append([[canon(v) for v in r] for r in rows])
        return rows

    monkeypatch.setattr(module, "_block_rows", spy)
    records = []
    for stmt, expected in statements:
        seen.clear()
        checked, unsupported = session.checked, len(session.unsupported)
        error = None
        try:
            session.run_statement(stmt, expected)
        except Exception as e:  # the record holds it; the caller compares
            error = (type(e).__name__, str(e))
        records.append({"stmt": stmt, "error": error,
                        "checked": session.checked - checked,
                        "unsupported": session.unsupported[unsupported:],
                        "rows": list(seen)})
    monkeypatch.setattr(module, "_block_rows", real)
    return records


def run_both(text: str, tmp_path, monkeypatch, distributed: bool = False):
    """The script through both sessions.  Returns (reference records, port
    records, reference session, port session) after asserting the
    records equal statement by statement.  ``distributed`` sets
    ``TIFLASH_REFTEST_DISTRIBUTED=1`` for both."""
    statements = parse_script(text, tmp_path)
    if distributed:
        monkeypatch.setenv("TIFLASH_REFTEST_DISTRIBUTED", "1")
    try:
        jsess = JR.RefTestSession()
        ref = run_session(JR, jsess, statements, monkeypatch)
        JFailPoint.disable_all()
        tsess = TR.RefTestSession(device="cpu")
        port = run_session(TR, tsess, statements, monkeypatch)
    finally:
        JFailPoint.disable_all()
        TFailPoint.disable_all()
    assert len(ref) == len(port) == len(statements)
    for r, p in zip(ref, port):
        assert p == r, f"statement differs: {r['stmt'][:200]}\nref:  {r}\nport: {p}"
    assert tsess.checked == jsess.checked
    assert tsess.unsupported == jsess.unsupported
    assert tsess.distributed_runs == getattr(jsess, "distributed_runs", 0)
    return ref, port, jsess, tsess


def expect_clean(records, errors=(), unsupported=()) -> int:
    """Each statement raised exactly when its text contains one of
    ``errors``, and recorded an unsupported entry exactly when it contains
    one of ``unsupported``.  Returns the number of checked queries."""
    for r in records:
        assert (r["error"] is not None) == any(e in r["stmt"] for e in errors), r
        assert bool(r["unsupported"]) == any(u in r["stmt"] for u in unsupported), r
    return sum(r["checked"] for r in records)


def case_text(name: str) -> str:
    """A script of ``tests/sql_cases``."""
    return (CASES_DIR / name).read_text()


@pytest.fixture(autouse=True)
def _no_failpoints_left():
    yield
    JFailPoint.disable_all()
    TFailPoint.disable_all()


__all__ = ["canon", "parse_script", "run_session", "run_both", "expect_clean",
           "case_text", "CASES_DIR"]
