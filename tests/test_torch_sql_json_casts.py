"""The reference's JSON cast signature pins (``tests/test_json_casts.py``:
CastXAsJson / CastJsonAsX and JsonValidJsonSig against hard-coded
MySQL/TiDB answers), loaded from that file and run through the port's
``RefTestSession(device="cpu")`` with the same table, the same statements
and the same recorded answers."""

import pytest

import test_json_casts as J

from tiflash_tpu_torch.runtime.errors import EngineError
from tiflash_tpu_torch.testing.reftest import RefTestSession

SETUP = [
    "create table tj (j json, i bigint, u bigint unsigned, r double,"
    " d decimal(10,2), s varchar(30), t datetime, du time(3))",
    "insert into tj values ('{\"a\": [1, 2]}', -5,"
    " 18446744073709551615, 1.5, 3.25, '[true, null]',"
    " '2020-01-02 03:04:05', '12:30:00.250')",
]


def _session():
    s = RefTestSession(device="cpu")
    for stmt in SETUP:
        s.run_statement(stmt, None)
    return s


def test_setup_is_the_references():
    """The port runs the reference test's own table: its session's
    statements are these."""
    seen = []

    class Recorder:
        def run_statement(self, sql, expected):
            seen.append(sql)

    real = J.RefTestSession
    J.RefTestSession = Recorder
    try:
        J._session()
    finally:
        J.RefTestSession = real
    assert seen == SETUP


@pytest.mark.parametrize("sig,sql,want", J.CASES, ids=[c[0] for c in J.CASES])
def test_json_cast_signature(sig, sql, want):
    s = _session()
    s.run_statement(sql, ["h"] + ["\t".join(r) for r in want])
    assert s.checked == 1 and not s.unsupported, (sig, s.unsupported)


def test_cast_invalid_text_as_json_errors_per_row():
    s = _session()
    s.run_statement("insert into tj values (NULL, 0, 0, 0, 0,"
                    " 'not json', '2020-01-01', '00:00:00')", None)
    with pytest.raises(EngineError, match="Invalid JSON text"):
        s.run_statement("select cast(s as json) from tj", ["h"])
