"""Cancellation, deadlines and sync points of the PyTorch port's runner.

Mirrors the runner half of ``tests/test_cancel.py`` and
``tests/test_syncpoint.py`` (their service halves wait for the port's
service): a pre-cancelled runner raises ``QueryCancelled`` as the
reference's does; a query parked at the ``executor.attempt`` sync point
or at a paused failpoint is cancelled from another thread; a flag set
between out-of-core chunks stops the query at the next chunk; the
errors classify as ``CANCELLED``.
"""

import threading
import time

import pytest

from tiflash_tpu.bench.tpch_queries import q6_plan as j_q6
from tiflash_tpu.runtime.cancel import CancelFlag as JFlag, QueryCancelled as JCancelled
from tiflash_tpu.runtime.executor import QueryRunner as JRunner
from tiflash_tpu.storage.tpch import generate_tpch

from torch_runtime_parity import to_port
from tiflash_tpu_torch.bench.tpch_queries import q1_plan, q6_plan
from tiflash_tpu_torch.runtime import errors as TE
from tiflash_tpu_torch.runtime import outofcore as TOC
from tiflash_tpu_torch.runtime.cancel import CancelFlag, QueryCancelled, QueryTimeout
from tiflash_tpu_torch.runtime.executor import QueryRunner
from tiflash_tpu_torch.runtime.failpoint import FailPoint
from tiflash_tpu_torch.runtime.settings import Settings
from tiflash_tpu_torch.runtime.syncpoint import SyncPoint, sync_point


@pytest.fixture(scope="module")
def cat():
    j_tables = generate_tpch(sf=0.001, seed=5, tables=["lineitem"]).blocks()
    return j_tables, to_port(j_tables)


@pytest.fixture(autouse=True)
def _clean():
    yield
    SyncPoint.disable_all()
    FailPoint.disable_all()


def _in_thread(fn):
    out = {}

    def work():
        try:
            out["result"] = fn()
        except BaseException as e:  # noqa: BLE001 - the test inspects it
            out["result"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t, out


def test_runner_pre_cancelled(cat):
    j_tables, t_tables = cat
    flag, jflag = CancelFlag(), JFlag()
    flag.set()
    jflag.set()
    with pytest.raises(JCancelled):
        JRunner(j_q6(), cancel=jflag).run(j_tables)
    with pytest.raises(QueryCancelled) as ei:
        QueryRunner(q6_plan(), cancel=flag).run(t_tables)
    assert TE.classify(ei.value) == TE.CANCELLED


def test_cancel_while_parked_at_attempt(cat):
    """Park the query at ``executor.attempt``, cancel it, release: it
    must end cancelled (the exact interleaving, not a race)."""
    _, t_tables = cat
    flag = CancelFlag()
    with SyncPoint.enable("executor.attempt") as sp:
        t, out = _in_thread(lambda: QueryRunner(q6_plan(), cancel=flag).run(t_tables))
        sp.wait_for_arrival()
        flag.set()
        sp.release()
        t.join(timeout=60)
    assert isinstance(out["result"], QueryCancelled)


def test_cancel_paused_failpoint_from_another_thread(cat):
    """A query paused at ``exception_before_fragment_run`` (the pause
    form) ends cancelled when another thread sets its flag."""
    _, t_tables = cat
    flag = CancelFlag()
    FailPoint.enable("exception_before_fragment_run", pause=True)
    t, out = _in_thread(lambda: QueryRunner(q6_plan(), cancel=flag).run(t_tables))
    deadline = time.monotonic() + 30
    while FailPoint.get("exception_before_fragment_run").hits == 0:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    flag.set()
    t.join(timeout=60)
    assert isinstance(out["result"], QueryCancelled)


def test_cancel_between_out_of_core_chunks(cat, monkeypatch):
    """A flag set after the first chunk of a chunked out-of-core
    aggregate stops the query at the next chunk's checkpoint."""
    _, t_tables = cat
    flag = CancelFlag()
    chunks = []
    real = TOC._to_host_rows

    def first_chunk_then_cancel(block):
        chunks.append(1)
        flag.set()
        return real(block)

    monkeypatch.setattr(TOC, "_to_host_rows", first_chunk_then_cancel)
    from tiflash_tpu_torch.plan import nodes as TP
    from tiflash_tpu_torch.ops.aggregate import AggDesc

    plan = TP.Aggregation(["l_returnflag"], [AggDesc("sum", "l_quantity", "q")],
                          TP.TableScan("lineitem"))
    s = Settings(max_bytes_before_external_group_by=1, max_spilled_rows_per_file=1000)
    with pytest.raises(QueryCancelled):
        QueryRunner(plan, settings=s, cancel=flag).run(t_tables)
    assert chunks == [1]


def test_max_execution_time_in_out_of_core_query(cat):
    """The deadline fires at an out-of-core checkpoint: a Q1 by group
    partitions with a 1 ms limit raises QueryTimeout (a CANCELLED code)."""
    _, t_tables = cat
    s = Settings(max_bytes_before_external_group_by=1, max_execution_time_ms=1)
    with pytest.raises(QueryTimeout) as ei:
        QueryRunner(q1_plan(), settings=s).run(t_tables)
    assert TE.classify(ei.value) == TE.CANCELLED


def test_syncpoint_primitive_park_release():
    hits = []

    def worker():
        hits.append("before")
        sync_point("unit.point")
        hits.append("after")

    with SyncPoint.enable("unit.point") as sp:
        t = threading.Thread(target=worker, daemon=True)
        t.start()
        sp.wait_for_arrival()
        assert hits == ["before"]        # deterministically parked
        sp.release()
        t.join(timeout=10)
        assert hits == ["before", "after"]


def test_syncpoint_disabled_is_noop():
    t0 = time.time()
    sync_point("never.enabled")
    assert time.time() - t0 < 0.5


def test_two_queries_serialize_at_the_attempt_point(cat):
    """Two runners park at ``executor.attempt`` in turn; released one at
    a time, both finish with the same rows (no state shared between
    runners)."""
    _, t_tables = cat
    with SyncPoint.enable("executor.attempt") as sp:
        ta, a = _in_thread(lambda: QueryRunner(q6_plan()).run(t_tables))
        sp.wait_for_arrival()
        tb, b = _in_thread(lambda: QueryRunner(q6_plan()).run(t_tables))
        sp.wait_for_arrival()
        sp.release(2)
        ta.join(timeout=60)
        tb.join(timeout=60)
    assert a["result"][0].to_pylists() == b["result"][0].to_pylists()
