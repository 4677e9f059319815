"""Cancellation, deadlines and sync points of the PyTorch port's runner
and service.

Mirrors ``tests/test_cancel.py`` and ``tests/test_syncpoint.py``: a
pre-cancelled runner raises ``QueryCancelled`` as the reference's does; a
query parked at the ``executor.attempt`` sync point or at a paused
failpoint is cancelled from another thread; a flag set between
out-of-core chunks stops the query at the next chunk; the errors classify
as ``CANCELLED``.  The service halves run the port's ``QueryService`` on
``device="cpu"``: a running (failpoint-paused) query is cancelled over
HTTP and frees its admission slot, a QUEUED query is cancelled before it
takes one, a cancelled synchronous request answers 499, and the
service's sync points pin cancel-while-running, cancel-while-queued and
the admission queue; each finished query's rows equal the reference's.
"""

import threading
import time

import pytest

from tiflash_tpu.bench.tpch_queries import q6_plan as j_q6
from tiflash_tpu.runtime.cancel import CancelFlag as JFlag, QueryCancelled as JCancelled
from tiflash_tpu.runtime.executor import QueryRunner as JRunner
from tiflash_tpu.storage.tpch import generate_tpch

from torch_runtime_parity import to_port
from tiflash_tpu_torch.mpp.service import QueryService, serve_background
from tiflash_tpu_torch.plan import serde
from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate
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


# ---- the service halves (tests/test_cancel.py:65-147,
# tests/test_syncpoint.py:71-136) --------------------------------------

@pytest.fixture(scope="module")
def service_cat():
    """The reference tests' catalog (SF 0.001, seed 5) in the port, and
    the reference's Q1/Q6 rows on it."""
    j_tables = generate_tpch(sf=0.001, seed=5).blocks()
    from tiflash_tpu.bench.tpch_queries import q1_plan as j_q1

    want = {"q1": JRunner(j_q1()).run(j_tables)[0].to_pylists(),
            "q6": JRunner(j_q6()).run(j_tables)[0].to_pylists()}
    return t_generate(sf=0.001, seed=5), want


@pytest.fixture()
def server(service_cat):
    svc = QueryService(service_cat[0], mesh=None, max_concurrency=1, device="cpu")
    httpd, port = serve_background(svc)
    yield f"http://127.0.0.1:{port}"
    FailPoint.disable_all()
    httpd.shutdown()


def _post(url, path, obj):
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    import json
    import urllib.request

    with urllib.request.urlopen(url + path) as r:
        return r.status, json.loads(r.read())


def _wait_state(url, qid, states, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        _, res = _get(url, f"/result?id={qid}")
        if res["state"] in states:
            return res
        time.sleep(0.02)
    raise AssertionError(f"query {qid} never reached {states}: {res}")


def test_cancel_running_query_frees_slot(server, service_cat):
    plan_json = serde.plan_to_json(q6_plan())
    # stall the query inside the runner (the failpoint's pause form)
    code, _ = _post(server, "/failpoint",
                    {"name": "exception_before_fragment_run", "action": "pause"})
    assert code == 200
    _, sub = _post(server, "/query", {"plan": plan_json, "async": True})
    qid = sub["query_id"]
    _wait_state(server, qid, ("RUNNING",))
    code, res = _post(server, "/cancel", {"query_id": qid})
    assert code == 200 and res["ok"]
    res = _wait_state(server, qid, ("CANCELLED",))
    assert "error" in res and "cancel" in res["error"].lower()
    # the admission slot is free again: a normal query runs to completion
    _post(server, "/failpoint",
          {"name": "exception_before_fragment_run", "action": "disable"})
    code, res = _post(server, "/query", {"plan": plan_json})
    assert code == 200 and res["columns"] == service_cat[1]["q6"]


def test_cancel_queued_query(server):
    plan_json = serde.plan_to_json(q6_plan())
    _post(server, "/failpoint",
          {"name": "exception_before_fragment_run", "action": "pause"})
    _, sub1 = _post(server, "/query", {"plan": plan_json, "async": True})
    _wait_state(server, sub1["query_id"], ("RUNNING",))
    # the second query waits on the (size-1) admission semaphore
    _, sub2 = _post(server, "/query", {"plan": plan_json, "async": True})
    q2 = sub2["query_id"]
    time.sleep(0.2)
    _, res = _get(server, f"/result?id={q2}")
    assert res["state"] == "QUEUED"
    code, res = _post(server, "/cancel", {"query_id": q2})
    assert code == 200 and res["ok"]
    _wait_state(server, q2, ("CANCELLED",))
    # clean up the paused first query
    _post(server, "/cancel", {"query_id": sub1["query_id"]})
    _wait_state(server, sub1["query_id"], ("CANCELLED",))


def test_cancel_unknown_id(server):
    code, res = _post(server, "/cancel", {"query_id": 99999})
    assert code == 200 and not res["ok"]


def test_sync_query_cancelled_returns_499(server):
    plan_json = serde.plan_to_json(q6_plan())
    _post(server, "/failpoint",
          {"name": "exception_before_fragment_run", "action": "pause"})
    t, out = _in_thread(lambda: _post(server, "/query", {"plan": plan_json}))
    # wait until it registers as RUNNING, then cancel via the process list
    t0 = time.time()
    qid = None
    while time.time() - t0 < 30:
        _, qs = _get(server, "/queries")
        running = [q for q in qs["queries"] if q["state"] == "RUNNING"]
        if running:
            qid = running[-1]["id"]
            break
        time.sleep(0.02)
    assert qid is not None
    _post(server, "/cancel", {"query_id": qid})
    t.join(timeout=30)
    assert not t.is_alive()
    code, res = out["result"]
    assert code == 499 and res["kind"] == "cancelled"
    assert res["code_name"] == "CANCELLED"


def _submit(svc, results, key):
    plan = serde.plan_to_json(q1_plan())

    def work():
        try:
            results[key] = svc.execute(plan)
        except Exception as e:  # noqa: BLE001 - the test inspects it
            results[key] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t


def test_cancel_while_running_deterministic(service_cat):
    """Park the query at the RUNNING transition, cancel it, release: it
    must finish CANCELLED."""
    svc = QueryService(service_cat[0], mesh=None, max_concurrency=2, device="cpu")
    results = {}
    with SyncPoint.enable("service.query.running") as sp:
        t = _submit(svc, results, "q")
        sp.wait_for_arrival()
        qs = svc.queries()["queries"]
        assert qs[-1]["state"] == "RUNNING"
        svc.cancel(qs[-1]["id"])
        sp.release()
        t.join(timeout=60)
    assert isinstance(results["q"], QueryCancelled)
    assert svc.queries()["queries"][-1]["state"] == "CANCELLED"


def test_cancel_while_queued_deterministic(service_cat):
    """With the one admission slot held by a parked query, a second query
    is QUEUED; cancelling it frees it without running."""
    svc = QueryService(service_cat[0], mesh=None, max_concurrency=1, device="cpu")
    results = {}
    with SyncPoint.enable("service.query.running") as sp:
        ta = _submit(svc, results, "a")
        sp.wait_for_arrival()          # A holds the only slot, parked
        tb = _submit(svc, results, "b")
        deadline = time.time() + 30    # B must register as QUEUED
        while time.time() < deadline:
            qs = {q["id"]: q["state"] for q in svc.queries()["queries"]}
            if len(qs) == 2 and list(qs.values())[1] == "QUEUED":
                break
            time.sleep(0.01)
        qs = svc.queries()["queries"]
        assert qs[-1]["state"] == "QUEUED"
        svc.cancel(qs[-1]["id"])
        tb.join(timeout=30)
        assert isinstance(results["b"], QueryCancelled)
        assert svc.queries()["queries"][-1]["state"] == "CANCELLED"
        sp.release()                   # A proceeds to completion
        ta.join(timeout=120)
    assert not isinstance(results["a"], Exception)
    assert results["a"]["columns"] == service_cat[1]["q1"]
    assert svc.queries()["queries"][0]["state"] == "FINISHED"


def test_admission_fifo_under_park(service_cat):
    """Two queued queries behind a parked one both complete after release
    (the slot is recycled; no slot leaks)."""
    svc = QueryService(service_cat[0], mesh=None, max_concurrency=1, device="cpu")
    results = {}
    with SyncPoint.enable("service.query.running") as sp:
        ta = _submit(svc, results, "a")
        sp.wait_for_arrival()
        tb = _submit(svc, results, "b")
        tc = _submit(svc, results, "c")
        sp.release(3)                  # a continues; b and c will not re-park
        for t in (ta, tb, tc):
            t.join(timeout=120)
    for k in ("a", "b", "c"):
        assert not isinstance(results[k], Exception), results[k]
        assert results[k]["columns"] == service_cat[1]["q1"]
    assert [q["state"] for q in svc.queries()["queries"]] == ["FINISHED"] * 3
