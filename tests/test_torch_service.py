"""The PyTorch port's query service against the JAX package's.

Mirrors ``tests/test_service.py`` case for case, with both packages'
services answering over HTTP on the same TPC-H tables (``generate_tpch``
at SF 0.001, seed 5, in each package): every result's ``columns`` equal
the reference service's, status codes and error payloads are the
reference's.  The port's service runs on ``device="cpu"`` here.  Two
cases differ: the reference's mesh case becomes one asserting that a
``mesh`` raises naming the distribution slice and that
``"distributed": true`` without one returns the single-device rows (as
the reference's service does when its mesh is None); the metrics-family
case runs the spilled aggregation only, and the two families only a mesh
moves (laned windows, runtime filters) must be present, not nonzero.
"""

import concurrent.futures as cf
import json
import tempfile
import urllib.error
import urllib.request

import numpy as np
import pytest

from tiflash_tpu.bench import tpch_queries as JQ
from tiflash_tpu.mpp.service import QueryService as JService
from tiflash_tpu.mpp.service import serve_background as j_serve
from tiflash_tpu.plan import serde as JS
from tiflash_tpu.storage.tpch import generate_tpch as j_generate

from tiflash_tpu_torch.bench.tpch_queries import q1_plan, q3_plan, q6_plan
from tiflash_tpu_torch.mpp.service import QueryService, serve_background
from tiflash_tpu_torch.plan import serde
from tiflash_tpu_torch.runtime.executor import run_query
from tiflash_tpu_torch.runtime.failpoint import FailPoint
from tiflash_tpu_torch.storage.tpch import generate_tpch


@pytest.fixture(scope="module")
def cat():
    return generate_tpch(sf=0.001, seed=5)


@pytest.fixture(scope="module")
def server(cat):
    svc = QueryService(cat, mesh=None, device="cpu")
    httpd, port = serve_background(svc)
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()
    FailPoint.disable_all()


@pytest.fixture(scope="module")
def jserver():
    httpd, port = j_serve(JService(j_generate(sf=0.001, seed=5), mesh=None))
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()


def _post(url, path, obj):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    with urllib.request.urlopen(url + path) as r:
        return r.status, json.loads(r.read())


def _same_query(server, jserver, plan_json, **extra):
    """Send one request to both services: same code, same columns."""
    code, resp = _post(server, "/query", {"plan": plan_json, **extra})
    jcode, jresp = _post(jserver, "/query", {"plan": plan_json, **extra})
    assert code == jcode == 200, (resp, jresp)
    assert resp["columns"] == jresp["columns"]
    assert resp["summary"]["rows"] == jresp["summary"]["rows"]
    return resp


@pytest.mark.parametrize("mk", [q1_plan, q3_plan])
def test_serde_roundtrip_executes_identically(cat, mk):
    plan = mk()
    s = serde.dumps(plan)
    assert json.loads(s) == json.loads(JS.dumps(getattr(JQ, mk.__name__)()))
    blocks = cat.blocks("cpu")
    a, _ = run_query(plan, blocks)
    b, _ = run_query(serde.loads(s), blocks)
    assert a.to_pylists() == b.to_pylists()


def test_http_query(server, jserver):
    resp = _same_query(server, jserver, serde.plan_to_json(q1_plan()))
    assert resp["summary"]["rows"] == len(resp["columns"]["l_returnflag"])
    assert resp["summary"]["rows"] >= 3
    assert resp["summary"]["backend"] == "cpu" and resp["summary"]["devices"] == 1


def test_http_status_metrics(server, jserver):
    code, st = _get(server, "/status")
    _, jst = _get(jserver, "/status")
    assert code == 200 and st["tables"] == jst["tables"]
    assert st["backend"] == "cpu" and st["devices"] == 1
    assert st["distributed"] is False and st["memory"] == {}
    _post(server, "/query", {"plan": serde.plan_to_json(q6_plan())})
    code, m = _get(server, "/metrics")
    assert code == 200 and m["queries_total"] >= 1


def test_http_bad_plan(server, jserver):
    code, resp = _post(server, "/query", {"plan": {"exec": "Nonsense"}})
    jcode, jresp = _post(jserver, "/query", {"plan": {"exec": "Nonsense"}})
    assert code == jcode and code in (400, 500)
    assert "error" in resp and resp["code"] == jresp["code"]


def test_http_failpoint(server, jserver):
    name = "exception_before_fragment_run"
    try:
        code, _ = _post(server, "/failpoint", {"name": name, "action": "enable"})
        assert code == 200
        code, resp = _post(server, "/query", {"plan": serde.plan_to_json(q1_plan())})
        assert code == 500 and resp.get("kind") == "failpoint"
        assert resp["code_name"] == "FAILPOINT"
    finally:
        _post(server, "/failpoint", {"name": name, "action": "disable"})
    _same_query(server, jserver, serde.plan_to_json(q1_plan()))


def test_http_query_registry(server):
    code, resp = _post(server, "/query", {"plan": serde.plan_to_json(q1_plan())})
    assert code == 200 and "query_id" in resp
    code, q = _get(server, "/queries")
    assert code == 200
    states = {e["id"]: e["state"] for e in q["queries"]}
    assert states[resp["query_id"]] == "FINISHED"
    code, r = _get(server, f"/result?id={resp['query_id']}")
    assert code == 200 and r["state"] == "FINISHED"


def test_http_system_tables(server, jserver):
    plan = {"exec": "TableScan", "table": "system_tables", "columns": None}
    resp = _same_query(server, jserver, plan)
    assert "lineitem" in resp["columns"]["table"]
    plan = {"exec": "TableScan", "table": "system_settings", "columns": None}
    _same_query(server, jserver, plan)
    plan = {"exec": "Selection",
            "cond": {"expr": "call", "func": "like",
                     "args": [{"expr": "col", "name": "name"},
                              {"expr": "lit", "value": "queries%"}]},
            "child": {"exec": "TableScan", "table": "system_metrics", "columns": None}}
    code, resp = _post(server, "/query", {"plan": plan})
    assert code == 200 and len(resp["columns"]["name"]) >= 1
    assert all(n.startswith("queries") for n in resp["columns"]["name"])


def test_http_concurrent_queries(server, jserver):
    """Admission-bounded concurrent execution: every result equals the
    plan's lone result, and the reference's."""
    plans = {"q1": q1_plan(), "q3": q3_plan(), "q6": q6_plan()}
    lone = {k: _same_query(server, jserver, serde.plan_to_json(p))["columns"]
            for k, p in plans.items()}

    def one(i):
        k = list(plans)[i % 3]
        code, resp = _post(server, "/query", {"plan": serde.plan_to_json(plans[k])})
        return k, code, resp["columns"]

    with cf.ThreadPoolExecutor(8) as ex:
        results = list(ex.map(one, range(12)))
    assert all(code == 200 for _, code, _ in results)
    assert all(cols == lone[k] for k, _, cols in results)


def test_service_distributed_mesh(cat, server, jserver):
    """A mesh raises naming the distribution slice; without one,
    ``"distributed": true`` runs on the one device and returns the
    single-device rows, as the reference's service does."""
    with pytest.raises(NotImplementedError, match="distribution slice"):
        QueryService(cat, mesh=object(), device="cpu")
    plan = serde.plan_to_json(q1_plan())
    resp = _same_query(server, jserver, plan, distributed=True)
    assert resp["summary"]["devices"] == 1
    _, single = _post(server, "/query", {"plan": plan})
    assert resp["columns"] == single["columns"]


def test_error_codes(server, jserver):
    """Errors carry stable registry codes, the reference's."""
    bad = {"plan": {"node": "TableScan", "table": "nope"}}
    code, resp = _post(server, "/query", bad)
    jcode, jresp = _post(jserver, "/query", bad)
    assert code == jcode and code in (400, 500)
    assert resp["code"] == jresp["code"] and resp["code_name"] == jresp["code_name"]
    from tiflash_tpu_torch.runtime import errors as E
    from tiflash_tpu_torch.runtime.cancel import QueryCancelled
    from tiflash_tpu_torch.runtime.memory import MemoryLimitError

    assert E.classify(QueryCancelled("x")) == E.CANCELLED
    assert E.classify(MemoryLimitError("x")) == E.MEMORY_LIMIT
    assert E.classify(NotImplementedError("x")) == E.UNSUPPORTED
    assert E.error_name(E.CANCELLED) == "CANCELLED"


def test_http_log_search(server):
    """/logs greps the in-memory ring of records."""
    _post(server, "/query", {"plan": serde.plan_to_json(q1_plan())})
    code, _ = _get(server, "/logs?q=query+done&limit=5")
    assert code == 200
    code, resp = _get(server, "/logs?q=done&level=INFO&limit=5")
    assert code == 200
    assert any("done" in r["message"] for r in resp["logs"])
    try:
        code, _ = _get(server, "/logs?q=[bad")
    except urllib.error.HTTPError as e:
        code = e.code
    assert code == 400


def test_http_per_request_settings_override(server, jserver):
    """Per-request settings steer one query and leave the service's alone;
    unknown names answer 400 at submit, sync and async."""
    plan = serde.plan_to_json(q1_plan())
    code, _ = _post(server, "/query", {"plan": plan,
                                       "settings": {"max_execution_time_ms": "1"}})
    assert code in (200, 499, 500)
    code2, resp2 = _post(server, "/query", {"plan": plan})
    assert code2 == 200 and resp2["summary"]["rows"] >= 1
    code3, resp3 = _post(server, "/query", {"plan": plan,
                                            "settings": {"no_such_setting": 1}})
    assert code3 == 400 and "no_such_setting" in resp3["error"]
    code4, _ = _post(server, "/query", {"plan": plan, "async": True,
                                        "settings": {"nope": 1}})
    assert code4 == 400
    # a real override steers execution: the grace join, the same rows
    resp5 = _same_query(server, jserver, serde.plan_to_json(q3_plan()),
                        settings={"max_bytes_before_external_join": 1,
                                  "enable_spill": True},
                        distributed=False)
    assert resp5["summary"]["rows"] >= 1


def test_metrics_families_after_spilled_and_distributed_query(server):
    """After a spilled out-of-core aggregation the families its runs move
    are nonzero on /metrics; every documented family is present."""
    import tiflash_tpu_torch.core.dtypes as dt
    from tiflash_tpu_torch.core.block import Block
    from tiflash_tpu_torch.ops.aggregate import AggDesc
    from tiflash_tpu_torch.plan import nodes as P
    from tiflash_tpu_torch.runtime.settings import Settings
    from tiflash_tpu_torch.storage.catalog import column_from_arrays

    rng = np.random.default_rng(3)
    n = 40_000
    tables = {"t": Block.from_dict({
        "g": column_from_arrays(rng.integers(0, 1 << 30, n) % 512, dt.INT64),
        "v": column_from_arrays(rng.integers(-50, 50, n), dt.INT64)})}
    plan = P.Aggregation(["g"], [AggDesc("sum", "v", "s")], P.TableScan("t"))
    with tempfile.TemporaryDirectory() as td:
        run_query(plan, tables,
                  settings=Settings(max_bytes_before_external_group_by=50_000, spill_dir=td))
    _post(server, "/query", {"plan": serde.plan_to_json(q1_plan())})
    code, m = _get(server, "/metrics")
    assert code == 200
    for family in ("queries_total", "ooc_chunks_total", "spill_parts_total",
                   "spill_bytes_total", "rows_returned_total", "query_seconds_total"):
        assert m.get(family, 0) > 0, (family, m)
    for family in ("compile_seconds_total", "fragments_compiled_total",
                   "laned_windows_planned_total", "ooc_grace_joins_total",
                   "ooc_host_merges_total", "runtime_filters_published_total",
                   "admission_waits_total", "queries_cancelled_total"):
        assert family in m, family
