"""The port's request spans (``runtime/tracing.py``).

The recorder on its own: off it hands out one shared no-op and records
nothing; spans nest through the context, share their request's query
id and land in a bounded ring; an op span's event pair resolves into
``device_ms``.  Through the HTTP service on the CPU: one ``/query``
gives the tree of service, runner and operator spans, its children
cover the request, and with tracing off no span object, clock reading or
CUDA event is made.  ``Block.pylists_bytes`` counts what ``to_pylists``
reads on a block with dead rows, and a kernel build counts in the
compile families of ``METRICS``.
"""

import json
import statistics
import sys
import time
import urllib.request

import pytest
import torch

from tiflash_tpu_torch.bench.tpch_queries import q1_plan, q3_plan
from tiflash_tpu_torch.core import dtypes as dt
from tiflash_tpu_torch.core.block import Block, Column
from tiflash_tpu_torch.mpp.mesh import cpu_mesh
from tiflash_tpu_torch.mpp.service import QueryService, serve_background
from tiflash_tpu_torch.ops.cuda import build
from tiflash_tpu_torch.plan import serde
from tiflash_tpu_torch.runtime import tracing
from tiflash_tpu_torch.runtime.executor import run_query
from tiflash_tpu_torch.runtime.logging import query_context
from tiflash_tpu_torch.runtime.metrics import METRICS
from tiflash_tpu_torch.storage.tpch import generate_tpch


@pytest.fixture
def spans():
    """Tracing on for the test; off and drained after it."""
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


@pytest.fixture(scope="module")
def cat():
    return generate_tpch(sf=0.001, seed=5)


@pytest.fixture(scope="module")
def server(cat):
    httpd, port = serve_background(QueryService(cat, device="cpu"))
    yield port
    httpd.shutdown()
    httpd.server_close()


def _query(port, plan):
    body = json.dumps({"plan": json.loads(serde.dumps(plan))}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/query", body,
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        assert r.status == 200
        return json.loads(r.read())


@pytest.fixture
def off():
    """Tracing off, whatever an earlier import in the process did."""
    tracing.disable()
    tracing.drain()


def test_off_is_the_shared_noop_and_records_nothing(off):
    sp = tracing.span("x", a=1)
    assert sp is tracing.NO_SPAN and tracing.op_span("Sort", "Sort_1", {}) is sp
    with sp as inner:
        inner.set(b=2)
    assert not sp
    assert tracing.drain() == []


def test_nesting_sets_parents(spans):
    with tracing.span("a") as a:
        with tracing.span("b") as b:
            with tracing.span("c"):
                pass
        with tracing.span("d", k=3) as d:
            d.set(rows=7)
    got = {s["name"]: s for s in tracing.drain()}
    assert [s for s in got] == ["c", "b", "d", "a"]   # in the order they closed
    assert got["a"]["parent_id"] is None
    assert got["b"]["parent_id"] == got["d"]["parent_id"] == a.span_id
    assert got["c"]["parent_id"] == b.span_id
    assert got["d"]["attrs"] == {"k": 3, "rows": 7}
    assert got["a"]["start_ns"] <= got["b"]["start_ns"] <= got["c"]["start_ns"] \
        <= got["c"]["end_ns"] <= got["b"]["end_ns"] <= got["d"]["start_ns"] \
        <= got["d"]["end_ns"] <= got["a"]["end_ns"]
    assert len({s["thread_id"] for s in got.values()}) == 1


def test_one_requests_spans_share_its_query_id(spans):
    # the root and the span before the id is known take it from the
    # first descendant that saw it
    with tracing.span("request"):
        with tracing.span("decode"):
            pass
        with query_context(41):
            with tracing.span("run"):
                with tracing.span("op"):
                    pass
        with tracing.span("result"):
            pass
    with query_context(42), tracing.span("other"):
        pass
    got = {s["name"]: s["query_id"] for s in tracing.drain()}
    assert got == {"decode": 41, "op": 41, "run": 41, "result": 41, "request": 41,
                   "other": 42}


def test_ring_stays_bounded():
    tracing.enable(capacity=4)
    try:
        for i in range(10):
            with tracing.span(f"s{i}"):
                pass
        assert [s["name"] for s in tracing.drain()] == ["s6", "s7", "s8", "s9"]
        assert tracing.drain() == []
    finally:
        tracing.disable()


class _Event:
    """A CUDA event's surface, on a fake clock."""

    clock = 0.0

    def record(self):
        _Event.clock += 2.5
        self.t = _Event.clock

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_marks_resolve_into_device_ms(spans):
    outer, inner = tracing.Span("op.Sort", {}), tracing.Span("op.TableScan", {})
    outer.events = (_Event(), _Event())
    inner.events = (_Event(), _Event())
    with outer:
        with inner:
            pass
    tracing.resolve_device()
    assert outer.events is None and inner.events is None
    got = {s["name"]: s["attrs"]["device_ms"] for s in tracing.drain()}
    assert got == {"op.TableScan": 2.5, "op.Sort": 7.5}
    tracing.resolve_device()   # nothing left to resolve


def _tree(spans_):
    by_id = {s["span_id"]: s for s in spans_}

    def depth(s):
        d = 0
        while s["parent_id"] is not None:
            s, d = by_id[s["parent_id"]], d + 1
        return d

    return by_id, depth


def _until_request_closed(timeout_s=10.0):
    """The ring's spans once the handler thread has closed its request
    span, which it does just after writing the reply."""
    got, deadline = [], time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got += tracing.drain()
        if any(s["name"] == "service.request" for s in got):
            return got
        time.sleep(0.001)
    raise AssertionError("no service.request span closed")


def test_one_query_gives_the_request_tree(server, spans):
    plan = q3_plan()
    _query(server, plan)   # warm
    _until_request_closed()   # the warm-up's request span, closed after its reply
    covers = []
    for _ in range(3):
        t_send = time.monotonic_ns()
        _query(server, plan)
        t_done = time.monotonic_ns()
        got = _until_request_closed()
        by_id, depth = _tree(got)
        root, = [s for s in got if s["name"] == "service.request"]
        # the handler closes the request span just after writing the reply,
        # which the client may have read by then
        assert root["parent_id"] is None and t_send <= root["start_ns"] <= t_done
        kids = [s for s in got if s["parent_id"] == root["span_id"]]
        assert [s["name"] for s in sorted(kids, key=lambda s: s["start_ns"])] == [
            "service.decode", "service.decode", "service.admission", "runner.prepare",
            "runner.autosize", "runner.checks", "runner.attempt", "runner.finish",
            "service.result", "service.encode"]
        assert len({s["query_id"] for s in got}) == 1 and root["query_id"] is not None
        attempt, = [s for s in kids if s["name"] == "runner.attempt"]
        assert attempt["attrs"] == {"attempt": 0}
        ops = [s for s in got if s["name"].startswith("op.")]
        top, = [s for s in ops if s["parent_id"] == attempt["span_id"]]
        assert top["name"] == "op.TopN" and top["attrs"] == {"nid": "TopN_1"}
        # one op span per plan node, nested as the plan is; none has a
        # device mark on the CPU
        assert len(ops) == len(plan.pretty().splitlines())
        assert all(by_id[s["parent_id"]]["name"].startswith("op.")
                   for s in ops if s is not top)
        assert all("device_ms" not in s["attrs"] for s in ops)
        res, = [s for s in kids if s["name"] == "service.result"]
        assert res["attrs"]["live_bytes"] <= res["attrs"]["host_bytes"]
        covers.append(sum(s["end_ns"] - s["start_ns"] for s in kids)
                      / (root["end_ns"] - root["start_ns"]))
    assert statistics.median(covers) >= 0.9, covers


def test_tracing_off_makes_no_span_clock_or_event(server, off, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a span site did work with tracing off")

    monkeypatch.setattr(tracing, "Span", boom)
    monkeypatch.setattr(tracing, "time", None)   # any clock reading would raise
    monkeypatch.setattr(torch.cuda, "Event", boom)
    out = _query(server, q3_plan())
    assert out["summary"]["rows"] > 0
    assert tracing.drain() == []


def test_a_mesh_run_has_attempts_and_no_op_spans(cat, spans):
    out, summary = run_query(q1_plan(), cat.blocks("cpu"), mesh=cpu_mesh(2))
    names = [s["name"] for s in tracing.drain()]
    assert names.count("runner.attempt") == summary.retries + 1
    assert not [n for n in names if n.startswith("op.")]


def test_pylists_bytes_on_a_block_with_dead_rows():
    n = 10
    sel = torch.zeros(n, dtype=torch.bool)
    sel[[1, 4, 8]] = True
    a = Column(torch.arange(n, dtype=torch.int64), dtype=dt.INT64)
    b = Column(torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
               dtype=dt.INT32)
    wide = Column(torch.zeros(n, 2, dtype=torch.int64), dtype=dt.Decimal(38, 2))
    blk = Block(names=("a", "b", "w"), columns=(a, b, wide), sel=sel)
    rows = len(blk.to_pylists()["a"])
    assert rows == 3
    # a live row holds 8 + 4 + 1 + 16 B; the live rows are gathered on the
    # device, so copied are the 3 rows (87 B) and the live count (8 B)
    assert blk.pylists_bytes(rows) == {"host_bytes": 95, "live_bytes": 87}
    whole = Block(names=("a", "b"), columns=(a, b))
    assert whole.pylists_bytes(n) == {"host_bytes": 130, "live_bytes": 130}


def test_a_kernel_build_counts_in_the_compile_families(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    src = tmp_path / "k.cu"
    src.write_text("// k")
    n0 = METRICS.counter("fragments_compiled_total").value
    s0 = METRICS.counter("compile_seconds_total").value
    build._build([("k", src, "// k")])
    assert METRICS.counter("fragments_compiled_total").value == n0 + 1
    assert METRICS.counter("compile_seconds_total").value > s0
    build._build([("k", src, "// k")])   # on disk now: no build, no count
    assert METRICS.counter("fragments_compiled_total").value == n0 + 1
    assert "rows_scanned_total" not in METRICS.dump()
