"""The span metrics' readers on a synthetic run: requests matched to the
load generator's records, the means per request, the copy ratio, the
scans' own kernel time, and nothing read where the program records no
span."""

from types import SimpleNamespace

import pytest

from torch.autograd import DeviceType

from portbench import spans, trace
from portbench.bytes_model import HBM_BYTES_PER_S
from portbench.metrics import (plan_device_ms, prepare_ms, result_copy_ratio, result_ms,
                               scan_roofline)
from portbench.tests.test_trace import Event, launched, reduced

MS = 1_000_000


def _span(sid, name, parent, qid, a_ms, b_ms, **attrs):
    return {"name": name, "span_id": sid, "parent_id": parent, "query_id": qid,
            "thread_id": 1, "start_ns": int(a_ms * MS), "end_ns": int(b_ms * MS),
            "attrs": attrs}


def _request(base, qid, t_ms, attempts=1, device=True):
    """One request's tree starting at ``t_ms``: 1 ms of prepare, 2 of
    autosize, 0.5 of checks, 10 a attempt, 3 of result, 1 of encode."""
    t = t_ms
    out = [_span(base, "service.request", None, qid, t, t + 30)]
    sid = base + 1
    for name, d in (("service.decode", 0.5), ("service.admission", 0.1),
                    ("runner.prepare", 1.0), ("runner.autosize", 2.0),
                    ("runner.checks", 0.5)):
        out.append(_span(sid, name, base, qid, t, t + d))
        sid, t = sid + 1, t + d
    for k in range(attempts):
        out.append(_span(sid, "runner.attempt", base, qid, t, t + 10, attempt=k))
        attrs = {"nid": "Sort_1"}
        if device:
            attrs["device_ms"] = 8.0
        out.append(_span(sid + 1, "op.Sort", sid, qid, t, t + 9.5, **attrs))
        out.append(_span(sid + 2, "op.TableScan", sid + 1, qid, t, t + 0.1, nid="TableScan_2",
                         **({"device_ms": 0.01} if device else {})))
        sid, t = sid + 3, t + 10
    out.append(_span(sid, "runner.finish", base, qid, t, t + 0.2))
    out.append(_span(sid + 1, "service.result", base, qid, t + 0.2, t + 3.2,
                     host_bytes=4000, live_bytes=100))
    out.append(_span(sid + 2, "service.encode", base, qid, t + 3.2, t + 4.2))
    return out


@pytest.fixture(autouse=True)
def recorder_off():
    """Importing the readers turned the program's spans on."""
    spans.spans_off()


def _run(records, recorded):
    run = SimpleNamespace(trace={"requests_done": records})
    run.spans = recorded
    run.span_requests = spans.match(records, recorded)
    return run


def _rec(t_send_ms, t_done_ms, wall_ms=10.0):
    return {"t_send": t_send_ms / 1e3, "t_done": t_done_ms / 1e3,
            "wall_seconds": wall_ms / 1e3, "status": 200}


def test_readers_on_two_requests(capsys):
    recorded = _request(100, 1, 1000.0) + _request(200, 2, 2000.0, attempts=2)
    recorded += _request(300, 3, 5000.0)   # its record is outside the slice
    run = _run([_rec(999.0, 1031.0), _rec(1999.5, 2040.0)], recorded)
    assert [q.root["query_id"] for q in run.span_requests] == [1, 2]
    assert prepare_ms.read(run) == pytest.approx(3.5)
    assert result_ms.read(run) == pytest.approx(4.0)
    assert result_copy_ratio.read(run) == pytest.approx(40.0)
    # the root operator's device time, over each request's attempts
    assert plan_device_ms.read(run) == pytest.approx((8.0 + 16.0) / 2)
    spans.report(run.span_requests)
    err = capsys.readouterr().err
    assert "runner.attempt" in err and "2 of them wholly inside" in err


def test_nothing_to_read():
    # the CPU has no device marks; a program without spans records none
    run = _run([_rec(999.0, 1031.0)], _request(100, 1, 1000.0, device=False))
    assert plan_device_ms.read(run) is None and prepare_ms.read(run) is not None
    empty = _run([_rec(999.0, 1031.0)], [])
    for mod in (prepare_ms, result_ms, result_copy_ratio, plan_device_ms):
        assert mod.read(empty) is None
        assert mod.read(SimpleNamespace(trace=None)) is None


def _scan_run(extra_records=()):
    """A slice of 100 ms (the profiler's clock is the monotonic clock
    here) holding a Q1 request sent at 20.2 ms and answered at 30 ms,
    between a Q15 answered at 20 ms and a Q3 sent at 30.1 ms.  Kernels, in
    ms, launched / run, where the device's times lie off the host's:
    Q15's last, 19 / 22.6 to 23.4, inside Q1's attempt; Q1's auto-sizing,
    20.9 / 20.95 to 21; Q1's attempt, 22.4 / 24 to 25 and 23.9 / 26.2 to
    26.7, the second past the attempt's end; Q1's result gather, 26.8 /
    26.85 to 27; Q3's first, 30.5 / 29.8 to 30.4.  Q1 must read 0.75 ms of
    bytes at 3.35 TB/s."""
    ev = [Event(trace.SLICE_RANGE, 0, 100 * MS, DeviceType.CPU)]
    for k, (t, a, b) in enumerate(((19, 22.6, 23.4), (20.9, 20.95, 21), (22.4, 24, 25),
                                   (23.9, 26.2, 26.7), (26.8, 26.85, 27), (30.5, 29.8, 30.4))):
        ev += launched("kernel", int(t * MS), int(a * MS), int(b * MS), k + 1)
    records = [dict(_rec(10.0, 20.0), shape="q15", key="q15"),
               dict(_rec(20.2, 30.0), shape="q1", key="q1", params={}),
               dict(_rec(30.1, 40.0), shape="q3", key="q3")] + list(extra_records)
    recorded = [_span(1, "service.request", None, 7, 20.3, 29.9),
                _span(2, "runner.autosize", 1, 7, 20.5, 21.5),
                _span(3, "runner.attempt", 1, 7, 22.0, 26.0, attempt=0),
                _span(4, "service.result", 1, 7, 26.5, 27.5)]
    run = _run(records, recorded)
    run.trace = reduced(ev, records)
    run.references = {"q1": SimpleNamespace(SCAN={}), "q15": SimpleNamespace(),
                      "q3": SimpleNamespace()}
    run.scan_bytes = SimpleNamespace(bytes=lambda key, ref, t, params: 0.75e-3 * HBM_BYTES_PER_S)
    run.tables = None
    return run


def test_scan_roofline_counts_the_scan_requests_own_kernels():
    """Only the 1.5 ms of kernels that Q1's attempt launched count, 0.75 /
    1.5, wherever the device ran them.  Its client interval launched 1.7
    ms (auto-sizing and gather too); the kernels that ran inside the
    interval, the neighbours' among them, add up to 2.75 ms."""
    run = _scan_run()
    assert scan_roofline.read(run) == pytest.approx(50.0)
    q1 = run.span_requests[0].record
    interval = trace.kernel_s(run.trace, int(q1["t_send"] * 1e9), int(q1["t_done"] * 1e9))
    assert interval == pytest.approx(1.7e-3)


def test_scan_roofline_reads_nothing_without_its_own_time():
    # a second client's request overlapping Q1's
    assert scan_roofline.read(_scan_run([dict(_rec(25.0, 35.0), shape="q3", key="q3")])) \
        is None
    run = _scan_run()
    run.span_requests[0].children = [s for s in run.span_requests[0].children
                                     if s["name"] != "runner.attempt"]
    assert scan_roofline.read(run) is None
    assert scan_roofline.read(SimpleNamespace(trace=None)) is None
