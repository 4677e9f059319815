"""The span metrics' readers on a synthetic run: requests matched to the
load generator's records, the means per request, the copy ratio, and
nothing read where the program records no span."""

from types import SimpleNamespace

import pytest

from portbench import spans
from portbench.metrics import plan_device_ms, prepare_ms, result_copy_ratio, result_ms

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
