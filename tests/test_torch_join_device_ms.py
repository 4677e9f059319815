"""``portbench/metrics/join_device_ms.py`` on synthetic traced runs: the
device time of the kernels launched inside each request's ``join.*``
spans, summed per request and averaged over the slice's requests; nothing
where requests overlap or the program records no join span."""

import pytest
from torch.autograd import DeviceType

from portbench import spans, trace
from portbench.metrics import join_device_ms
from portbench.tests.test_spans import MS, _rec, _run, _span
from portbench.tests.test_trace import Event, launched, reduced


def _rec_of(t_send_ms, t_done_ms, shape="ssb_q2_1"):
    return dict(_rec(t_send_ms, t_done_ms), shape=shape)


@pytest.fixture(autouse=True)
def recorder_off():
    spans.spans_off()


def _request(base, qid, t_ms, joins):
    """A request at ``t_ms`` whose attempt holds an op.Join with a
    ``join.<method>`` span for each (method, start, end) in ``joins``
    (ms into the request)."""
    a = t_ms + 1
    out = [_span(base, "service.request", None, qid, t_ms, t_ms + 10),
           _span(base + 1, "runner.attempt", base, qid, a, a + 8, attempt=0),
           _span(base + 2, "op.Join", base + 1, qid, a + 1, a + 7, nid="Join_1")]
    for k, (method, s, e) in enumerate(joins):
        out.append(_span(base + 3 + k, f"join.{method}", base + 2, qid, t_ms + s, t_ms + e,
                         rows=60_000, build=2556))
    return out


def _slice_run(records_extra=(), joins=(("dense", 3, 4), ("sorted", 4, 5))):
    """A 100-ms slice: request 1 at 10 ms with its joins, whose spans
    launch kernels of 0.25 ms (13.2-13.45) and 0.1 ms (14.5-14.6), and an
    operator kernel outside them; request 2 at 40 ms with no join."""
    ev = [Event(trace.SLICE_RANGE, 0, 100 * MS, DeviceType.CPU)]
    for k, (t, a, b) in enumerate(((13.5, 13.2, 13.45), (14.5, 14.5, 14.6),
                                   (16.5, 17.0, 18.0), (45.0, 45.0, 46.0))):
        ev += launched("kernel", int(t * MS), int(a * MS), int(b * MS), k + 1)
    records = [_rec_of(10.0, 22.0), _rec_of(40.0, 52.0, "q1")] + list(records_extra)
    run = _run(records, _request(100, 1, 10.0, joins) + _request(200, 2, 40.0, ()))
    run.trace = reduced(ev, records)
    return run


def test_sums_the_join_spans_kernels_per_request():
    assert join_device_ms.read(_slice_run()) == pytest.approx((0.25 + 0.1 + 0.0) / 2)


def test_reads_nothing_without_its_own_time():
    assert join_device_ms.read(_slice_run([_rec_of(15.0, 30.0)])) is None   # overlap
    assert join_device_ms.read(_slice_run(joins=())) is None   # no join span
    assert join_device_ms.read(_run([_rec(-0.5, 10.5)], [])) is None
