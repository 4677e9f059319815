"""On the card: the program's spans and the profiler's trace share a clock.

A span holding a known kernel and a ``synchronize`` (with 2 ms of host
time on either side), under the profiler as ``trace.Slice`` runs it,
mapped onto the trace with the offset ``trace.reduce`` uses (the slice's
range start less the monotonic clock read at its start), must hold the
kernel's device interval.  And the offset, the start of a profiler range
less the monotonic clock read just inside it, must differ by under 50 us
between the slice's start and its end, 3 s later.  A range's stamp and
the clock read inside it lie tens of microseconds apart, by a varying
amount, and the first range after the profiler starts lies further from
the clock than the rest; so each end takes the median of five ranges,
after one range that is not counted."""

import statistics
import time

import pytest

from portbench import trace

MARGIN_S = 0.002   # host time inside the span on either side of the kernel
SLICE_S = 3.0
MARKS = 5


def _marks(torch, prefix):
    """(range name, monotonic ns read inside it) of ``MARKS`` ranges."""
    out = []
    for i in range(MARKS):
        name = f"portbench.span_clock.{prefix}{i}"
        with torch.profiler.record_function(name):
            out.append((name, time.monotonic_ns()))
        time.sleep(0.01)
    return out


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_trace(cuda_card):
    import torch
    from torch.autograd import DeviceType

    from tiflash_tpu_torch.runtime import tracing

    x = torch.ones(1 << 26, device="cuda")
    torch.cuda.synchronize()
    sl = trace.Slice("cuda")
    tracing.enable()
    try:
        sl.start()
        _marks(torch, "warm")
        first = _marks(torch, "start")
        with tracing.span("probe"):
            time.sleep(MARGIN_S)
            x.mul_(1.5)
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
        time.sleep(SLICE_S)
        last = _marks(torch, "end")
        sl.stop()
    finally:
        tracing.disable()
    probe, = [s for s in tracing.drain() if s["name"] == "probe"]
    events = sl.prof.profiler.kineto_results.events()
    host = {e.name(): e.start_ns() for e in events if e.device_type() == DeviceType.CPU}
    offset = host[trace.SLICE_RANGE] - int(sl.mono_start * 1e9)
    at_start = statistics.median(host[n] - m for n, m in first)
    at_end = statistics.median(host[n] - m for n, m in last)
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.name().startswith(trace.COPY_PREFIXES) and e.name() not in host]
    assert kernels, [e.name() for e in events]
    lo, hi = probe["start_ns"] + offset, probe["end_ns"] + offset
    seen = (f"span {hi - lo} ns; kernels {[e.name()[:40] for e in kernels]} from "
            f"{min(e.start_ns() for e in kernels) - lo} ns after its start to "
            f"{hi - max(e.end_ns() for e in kernels)} ns before its end; the slice's offset "
            f"{offset} ns, {offset - at_start} ns from the marks' at its start; the marks' "
            f"offset {at_end - at_start} ns later at its end")
    print(seen)
    assert all(lo <= e.start_ns() and e.end_ns() <= hi for e in kernels), seen
    assert abs(at_end - at_start) < 50_000, seen
