"""The trace's reduction: the device is busy while a kernel runs; copies
and sets are counted apart, and an idle gap is a stretch with no kernel."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from portbench import trace


class Event:
    def __init__(self, name, a, b, device=DeviceType.CUDA, corr=0):
        self._n, self._a, self._b, self._d, self._c = name, a, b, device, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c


def launched(name, launch, a, b, corr):
    """A kernel run over [a, b] on the device and its launch on the host."""
    return [Event("cudaLaunchKernel", launch, launch + 1, DeviceType.CPU, corr),
            Event(name, a, b, DeviceType.CUDA, corr)]


def reduced(events, records=()):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    sl = SimpleNamespace(prof=prof, mono_start=0.0)
    return trace.reduce(sl, list(records))


def test_copies_are_not_busy():
    ev = [Event(trace.SLICE_RANGE, 0, 1000, DeviceType.CPU),
          Event("gemm_kernel", 100, 200), Event("Memcpy DtoH (Device -> Pageable)", 150, 600),
          Event("add_kernel", 700, 750), Event("Memset (Device)", 900, 950),
          Event("cpu_op", 0, 1000, DeviceType.CPU)]
    r = reduced(ev)
    assert r["window_s"] == 1000 / 1e9
    assert r["busy_s"] == 150 / 1e9
    assert r["copy_s"] == 500 / 1e9
    assert (r["kernel_events"], r["copy_events"]) == (2, 2)
    assert [n for n, _ in r["device_ops"]][0] == "Memcpy DtoH (Device -> Pageable)"
    # the longest stretch without a kernel is 200..700, although a copy ran in it
    assert r["idle_gaps"][0] == ["no request in flight", 500 / 1e9]


def test_kernel_time_inside_requests():
    """``kernel_s`` reads the device time of the kernels launched inside an
    interval of the monotonic clock, wherever they ran, copies apart,
    and nothing for an interval that leaves the slice; requests of one
    client do not overlap."""
    ev = [Event(trace.SLICE_RANGE, 0, 1000, DeviceType.CPU),
          *launched("k1", 60, 100, 200, 1), Event("Memcpy HtoD (Pageable -> Device)", 200, 400),
          *launched("k2", 420, 600, 650, 2), *launched("k3", 520, 660, 700, 3)]
    recs = [{"shape": "q1", "t_send": 50e-9, "t_done": 450e-9},
            {"shape": "q6", "t_send": 500e-9, "t_done": 900e-9}]
    r = reduced(ev, recs)
    assert [round(trace.kernel_s(r, 50, 450) * 1e9), round(trace.kernel_s(r, 500, 900) * 1e9)] \
        == [100 + 50, 40]
    assert trace.kernel_s(r, 450, 500) == 0
    assert trace.kernel_s(r, 900, 1100) is None
    assert len(r["requests_done"]) == 2 and not r["overlap"]
    both = reduced(ev, recs + [{"shape": "q3", "t_send": 300e-9, "t_done": 700e-9}])
    assert both["overlap"]


def test_clock_offset_from_the_narrowest_mark():
    """The mark whose monotonic readings bracket its range's start most
    narrowly gives the offset; a wide bracket (a thread switch inside
    it) is passed over.  Without marks, the slice's own range."""
    ev = [Event(trace.SLICE_RANGE, 5_000, 90_000, DeviceType.CPU),
          Event(f"{trace.CLOCK_MARK}0", 12_000, 12_001, DeviceType.CPU),
          Event(f"{trace.CLOCK_MARK}1", 14_000, 14_001, DeviceType.CPU),
          *launched("k", 19_500, 20_000, 30_000, 1)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    # mark 0: read at 1000 and 7000 (a switch), mark 1: at 3990 and 4010
    sl = SimpleNamespace(prof=prof, mono_start=0.0, marks=[(1_000, 7_000), (3_990, 4_010)])
    r = trace.reduce(sl, [])
    assert (r["offset_ns"], r["offset_err_ns"]) == (10_000, 10)
    assert round(trace.kernel_s(r, 9_000, 10_000) * 1e9) == 10_000
    sl.marks = []
    r = trace.reduce(sl, [])
    assert (r["offset_ns"], r["offset_err_ns"]) == (5_000, None)
    assert trace.kernel_s(r, 9_000, 10_000) == 0
