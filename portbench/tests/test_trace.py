"""The trace's reduction: the device is busy while a kernel runs; copies
and sets are counted apart, and an idle gap is a stretch with no kernel."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from portbench import trace


class Event:
    def __init__(self, name, a, b, device=DeviceType.CUDA):
        self._n, self._a, self._b, self._d = name, a, b, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return self._d


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
    ev = [Event(trace.SLICE_RANGE, 0, 1000, DeviceType.CPU),
          Event("k1", 100, 200), Event("Memcpy HtoD (Pageable -> Device)", 200, 400),
          Event("k2", 600, 650)]
    recs = [{"shape": "q1", "t_send": 50e-9, "t_done": 450e-9},
            {"shape": "q6", "t_send": 500e-9, "t_done": 900e-9}]
    r = reduced(ev, recs)
    assert [round(b * 1e9) for _, b in r["own_busy"]] == [100, 50]
    assert len(r["requests_done"]) == 2
