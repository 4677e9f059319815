"""The profiled slice of a traced run, reduced to what the per-layer
metrics read.

``Slice`` runs ``torch.profiler`` (CPU and CUDA activity) over a steady
part of the window.  The device's activity is traced whichever thread
launched it; host operations only on the thread that runs the profiler
(the profiler's every-thread mode aborted the process on the card under
the two-client mix, whose server threads come and go by the hundred).  A
profiler range named ``portbench.slice`` marks the slice in the
profiler's clock; the monotonic clock read at its start maps the load
generator's timestamps onto it.  The reduction keeps:

- ``busy_s``: the union of the kernels' activity inside the slice, and
  ``window_s``, the slice's length;
- ``copy_s``: the union of the copies and sets (``Memcpy ...``,
  ``Memset ...``) inside the slice, apart from the kernels: a copy to or
  from pageable host memory spans the driver's staging on the host while
  no SM works;
- ``device_ops``: device time by name (kernels, copies and sets), the
  most first;
- ``idle_gaps``: the longest stretches inside the slice with no kernel
  on the device, each named by the request shapes the host was serving
  at its middle.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

SLICE_RANGE = "portbench.slice"
NAME_CHARS = 120   # a kernel's name is cut to this, to keep the result line short
COPY_PREFIXES = ("Memcpy", "Memset")


class Slice:
    """Made during set-up: a first profiler start and stop, which sets up
    the profiler's own machinery (seconds, the first time in a process),
    so the slice's own start is quick."""

    def __init__(self, device: str):
        import torch

        self._acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            self._acts.append(torch.profiler.ProfilerActivity.CUDA)
        warm = torch.profiler.profile(activities=self._acts)
        warm.start()
        warm.stop()
        self.prof = torch.profiler.profile(activities=self._acts)
        self._range = torch.profiler.record_function(SLICE_RANGE)
        self.mono_start = None

    def start(self) -> None:
        self.prof.start()
        self.mono_start = time.monotonic()
        self._range.__enter__()

    def stop(self) -> None:
        self._range.__exit__(None, None, None)
        self.mono_stop = time.monotonic()
        self.prof.stop()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _covered(busy: List[Tuple[int, int]], a: int, b: int) -> int:
    """Nanoseconds of the union ``busy`` inside [a, b]."""
    i = bisect.bisect_left(busy, (a, a))
    i = max(0, i - 1)
    total = 0
    while i < len(busy) and busy[i][0] < b:
        total += max(0, min(busy[i][1], b) - max(busy[i][0], a))
        i += 1
    return total


def reduce(sl: Slice, records: List[Dict], top: int = 10) -> Dict:
    """The slice's numbers; ``records`` are the load generator's."""
    from torch.autograd import DeviceType

    events = sl.prof.profiler.kineto_results.events()
    marks = [e for e in events if e.name() == SLICE_RANGE]
    lo = marks[0].start_ns() if marks else min(e.start_ns() for e in events)
    hi = marks[0].end_ns() if marks else max(e.end_ns() for e in events)
    offset_ns = lo - int(sl.mono_start * 1e9)

    kernels, copies = [], []
    by_name: Dict[str, int] = {}
    for e in events:
        a, b = max(e.start_ns(), lo), min(e.end_ns(), hi)
        if b > a and e.device_type() == DeviceType.CUDA:
            (copies if e.name().startswith(COPY_PREFIXES) else kernels).append((a, b))
            by_name[e.name()] = by_name.get(e.name(), 0) + (b - a)
    busy = _union(kernels)
    busy_ns = sum(b - a for a, b in busy)

    # requests by the profiler's clock
    reqs = [(int(r["t_send"] * 1e9) + offset_ns, int(r["t_done"] * 1e9) + offset_ns, r)
            for r in records]
    done_in = [r for s, d, r in reqs if lo <= d <= hi]
    # device time inside each request's own interval: that request's
    # alone where no two requests of the slice overlap (one client)
    inside = sorted((max(s, lo), d) for s, d, r in reqs if lo <= d <= hi)
    overlap = any(b[0] < a[1] for a, b in zip(inside, inside[1:]))
    own_busy = [(r, _covered(busy, max(s, lo), d) / 1e9) for s, d, r in reqs if lo <= d <= hi]

    gaps = []
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:top]:
        mid = (a + b) // 2
        shapes = sorted({r["shape"] for s, d, r in reqs if s <= mid <= d})
        label = f"host serving {'+'.join(shapes)}" if shapes else "no request in flight"
        idle.append([label, length / 1e9])
    ops_sorted = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy_ns / 1e9,
        "copy_s": sum(b - a for a, b in _union(copies)) / 1e9,
        "kernel_events": len(kernels),
        "copy_events": len(copies),
        "requests_done": done_in,
        "own_busy": None if overlap else own_busy,
        "device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in ops_sorted[:top]],
        "idle_gaps": idle,
    }


def run_slice(sl: Slice, t0: float, seconds: float, spec: Optional[Dict]) -> None:
    """Profile from the mix's ``start_s`` into the window for its
    ``seconds``, both cut to fit: the slice starts in the first quarter of
    the window and ends half a second before its close at the latest."""
    spec = spec or {}
    start = t0 + min(float(spec.get("start_s", 0.0)), 0.25 * seconds)
    time.sleep(max(0.0, start - time.monotonic()))
    sl.start()
    end = min(time.monotonic() + float(spec.get("seconds", seconds)), t0 + seconds - 0.5)
    time.sleep(max(0.0, end - time.monotonic()))
    sl.stop()
