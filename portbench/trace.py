"""The profiled slice of a traced run, reduced to what the per-layer
metrics read.

``Slice`` runs ``torch.profiler`` (CPU and CUDA activity) over a steady
part of the window.  The device's activity, and the CUDA calls that
launched it, are traced whichever thread made them; other host
operations only on the thread that runs the profiler (the profiler's
every-thread mode aborted the process on the card under the two-client
mix, whose server threads come and go by the hundred).  A
profiler range named ``portbench.slice`` marks the slice in the
profiler's clock.  Clock marks just after it (``portbench.clock.<i>``,
short ranges, each with the monotonic clock read just before and just
after it begins) map the load generator's timestamps and the program's
spans onto that clock: the mark whose two readings lie closest together
gives the offset, since a thread switch between them widens the bracket.
The reduction keeps:

- ``busy_s``: the union of the kernels' activity inside the slice, and
  ``window_s``, the slice's length;
- ``launched``: each kernel with the host time of the call that launched
  it (the profiler links the two by a correlation id), with the clock
  offset and its error bound, so that ``kernel_s`` reads the device time
  of the kernels that any span of the program launched;
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

# CUPTI set up once per process and kept between the profiler's sessions
# (torch's own setting where a re-initialisation after a teardown
# crashes): the slice's start then sets nothing up again; ``run.py``
# puts these into a traced run's environment before it imports torch
CUPTI_ENV = {"TEARDOWN_CUPTI": "0", "DISABLE_CUPTI_LAZY_REINIT": "1"}
SLICE_RANGE = "portbench.slice"
CLOCK_MARK = "portbench.clock."
CLOCK_MARKS = 16
NAME_CHARS = 120   # a kernel's name is cut to this, to keep the result line short
COPY_PREFIXES = ("Memcpy", "Memset")
LAUNCH_PREFIX = "cu"   # the runtime's and the driver's calls: cudaLaunchKernel, cuLaunchKernel


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
        self._record = torch.profiler.record_function
        self.mono_start = None
        self.marks: List[Tuple[int, int]] = []

    def start(self) -> None:
        self.prof.start()
        self.mono_start = time.monotonic()
        self._range.__enter__()
        for i in range(CLOCK_MARKS):
            a = time.monotonic_ns()
            with self._record(f"{CLOCK_MARK}{i}"):
                b = time.monotonic_ns()
            self.marks.append((a, b))

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


def clock_offset(sl: Slice, events, lo: int) -> Tuple[int, Optional[int]]:
    """The profiler's clock less the monotonic clock (ns), and its error
    bound: half the narrowest clock mark's bracket.  Without marks, the
    slice's range start less the monotonic clock read before it began,
    with no bound: a thread switch between the two shifts it."""
    stamps = {e.name(): e.start_ns() for e in events if e.name().startswith(CLOCK_MARK)}
    brackets = [(b - a, stamps[f"{CLOCK_MARK}{i}"] - (a + b) // 2)
                for i, (a, b) in enumerate(getattr(sl, "marks", []))
                if f"{CLOCK_MARK}{i}" in stamps]
    if not brackets:
        return lo - int(sl.mono_start * 1e9), None
    width, offset = min(brackets)
    return offset, width // 2


def reduce(sl: Slice, records: List[Dict], top: int = 10) -> Dict:
    """The slice's numbers; ``records`` are the load generator's."""
    from torch.autograd import DeviceType

    events = sl.prof.profiler.kineto_results.events()
    marks = [e for e in events if e.name() == SLICE_RANGE]
    lo = marks[0].start_ns() if marks else min(e.start_ns() for e in events)
    hi = marks[0].end_ns() if marks else max(e.end_ns() for e in events)
    offset_ns, offset_err_ns = clock_offset(sl, events, lo)

    launch_ns = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() == DeviceType.CPU and e.correlation_id()
                 and e.name().startswith(LAUNCH_PREFIX)}
    kernels, copies, launched = [], [], []
    by_name: Dict[str, int] = {}
    for e in events:
        a, b = max(e.start_ns(), lo), min(e.end_ns(), hi)
        if b > a and e.device_type() == DeviceType.CUDA:
            if e.name().startswith(COPY_PREFIXES):
                copies.append((a, b))
            else:
                kernels.append((a, b))
                if e.correlation_id() in launch_ns:
                    launched.append((launch_ns[e.correlation_id()], a, b))
            by_name[e.name()] = by_name.get(e.name(), 0) + (b - a)
    launched.sort()
    busy = _union(kernels)
    busy_ns = sum(b - a for a, b in busy)

    # requests by the profiler's clock
    reqs = [(int(r["t_send"] * 1e9) + offset_ns, int(r["t_done"] * 1e9) + offset_ns, r)
            for r in records]
    done_in = [r for s, d, r in reqs if lo <= d <= hi]
    # with more than one client a request's spans may hold another's kernels
    inside = sorted((max(s, lo), d) for s, d, r in reqs if lo <= d <= hi)
    overlap = any(b[0] < a[1] for a, b in zip(inside, inside[1:]))

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
        "overlap": overlap,
        "launched": launched,
        "lo_ns": lo,
        "hi_ns": hi,
        "offset_ns": offset_ns,
        "offset_err_ns": offset_err_ns,
        "device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in ops_sorted[:top]],
        "idle_gaps": idle,
    }


def kernel_s(tr: Dict, start_ns: int, end_ns: int) -> Optional[float]:
    """Seconds of device time (the union of their activity) of the kernels
    launched inside [start_ns, end_ns] on the monotonic clock (the load
    generator's and the program's spans'), or None where that interval is
    not wholly inside the slice.  By launch, not by when a kernel ran: the
    trace's device times can lie milliseconds off its host times, and a
    kernel queued behind others runs after its launcher has moved on."""
    a, b = start_ns + tr["offset_ns"], end_ns + tr["offset_ns"]
    if a < tr["lo_ns"] or b > tr["hi_ns"]:
        return None
    ks = tr["launched"]
    i = bisect.bisect_left(ks, (a,))
    j = bisect.bisect_right(ks, (b, float("inf")))
    return sum(y - x for x, y in _union([(x, y) for _, x, y in ks[i:j]])) / 1e9


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
