"""The program's request spans in a traced run.

The port records spans at the boundaries of a request
(``tiflash_tpu_torch/runtime/tracing.py``): ``service.request`` around
each ``POST /query``, its children ``service.decode``,
``service.admission``, ``runner.prepare``, ``runner.autosize``,
``runner.checks``, ``runner.attempt`` (one per attempt), ``runner.finish``,
``service.result`` and ``service.encode``, and an ``op.<NodeType>`` per
plan node inside each attempt, with the stream's ``device_ms`` between
its entry and exit marks on the card.

Importing this module turns the recorder on (``spans_on``): ``run.py``
imports the per-layer metrics' readers, the span metrics' among them,
only for a traced run and before its set-up, so the ring holds every
request of the window.  A program without the recorder records nothing,
and every reader here then returns None.

``requests(run)`` drains the ring once (kept as ``run.spans``) and
matches each ``service.request`` span, with every span of its query id,
to the load generator's record
whose ``[t_send, t_done]`` holds it (both on ``CLOCK_MONOTONIC``), over
the requests the trace counts as completed in the profiled slice
(``run.trace["requests_done"]``, the base of ``device_busy_ms``).  The
first call prints to standard error, by span name, the calls, the time
and the self time per request, and the part of ``service_ms`` the spans
account for.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional


def _recorder():
    try:
        from tiflash_tpu_torch.runtime import tracing
    except ImportError:
        return None
    return tracing


def spans_on() -> None:
    """Turn the program's spans on, where it has the recorder."""
    tracing = _recorder()
    if tracing is not None:
        tracing.enable()


def spans_off() -> List[Dict]:
    """Turn the spans off and return every one recorded."""
    tracing = _recorder()
    if tracing is None:
        return []
    tracing.disable()
    return tracing.drain()


spans_on()


def dur_ms(sp: Dict) -> float:
    return (sp["end_ns"] - sp["start_ns"]) / 1e6


class Request:
    """One ``service.request`` span and every span below it."""

    def __init__(self, record: Dict, root: Dict, spans: List[Dict]):
        self.record = record
        self.root = root
        self.spans = spans
        self.children = [s for s in spans if s["parent_id"] == root["span_id"]]

    def total_ms(self, *names: str) -> float:
        return sum(dur_ms(s) for s in self.children if s["name"] in names)

    def plan_device_ms(self) -> Optional[float]:
        """The root operators' ``device_ms`` over every attempt."""
        attempts = {s["span_id"] for s in self.children if s["name"] == "runner.attempt"}
        roots = [s for s in self.spans if s["parent_id"] in attempts
                 and s["name"].startswith("op.")]
        if not roots or any("device_ms" not in s["attrs"] for s in roots):
            return None
        return sum(s["attrs"]["device_ms"] for s in roots)


def match(records: List[Dict], spans: List[Dict]) -> List[Request]:
    """Each record with the ``service.request`` tree that started inside
    its interval (the nearest one to its ends where several did: exact
    for one client); records with none are left out.  The server closes
    the span just after writing the reply, so its end may trail the
    client's by the time the client took to read it."""
    trees: Dict[object, List[Dict]] = {}
    for s in spans:
        trees.setdefault(s["query_id"], []).append(s)
    roots = sorted((s for s in spans if s["name"] == "service.request"
                    and s["parent_id"] is None), key=lambda s: s["start_ns"])
    used, out = set(), []
    for r in sorted(records, key=lambda r: r["t_done"] - r["t_send"]):
        lo, hi = r["t_send"] * 1e9, r["t_done"] * 1e9
        inside = [s for s in roots if s["span_id"] not in used
                  and lo <= s["start_ns"] <= hi]
        if not inside:
            continue
        best = min(inside, key=lambda s: (s["start_ns"] - lo) + abs(hi - s["end_ns"]))
        used.add(best["span_id"])
        tree = [best] if best["query_id"] is None else trees[best["query_id"]]
        out.append(Request(r, best, tree))
    return out


def requests(run) -> Optional[List[Request]]:
    """The slice's completed requests with their spans, or None when the
    run has no trace or the program recorded no span."""
    if not getattr(run, "trace", None):
        return None
    if not hasattr(run, "spans"):
        run.spans = spans_off()
        run.span_requests = match(run.trace["requests_done"], run.spans)
        if run.span_requests:
            report(run.span_requests)
    return run.span_requests or None


def report(reqs: List[Request], out=None) -> None:
    """By span name: calls, time and self time per request (ms); then
    ``service_ms``'s parts.  To standard error unless ``out`` is given."""
    out = out or sys.stderr
    n = len(reqs)
    total: Dict[str, float] = {}
    own: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for q in reqs:
        kids: Dict[int, float] = {}
        for s in q.spans:
            if s["parent_id"] is not None:
                kids[s["parent_id"]] = kids.get(s["parent_id"], 0.0) + dur_ms(s)
        for s in q.spans:
            k = s["name"]
            calls[k] = calls.get(k, 0) + 1
            total[k] = total.get(k, 0.0) + dur_ms(s)
            own[k] = own.get(k, 0.0) + max(0.0, dur_ms(s) - kids.get(s["span_id"], 0.0))
    trail = [q.root["end_ns"] / 1e9 - q.record["t_done"] for q in reqs]
    print(f"spans over {n} requests (per request: calls, ms, self ms); "
          f"{sum(t <= 0 for t in trail)} of them wholly inside the client's interval, "
          f"the latest end {max(trail) * 1e6:.1f} us after the client's", file=out)
    for k in sorted(total, key=lambda k: -own[k]):
        print(f"  {k:<24} {calls[k] / n:8.2f} {total[k] / n:10.3f} {own[k] / n:10.3f}",
              file=out)
    latency = sum((q.record["t_done"] - q.record["t_send"]) * 1e3 for q in reqs) / n
    root = sum(dur_ms(q.root) for q in reqs) / n
    attempts = sum(q.total_ms("runner.attempt") for q in reqs) / n
    children = sum(sum(dur_ms(s) for s in q.children) for q in reqs) / n
    walls = [q.record["wall_seconds"] * 1e3 for q in reqs if "wall_seconds" in q.record]
    service = latency - sum(walls) / len(walls) if walls else float("nan")
    print(f"  latency {latency:.3f} ms; service_ms over these requests {service:.3f}; "
          f"service.request {root:.3f} "
          f"(children {100 * children / root:.1f}% of it); outside the attempts: "
          f"children {children - attempts:.3f} + the client's rest {latency - root:.3f} "
          f"= {children - attempts + latency - root:.3f}",
          file=out)
