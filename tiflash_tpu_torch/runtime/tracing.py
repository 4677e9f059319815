"""Request spans: where a request's time goes inside the engine.

The one span recorder of the port; counters stay in ``runtime/metrics.py``.
``span(name, **attrs)`` is a context manager that records the span's
name, its start and end on ``time.monotonic_ns()`` (``CLOCK_MONOTONIC``
on Linux, the clock a profiler's trace can be mapped onto), a span id,
its parent's id (the span open in the same context, a contextvar), the
thread and the request's query id.  The query id is the one
``runtime/logging.py:query_context`` sets; a span opened before the
service knows it (the HTTP request, the plan's decode, the admission
wait) takes its request's id from the root span of its tree, which
takes it from the first descendant that saw one.  ``set(**attrs)`` adds
attributes to the open span: counts taken at the boundary.

Finished spans go into a bounded ring (``enable(capacity)``, oldest
dropped first); ``drain()`` empties it into plain dicts.  Tracing is off
by default and nothing in the engine turns it on: with it off ``span``
and ``op_span`` test one module flag and return the shared ``NO_SPAN``,
which takes no clock reading, makes no span object or CUDA event and
never reads from the device.

``op_span`` is the plan compiler's span per node (``op.<NodeType>``,
attribute ``nid``).  On a CUDA block it also records an unsynchronised
``torch.cuda.Event`` pair on the current stream; ``resolve_device()``,
called once the host has waited on the device (the runner does it after
an attempt's ``read_flags``), turns each pair into the attribute
``device_ms``: the stream's time from the node's entry mark to its exit
mark, its children's work and any stretch the stream waited for the host
inside it included.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import threading
import time
from typing import Dict, List

from .logging import _query_id

_enabled = False
_ring: collections.deque = collections.deque(maxlen=1 << 16)
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar("tfl_torch_span", default=None)
# op spans of this context whose CUDA events wait for resolve_device()
_pending: contextvars.ContextVar = contextvars.ContextVar("tfl_torch_span_events",
                                                         default=None)


class Span:
    __slots__ = ("name", "attrs", "span_id", "parent", "root", "query_id",
                 "thread_id", "start_ns", "end_ns", "events", "_token")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self.events = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        parent = _current.get()
        self.parent = parent
        # a tree's root is its own root: None, so a span makes no cycle
        self.root = None if parent is None else (parent.root or parent)
        self.span_id = next(_ids)
        self.query_id = _query_id.get()
        root = self.root or self
        if self.query_id is not None and root.query_id is None:
            root.query_id = self.query_id
        self.thread_id = threading.get_ident()
        self._token = _current.set(self)
        self.start_ns = time.monotonic_ns()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record()
            pending = _pending.get()
            if pending is None:
                pending = []
                _pending.set(pending)
            pending.append(self)
        self.end_ns = time.monotonic_ns()
        _current.reset(self._token)
        _ring.append(self)
        return False

    def as_dict(self) -> Dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": None if self.parent is None else self.parent.span_id,
            "query_id": (self if self.root is None or self.query_id is not None
                         else self.root).query_id,
            "thread_id": self.thread_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "attrs": dict(self.attrs),
        }


class _NoSpan:
    """What ``span`` returns with tracing off: a context manager that does
    nothing, false in a test, so a caller can skip work for attributes."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A span named ``name`` around a ``with`` block (``NO_SPAN`` when
    tracing is off)."""
    if not _enabled:
        return NO_SPAN
    return Span(name, attrs)


def op_span(kind: str, nid: str, tables):
    """The span of one plan node (``op.<kind>``, attribute ``nid``); with
    CUDA event marks when ``tables`` lie on a CUDA device."""
    if not _enabled:
        return NO_SPAN
    sp = Span("op." + kind, {"nid": nid})
    block = next(iter(tables.values()), None)
    if block is not None and block.columns and block.device.type == "cuda":
        import torch

        sp.events = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
    return sp


def resolve_device() -> None:
    """Set ``device_ms`` on this context's op spans from their event
    pairs.  Call after the host has waited on the device: the wait on the
    last mark is then already over."""
    pending = _pending.get()
    if not pending:
        return
    _pending.set(None)
    pending[-1].events[1].synchronize()
    for sp in pending:
        start, end = sp.events
        sp.attrs["device_ms"] = start.elapsed_time(end)
        sp.events = None


def enable(capacity: int = 1 << 16) -> None:
    """Turn tracing on, into a fresh ring of ``capacity`` spans."""
    global _enabled, _ring
    _ring = collections.deque(maxlen=capacity)
    _enabled = True


def disable() -> None:
    """Turn tracing off; spans open now still finish into the ring."""
    global _enabled
    _enabled = False


def drain() -> List[Dict]:
    """Every finished span in the ring, oldest first, as plain dicts; the
    ring is left empty."""
    out = []
    while True:
        try:
            sp = _ring.popleft()
        except IndexError:
            return out
        out.append(sp.as_dict())


__all__ = ["span", "op_span", "resolve_device", "enable", "disable", "drain",
           "NO_SPAN", "Span"]
