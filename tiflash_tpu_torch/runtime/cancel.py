"""Query cancellation.

Counterpart of ``tiflash_tpu/runtime/cancel.py``, a host-only copy.

Role analog: ``Flash/Mpp/MPPTask.h:121-126`` (``abort`` / ``abortTunnels``
/ ``abortQueryExecutor``) and ``FlashService::CancelMPPTask``.  The
reference propagates an abort through tunnels and executors; here
cancellation is a HOST-side cooperative flag checked at every
orchestration boundary the executor owns: admission wait, each
capacity-retry attempt, each out-of-core chunk, partition and merge
bucket, and paused failpoints.  Kernels already queued on a CUDA stream
run to completion (a stream cannot be interrupted mid-kernel)
— the flag then stops the query at the next boundary and frees its
admission slot.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional


class QueryCancelled(RuntimeError):
    """Raised inside the executing thread at the next cancel checkpoint."""


class QueryTimeout(QueryCancelled):
    """Deadline exceeded (``max_execution_time_ms``; reference
    ``Interpreters/Settings.h`` max_execution_time)."""


class CancelFlag:
    """One per query: set() from any thread, check() from the executor."""

    def __init__(self):
        self._ev = threading.Event()

    def set(self) -> None:
        self._ev.set()

    def is_set(self) -> bool:
        return self._ev.is_set()

    def check(self) -> None:
        if self._ev.is_set():
            raise QueryCancelled("query cancelled")

    def wait(self, timeout: float) -> bool:
        return self._ev.wait(timeout)


_current = threading.local()


def current_cancel_flag() -> Optional[CancelFlag]:
    """The executing thread's active flag (used by paused failpoints)."""
    return getattr(_current, "flag", None)


@contextlib.contextmanager
def cancel_scope(flag: Optional[CancelFlag], deadline: Optional[float] = None):
    """Install ``flag`` (and an optional ``time.monotonic`` deadline) as the
    thread's active cancellation state."""
    prev = getattr(_current, "flag", None)
    prev_deadline = getattr(_current, "deadline", None)
    _current.flag = flag
    _current.deadline = deadline
    try:
        yield
    finally:
        _current.flag = prev
        _current.deadline = prev_deadline


def checkpoint() -> None:
    """Raise QueryCancelled/QueryTimeout if the thread's active flag is set
    or its deadline has passed."""
    flag = current_cancel_flag()
    if flag is not None:
        flag.check()
    deadline = getattr(_current, "deadline", None)
    if deadline is not None:
        import time

        if time.monotonic() > deadline:
            raise QueryTimeout("max_execution_time exceeded")


__all__ = [
    "QueryCancelled",
    "QueryTimeout",
    "CancelFlag",
    "cancel_scope",
    "current_cancel_flag",
    "checkpoint",
]
