"""Deterministic-interleaving sync points for concurrency tests.

Counterpart of ``tiflash_tpu/runtime/syncpoint.py``, a host-only copy.

Role analog: ``Common/SyncPoint/SyncPoint.h`` / ``SyncPointCtl`` — the
reference instruments code with named sync points; a test enables one,
waits for a thread to ARRIVE there (it pauses), interleaves other work,
then releases it.  This replaces stochastic sleep-based service tests
with reproducible schedules.

Product code marks interesting spots with ``sync_point("name")`` — a
no-op (one dict lookup) unless a test enabled the name.  Tests:

    with SyncPoint.enable("service.query.running") as sp:
        ...start query on another thread...
        sp.wait_for_arrival()   # query thread is now parked there
        ...interleave: cancel it, start another, inspect state...
        sp.release()            # let it continue

A parked thread still honors its query's CancelFlag (polled while
waiting) so a paused query can be cancelled deterministically.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class _Channel:
    def __init__(self) -> None:
        self.arrived = threading.Semaphore(0)
        self.released = threading.Semaphore(0)
        self.active = True


class SyncPointHandle:
    def __init__(self, name: str, chan: _Channel) -> None:
        self.name = name
        self._chan = chan

    def wait_for_arrival(self, timeout: float = 30.0) -> None:
        """Block until some thread reaches the sync point (it stays parked)."""
        if not self._chan.arrived.acquire(timeout=timeout):
            raise TimeoutError(f"no thread arrived at sync point {self.name!r}"
                               f" within {timeout}s")

    def release(self, n: int = 1) -> None:
        """Let ``n`` parked (or future) arrivals continue."""
        for _ in range(n):
            self._chan.released.release()

    def __enter__(self) -> "SyncPointHandle":
        return self

    def __exit__(self, *exc) -> None:
        SyncPoint.disable(self.name)


class SyncPoint:
    """Process-global registry of enabled sync points."""

    _lock = threading.Lock()
    _enabled: Dict[str, _Channel] = {}

    @classmethod
    def enable(cls, name: str) -> SyncPointHandle:
        with cls._lock:
            chan = _Channel()
            cls._enabled[name] = chan
        return SyncPointHandle(name, chan)

    @classmethod
    def disable(cls, name: str) -> None:
        with cls._lock:
            chan = cls._enabled.pop(name, None)
        if chan is not None:
            chan.active = False
            # unpark anything still waiting so disable never deadlocks
            chan.released.release()
            chan.released.release()

    @classmethod
    def disable_all(cls) -> None:
        for name in list(cls._enabled):
            cls.disable(name)

    @classmethod
    def _get(cls, name: str) -> Optional[_Channel]:
        # dict read without the lock: enabling/disabling during a race is
        # inherently ordered by the test itself
        return cls._enabled.get(name)


def sync_point(name: str) -> None:
    """Product-code side: park here iff a test enabled ``name``.

    Polls the current query's CancelFlag while parked so cancellation
    still wins over a forgotten release()."""
    chan = SyncPoint._get(name)
    if chan is None:
        return
    from .cancel import current_cancel_flag

    chan.arrived.release()
    flag = current_cancel_flag()
    while chan.active:
        if chan.released.acquire(timeout=0.05):
            return
        if flag is not None and flag.is_set():
            # cancelled while parked: consume nothing, let the caller's
            # next cancel checkpoint raise (keeps park/release accounting
            # simple and the raise site consistent)
            return


__all__ = ["SyncPoint", "SyncPointHandle", "sync_point"]
