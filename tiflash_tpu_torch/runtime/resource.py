"""Resource control: token-bucket admission per resource group.

Counterpart of ``tiflash_tpu/runtime/resource.py``, a host-only copy.

Role analog: ``Flash/ResourceControl/LocalAdmissionController.h`` +
``TokenBucket.h:32`` and RU accounting (``Flash/Executor/toRU.cpp``;
design ``docs/design/2023-09-21-tiflash-resource-control.md``).  The
reference fetches tokens from PD's global admission controller; here the
bucket is local (refilled by wall clock) and RU = request units derived
from rows scanned + wall seconds, matching the spirit of toRU's
cpu-time -> RU conversion.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional


@dataclasses.dataclass
class TokenBucket:
    fill_rate: float          # RU per second
    capacity: float           # max burst RU
    tokens: float = 0.0
    _last: float = dataclasses.field(default_factory=time.monotonic)

    def _refill(self):
        now = time.monotonic()
        self.tokens = min(self.capacity, self.tokens + (now - self._last) * self.fill_rate)
        self._last = now

    def try_consume(self, ru: float) -> bool:
        self._refill()
        if self.tokens >= ru:
            self.tokens -= ru
            return True
        return False

    def wait_consume(self, ru: float, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while True:
            if self.try_consume(ru):
                return True
            if time.monotonic() >= deadline:
                return False
            self._refill()
            deficit = max(ru - self.tokens, 0.0)
            from .metrics import METRICS

            METRICS.counter("admission_waits_total").inc()
            wait_s = min(deficit / max(self.fill_rate, 1e-9), 0.25)
            METRICS.counter("admission_wait_seconds_total").inc(wait_s)
            time.sleep(wait_s)


def to_ru(rows_scanned: int, wall_seconds: float) -> float:
    """Request-unit model: ~1 RU per 100k rows + 1 RU per 10ms of wall
    time (the cpu-time->RU shape of ``toRU.cpp``, constants ours)."""
    return rows_scanned / 100_000 + wall_seconds * 100


class ResourceGroupManager:
    """Named resource groups with independent buckets (the
    LocalAdmissionController analog; no PD — groups are local config)."""

    def __init__(self):
        self._groups: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def configure(self, name: str, fill_rate: float, capacity: Optional[float] = None):
        with self._lock:
            self._groups[name] = TokenBucket(
                fill_rate=fill_rate, capacity=capacity or fill_rate * 2,
                tokens=capacity or fill_rate * 2,
            )

    def admit(self, name: str, ru: float, timeout: float = 30.0) -> bool:
        """True if the group admits the request (unknown groups always do)."""
        with self._lock:
            bucket = self._groups.get(name)
        if bucket is None:
            return True
        return bucket.wait_consume(ru, timeout)


RESOURCE_GROUPS = ResourceGroupManager()

__all__ = ["TokenBucket", "ResourceGroupManager", "RESOURCE_GROUPS", "to_ru"]
