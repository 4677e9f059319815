"""Execution summaries (EXPLAIN ANALYZE analog).

Counterpart of ``tiflash_tpu/runtime/summary.py``, with its fields and
the port's ``device`` (the result's torch device).  ``backend`` is
``"cuda"`` or ``"cpu"``; ``compile_seconds`` is the time this run spent
building kernels (``ops/cuda/build.BUILD_SECONDS``); the two byte fields
are the CUDA caching allocator's (``runtime/memory.py``), 0 on the CPU.
The allocator's counters are process-wide, as the reference's are: while
several queries run at once (the service's threads), a query's
``peak_device_bytes`` includes what the others held.

Role analog: ``Flash/Statistics/ExecutorStatisticsCollector.h:38`` /
``ExecutionSummary.cpp`` — per-executor rows + timing returned to TiDB.
Here: per-node live-row counts come back as traced scalars from the
fragment diagnostics; the runner stamps wall times and retry counts.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List


@dataclasses.dataclass
class ExecutionSummary:
    plan_text: str = ""
    node_rows: Dict[str, int] = dataclasses.field(default_factory=dict)
    wall_seconds: float = 0.0
    compile_seconds: float = 0.0
    retries: int = 0
    overflow_nodes: List[str] = dataclasses.field(default_factory=list)
    result_rows: int = 0
    backend: str = ""
    num_devices: int = 1
    # runtime memory accounting (MemoryTracker live-byte counters):
    # allocator peak during the run and live-byte delta across it
    peak_device_bytes: int = 0
    device_bytes_delta: int = 0
    device: str = ""
    # out-of-core runs: the mode, the sizing budget, and the chunk or
    # partition count (``pieces``), as ``runtime/outofcore.py`` reports
    out_of_core: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def pretty(self) -> str:
        lines = [
            f"wall={self.wall_seconds*1e3:.2f}ms compile={self.compile_seconds:.1f}s "
            f"retries={self.retries} rows={self.result_rows} "
            f"backend={self.backend} devices={self.num_devices}"
        ]
        for nid, rows in self.node_rows.items():
            lines.append(f"  {nid}: rows={rows}")
        return "\n".join(lines)


__all__ = ["ExecutionSummary"]
