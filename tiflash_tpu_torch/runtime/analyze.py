"""EXPLAIN ANALYZE with per-operator timings.

Counterpart of ``tiflash_tpu/runtime/analyze.py``, with its output.  Role
analog: ``Flash/Statistics/ExecutorStatisticsCollector.h:38`` /
``ExecutionSummary.cpp``, where the pipeline executor stamps each
operator's time as rows stream through it.  Here each plan subtree runs
on its own and is timed, and

    self_time(node) = t(subtree(node)) - sum of t(subtree(child)),

clamped at 0.  On a CUDA device a subtree's time is measured with CUDA
events after a synchronize (queued work from before cannot leak in; the
call itself ends in host reads); on the CPU with ``time.perf_counter``.
This replaces the reference's perturbed carry chains, a workaround for
XLA eliding identical dispatches.  The subtrees run in rounds, each
round every subtree once in pre-order: ``k1`` warm rounds (every shape
allocated once before any timing), then ``k2`` timed rounds, so a drift
of the host or the card's clocks touches every subtree alike.  A
subtree's time is its median.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

import torch

from ..core.block import Block
from ..plan import nodes as P


def walk_subtrees(plan: P.PlanNode, path: str = "0"):
    """Pre-order (path, node) pairs; child order mirrors plan structure."""
    yield path, plan
    for i, c in enumerate(plan.children):
        yield from walk_subtrees(c, f"{path}.{i}")


def _label(node: P.PlanNode) -> str:
    return type(node).__name__


def _device(tables: Dict[str, Block]) -> torch.device:
    return next(iter(tables.values())).device


def _run_once(plan: P.PlanNode, tables: Dict[str, Block], device) -> float:
    """Seconds of one ``execute_plan`` of ``plan``, synchronized."""
    from ..plan.compiler import execute_plan

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = execute_plan(plan, tables)
        int(out.num_rows())
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = execute_plan(plan, tables)
    int(out.num_rows())
    return time.perf_counter() - t0


def time_subtree(plan: P.PlanNode, tables: Dict[str, Block],
                 k1: int = 2, k2: int = 6) -> float:
    """Median seconds of one run of ``plan`` over ``k2`` timed runs,
    after ``k1`` warm runs."""
    device = _device(tables)
    for _ in range(k1):
        _run_once(plan, tables, device)
    return statistics.median(_run_once(plan, tables, device) for _ in range(k2))


def _has_unbound_cte(node: P.PlanNode, bound: frozenset = frozenset()) -> bool:
    if isinstance(node, P.CTERef):
        return node.name not in bound
    if isinstance(node, P.WithCTE):
        if any(_has_unbound_cte(d, bound) for d in node.defs.values()):
            return True
        return _has_unbound_cte(node.child, bound | frozenset(node.defs))
    return any(_has_unbound_cte(c, bound) for c in node.children)


def explain_analyze(plan: P.PlanNode, tables: Dict[str, Block],
                    k1: int = 2, k2: int = 6) -> List[Dict]:
    """Per-node timing report: rows in pre-order with the path, the
    operator, its subtree seconds and its self seconds (None where a
    subtree cannot run alone, as a CTERef outside its WithCTE)."""
    entries = list(walk_subtrees(plan))
    device = _device(tables)
    # a CTERef outside its WithCTE is not runnable standalone
    runs: Dict[str, List[float]] = {path: [] for path, node in entries
                                    if not _has_unbound_cte(node)}
    for round_no in range(k1 + k2):
        for path, node in entries:
            if path not in runs:
                continue
            try:
                t = _run_once(node, tables, device)
            except Exception:
                del runs[path]
                continue
            if round_no >= k1:
                runs[path].append(t)
    sub_times: Dict[str, Optional[float]] = {
        path: statistics.median(runs[path]) if runs.get(path) else None
        for path, _ in entries}

    report = []
    for path, node in entries:
        t = sub_times.get(path)
        self_t = None
        if t is not None:
            child_sum = 0.0
            ok = True
            for cp, _ in entries:
                if cp.startswith(path + ".") and cp.count(".") == path.count(".") + 1:
                    ct = sub_times.get(cp)
                    if ct is None:
                        ok = False
                        break
                    child_sum += ct
            if ok:
                self_t = max(t - child_sum, 0.0)
        report.append({
            "path": path,
            "operator": _label(node),
            "detail": str(node) if len(str(node)) < 120 else _label(node),
            "subtree_s": t,
            "self_s": self_t,
        })
    return report


def format_analyze(report: List[Dict]) -> str:
    lines = ["path        operator              subtree       self"]
    for r in report:
        sub = "-" if r["subtree_s"] is None else f"{r['subtree_s']*1e3:9.2f}ms"
        slf = "-" if r["self_s"] is None else f"{r['self_s']*1e3:9.2f}ms"
        indent = "  " * r["path"].count(".")
        lines.append(f"{r['path']:<10}  {indent}{r['operator']:<20.20} {sub:>11} {slf:>10}")
    return "\n".join(lines)


__all__ = ["explain_analyze", "format_analyze", "time_subtree", "walk_subtrees"]
