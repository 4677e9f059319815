"""Device-memory accounting: pre-flight estimation per query, and the
CUDA allocator's counters around a run.

Counterpart of ``tiflash_tpu/runtime/memory.py``.  Role analog: the
hierarchical ``MemoryTracker`` (``Common/MemoryTracker.h:39``) that aborts
or spills queries over quota.  Enforcement happens before launch: the
runner estimates the bytes a plan materializes (inputs + per-node
outputs + transient sort copies) and, over the quota, refuses to run it
in one piece; the out-of-core driver (``runtime/outofcore.py``) then
splits the input.

``block_bytes`` is the reference's rule over the port's storage: each
column's ``data`` (limb planes of a wide decimal included) and validity
at one byte a row, plus the selection mask.  The ``narrow32`` shadow is
not counted, as the reference does not count its own, so the same
``Settings`` pick the same out-of-core mode and the same chunk and
partition counts in both packages.  ``block_bytes(b, shadows=True)``
adds the shadows: what the block holds on the card.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from ..core.block import Block
from ..plan import nodes as P


class MemoryLimitError(RuntimeError):
    pass


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def block_bytes(block: Block, shadows: bool = False) -> int:
    total = 0
    for c in block.columns:
        total += _nbytes(c.data)
        if c.validity is not None:
            total += c.validity.numel()
        if shadows:
            total += _nbytes(c.narrow32)
    if block.sel is not None:
        total += block.sel.numel()
    return total


def _row_bytes(block: Block) -> int:
    return max(1, block_bytes(block) // max(block.capacity, 1))


def _selection_fraction(node: P.PlanNode, tables: Dict[str, Block]):
    """Sampled live fraction of a Selection over a base scan (None when
    not measurable), so the per-operator working set sees the input after
    its selections."""
    scan = node.children[0]
    while isinstance(scan, (P.Selection, P.Projection)):
        scan = scan.children[0]
    if not isinstance(scan, P.TableScan):
        return None
    from ..plan.auto import _sampled_selectivity

    return _sampled_selectivity(node.cond, scan, tables)


def _plan_node_sizes(plan: P.PlanNode, tables: Dict[str, Block]):
    """Per-node size model: ``[(node, out_bytes, work_bytes)]`` in
    post-order; ``out_bytes`` is the node's estimated output and
    ``work_bytes`` its own transient + output footprint."""
    rows = []

    def walk(node: P.PlanNode) -> int:
        if isinstance(node, P.TableScan):
            b = tables.get(node.table)
            out = block_bytes(b) if b is not None else 0
            rows.append((node, out, 0))
            return out
        child_sizes = [walk(c) for c in node.children]
        if isinstance(node, P.Selection):
            out, work = child_sizes[0], 0
            frac = _selection_fraction(node, tables)
            if frac is not None:
                out = max(1, int(out * frac))
        elif isinstance(node, P.Projection):
            out = child_sizes[0]  # approx: similar width
            work = out
        elif isinstance(node, P.Aggregation):
            out = child_sizes[0]
            work = 3 * out  # sort operands + permuted copy + output
        elif isinstance(node, P.Join):
            probe, build = child_sizes
            cap = getattr(node, "output_capacity", None)
            if cap and tables:
                any_b = next(iter(tables.values()))
                out = cap * _row_bytes(any_b) * 2
            else:
                out = probe + build
            work = out + 2 * build  # sorted build copy
        elif isinstance(node, P.CrossJoin):
            out = child_sizes[0] + child_sizes[1]
            work = out
        elif isinstance(node, (P.Sort, P.TopN, P.Window)):
            out = child_sizes[0]
            work = 2 * out  # sort operands + permuted output
        else:
            out = child_sizes[0] if child_sizes else 0
            work = 0
        rows.append((node, out, work))
        return out

    walk(plan)
    return rows


def estimate_plan_bytes(plan: P.PlanNode, tables: Dict[str, Block]) -> int:
    """Rough peak-bytes estimate: inputs once + every node's own
    footprint (outputs and sort-like transients)."""
    total = sum(block_bytes(b) for b in tables.values())
    return total + sum(work for _, _, work in _plan_node_sizes(plan, tables))


def estimate_operator_bytes(plan: P.PlanNode, tables: Dict[str, Block],
                            kinds: tuple) -> int:
    """Working set of the largest node of the given kinds: its inputs
    plus its own transients, the comparator for the per-operator
    ``max_bytes_before_external_*`` thresholds."""
    sizes = _plan_node_sizes(plan, tables)
    out_of = {id(n): o for n, o, _ in sizes}
    best = 0
    for node, _out, work in sizes:
        if isinstance(node, kinds):
            inputs = sum(out_of[id(c)] for c in node.children)
            best = max(best, inputs + work)
    return best


def plan_chunk_rows(plan: P.PlanNode, tables: Dict[str, Block],
                    budget: int, work_factor: int = 8) -> int:
    """Rows per out-of-core chunk so that a chunk's working set fits the
    budget, from the per-row width of the widest scanned table (its
    scanned columns only).  ``work_factor`` covers transient copies."""
    widest = 1

    def walk(node: P.PlanNode) -> None:
        nonlocal widest
        if isinstance(node, P.TableScan):
            b = tables.get(node.table)
            if b is not None:
                if node.columns:
                    have = [c for c in node.columns if c in b.names]
                    if have:
                        sub = Block(names=tuple(have),
                                    columns=tuple(b[c] for c in have), sel=None)
                        widest = max(widest, _row_bytes(sub))
                        return
                widest = max(widest, _row_bytes(b))
        for c in node.children:
            walk(c)

    walk(plan)
    return max(4096, int(budget // (work_factor * widest)))


# ---------------------------------------------------------------------------
# runtime accounting: the CUDA caching allocator's counters
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _device_total_bytes(index: int) -> int:
    return int(torch.cuda.mem_get_info(index)[1])


def device_memory_stats(device=None) -> Dict[str, int]:
    """The allocator's live and peak bytes on ``device`` and the card's
    total memory as the limit; ``{}`` for a CPU device (no counters), as
    the reference returns on backends without stats.  The counters are
    the caching allocator's host-side books: reading them needs no
    synchronize."""
    if device is None or torch.device(device).type != "cuda":
        return {}
    dev = torch.device(device)
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": _device_total_bytes(dev.index or 0),
    }


class QueryMemoryScope:
    """Per-query runtime accounting on ``device``: resets the allocator's
    peak at entry, so ``peak_bytes`` is this query's peak, and reports
    the live-byte delta across the scope.  Zeros on the CPU.  The peak and
    the live bytes are the process's: with queries running at once in
    other threads, both include their allocations."""

    def __init__(self, device=None):
        self.device = device
        self.before: Dict[str, int] = {}
        self.peak_bytes: int = 0
        self.delta_bytes: int = 0

    def __enter__(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.before = device_memory_stats(self.device)
        return self

    def __exit__(self, *exc):
        after = device_memory_stats(self.device)
        if after:
            self.peak_bytes = after.get("peak_bytes_in_use", 0)
            self.delta_bytes = after.get("bytes_in_use", 0) - self.before.get(
                "bytes_in_use", 0)
            from .metrics import METRICS

            METRICS.counter("device_bytes_in_use").set(after.get("bytes_in_use", 0))
            METRICS.counter("device_peak_bytes").set(self.peak_bytes)
        return False


def check_memory(plan: P.PlanNode, tables: Dict[str, Block], limit: Optional[int]):
    if limit is None:
        return
    est = estimate_plan_bytes(plan, tables)
    if est > limit:
        raise MemoryLimitError(
            f"estimated device bytes {est:,} exceed limit {limit:,}; "
            "split the input tables or raise max_bytes_per_device")


__all__ = ["estimate_plan_bytes", "estimate_operator_bytes", "check_memory",
           "MemoryLimitError", "block_bytes", "plan_chunk_rows",
           "device_memory_stats", "QueryMemoryScope"]
