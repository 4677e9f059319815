"""Single-device query runner with capacity-overflow retries.

Counterpart of ``tiflash_tpu/runtime/executor.py:run_query``.  A plan
runs through ``plan/compiler.py:execute_plan``; when an operator reports
that its bounded output overflowed, the runner grows that operator's
capacity to 1.25x what it reported and runs again, up to
``MAX_CAPACITY_RETRIES`` times.  A Join whose unique-build promise was
false also moves to the general join path.

Not ported: the mesh (distributed) path, the plan rewrites
(``eager_aggregation``/``prune_columns``), auto-sizing, out-of-core
fallbacks and the session settings.  They come with later slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

from ..core.block import Block
from ..plan import nodes as P
from ..plan.compiler import Diagnostics, execute_plan

MAX_CAPACITY_RETRIES = 4


@dataclasses.dataclass
class ExecutionSummary:
    plan_text: str = ""
    node_rows: Dict[str, int] = dataclasses.field(default_factory=dict)
    wall_seconds: float = 0.0
    retries: int = 0
    overflow_nodes: List[str] = dataclasses.field(default_factory=list)
    result_rows: int = 0
    device: str = ""


def enumerate_plan(plan: P.PlanNode) -> Dict[int, P.PlanNode]:
    """The DFS pre-order ids the compiler gives nodes (its overflow keys
    are f"{type(node).__name__}_{id}")."""
    nodes: Dict[int, P.PlanNode] = {}
    ctr = [0]

    def walk(node: P.PlanNode):
        ctr[0] += 1
        nodes[ctr[0]] = node
        for c in node.children:
            walk(c)

    walk(plan)
    return nodes


def _grow(plan: P.PlanNode, flagged: Dict[str, int]) -> None:
    """Overflow values carry the required capacity: grow to 1.25x it."""
    nodes = enumerate_plan(plan)
    for key, needed in flagged.items():
        target = max(int(needed * 1.25) + 1, 16)
        node = nodes.get(int(key.rpartition("_")[2]))
        if isinstance(node, P.Aggregation):
            node.num_slots = max(target, (node.num_slots or 0) * 2)
        elif isinstance(node, P.Join):
            node.output_capacity = max(target, (node.output_capacity or 0) * 2)
            # an overflow of the unique path means the build keys were
            # not unique: retry on the general (duplicate-correct) path
            node.unique_build = False


def run_query(
    plan: P.PlanNode,
    tables: Dict[str, Block],
    fuse_stream_agg: bool = True,
    mesh=None,
) -> Tuple[Block, ExecutionSummary]:
    """Run ``plan`` over ``tables`` (Blocks, all on one device) with
    overflow retries.  Returns (result block, summary)."""
    if mesh is not None:
        raise NotImplementedError(
            "run_query over a mesh comes with the distribution slice of the "
            "port; this runner is single-device")
    t_start = time.perf_counter()
    summary = ExecutionSummary(plan_text=plan.pretty())
    for attempt in range(MAX_CAPACITY_RETRIES + 1):
        diag = Diagnostics({}, {})
        out = execute_plan(plan, tables, diag, fuse_stream_agg)
        flagged = {k: int(v.max()) for k, v in diag.overflows.items()
                   if int(v.max()) > 0}
        if not flagged:
            break
        summary.retries += 1
        summary.overflow_nodes.extend(flagged)
        if attempt == MAX_CAPACITY_RETRIES:
            raise RuntimeError(
                f"capacity overflow persisted after {MAX_CAPACITY_RETRIES} "
                f"retries: {flagged}")
        _grow(plan, flagged)
    summary.node_rows = {k: int(v) for k, v in diag.rows.items()}
    summary.result_rows = int(out.num_rows())
    summary.device = str(out.device) if out.columns else ""
    summary.wall_seconds = time.perf_counter() - t_start
    return out, summary


__all__ = ["run_query", "ExecutionSummary", "enumerate_plan"]
