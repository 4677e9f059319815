"""Single-device query runner with capacity-overflow retries.

Counterpart of ``tiflash_tpu/runtime/executor.py:run_query``.  The plan
first goes through the reference's rewrites,
``prune_columns(eager_aggregation(plan))`` (``plan/rewrite.py``), unless
``plan_rewrites=False`` (the reference's
``Settings.enable_plan_rewrites``).  It then runs through
``plan/compiler.py:execute_plan``; when an operator reports that its
bounded output overflowed, the runner grows that operator's capacity in
the rewritten tree to 1.25x what it reported and runs again, up to
``MAX_CAPACITY_RETRIES`` times: an Aggregation's slots, a Join's or a
CrossJoin's output capacity.  A Join whose unique-build promise was
false also moves to the general join path.

Every overflow flag and runtime-error flag of a run is read in one host
read.  An error flag never causes a retry: a run with an overflow is
retried (its rows are garbage), and only a capacity-clean run raises its
runtime errors (``EngineError``, code ``RUNTIME_EVAL``), as the
reference's runner does.

Not ported: the mesh (distributed) path, auto-sizing, out-of-core
fallbacks and the rest of the reference's ``Settings``.  They come with
later slices.  The query clock (NOW(), CURDATE(), RAND() without a seed)
is pinned once per run, as the reference's executor does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import torch

from ..core.block import Block
from ..expr.compile import query_clock, query_now_us
from ..plan import nodes as P
from ..plan.compiler import Diagnostics, execute_plan, flag_dict
from .errors import raise_runtime_errors, split_runtime_errors

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
        elif isinstance(node, (P.Join, P.CrossJoin)):
            node.output_capacity = max(target, (node.output_capacity or 0) * 2)
            # an overflow of the unique path means the build keys were
            # not unique: retry on the general (duplicate-correct) path
            if getattr(node, "unique_build", False):
                node.unique_build = False


def read_flags(flags: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Each flag's largest value as a host int, all in one host read."""
    if not flags:
        return {}
    maxes = [torch.as_tensor(v).max().to(torch.int64) for v in flags.values()]
    dev = maxes[0].device
    host = torch.stack([m.to(dev) for m in maxes]).tolist()
    return dict(zip(flags, host))


def run_query(
    plan: P.PlanNode,
    tables: Dict[str, Block],
    fuse_stream_agg: bool = True,
    mesh=None,
    plan_rewrites: bool = True,
) -> Tuple[Block, ExecutionSummary]:
    """Run ``plan`` over ``tables`` (Blocks, all on one device) with
    overflow retries.  Returns (result block, summary).  Capacity growth
    lands on the rewritten tree; with ``plan_rewrites=False`` that is
    ``plan`` itself."""
    if mesh is not None:
        raise NotImplementedError(
            "run_query over a mesh comes with the distribution slice of the "
            "port; this runner is single-device")
    # one NOW() for the whole query, retries included
    with query_clock(query_now_us()):
        return _run(plan, tables, fuse_stream_agg, plan_rewrites)


def _run(plan, tables, fuse_stream_agg, plan_rewrites):
    t_start = time.perf_counter()
    if plan_rewrites:
        from ..plan.rewrite import eager_aggregation, prune_columns

        plan = prune_columns(eager_aggregation(plan))
    summary = ExecutionSummary(plan_text=plan.pretty())
    for attempt in range(MAX_CAPACITY_RETRIES + 1):
        diag = Diagnostics({}, {})
        out = execute_plan(plan, tables, diag, fuse_stream_agg)
        overflows, errors = split_runtime_errors(read_flags(flag_dict(diag)))
        flagged = {k: v for k, v in overflows.items() if v > 0}
        if not flagged:
            raise_runtime_errors(errors)
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
