"""Fragment compiler: plan tree -> one eager function over tensors.

Counterpart of ``tiflash_tpu/plan/compiler.py``.  The reference traces a
fragment into one jitted program; the port runs the same walk eagerly.
Filters stay lazy selection masks; an Aggregation first tries the fused
scan->filter->project->aggregate path (``ops/stream_fuse.py``), which
declines any chain but scan/selection/projection (a join child, for
one), and falls back to the general aggregation methods.  A Join or a
CrossJoin runs its probe subtree, then its build subtree
(``ops/join.py``); a TopN runs ``ops/sort.py:top_n``.  A WithCTE runs
each definition once, before its child, and every CTERef of that name
returns the same block.  Node ids are the reference's DFS pre-order ids,
so overflow keys such as ``Join_5`` match.

The reference chooses the fused path by an environment knob; here it is
the explicit ``fuse_stream_agg`` argument of ``compile_fragment``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.block import Block
from ..expr.compile import ExprEvaluator
from ..expr.nodes import ColumnRef
from ..ops.aggregate import hash_aggregate
from ..ops.join import cross_join, hash_join_with_tail
from ..ops.sort import limit_block, sort_block, top_n
from . import nodes as P


@dataclasses.dataclass
class Diagnostics:
    """Scalars surfaced to the host runner: overflow flags trigger
    capacity-growing re-runs, row counts feed execution summaries."""

    overflows: Dict[str, torch.Tensor]
    rows: Dict[str, torch.Tensor]


def execute_plan(plan: P.PlanNode, tables: Dict[str, Block],
                 diag: Optional[Diagnostics] = None,
                 fuse_stream_agg: bool = True) -> Block:
    """Recursive walk of the plan, executing each node on its child."""
    if diag is None:
        diag = Diagnostics({}, {})
    return _exec_node(plan, tables, diag, [0], fuse_stream_agg)


def _exec_node(node: P.PlanNode, tables: Dict[str, Block], diag: Diagnostics,
               ctr: List[int], fuse: bool) -> Block:
    ctr[0] += 1
    nid = f"{type(node).__name__}_{ctr[0]}"

    def child_of(n):
        return _exec_node(n, tables, diag, ctr, fuse)

    if isinstance(node, P.TableScan):
        block = tables[node.table]
        if node.columns is not None:
            block = block.select(list(node.columns))
        diag.rows[nid] = block.num_rows()
        return block

    if isinstance(node, P.Selection):
        child = child_of(node.child)
        cond = ExprEvaluator(child).evaluate(node.cond)
        mask = cond.data.to(torch.bool)
        if cond.validity is not None:
            mask = mask & cond.validity  # NULL condition == not selected
        out = child.and_sel(mask)
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.AddColumns):
        child = child_of(node.child)
        ev = ExprEvaluator(child)
        out = child
        for name, e in node.exprs.items():
            out = out.with_column(name, ev.evaluate(e))
        return out

    if isinstance(node, P.Projection):
        child = child_of(node.child)
        ev = ExprEvaluator(child)
        cols = {name: ev.evaluate(e) for name, e in node.exprs.items()}
        out = Block.from_dict(cols, sel=child.sel)
        # row order is unchanged: clustering survives through bare-column
        # passthroughs (renames included)
        if child.clustered_by:
            rename = {
                e.name: out_name
                for out_name, e in node.exprs.items()
                if isinstance(e, ColumnRef)
            }
            kept = []
            for k in child.clustered_by:
                if k not in rename:
                    break
                kept.append(rename[k])
            if kept:
                out = dataclasses.replace(out, clustered_by=tuple(kept))
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Aggregation):
        if fuse:
            from ..ops.stream_fuse import try_fuse_stream_agg

            res = try_fuse_stream_agg(node, tables)
            if res is not None:
                diag.overflows[nid] = res.overflow
                diag.rows[nid] = res.num_groups
                return res.block
        child = child_of(node.child)
        if node.mode is not None:
            raise NotImplementedError(
                f"aggregation mode {node.mode!r} comes with the distribution "
                "slice of the port")
        res = hash_aggregate(child, list(node.keys), list(node.aggs), node.num_slots)
        diag.overflows[nid] = res.overflow
        diag.rows[nid] = res.num_groups
        return res.block

    if isinstance(node, P.Join):
        if node.rf_id is not None:
            raise NotImplementedError(
                "runtime filters (Join.rf_id) come with the distribution "
                "slice of the port")
        # probe first, then build: the DFS pre-order ids of the reference
        probe = child_of(node.probe)
        build = child_of(node.build)
        cap = None if node.unique_build else (node.output_capacity
                                              or probe.capacity)
        joined, extras = hash_join_with_tail(
            probe, build, list(node.probe_keys), list(node.build_keys),
            kind=node.kind, output_capacity=cap,
            build_payload=node.build_payload)
        diag.overflows[nid] = extras["overflow"]
        diag.rows[nid] = joined.num_rows()
        return joined

    if isinstance(node, P.CrossJoin):
        probe = child_of(node.probe)
        build = child_of(node.build)
        out, needed = cross_join(probe, build, node.output_capacity or probe.capacity)
        diag.overflows[nid] = needed
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.WithCTE):
        tables = dict(tables)
        for name, d in node.defs.items():
            tables["__cte_" + name] = _exec_node(d, tables, diag, ctr, fuse)
        return _exec_node(node.child, tables, diag, ctr, fuse)

    if isinstance(node, P.CTERef):
        try:
            return tables["__cte_" + node.name]
        except KeyError:
            raise KeyError(f"CTE {node.name!r} not defined by an enclosing "
                           "WithCTE") from None

    if isinstance(node, P.TopN):
        child = child_of(node.child)
        out = top_n(child, list(node.sort_keys), node.limit)
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Sort):
        child = child_of(node.child)
        out = sort_block(child, list(node.sort_keys))
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Limit):
        child = child_of(node.child)
        out = limit_block(child, node.limit)
        diag.rows[nid] = out.num_rows()
        return out

    raise NotImplementedError(
        f"plan node {type(node).__name__} is not ported yet: it comes with "
        "a later slice of the port")


def compile_fragment(
    plan: P.PlanNode,
    fuse_stream_agg: bool = True,
) -> Callable[[Dict[str, Block]], Tuple[Block, Dict[str, torch.Tensor]]]:
    """Returns fn(tables) -> (result block, overflow flags).
    ``fuse_stream_agg`` lets an Aggregation over a scan chain take the
    fused stream-agg path."""

    def run(tables: Dict[str, Block]):
        diag = Diagnostics({}, {})
        out = execute_plan(plan, tables, diag, fuse_stream_agg)
        return out, dict(diag.overflows)

    return run


__all__ = ["execute_plan", "compile_fragment", "Diagnostics"]
