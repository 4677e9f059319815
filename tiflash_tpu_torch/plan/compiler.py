"""Fragment compiler: plan tree -> one eager function over tensors.

Counterpart of ``tiflash_tpu/plan/compiler.py``.  The reference traces a
fragment into one jitted program; the port runs the same walk eagerly.
Filters stay lazy selection masks; an Aggregation first tries the fused
scan->filter->project->aggregate path (``ops/stream_fuse.py``), which
declines any chain but scan/selection/projection (a join child, for
one), and falls back to the general aggregation methods.  A Join or a
CrossJoin runs its probe subtree, then its build subtree
(``ops/join.py``; right and full outer joins append the unmatched build
rows; a Join with an ``rf_id`` runs its build subtree first and
publishes its runtime filter, which the probe subtree's
``RuntimeFilterApply`` applies, ``ops/runtime_filter.py``); a TopN runs
``ops/sort.py:top_n``; a Window runs
``ops/window.py:window_block``, an Expand ``ops/expand.py:expand_block``,
and a Union concatenates its children's rows in order
(``exchange/skew.py:concat_blocks``).  A WithCTE runs
each definition once, before its child, and every CTERef of that name
returns the same block.  Node ids are the reference's DFS pre-order ids,
so overflow keys such as ``Join_5`` match.  Each node runs inside its
span ``op.<NodeType>`` (``runtime/tracing.py:op_span``; nothing while
tracing is off).

The walk (``_run_node``) owns the order and the structure: node ids,
spans, the order of the children, the fused path, scans and CTEs.  What
a node does over its computed children is ``apply_local``, which the
mesh runner (``mpp/runner.py``) also runs once per shard.

The reference chooses the fused path by an environment knob; here it is
the explicit ``fuse_stream_agg`` argument of ``compile_fragment``.

The runtime error channel: after a Selection, an AddColumns or a
Projection evaluates its expressions, the evaluator's per-row error masks
(string and JSON tables with ``EvalError`` entries) are folded into one
flag per message over the child block's live rows
(``Diagnostics.errors``); a filtered-out row never errors.
``compile_fragment`` returns them beside the overflow flags under
``RTERR_PREFIX``, and the runner raises them once a run is
capacity-clean (``runtime/errors.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.block import Block
from ..expr.compile import ExprEvaluator
from ..expr.nodes import ColumnRef
from ..exchange.skew import concat_blocks
from ..ops.aggregate import auto_passthrough_aggregate, hash_aggregate
from ..ops.expand import expand_block
from ..ops.join import cross_join, hash_join_with_tail
from ..ops.runtime_filter import apply_runtime_filter, publish_runtime_filter
from ..ops.sort import limit_block, sort_block, top_n
from ..ops.window import window_block
from ..runtime import tracing
from ..runtime.errors import RTERR_PREFIX
from . import nodes as P


@dataclasses.dataclass
class Diagnostics:
    """Scalars surfaced to the host runner: overflow flags trigger
    capacity-growing re-runs, row counts feed execution summaries."""

    overflows: Dict[str, torch.Tensor]
    rows: Dict[str, torch.Tensor]
    # message -> 0-d bool flag: some live row hit a per-row EvalError
    errors: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # the run's published runtime filters: rf_id -> one list per local
    # shard (one without a mesh) of per-key (min, max, set|None)
    rf: Dict[str, list] = dataclasses.field(default_factory=dict)
    rf_in_set_max: int = 1 << 20


def execute_plan(plan: P.PlanNode, tables: Dict[str, Block],
                 diag: Optional[Diagnostics] = None,
                 fuse_stream_agg: bool = True) -> Block:
    """Recursive walk of the plan, executing each node on its child."""
    if diag is None:
        diag = Diagnostics({}, {})
    diag.rf.clear()  # a run's filters must not leak into the next
    return _exec_node(plan, tables, diag, [0], fuse_stream_agg)


def _drain_eval_errors(ev: ExprEvaluator, block: Block, diag: Diagnostics) -> None:
    """Fold the evaluator's per-row error masks into one flag per message
    over the block's live rows (the evaluator's list is emptied)."""
    for mask, msg in ev.runtime_errors:
        if block.sel is not None:
            mask = mask & block.sel
        flag = torch.any(mask)
        prev = diag.errors.get(msg)
        diag.errors[msg] = flag if prev is None else (prev | flag)
    ev.runtime_errors.clear()


def _exec_node(node: P.PlanNode, tables: Dict[str, Block], diag: Diagnostics,
               ctr: List[int], fuse: bool) -> Block:
    ctr[0] += 1
    kind = type(node).__name__
    nid = f"{kind}_{ctr[0]}"
    with tracing.op_span(kind, nid, tables):
        return _run_node(node, nid, tables, diag, ctr, fuse)


def _run_node(node: P.PlanNode, nid: str, tables: Dict[str, Block], diag: Diagnostics,
              ctr: List[int], fuse: bool) -> Block:
    """The walk: scans, CTEs, the fused aggregation and the order of the
    children; every other node's own work is ``apply_local``."""
    def child_of(n):
        return _exec_node(n, tables, diag, ctr, fuse)

    if isinstance(node, P.TableScan):
        block = tables[node.table]
        if node.columns is not None:
            block = block.select(list(node.columns))
        diag.rows[nid] = block.num_rows()
        return block

    if isinstance(node, P.WithCTE):
        tables = dict(tables)
        for name, d in node.defs.items():
            tables["__cte_" + name] = _exec_node(d, tables, diag, ctr, fuse)
        return _exec_node(node.child, tables, diag, ctr, fuse)

    if isinstance(node, P.CTERef):
        return cte_block(tables, node.name)

    if isinstance(node, (P.ExchangeSender, P.ExchangeReceiver)):
        raise ValueError(
            "exchange nodes mark fragment boundaries: run the plan through "
            "mpp.runner, not the single-fragment compiler")

    if fuse and isinstance(node, P.Aggregation):
        from ..ops.stream_fuse import try_fuse_stream_agg

        res = try_fuse_stream_agg(node, tables)
        if res is not None:
            diag.overflows[nid] = res.overflow
            diag.rows[nid] = res.num_groups
            return res.block

    if isinstance(node, P.Join) and node.rf_id is not None:
        # build first, so its filter reaches the probe subtree
        build = child_of(node.build)
        diag.rf[node.rf_id] = publish_runtime_filter(
            node.build_keys, [build], in_set_max=diag.rf_in_set_max)
        children = [child_of(node.probe), build]
    else:
        # probe first, then build: the DFS pre-order ids of the reference
        children = [child_of(c) for c in node.children]
    return apply_local(node, nid, children, diag)


def cte_block(tables: Dict, name: str):
    """The block a WithCTE defined under ``name``."""
    try:
        return tables["__cte_" + name]
    except KeyError:
        raise KeyError(f"CTE {name!r} not defined by an enclosing WithCTE") from None


def apply_local(node: P.PlanNode, nid: str, children: List[Block],
                diag: Diagnostics) -> Block:
    """One node's own work over its children's blocks (probe before
    build), on one device or on one shard of a mesh: records the node's
    overflow flag, evaluation-error flags and live rows in ``diag``, and
    reads a published runtime filter from ``diag.rf`` (its first entry:
    the one shard's)."""
    child = children[0] if children else None
    if isinstance(node, P.AddColumns):
        ev = ExprEvaluator(child)
        out = child
        for name, e in node.exprs.items():
            out = out.with_column(name, ev.evaluate(e))
        _drain_eval_errors(ev, child, diag)
        return out

    if isinstance(node, P.Aggregation):
        # "partial" and "final" are tags: both run the method dispatch
        if node.mode == "auto":
            res = auto_passthrough_aggregate(child, list(node.keys), list(node.aggs))
        else:
            res = hash_aggregate(child, list(node.keys), list(node.aggs),
                                 node.num_slots)
        diag.overflows[nid] = res.overflow
        diag.rows[nid] = res.num_groups
        return res.block

    if isinstance(node, P.Selection):
        ev = ExprEvaluator(child)
        cond = ev.evaluate(node.cond)
        _drain_eval_errors(ev, child, diag)
        mask = cond.data.to(torch.bool)
        if cond.validity is not None:
            mask = mask & cond.validity  # NULL condition == not selected
        out = child.and_sel(mask)
    elif isinstance(node, P.Projection):
        ev = ExprEvaluator(child)
        cols = {name: ev.evaluate(e) for name, e in node.exprs.items()}
        _drain_eval_errors(ev, child, diag)
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
    elif isinstance(node, P.Join):
        probe, build = children
        cap = None if node.unique_build else (node.output_capacity
                                              or probe.capacity)
        out, extras = hash_join_with_tail(
            probe, build, list(node.probe_keys), list(node.build_keys),
            kind=node.kind, output_capacity=cap,
            build_payload=node.build_payload)
        diag.overflows[nid] = extras["overflow"]
    elif isinstance(node, P.CrossJoin):
        probe, build = children
        out, diag.overflows[nid] = cross_join(probe, build,
                                              node.output_capacity or probe.capacity)
    elif isinstance(node, P.RuntimeFilterApply):
        entries = diag.rf.get(node.rf_id)
        out = apply_runtime_filter(child, node.key_names,
                                   None if entries is None else entries[0])
    elif isinstance(node, P.Expand):
        out = expand_block(child, [list(s) for s in node.grouping_sets], node.gid_name)
    elif isinstance(node, P.Window):
        out = window_block(child, list(node.partition_by), list(node.order_by),
                           list(node.funcs))
    elif isinstance(node, P.Union):
        out = children[0]
        for p in children[1:]:
            out = concat_blocks(out, p)
    elif isinstance(node, P.TopN):
        out = top_n(child, list(node.sort_keys), node.limit)
    elif isinstance(node, P.Sort):
        out = sort_block(child, list(node.sort_keys))
    elif isinstance(node, P.Limit):
        out = limit_block(child, node.limit)
    else:
        raise NotImplementedError(f"plan node {type(node).__name__}")
    diag.rows[nid] = out.num_rows()
    return out


def compile_fragment(
    plan: P.PlanNode,
    fuse_stream_agg: bool = True,
    rf_in_set_max: int = 1 << 20,
) -> Callable[[Dict[str, Block]], Tuple[Block, Dict[str, torch.Tensor]]]:
    """Returns fn(tables) -> (result block, flags): the overflow flags,
    and the runtime-error flags under ``RTERR_PREFIX``
    (``runtime/errors.py:split_runtime_errors`` parts them).
    ``fuse_stream_agg`` lets an Aggregation over a scan chain take the
    fused stream-agg path; ``rf_in_set_max`` gates the runtime filters'
    key-set form."""

    def run(tables: Dict[str, Block]):
        diag = Diagnostics({}, {}, rf_in_set_max=rf_in_set_max)
        out = execute_plan(plan, tables, diag, fuse_stream_agg)
        return out, flag_dict(diag)

    return run


def flag_dict(diag: Diagnostics) -> Dict[str, torch.Tensor]:
    """The overflow flags and, under ``RTERR_PREFIX``, the runtime-error
    flags of one run."""
    flags = dict(diag.overflows)
    for msg, v in diag.errors.items():
        flags[RTERR_PREFIX + msg] = v
    return flags


__all__ = ["execute_plan", "apply_local", "cte_block", "compile_fragment",
           "Diagnostics", "flag_dict"]
