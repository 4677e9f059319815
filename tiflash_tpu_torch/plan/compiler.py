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
``RuntimeFilterApply`` applies, ``mpp/runner.py``); a TopN runs
``ops/sort.py:top_n``; a Window runs
``ops/window.py:window_block``, an Expand ``ops/expand.py:expand_block``,
and a Union concatenates its children's rows in order
(``exchange/skew.py:concat_blocks``).  A WithCTE runs
each definition once, before its child, and every CTERef of that name
returns the same block.  Node ids are the reference's DFS pre-order ids,
so overflow keys such as ``Join_5`` match.  Each node runs inside its
span ``op.<NodeType>`` (``runtime/tracing.py:op_span``; nothing while
tracing is off).

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
    # published runtime filters: rf_id -> [per-key (min, max, set|None)]
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


def eval_error_flags(ev: ExprEvaluator, block: Block) -> Dict[str, torch.Tensor]:
    """An evaluator's per-row error masks folded into one flag per
    message, masked to the block's live rows (the evaluator's list is
    emptied)."""
    out: Dict[str, torch.Tensor] = {}
    for mask, msg in ev.runtime_errors:
        if block.sel is not None:
            mask = mask & block.sel
        flag = torch.any(mask)
        prev = out.get(msg)
        out[msg] = flag if prev is None else (prev | flag)
    ev.runtime_errors.clear()
    return out


def _drain_eval_errors(ev: ExprEvaluator, block: Block, diag: Diagnostics) -> None:
    for msg, flag in eval_error_flags(ev, block).items():
        prev = diag.errors.get(msg)
        diag.errors[msg] = flag if prev is None else (prev | flag)


def _exec_node(node: P.PlanNode, tables: Dict[str, Block], diag: Diagnostics,
               ctr: List[int], fuse: bool) -> Block:
    ctr[0] += 1
    kind = type(node).__name__
    nid = f"{kind}_{ctr[0]}"
    with tracing.op_span(kind, nid, tables):
        return _run_node(node, nid, tables, diag, ctr, fuse)


def _run_node(node: P.PlanNode, nid: str, tables: Dict[str, Block], diag: Diagnostics,
              ctr: List[int], fuse: bool) -> Block:
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
        ev = ExprEvaluator(child)
        cond = ev.evaluate(node.cond)
        _drain_eval_errors(ev, child, diag)
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
        _drain_eval_errors(ev, child, diag)
        return out

    if isinstance(node, P.Projection):
        child = child_of(node.child)
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
        # "partial" and "final" are tags: both run the method dispatch
        if node.mode == "auto":
            res = auto_passthrough_aggregate(child, list(node.keys), list(node.aggs))
        else:
            res = hash_aggregate(child, list(node.keys), list(node.aggs),
                                 node.num_slots)
        diag.overflows[nid] = res.overflow
        diag.rows[nid] = res.num_groups
        return res.block

    if isinstance(node, P.Join):
        if node.rf_id is not None:
            from ..mpp.runner import _publish_runtime_filter

            # build first, so its filter reaches the probe subtree
            build = child_of(node.build)
            _publish_runtime_filter(node, [build], diag.rf, None, diag.rf_in_set_max)
            probe = child_of(node.probe)
        else:
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

    if isinstance(node, P.RuntimeFilterApply):
        from ..mpp.runner import _apply_runtime_filter

        child = child_of(node.child)
        entries = diag.rf.get(node.rf_id)
        out = _apply_runtime_filter(node, child, None if entries is None else entries[0])
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Expand):
        child = child_of(node.child)
        out = expand_block(child, [list(s) for s in node.grouping_sets], node.gid_name)
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Window):
        child = child_of(node.child)
        out = window_block(child, list(node.partition_by), list(node.order_by),
                           list(node.funcs))
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Union):
        parts = [child_of(c) for c in node.children]
        out = parts[0]
        for p in parts[1:]:
            out = concat_blocks(out, p)
        diag.rows[nid] = out.num_rows()
        return out

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

    if isinstance(node, (P.ExchangeSender, P.ExchangeReceiver)):
        raise ValueError(
            "exchange nodes mark fragment boundaries: run the plan through "
            "mpp.runner, not the single-fragment compiler")

    raise NotImplementedError(f"plan node {type(node).__name__}")


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


__all__ = ["execute_plan", "compile_fragment", "Diagnostics", "flag_dict",
           "eval_error_flags"]
