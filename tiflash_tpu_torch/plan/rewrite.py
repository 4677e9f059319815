"""Logical plan rewrites: aggregation pushdown and column pruning.

Counterpart of ``tiflash_tpu/plan/rewrite.py``, the pass the runner
applies to every plan before it runs it (``runtime/executor.py``):

- ``eager_aggregation`` pushes an Aggregation below a unique-build inner
  join when every aggregate reads only probe-side columns and the group
  keys hold the probe join keys.  The pre-aggregated probe side is much
  smaller than the joined rows, and over a scan clustered by the join
  key the pushed aggregation takes the stream method, without a sort.
- ``prune_columns`` drops columns no parent reads: scans read fewer
  columns, projections compute fewer expressions, and a join gathers
  only the build payload its parent needs (``Join.build_payload``).

Other node kinds (cross joins and CTEs among them) take the reference's
conservative default: nothing is pruned under them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..expr.nodes import Call, Cast, ColumnRef, Expr, Literal, col
from . import nodes as P


def _expr_refs(e: Expr, out: Set[str]) -> None:
    if isinstance(e, ColumnRef):
        out.add(e.name)
    elif isinstance(e, Call):
        for a in e.args:
            _expr_refs(a, out)
    elif isinstance(e, Cast):
        _expr_refs(e.arg, out)
    elif isinstance(e, Literal):
        pass
    else:  # unknown node kind: treat as unanalyzable
        out.add("__unknown__")


def _refs(e: Expr) -> Set[str]:
    out: Set[str] = set()
    _expr_refs(e, out)
    return out


def output_columns(node: P.PlanNode) -> Optional[Set[str]]:
    """Static output-column set of a plan subtree (None if unknowable)."""
    if isinstance(node, P.TableScan):
        return set(node.columns) if node.columns is not None else None
    if isinstance(node, (P.Selection, P.Limit)):
        return output_columns(node.children[0])
    if isinstance(node, P.Projection):
        return set(node.exprs)
    if isinstance(node, (P.Join, P.CrossJoin)):
        a = output_columns(node.probe)
        b = output_columns(node.build)
        return None if a is None or b is None else a | b
    if isinstance(node, P.Aggregation):
        return set(node.keys) | {a.name for a in node.aggs}
    return None


def _replace_child(node: P.PlanNode, old: P.PlanNode, new: P.PlanNode) -> None:
    """Swap one child in place; ``children`` mirrors the named fields."""
    for f in ("child", "probe", "build"):
        if getattr(node, f, None) is old:
            setattr(node, f, new)
    node.children = tuple(new if x is old else x for x in node.children)


def eager_aggregation(plan: P.PlanNode) -> P.PlanNode:
    """Apply the agg-below-join rewrite wherever it is valid.  Like the
    reference, it patches the nodes it does not replace in place."""
    node = plan
    if isinstance(node, P.Aggregation):
        rewritten = _try_push_agg(node)
        if rewritten is not None:
            return rewritten
        node.child = eager_aggregation(node.child)
        node.__post_init__()
        return node
    for c in node.children:
        new_c = eager_aggregation(c)
        if new_c is not c:
            _replace_child(node, c, new_c)
    return node


def _try_push_agg(agg: P.Aggregation) -> Optional[P.PlanNode]:
    # an optional Projection between the aggregation and the join
    child = agg.child
    proj: Optional[P.Projection] = None
    if isinstance(child, P.Projection):
        proj = child
        join = proj.child
    else:
        join = child
    if not isinstance(join, P.Join):
        return None
    if join.kind != "inner" or not join.unique_build or join.rf_id is not None:
        return None

    probe_cols = output_columns(join.probe)
    build_cols = output_columns(join.build)
    if probe_cols is None or build_cols is None or (probe_cols & build_cols):
        return None

    # effective projection: identity over the join output if absent
    exprs: Dict[str, Expr] = (
        dict(proj.exprs)
        if proj is not None
        else {c: col(c) for c in probe_cols | build_cols}
    )

    def side(name: str) -> Optional[str]:
        """'probe' / 'build' / None (mixed or unknown) for one output."""
        e = exprs.get(name)
        if e is None:
            return None
        refs = _refs(e)
        if refs and refs <= probe_cols:
            return "probe"
        if refs and refs <= build_cols:
            return "build"
        return None

    # every aggregate input is probe-side; count(*) counts joined rows,
    # which equal probe rows under a unique build
    for a in agg.aggs:
        for dep in filter(None, (a.arg, a.filter_col)):
            if side(dep) != "probe":
                return None

    # group keys split cleanly by side
    k_probe = [k for k in agg.keys if side(k) == "probe"]
    k_build = [k for k in agg.keys if side(k) == "build"]
    if len(k_probe) + len(k_build) != len(agg.keys):
        return None

    # the probe join keys ride through the projection as bare columns that
    # are group keys, so no pre-aggregated group straddles join keys
    out_probe_keys: List[str] = []
    for pk in join.probe_keys:
        hit = next(
            (
                name
                for name in k_probe
                if isinstance(exprs[name], ColumnRef) and exprs[name].name == pk
            ),
            None,
        )
        if hit is None:
            return None
        out_probe_keys.append(hit)

    probe_proj = P.Projection(
        {name: exprs[name] for name in set(k_probe)
         | {d for a in agg.aggs for d in (a.arg, a.filter_col) if d}},
        join.probe,
    )
    pushed = P.Aggregation(
        keys=k_probe,
        aggs=list(agg.aggs),
        child=probe_proj,
        num_slots=agg.num_slots,
        mode=agg.mode,
    )
    new_join = P.Join(
        kind="inner",
        probe_keys=out_probe_keys,
        build_keys=list(join.build_keys),
        probe=pushed,
        build=join.build,
        unique_build=True,
    )
    # build-side keys may be expressions over build columns (join output
    # columns now); restore the original output shape and order
    final_exprs: Dict[str, Expr] = {}
    for k in agg.keys:
        final_exprs[k] = col(k) if side(k) == "probe" else exprs[k]
    for a in agg.aggs:
        final_exprs[a.name] = col(a.name)
    return P.Projection(final_exprs, new_join)


def prune_columns(plan: P.PlanNode, required: Optional[Set[str]] = None) -> P.PlanNode:
    """Top-down column pruning.

    ``required=None`` means everything (the root keeps its full output).
    Scans drop unread columns, projections drop unused expressions, and
    join children narrow to (side requirement | join keys), with a
    bare-column Projection inserted where a lazy Selection would leak its
    filter columns into the join payload."""
    node = plan
    if isinstance(node, P.TableScan):
        if required is not None and node.columns is not None:
            return P.TableScan(node.table, [c for c in node.columns if c in required])
        return node
    if isinstance(node, P.Selection):
        creq = None if required is None else (required | _refs(node.cond))
        return P.Selection(node.cond, prune_columns(node.child, creq))
    if isinstance(node, P.Projection):
        exprs = node.exprs if required is None else {
            n: e for n, e in node.exprs.items() if n in required
        }
        if not exprs:  # keep one column to preserve the row count
            first = next(iter(node.exprs))
            exprs = {first: node.exprs[first]}
        creq: Set[str] = set()
        for e in exprs.values():
            creq |= _refs(e)
        return P.Projection(exprs, prune_columns(node.child, creq))
    if isinstance(node, P.Aggregation):
        aggs = list(node.aggs) if required is None else [
            a for a in node.aggs if a.name in required
        ]
        creq = set(node.keys)
        for a in aggs:
            for dep in (a.arg, a.filter_col):
                if dep:
                    creq.add(dep)
        return P.Aggregation(keys=list(node.keys), aggs=aggs,
                             child=prune_columns(node.child, creq),
                             num_slots=node.num_slots, mode=node.mode)
    if isinstance(node, (P.TopN, P.Sort)):
        creq = None if required is None else (
            required | {sk.name for sk in node.sort_keys}
        )
        child = prune_columns(node.children[0], creq)
        if isinstance(node, P.TopN):
            return P.TopN(list(node.sort_keys), node.limit, child)
        return P.Sort(list(node.sort_keys), child)
    if isinstance(node, P.Limit):
        return P.Limit(node.limit, prune_columns(node.child, required))
    if isinstance(node, P.Join) and node.rf_id is None:
        probe_out = output_columns(node.probe)
        build_out = output_columns(node.build)

        def narrow(child, side_out, keys):
            if required is None or side_out is None:
                return prune_columns(child, None)
            need = (required & side_out) | set(keys)
            pruned = prune_columns(child, need)
            got = output_columns(pruned)
            if got is not None and got - need:
                # e.g. a lazy Selection leaks its filter columns: cut them
                order = [c for c in sorted(got) if c in need]
                pruned = P.Projection({c: col(c) for c in order}, pruned)
            return pruned

        # the build input keeps its join keys, but the payload gather
        # takes only what the parent reads; conservative when probe and
        # build names collide (the join suffixes those with "_r") or when
        # a required name resolves to neither side
        build_payload = None
        if (required is not None and build_out is not None
                and probe_out is not None
                and not (probe_out & build_out)
                and not (required - (probe_out | build_out))):
            build_payload = sorted(required & build_out)
        return P.Join(
            kind=node.kind,
            probe_keys=list(node.probe_keys),
            build_keys=list(node.build_keys),
            probe=narrow(node.probe, probe_out, node.probe_keys),
            build=narrow(node.build, build_out, node.build_keys),
            unique_build=node.unique_build,
            output_capacity=node.output_capacity,
            build_payload=build_payload,
        )
    # conservative default: recurse with everything required
    for c in node.children:
        new_c = prune_columns(c, None)
        if new_c is not c:
            _replace_child(node, c, new_c)
    return node


__all__ = ["eager_aggregation", "prune_columns", "output_columns"]
