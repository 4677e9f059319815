"""Distributed plan rewrites: multi-stage aggregation, shuffle and
broadcast joins, partitioned windows and the gathered top-N.

Counterpart of ``tiflash_tpu/plan/distribute.py``; the same trees.  Role
analog: TiDB's MPP plan shapes (partial agg -> hash exchange -> final
agg, shuffle and broadcast join build sides).

``split_aggregation`` rewrites an Aggregation into the partial /
exchange / final triple with the classic state decomposition
(sum->sum, count->sum of counts, min/max/first/bit_* self-merging,
avg->(sum, count) and a final divide); a keyless all-
``approx_count_distinct`` aggregation sends each shard's KMV candidates
through a passthrough exchange instead of raw rows; a
``count_distinct`` with only row-decomposable companions hashes raw rows
on keys + distinct arguments so every shard partial-counts (the
arg-split form); other non-decomposable aggregates co-locate whole
groups.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..expr.nodes import Expr, col
from ..ops.aggregate import AggDesc
from . import nodes as P


def split_aggregation(
    keys,
    aggs,
    child: P.PlanNode,
    partial_slots: Optional[int] = None,
    final_slots: Optional[int] = None,
    auto_passthrough: bool = False,
) -> P.PlanNode:
    """Aggregation(keys, aggs, child) -> partial agg, hash shuffle on keys,
    final agg, (projection restoring avg and column order).

    ``auto_passthrough`` makes the partial stage adaptive: it skips the
    pre-aggregation at runtime when a sample says the keys are
    high-cardinality (auto pass-through hashagg analog)."""
    _COLOCATE = {"count_distinct", "var_pop", "var_samp", "stddev_pop",
                 "stddev_samp", "quantile", "group_concat"}
    if (not keys and aggs
            and all(a.func == "approx_count_distinct" for a in aggs)):
        # mergeable-sketch NDV (AggregateFunctionUniq.h analog): each shard
        # emits its KMV candidates as k rows, a passthrough exchange
        # concatenates them, and the final stage re-sketches the union —
        # no raw-row shuffle, fixed k-row exchange volume per shard
        partial = [AggDesc("approx_cd_partial", a.arg, a.name, a.filter_col)
                   for a in aggs]
        x = P.ExchangeReceiver(P.ExchangeSender(
            "passthrough", [], P.Aggregation(keys=[], aggs=partial,
                                             child=child, mode="partial")))
        return P.Aggregation(
            keys=[], aggs=[AggDesc("approx_cd_final", a.name, a.name)
                           for a in aggs],
            child=x, mode="final",
        )
    # grouped (or mixed-scalar) approx: co-locate like count_distinct
    if any(a.func in _COLOCATE or a.func == "approx_count_distinct"
           for a in aggs):
        cd = [a for a in aggs if a.func == "count_distinct"]
        others = [a for a in aggs if a.func != "count_distinct"]
        if (cd and all(a.filter_col is None for a in cd)
                and len({a.arg for a in cd}) == 1
                and all(o.func in ("sum", "count", "min", "max",
                                   "bit_and", "bit_or", "bit_xor")
                        for o in others)):
            # ARG-SPLIT distinct (the laned-aggregation analog,
            # VERDICT r3 item 6): distinct counting is decomposable
            # over arg-disjoint shards, so hash raw rows on
            # keys + distinct-args — EVERY device partial-counts even
            # with one group-key value — then SUM the partial distinct
            # counts per key.  sum/count/min/max ride the same exchange
            # unchanged (they are row-decomposable).  Reference role:
            # fine-grained shuffle serving aggregation,
            # Flash/Mpp/FineGrainedShuffleWriter.cpp.
            xkeys = list(keys) + sorted({a.arg for a in cd})
            x = P.ExchangeReceiver(P.ExchangeSender("hash", xkeys, child))
            partial: List[AggDesc] = []
            final: List[AggDesc] = []
            for a in aggs:
                if a.func == "count_distinct":
                    partial.append(AggDesc("count_distinct", a.arg, a.name))
                    final.append(AggDesc("sum", a.name, a.name))
                elif a.func in ("sum", "count"):
                    partial.append(AggDesc(a.func, a.arg, a.name,
                                           a.filter_col))
                    final.append(AggDesc("sum", a.name, a.name))
                else:  # min/max/bit_*: self-merging
                    partial.append(AggDesc(a.func, a.arg, a.name,
                                           a.filter_col))
                    final.append(AggDesc(a.func, a.name, a.name))
            node: P.PlanNode = P.Aggregation(
                keys=keys, aggs=partial, child=x, num_slots=partial_slots,
                mode="partial")
            node = P.ExchangeReceiver(P.ExchangeSender(
                "hash" if keys else "passthrough", keys, node))
            return P.Aggregation(keys=keys, aggs=final, child=node,
                                 num_slots=final_slots, mode="final")
        # distinct states don't merge: co-locate whole groups by shuffling
        # raw rows on the keys, then run the full aggregation locally
        # (the reference would push a uniq-state; exactness > state size
        # here — see ops/aggregate._distinct_first_flags)
        x = P.ExchangeReceiver(P.ExchangeSender("hash" if keys else "passthrough",
                                                keys, child))
        return P.Aggregation(keys=keys, aggs=aggs, child=x, num_slots=final_slots)

    partial: List[AggDesc] = []
    final: List[AggDesc] = []
    post: Dict[str, Expr] = {k: col(k) for k in keys}
    needs_post = False
    for a in aggs:
        if a.func == "sum":
            partial.append(AggDesc("sum", a.arg, a.name, a.filter_col))
            final.append(AggDesc("sum", a.name, a.name))
            post[a.name] = col(a.name)
        elif a.func == "count":
            partial.append(AggDesc("count", a.arg, a.name, a.filter_col))
            final.append(AggDesc("sum", a.name, a.name))
            post[a.name] = col(a.name)
        elif a.func in ("min", "max", "first", "bit_and", "bit_or", "bit_xor"):
            # self-merging states: merge(partials) is the same function
            partial.append(AggDesc(a.func, a.arg, a.name, a.filter_col))
            final.append(AggDesc(a.func, a.name, a.name))
            post[a.name] = col(a.name)
        elif a.func == "avg":
            s, c = a.name + "__psum", a.name + "__pcnt"
            partial.append(AggDesc("sum", a.arg, s, a.filter_col))
            partial.append(AggDesc("count", a.arg, c, a.filter_col))
            final.append(AggDesc("sum", s, s))
            final.append(AggDesc("sum", c, c))
            # TiDB avg scale: arg_scale + 4 == divide's scale increment
            post[a.name] = col(s) / col(c)
            needs_post = True
        else:
            raise NotImplementedError(f"distributed {a.func}")
    node: P.PlanNode = P.Aggregation(
        keys=keys, aggs=partial, child=child, num_slots=partial_slots,
        mode="partial" if not (auto_passthrough and keys) else "auto",
    )
    # scalar aggregation has no shuffle key: gather the 1-row partials
    xtype = "hash" if keys else "passthrough"
    node = P.ExchangeReceiver(P.ExchangeSender(xtype, keys, node))
    node = P.Aggregation(
        keys=keys, aggs=final, child=node, num_slots=final_slots, mode="final"
    )
    if needs_post or any(a.func == "avg" for a in aggs):
        node = P.Projection(post, node)
    return node


_rf_counter = [0]


def shuffle_join(
    kind: str,
    probe_keys,
    build_keys,
    probe: P.PlanNode,
    build: P.PlanNode,
    unique_build: bool = False,
    output_capacity: Optional[int] = None,
    runtime_filter: bool = False,
) -> P.Join:
    """Hash-shuffle both sides on the join key, then local join.

    (Config-4 shape: repartition join across chips.)  With
    ``runtime_filter`` (inner/semi only) the build side executes first and
    its key min/max prunes probe rows BEFORE the probe's all-to-all —
    the exchange-volume reduction that motivates the reference's runtime
    filter pushdown into table scan."""
    rf_id = None
    probe_sub = probe
    if runtime_filter and kind in ("inner", "semi"):
        _rf_counter[0] += 1
        rf_id = f"rf{_rf_counter[0]}"
        probe_sub = P.RuntimeFilterApply(rf_id, probe_keys, probe)
    p = P.ExchangeReceiver(P.ExchangeSender("hash", probe_keys, probe_sub))
    b = P.ExchangeReceiver(P.ExchangeSender("hash", build_keys, build))
    return P.Join(
        kind=kind, probe_keys=probe_keys, build_keys=build_keys,
        probe=p, build=b, unique_build=unique_build,
        output_capacity=output_capacity, rf_id=rf_id,
    )


def broadcast_join(
    kind: str,
    probe_keys,
    build_keys,
    probe: P.PlanNode,
    build: P.PlanNode,
    unique_build: bool = False,
    output_capacity: Optional[int] = None,
) -> P.Join:
    """Broadcast the (small) build side to every device; probe stays put."""
    b = P.ExchangeReceiver(P.ExchangeSender("broadcast", (), build))
    return P.Join(
        kind=kind, probe_keys=probe_keys, build_keys=build_keys,
        probe=probe, build=b, unique_build=unique_build,
        output_capacity=output_capacity,
    )


def partitioned_window(
    partition_by, order_by, funcs, child: P.PlanNode
) -> P.PlanNode:
    """Hash-exchange on the partition keys so each device owns whole
    partitions, then the local window kernel (the fine-grained-shuffle
    analog: ``docs/design/2022-06-14-fine-grained-shuffle.md``).  With
    NO partition keys (and no lane split either — the laned planner
    already declined), the whole stream gathers to one owner: a global
    window has a single partition by definition."""
    mode = "hash" if partition_by else "passthrough"
    x = P.ExchangeReceiver(P.ExchangeSender(mode, partition_by, child))
    return P.Window(partition_by, order_by, funcs, x)


def gather_topn(sort_keys, limit: int, child: P.PlanNode) -> P.PlanNode:
    """Local top-N, passthrough-gather, final top-N (replicated)."""
    local = P.TopN(sort_keys, limit, child)
    gathered = P.ExchangeReceiver(P.ExchangeSender("passthrough", (), local))
    return P.TopN(sort_keys, limit, gathered)


__all__ = ["split_aggregation", "shuffle_join", "broadcast_join",
           "partitioned_window", "gather_topn"]
