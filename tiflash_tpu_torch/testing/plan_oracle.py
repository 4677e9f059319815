"""Plan-level oracle: interpret a plan tree over python-value tables.

Counterpart of ``tiflash_tpu/testing/plan_oracle.py`` over the port's
plan classes: the expected-result generator for end-to-end query parity
(the role of the reference's fullstack-test expected tables), built on
``testing/oracle.py``'s relational operators.  Shares no code with the
engine.  Every node's fields are read by name.
"""

from __future__ import annotations

from typing import Dict

from ..plan import nodes as P
from . import oracle as O


def execute_plan_oracle(plan: P.PlanNode, tables: Dict[str, O.PyTable]) -> O.PyTable:
    if isinstance(plan, P.TableScan):
        t = tables[plan.table]
        if plan.columns is not None:
            t = {c: t[c] for c in plan.columns}
        return dict(t)
    if isinstance(plan, P.Selection):
        return O.o_filter(execute_plan_oracle(plan.child, tables), plan.cond)
    if isinstance(plan, P.Projection):
        return O.o_project(execute_plan_oracle(plan.child, tables), plan.exprs)
    if isinstance(plan, P.Aggregation):
        child = execute_plan_oracle(plan.child, tables)
        return O.o_aggregate(
            child, list(plan.keys),
            [(a.func, a.arg, a.name, a.filter_col) for a in plan.aggs],
        )
    if isinstance(plan, P.Join):
        left = execute_plan_oracle(plan.probe, tables)
        right = execute_plan_oracle(plan.build, tables)
        if plan.kind == "anti_null_aware":
            return O.o_anti_null_aware(
                left, right, list(plan.probe_keys), list(plan.build_keys)
            )
        return O.o_join(
            left, right, list(plan.probe_keys), list(plan.build_keys), kind=plan.kind
        )
    if isinstance(plan, P.SkewShuffleJoin):
        left = execute_plan_oracle(plan.probe, tables)
        right = execute_plan_oracle(plan.build, tables)
        return O.o_join(
            left, right, list(plan.probe_keys), list(plan.build_keys), kind=plan.kind
        )
    if isinstance(plan, P.CrossJoin):
        left = execute_plan_oracle(plan.probe, tables)
        right = execute_plan_oracle(plan.build, tables)
        return O.o_cross_join(left, right)
    if isinstance(plan, P.Expand):
        child = execute_plan_oracle(plan.child, tables)
        return O.o_expand(child, [list(s) for s in plan.grouping_sets], plan.gid_name)
    if isinstance(plan, P.TopN):
        child = execute_plan_oracle(plan.child, tables)
        return O.o_sort(
            child, [(k.name, k.desc, k.nulls_first) for k in plan.sort_keys],
            limit=plan.limit,
        )
    if isinstance(plan, P.Sort):
        child = execute_plan_oracle(plan.child, tables)
        return O.o_sort(
            child, [(k.name, k.desc, k.nulls_first) for k in plan.sort_keys])
    if isinstance(plan, P.Limit):
        child = execute_plan_oracle(plan.child, tables)
        return {k: v[: plan.limit] for k, v in child.items()}
    if isinstance(plan, P.Window):
        child = execute_plan_oracle(plan.child, tables)
        return O.o_window(
            child,
            list(plan.partition_by),
            [(k.name, k.desc) for k in plan.order_by],
            list(plan.funcs),
        )
    if isinstance(plan, P.Union):
        parts = [execute_plan_oracle(c, tables) for c in plan.children]
        out = {k: [] for k in parts[0]}
        for p in parts:
            for k in out:
                out[k].extend(p[k])
        return out
    if isinstance(plan, P.RuntimeFilterApply):
        # semantically transparent for inner/semi joins: it only removes
        # rows that could not match anyway
        return execute_plan_oracle(plan.child, tables)
    if isinstance(plan, P.WithCTE):
        tables = dict(tables)
        for name, d in plan.defs.items():
            tables["__cte_" + name] = execute_plan_oracle(d, tables)
        return execute_plan_oracle(plan.child, tables)
    if isinstance(plan, P.CTERef):
        return dict(tables["__cte_" + plan.name])
    if isinstance(plan, (P.ExchangeSender, P.ExchangeReceiver)):
        # exchanges don't change row content: transparent to the oracle
        return execute_plan_oracle(plan.children[0], tables)
    raise NotImplementedError(type(plan).__name__)


__all__ = ["execute_plan_oracle"]
