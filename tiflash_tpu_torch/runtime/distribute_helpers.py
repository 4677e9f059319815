"""Partial/final plan construction shared by out-of-core aggregation.

Counterpart of ``tiflash_tpu/runtime/distribute_helpers.py``, a host-only copy.

The state decomposition of the reference's distributed split
(``tiflash_tpu/plan/distribute.py``), with a host-side concatenation in
place of an exchange between the stages."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from ..expr.nodes import Expr, col
from ..ops.aggregate import AggDesc
from ..plan import nodes as P


def build_partial_final(
    plan: P.Aggregation,
) -> Tuple[P.PlanNode, Callable[[], P.PlanNode]]:
    """Returns (partial plan over the original child, thunk building the
    final plan over a table named '__partials')."""
    keys = list(plan.keys)
    partial, final = [], []
    post: Dict[str, Expr] = {k: col(k) for k in keys}
    needs_post = False
    for a in plan.aggs:
        if a.func == "sum":
            partial.append(AggDesc("sum", a.arg, a.name, a.filter_col))
            final.append(AggDesc("sum", a.name, a.name))
            post[a.name] = col(a.name)
        elif a.func == "count":
            partial.append(AggDesc("count", a.arg, a.name, a.filter_col))
            final.append(AggDesc("sum", a.name, a.name))
            post[a.name] = col(a.name)
        elif a.func in ("min", "max", "first"):
            partial.append(AggDesc(a.func, a.arg, a.name, a.filter_col))
            final.append(AggDesc(a.func, a.name, a.name))
            post[a.name] = col(a.name)
        elif a.func == "avg":
            s, c = a.name + "__psum", a.name + "__pcnt"
            partial.append(AggDesc("sum", a.arg, s, a.filter_col))
            partial.append(AggDesc("count", a.arg, c, a.filter_col))
            final.append(AggDesc("sum", s, s))
            final.append(AggDesc("sum", c, c))
            post[a.name] = col(s) / col(c)
            needs_post = True
        else:
            raise NotImplementedError(f"chunked {a.func}")

    partial_plan = P.Aggregation(
        keys=keys, aggs=partial, child=plan.child, num_slots=plan.num_slots,
        mode="partial",
    )

    def final_builder() -> P.PlanNode:
        node: P.PlanNode = P.Aggregation(
            keys=keys, aggs=final, child=P.TableScan("__partials"),
            num_slots=plan.num_slots, mode="final",
        )
        if needs_post:
            node = P.Projection(post, node)
        return node

    return partial_plan, final_builder


__all__ = ["build_partial_final"]
