"""Plan and expression (de)serialization to JSON: the port's second entry
point, for a plan that arrives serialized, as TiDB's DAG request does.

Counterpart of ``tiflash_tpu/plan/serde.py``, with its JSON: a plan the
reference's ``dumps`` writes loads here to the same tree, and this
module's ``dumps`` of such a plan loads in the reference.  Codecs: data
types, expressions (column references, literals with ISO dates, calls),
sort keys, aggregate and window descriptors, and every single-device
node the reference's codec has (TableScan, Selection, Projection,
Aggregation, Join, CrossJoin, TopN, Sort, Limit, Window, Expand, WithCTE,
CTERef).  The distributed nodes (exchanges, the skew join, runtime
filters) come with the distribution slice.

One codec goes beyond the reference's: ``Union``, as
``{"exec": "Union", "inputs": [...]}``, so a partitioned table's scan
(``partition_table_scan``) travels serialized too.  The reference's
``loads`` does not know it.  Like the reference, there is no codec for
``Cast`` or ``AddColumns``.
"""

from __future__ import annotations

import datetime
import json
from typing import Any, Dict

from ..core import dtypes as dt
from ..expr.nodes import Call, ColumnRef, Expr, Literal
from ..ops.aggregate import AggDesc
from ..ops.sort import SortKey
from ..ops.window import WindowDesc
from . import nodes as P


# ---- dtype ----

def dtype_to_json(t: dt.DataType) -> Dict[str, Any]:
    return {"kind": t.kind.value, "nullable": t.nullable,
            "precision": t.precision, "scale": t.scale}


def dtype_from_json(d: Dict[str, Any]) -> dt.DataType:
    return dt.DataType(dt.TypeKind(d["kind"]), d.get("nullable", False),
                       d.get("precision", 0), d.get("scale", 0))


# ---- expressions ----

def expr_to_json(e: Expr) -> Dict[str, Any]:
    if isinstance(e, ColumnRef):
        return {"expr": "col", "name": e.name}
    if isinstance(e, Literal):
        v = e.value
        if isinstance(v, datetime.date):
            return {"expr": "lit", "value": v.isoformat(), "vtype": "date"}
        return {"expr": "lit", "value": v}
    if isinstance(e, Call):
        return {"expr": "call", "func": e.func,
                "args": [expr_to_json(a) for a in e.args]}
    raise TypeError(type(e))


def expr_from_json(d: Dict[str, Any]) -> Expr:
    k = d["expr"]
    if k == "col":
        return ColumnRef(d["name"])
    if k == "lit":
        v = d["value"]
        if d.get("vtype") == "date":
            v = datetime.date.fromisoformat(v)
        return Literal(v)
    if k == "call":
        return Call(d["func"], tuple(expr_from_json(a) for a in d["args"]))
    raise ValueError(k)


# ---- descriptors ----

def _sk_to_json(k: SortKey):
    return {"name": k.name, "desc": k.desc, "nulls_first": k.nulls_first}


def _sk_from_json(d):
    return SortKey(d["name"], d["desc"], d["nulls_first"])


def _agg_to_json(a: AggDesc):
    return {"func": a.func, "arg": a.arg, "name": a.name,
            "filter_col": a.filter_col, "param": a.param,
            "separator": a.separator, "distinct": a.distinct}


def _agg_from_json(d):
    return AggDesc(d["func"], d["arg"], d["name"], d.get("filter_col"),
                   d.get("param"), d.get("separator", ","), d.get("distinct", False))


def _w_to_json(w: WindowDesc):
    return {"func": w.func, "name": w.name, "arg": w.arg, "offset": w.offset,
            "default": w.default,
            "frame": list(w.frame) if w.frame else None,
            "frame_type": w.frame_type}


def _w_from_json(d):
    fr = d.get("frame")
    return WindowDesc(d["func"], d["name"], d.get("arg"), d.get("offset", 1),
                      d.get("default"), tuple(fr) if fr else None,
                      d.get("frame_type", "rows"))


# ---- plan nodes ----

def _child(node) -> Dict[str, Any]:
    return plan_to_json(node.child)


def plan_to_json(node: P.PlanNode) -> Dict[str, Any]:
    t = type(node).__name__
    if isinstance(node, P.TableScan):
        return {"exec": t, "table": node.table,
                "columns": list(node.columns) if node.columns else None}
    if isinstance(node, P.Selection):
        return {"exec": t, "cond": expr_to_json(node.cond), "child": _child(node)}
    if isinstance(node, P.Projection):
        return {"exec": t,
                "exprs": {k: expr_to_json(v) for k, v in node.exprs.items()},
                "child": _child(node)}
    if isinstance(node, P.Aggregation):
        return {"exec": t, "keys": list(node.keys),
                "aggs": [_agg_to_json(a) for a in node.aggs],
                "num_slots": node.num_slots, "mode": node.mode,
                "child": _child(node)}
    if isinstance(node, P.Join):
        return {"exec": t, "kind": node.kind,
                "probe_keys": list(node.probe_keys),
                "build_keys": list(node.build_keys),
                "unique_build": node.unique_build,
                "output_capacity": node.output_capacity,
                "rf_id": node.rf_id,
                "build_payload": (None if node.build_payload is None
                                  else list(node.build_payload)),
                "probe": plan_to_json(node.probe),
                "build": plan_to_json(node.build)}
    if isinstance(node, P.CrossJoin):
        return {"exec": t, "output_capacity": node.output_capacity,
                "probe": plan_to_json(node.probe),
                "build": plan_to_json(node.build)}
    if isinstance(node, P.TopN):
        return {"exec": t, "sort_keys": [_sk_to_json(k) for k in node.sort_keys],
                "limit": node.limit, "child": _child(node)}
    if isinstance(node, P.Sort):
        return {"exec": t, "sort_keys": [_sk_to_json(k) for k in node.sort_keys],
                "child": _child(node)}
    if isinstance(node, P.Limit):
        return {"exec": t, "limit": node.limit, "child": _child(node)}
    if isinstance(node, P.Window):
        return {"exec": t, "partition_by": list(node.partition_by),
                "order_by": [_sk_to_json(k) for k in node.order_by],
                "funcs": [_w_to_json(w) for w in node.funcs],
                "child": _child(node)}
    if isinstance(node, P.Expand):
        return {"exec": t, "grouping_sets": [list(s) for s in node.grouping_sets],
                "gid_name": node.gid_name, "child": _child(node)}
    if isinstance(node, P.Union):
        return {"exec": t, "inputs": [plan_to_json(c) for c in node.children]}
    if isinstance(node, P.WithCTE):
        return {"exec": t, "defs": {k: plan_to_json(v) for k, v in node.defs.items()},
                "child": _child(node)}
    if isinstance(node, P.CTERef):
        return {"exec": t, "name": node.name}
    raise TypeError(t)


def plan_from_json(d: Dict[str, Any]) -> P.PlanNode:
    t = d["exec"]
    if t == "TableScan":
        return P.TableScan(d["table"], d.get("columns"))
    if t == "Selection":
        return P.Selection(expr_from_json(d["cond"]), plan_from_json(d["child"]))
    if t == "Projection":
        return P.Projection({k: expr_from_json(v) for k, v in d["exprs"].items()},
                            plan_from_json(d["child"]))
    if t == "Aggregation":
        return P.Aggregation(d["keys"], [_agg_from_json(a) for a in d["aggs"]],
                             plan_from_json(d["child"]), d.get("num_slots"),
                             d.get("mode"))
    if t == "Join":
        return P.Join(d["kind"], d["probe_keys"], d["build_keys"],
                      plan_from_json(d["probe"]), plan_from_json(d["build"]),
                      d.get("unique_build", False), d.get("output_capacity"),
                      d.get("rf_id"), d.get("build_payload"))
    if t == "CrossJoin":
        return P.CrossJoin(plan_from_json(d["probe"]), plan_from_json(d["build"]),
                           d.get("output_capacity"))
    if t == "TopN":
        return P.TopN([_sk_from_json(k) for k in d["sort_keys"]], d["limit"],
                      plan_from_json(d["child"]))
    if t == "Sort":
        return P.Sort([_sk_from_json(k) for k in d["sort_keys"]],
                      plan_from_json(d["child"]))
    if t == "Limit":
        return P.Limit(d["limit"], plan_from_json(d["child"]))
    if t == "Window":
        return P.Window(d["partition_by"], [_sk_from_json(k) for k in d["order_by"]],
                        [_w_from_json(w) for w in d["funcs"]],
                        plan_from_json(d["child"]))
    if t == "Expand":
        return P.Expand(d["grouping_sets"], plan_from_json(d["child"]),
                        d.get("gid_name", "groupingID"))
    if t == "Union":
        return P.Union([plan_from_json(c) for c in d["inputs"]])
    if t == "WithCTE":
        return P.WithCTE({k: plan_from_json(v) for k, v in d["defs"].items()},
                         plan_from_json(d["child"]))
    if t == "CTERef":
        return P.CTERef(d["name"])
    if t in ("SkewShuffleJoin", "ExchangeSender", "ExchangeReceiver",
             "RuntimeFilterApply"):
        raise NotImplementedError(
            f"plan node {t} comes with the distribution slice of the port")
    raise ValueError(t)


def dumps(plan: P.PlanNode, **kw) -> str:
    return json.dumps(plan_to_json(plan), **kw)


def loads(s: str) -> P.PlanNode:
    return plan_from_json(json.loads(s))


__all__ = ["plan_to_json", "plan_from_json", "expr_to_json", "expr_from_json",
           "dumps", "loads", "dtype_to_json", "dtype_from_json"]
