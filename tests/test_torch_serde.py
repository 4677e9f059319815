"""The plan wire format: the port's ``plan/serde.py`` against the JAX
package's.  For every plan both can express, the port's JSON text is the
reference's, character for character; the reference's ``dumps`` loads in
the port to the same tree, and the port's ``dumps`` loads in the
reference to the same tree (``pretty()`` and a second ``dumps`` equal).
Plans: the analytic plans, TPC-H's builders that hold no ``Cast`` (the
wire format, in both packages, has no Cast codec), the declarative
cases, and every descriptor field (sort keys with NULL placement,
aggregate parameters, window frames and defaults, date literals).
"""

import json
import os

import pytest

from tiflash_tpu.plan import serde as j_serde

from test_torch_tpch_spec import to_reference
from tiflash_tpu_torch.bench import analytics as A
from tiflash_tpu_torch.bench import tpch_queries as Q
from tiflash_tpu_torch.core import dtypes as TD
from tiflash_tpu_torch.expr.nodes import call, col, lit
from tiflash_tpu_torch.ops.aggregate import AggDesc
from tiflash_tpu_torch.ops.sort import SortKey
from tiflash_tpu_torch.ops.window import WindowDesc
from tiflash_tpu_torch.plan import nodes as P
from tiflash_tpu_torch.plan import serde as t_serde

CASES_DIR = os.path.join(os.path.dirname(__file__), "cases")


def _every_field_plan() -> P.PlanNode:
    import datetime

    scan = P.TableScan("t", ["a", "b", "d"])
    sel = P.Selection(call("and", col("d") >= lit(datetime.date(1995, 3, 15)),
                           call("is_not_null", col("b"))), scan)
    win = P.Window(["a"], [SortKey("b", True, True), SortKey("d", False, None)], [
        WindowDesc("lead", "ld", "b", 2, 0),
        WindowDesc("sum", "s", "b", frame=(3, None), frame_type="range"),
        WindowDesc("nth_value", "n", "b", 2, frame=(None, 1))], sel)
    exp = P.Expand([["a"], []], win, gid_name="gid")
    agg = P.Aggregation(["a", "gid"], [
        AggDesc("quantile", "b", "q", None, 0.25),
        AggDesc("group_concat", "a", "g", "f", 8, "|", True),
        AggDesc("count", None, "c")], exp, num_slots=64)
    r = P.TableScan("r", None)
    j = P.Join("full_outer", ["a"], ["k"], agg, r, False, 128, None, ["k", "w"])
    cte = P.WithCTE({"x": j}, P.Limit(5, P.TopN([SortKey("c", True)], 10,
                                                 P.CrossJoin(P.CTERef("x"),
                                                             P.CTERef("x"), 99))))
    return P.Sort([SortKey("c")], cte)


def _plans():
    out = {"every_field": _every_field_plan()}
    for name, (fn, _) in A.ANALYTICS.items():
        if name != "partitioned_q1":
            out[name] = fn()
    for n in range(1, 23):
        fn = getattr(Q, f"q{n}_plan")
        try:
            t_serde.dumps(fn())
        except TypeError:
            continue  # a Cast or an AddColumns: no codec in either package
        out[f"q{n}"] = fn()
    return out


PLANS = _plans()


def test_most_tpch_builders_serialize():
    assert sum(k.startswith("q") and k[1:].isdigit() for k in PLANS) >= 15


@pytest.mark.parametrize("name", sorted(PLANS))
def test_port_json_is_reference_json_both_ways(name):
    plan = PLANS[name]
    text = t_serde.dumps(plan)
    j_plan = j_serde.loads(text)
    assert j_plan.pretty() == plan.pretty()
    assert j_serde.dumps(j_plan) == text
    # the reference's own dumps of the same tree loads in the port
    ref_text = j_serde.dumps(to_reference(plan))
    assert ref_text == text
    back = t_serde.loads(ref_text)
    assert back.pretty() == plan.pretty()
    assert t_serde.dumps(back) == text


@pytest.mark.parametrize("fname", sorted(f for f in os.listdir(CASES_DIR)
                                         if f.endswith(".json")))
def test_declarative_case_plans_round_trip(fname):
    with open(os.path.join(CASES_DIR, fname)) as f:
        d = json.load(f)["plan"]
    t_plan = t_serde.plan_from_json(d)
    j_plan = j_serde.plan_from_json(d)
    assert t_plan.pretty() == j_plan.pretty()
    assert t_serde.plan_to_json(t_plan) == j_serde.plan_to_json(j_plan)


def test_union_has_a_codec_the_reference_lacks():
    plan = A.partitioned_q1_plan()
    text = t_serde.dumps(plan)
    assert t_serde.loads(text).pretty() == plan.pretty()
    assert json.loads(text)["child"]["child"]["child"]["child"]["exec"] == "Union"
    with pytest.raises(ValueError, match="Union"):
        j_serde.loads(text)
    with pytest.raises(TypeError):
        j_serde.dumps(to_reference(plan))


def test_dtype_and_distributed_nodes():
    for t in (TD.INT64, TD.Decimal(15, 2, True), TD.STRING.with_nullable(True),
              TD.DATE, TD.FLOAT64):
        d = t_serde.dtype_to_json(t)
        assert t_serde.dtype_from_json(d) == t
        assert d == j_serde.dtype_to_json(to_reference(t))
    for node in ({"exec": "ExchangeReceiver", "source": None},
                 {"exec": "RuntimeFilterApply", "rf_id": "r", "key_names": []}):
        with pytest.raises(NotImplementedError, match="distribution slice"):
            t_serde.plan_from_json(node)
    with pytest.raises(TypeError):
        t_serde.expr_to_json(object())
