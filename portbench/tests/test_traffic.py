"""The frozen queries and the mixes: every query loads through the port's
``plan_from_json`` with its placeholders bound and runs at a tiny scale;
every stream is a permutation of the 22 shapes; draws stay in the
specification's ranges and repeat for a seed."""

import json

import pytest

from portbench import traffic
from portbench.tests.conftest import served, world

SHAPES = [f"q{n}" for n in range(1, 23)]


@pytest.mark.parametrize("shape", SHAPES)
def test_query_loads_and_runs(shape):
    from tiflash_tpu_torch.plan.serde import plan_from_json

    q = traffic.load_json("queries", shape)
    plan = traffic.bind(q, q["params"])
    assert "$" not in json.dumps(plan)
    plan_from_json(plan)
    _, service, _ = world(1, 0.01)
    cols = served(service, plan)
    assert cols


def test_placeholders_of_q1_and_q6():
    q1 = traffic.load_json("queries", "q1")
    assert "1998-09-02" in json.dumps(traffic.bind(q1, {"DELTA": 90}))
    assert "1998-08-03" in json.dumps(traffic.bind(q1, {"DELTA": 120}))
    q6 = json.dumps(traffic.bind(traffic.load_json("queries", "q6"),
                                 {"YEAR": 1997, "DISCOUNT": 0.02, "QUANTITY": 25}))
    for lit in ('"1997-01-01"', '"1998-01-01"', "0.01", "0.03", "25.0"):
        assert lit in q6


@pytest.mark.parametrize("mix", ["shapes22_1client", "shapes22_2clients"])
def test_streams_are_permutations(mix):
    spec = traffic.load_json("mixes", mix)
    for stream in spec["streams"]:
        assert sorted(stream, key=lambda s: int(s[1:])) == SHAPES


def test_spec_stream_orders():
    assert traffic.load_json("mixes", "shapes22_1client")["streams"][0][:3] == ["q14", "q2", "q9"]
    s01, s02 = traffic.load_json("mixes", "shapes22_2clients")["streams"]
    assert s01[:3] == ["q21", "q3", "q18"] and s02[:3] == ["q6", "q17", "q14"]


def test_dashboard_draws():
    mix = traffic.Mix("dashboard", 2 ** 31 + 17)
    seen = [next(g) for g in [mix.requests(0)] for _ in range(400)]
    shapes = [s for s, _, _ in seen]
    assert 150 < shapes.count("q1") < 250
    for shape, p, _ in seen:
        if shape == "q1":
            assert 60 <= p["DELTA"] <= 120
        else:
            assert 1993 <= p["YEAR"] <= 1997 and p["QUANTITY"] in (24, 25)
            assert 0.02 <= p["DISCOUNT"] <= 0.09
    again = traffic.Mix("dashboard", 2 ** 31 + 17).requests(0)
    assert [next(again) for _ in range(400)] == seen
    other = traffic.Mix("dashboard", 5).requests(0)
    assert [next(other) for _ in range(400)] != seen
