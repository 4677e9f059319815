"""The Star Schema Benchmark's 13 queries through the port's query service
(``mpp/service.py`` over ``QueryRunner``, the benchmark's served path) on
the CPU, against the benchmark's plain references.

The data is ``portbench/ssb_datagen.py``'s at SF 0.01 from two seeds;
each query is its frozen plan (``portbench/queries/ssb_q*.json``) and
each answer, through a JSON round trip, is judged by
``portbench/check.py`` against ``portbench/reference/ssb_q*.py``: exact,
in order where the plan orders.  One traced request shows the
aggregation's ``agg.<method>`` span inside its ``op.Aggregation`` and
the method's counters.
"""

import importlib
import json

import pytest

from portbench import check, dataset, system, traffic
from portbench.reference._common import Tables
from tiflash_tpu_torch.mpp.service import QueryService
from tiflash_tpu_torch.runtime import tracing
from tiflash_tpu_torch.runtime.metrics import METRICS

SF = 0.01
SEEDS = (7, 2 ** 33 + 1)
SHAPES = [f"ssb_q{f}_{q}" for f, n in ((1, 3), (2, 3), (3, 4), (4, 3)) for q in range(1, n + 1)]


@pytest.fixture(scope="module", params=SEEDS)
def world(request):
    tables = dataset.generator(dataset.config("ssb_sf10")).generate(SF, request.param, "cpu")
    return QueryService(system.build_catalog(tables), device="cpu"), Tables(tables, "cpu")


def _served(service, shape):
    q = traffic.load_json("queries", shape)
    return json.loads(json.dumps(service.execute(traffic.bind(q, q["params"]))["columns"],
                                 default=str))


def test_thirteen_queries_in_four_flights():
    assert len(SHAPES) == 13
    assert traffic.Mix("flights13_1client", 1).spec["streams"] == [SHAPES]


@pytest.mark.parametrize("shape", SHAPES)
def test_served_answer_equals_the_reference(world, shape):
    service, t = world
    ref = importlib.import_module(f"portbench.reference.{shape}")
    want = ref.answer(t, {})
    assert check.compare(_served(service, shape), want, ref.ORDER_BY, ref.LIMIT) is None
    # the rows that reach the aggregation, which dense_agg_roofline counts
    some = next(iter(want.values())) not in ([], [None])
    assert (int(ref.live(t, {}).sum()) > 0) == some
    assert set(ref.answer(t, {}, control=True)) == set(want)


def test_a_traced_request_names_its_method(world):
    """Q4.1 groups by d_year (1992-1998, from range stats) and c_nation
    (a dictionary): 8 x 26 slots with the joins' NULLs, the direct
    method; Q1.1 is keyless."""
    service, t = world
    before = METRICS.dump()
    tracing.enable()
    try:
        _served(service, "ssb_q4_1")
        _served(service, "ssb_q1_1")
    finally:
        tracing.disable()
    spans = tracing.drain()
    by_id = {s["span_id"]: s for s in spans}
    aggs = [s for s in spans if s["name"].startswith("agg.")]
    assert [s["name"] for s in aggs] == ["agg.direct", "agg.scalar"]
    assert all(by_id[s["parent_id"]]["name"] == "op.Aggregation" for s in aggs)
    direct, scalar = (s["attrs"] for s in aggs)
    assert direct["slots"] == 8 * 26 and direct["keys"] == 2
    assert direct["rows"] == scalar["rows"] == len(t.host["lo_orderkey"])
    assert scalar["slots"] == 1 and scalar["keys"] == 0
    after = METRICS.dump()
    for method, rows in (("direct", direct["rows"]), ("scalar", scalar["rows"])):
        assert after[f"agg_calls_total_method_{method}"] == \
            before.get(f"agg_calls_total_method_{method}", 0) + 1
        assert after[f"agg_rows_total_method_{method}"] == \
            before.get(f"agg_rows_total_method_{method}", 0) + rows
