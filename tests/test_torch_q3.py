"""TPC-H Q3 (rewrite on and off), Q10, Q4, Q22 and ORDER BY ... LIMIT end
to end: the PyTorch port's ``run_query`` against the JAX package's on
catalogs both generate from one seed (tolerance zero: every output is an
integer, a string, a date or a decimal mantissa).

Templates: ``tests/test_tpch_e2e.py`` (Q3, its rewrite, top-N) and
``tests/test_tpch_more.py`` (Q4, Q10, Q22).  Also the fused stream-agg
path declining on Q3, the aggregation method each query dispatches to,
and the independent numpy versions of these queries in
``chip_smoke.py``.
"""

import pytest

from tiflash_tpu.bench import tpch_queries as JQ
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.runtime.settings import Settings
from tiflash_tpu.storage.tpch import generate_tpch as j_generate
from tiflash_tpu.testing.oracle import assert_tables_equal

import chip_smoke
from torch_agg_rule import record_ranged
from tiflash_tpu_torch.bench import tpch_queries as TQ
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.ops import stream_fuse as TSF
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate

SF, SEED = 0.002, 0
TABLES = chip_smoke.Q3_TABLES
LIMIT = chip_smoke.TOPN_LIMIT

# (reference plan, port plan, rewrites on, catalog)
QUERIES = {
    "q3": (JQ.q3_plan, TQ.q3_plan, True, "three"),
    "q3_no_rewrite": (lambda: JQ.q3_plan(rewrite=False),
                      lambda: TQ.q3_plan(rewrite=False), False, "three"),
    "q10": (JQ.q10_plan, TQ.q10_plan, True, "three"),
    "q4": (JQ.q4_plan, TQ.q4_plan, True, "three"),
    "q22": (JQ.q22_plan, TQ.q22_plan, True, "three"),
    "topn": (lambda: JQ.sort_topn_plan(LIMIT), lambda: TQ.sort_topn_plan(LIMIT), True,
             "lineitem"),
}


@pytest.fixture(scope="module")
def catalogs():
    return {
        "three": (j_generate(sf=SF, seed=SEED, tables=TABLES).blocks(),
                  t_generate(sf=SF, seed=SEED, tables=TABLES)),
        "lineitem": (j_generate(sf=SF, seed=SEED, tables=["lineitem"]).blocks(),
                     t_generate(sf=SF, seed=SEED, tables=["lineitem"])),
    }


def _result(block):
    return block.to_pylists(), [repr(c.dtype) for c in block.columns]


def reference_slots(j_plan, j_tables, rewrites=True):
    """The ``num_slots`` of each Aggregation (DFS order) in the tree the
    reference's runner runs: rewritten, then auto-sized."""
    from tiflash_tpu.plan.auto import autosize_plan
    from tiflash_tpu.plan.rewrite import eager_aggregation, prune_columns

    if rewrites:
        j_plan = prune_columns(eager_aggregation(j_plan))
    autosize_plan(j_plan, j_tables)
    out, stack = [], [j_plan]
    while stack:
        n = stack.pop()
        if isinstance(n, JP.Aggregation):
            out.append(n.num_slots)
        stack.extend(reversed(n.children))
    return out


def _dispatch_spy(monkeypatch):
    """Record which aggregation method each Aggregation took."""
    calls = []
    real = {m: getattr(TA, m) for m in ("aggregate_stream", "aggregate_sort",
                                         "aggregate_direct")}
    monkeypatch.setattr(TA, "aggregate_stream", lambda b, k, a, ns: (
        calls.append(("stream", list(k), ns)) or real["aggregate_stream"](b, k, a, ns)))
    monkeypatch.setattr(TA, "aggregate_sort", lambda b, k, a, ns: (
        calls.append(("sort", list(k), ns)) or real["aggregate_sort"](b, k, a, ns)))
    monkeypatch.setattr(TA, "aggregate_direct", lambda b, k, a, sd, use_kernel=None: (
        calls.append(("direct", list(k), sd[1])) or real["aggregate_direct"](
            b, k, a, sd, use_kernel)))
    return calls


@pytest.mark.parametrize("query", list(QUERIES))
def test_run_query_matches_reference(catalogs, monkeypatch, query):
    j_plan, t_plan, rewrites, cat = QUERIES[query]
    j_tables, t_cat = catalogs[cat]
    calls = _dispatch_spy(monkeypatch)
    ranged = []
    record_ranged(monkeypatch, ranged)
    fused = TSF.FUSE_STATS["count"]

    want, j_summary = j_run(j_plan(), j_tables,
                            settings=Settings(enable_plan_rewrites=rewrites))
    got, summary = t_run(t_plan(), t_cat.blocks("cpu"), plan_rewrites=rewrites)

    assert _result(got)[1] == _result(want)[1]
    assert_tables_equal(got.to_pylists(), want.to_pylists(), ordered=True)
    assert got.to_pylists() == want.to_pylists()
    assert summary.plan_text == j_summary.plan_text
    assert summary.retries == j_summary.retries == 0
    assert summary.result_rows == int(want.num_rows())
    assert summary.device == "cpu"
    assert TSF.FUSE_STATS["count"] == fused  # no aggregation here fuses
    # the runner's auto-sized capacities, the reference's
    slots = reference_slots(j_plan(), j_tables, rewrites) or [None]
    expected = {
        # the pushed single-key aggregation over the clustered scan
        "q3": [("stream", ["l_orderkey"], slots[0])],
        # three keys over the joined rows
        "q3_no_rewrite": [("sort", ["l_orderkey", "o_orderdate", "o_shippriority"],
                           slots[0])],
        # o_custkey after a join is not clustered, and the customer keys'
        # range stats give the port a dense domain at this scale, where
        # the reference sorts (torch_agg_rule.py)
        "q10": [("direct", ["c_custkey"], ranged[0][1] if ranged else None)],
        # 5 priorities: the direct method's masked sub-method
        "q4": [("direct", ["o_orderpriority"], 5)],
        "q22": [],
        "topn": [],
    }[query]
    assert calls == expected
    assert [k for k, _, _ in ranged] == ([("c_custkey",)] if query == "q10" else [])
    if query in ("q3", "q3_no_rewrite", "q10", "topn"):
        assert summary.result_rows == {"q10": 20, "topn": LIMIT}.get(query, 10)


def test_q3_rewrite_on_and_off_agree(catalogs):
    _, t_cat = catalogs["three"]
    on, _ = t_run(TQ.q3_plan(), t_cat.blocks("cpu"))
    off, _ = t_run(TQ.q3_plan(rewrite=False), t_cat.blocks("cpu"), plan_rewrites=False)
    assert _result(on) == _result(off)
    s = TQ.q3_plan().pretty()
    assert s.index("Join") < s.index("Aggregation"), "the aggregation sits under the join"


def test_fuse_declines_on_q3(catalogs):
    """Q3's pushed aggregation groups by l_orderkey, which has no static
    key domain, so the fused stream-agg path declines."""
    from tiflash_tpu_torch.plan import nodes as TP

    _, t_cat = catalogs["three"]
    aggs = [n for n in _walk(TQ.q3_plan()) if isinstance(n, TP.Aggregation)]
    assert len(aggs) == 1 and list(aggs[0].keys) == ["l_orderkey"]
    assert TSF.try_fuse_stream_agg(aggs[0], t_cat.blocks("cpu")) is None


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


@pytest.mark.parametrize("query", ["q3", "q10", "q4", "q22", "topn"])
def test_numpy_check_of_chip_smoke_agrees(catalogs, query):
    _, t_cat = catalogs[QUERIES[query][3]]
    out, _ = t_run(QUERIES[query][1](), t_cat.blocks("cpu"))
    if query == "topn":
        li = chip_smoke.lineitem_arrays(t_cat)
        want = chip_smoke.numpy_topn(li["l_extendedprice"],
                                     {"l_orderkey": li["l_orderkey"],
                                      "l_extendedprice": li["l_extendedprice"]}, LIMIT)
    else:
        want = getattr(chip_smoke, f"numpy_{query}")(chip_smoke.tpch3_arrays(t_cat))
    assert out.to_pylists() == want
