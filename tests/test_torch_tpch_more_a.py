"""TPC-H Q2, Q5, Q8, Q9, Q11, Q12, Q13 and Q14 end to end: the PyTorch
port's ``run_query`` against the JAX package's on the eight-table
catalogs both generate from one seed at sf 0.002 (tolerance zero: every
output is an integer, a string, a date or a decimal mantissa).

Seed 0 runs every query.  Its 20 suppliers include none in BRAZIL or
GERMANY, so Q8's share is NULL and Q11 selects nothing there; seed 16
runs Q8 and Q11 again where both return values.  Each case also holds
the port's aggregation methods, call by call, to the reference's, but
for the keys whose range stats give the port a dense domain
(``torch_agg_rule.py``), and checks that the fused path never ran and
that the direct_agg kernel's branch ran only for those keys.  The
rewritten trees are compared node by node, and the numpy versions of
Q2, Q9, Q13 and Q14 in ``chip_smoke.py`` are held against the port.

``tests/test_torch_tpch_more_b.py`` covers Q15-Q21 with the same helpers.
"""

import pytest

from tiflash_tpu.bench import tpch_queries as JQ
from tiflash_tpu.ops import aggregate as JA
from tiflash_tpu.plan.rewrite import eager_aggregation as j_eager, prune_columns as j_prune
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.storage.tpch import generate_tpch as j_generate
from tiflash_tpu.testing.oracle import assert_tables_equal

import chip_smoke
from test_torch_rewrite import _shape
from torch_agg_rule import by_rule, kernel_calls, record_ranged
from tiflash_tpu_torch.bench import tpch_queries as TQ
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.ops import stream_fuse as TSF
from tiflash_tpu_torch.plan.rewrite import eager_aggregation as t_eager, prune_columns as t_prune
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate

SF = 0.002
TABLES = chip_smoke.EIGHT_TABLES

# query -> (reference plan, port plan)
QUERIES = {q: (getattr(JQ, f"{q}_plan"), getattr(TQ, f"{q}_plan"))
           for q in ("q2", "q5", "q8", "q9", "q11", "q12", "q13", "q14")}
CASES = [(q, 0) for q in QUERIES] + [("q8", 16), ("q11", 16)]
NUMPY = {"q2": chip_smoke.numpy_q2, "q9": chip_smoke.numpy_q9,
         "q13": chip_smoke.numpy_q13, "q14": chip_smoke.numpy_q14}


class Catalogs:
    """Both packages' eight-table catalogs per seed, made on first use."""

    def __init__(self):
        self._cats = {}

    def __getitem__(self, seed):
        if seed not in self._cats:
            self._cats[seed] = (
                j_generate(sf=SF, seed=seed, tables=TABLES).blocks(),
                t_generate(sf=SF, seed=seed, tables=TABLES))
        return self._cats[seed]


@pytest.fixture(scope="module")
def catalogs():
    return Catalogs()


def _dispatch_spy(monkeypatch, mod, calls):
    """Record, in ``calls``, each aggregation method ``mod`` dispatches to
    and its group keys."""
    for name, method in (("aggregate_stream", "stream"), ("aggregate_sort", "sort"),
                         ("aggregate_direct", "direct")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda b, k, *a, _r=real, _m=method, **kw: (
            calls.append((_m, list(k))) or _r(b, k, *a, **kw)))
    real_scalar = mod.aggregate_scalar
    monkeypatch.setattr(mod, "aggregate_scalar", lambda b, aggs: (
        calls.append(("keyless", [])) or real_scalar(b, aggs)))


def check_against_reference(catalogs, monkeypatch, j_plan, t_plan, seed):
    """Run one plan through both packages; hold rows, dtypes, the tree
    that ran, the retries and the aggregation methods equal.  Returns
    the port's (result, summary)."""
    j_tables, t_cat = catalogs[seed]
    j_calls, t_calls = [], []
    _dispatch_spy(monkeypatch, JA, j_calls)
    ranged = []
    record_ranged(monkeypatch, ranged)
    _dispatch_spy(monkeypatch, TA, t_calls)
    kernel_branch = []
    real_kernel = TA._accumulate_direct_kernel
    monkeypatch.setattr(TA, "_accumulate_direct_kernel", lambda *a: (
        kernel_branch.append(1) or real_kernel(*a)))
    fused = TSF.FUSE_STATS["count"]

    want, j_summary = j_run(j_plan(), j_tables)
    got, summary = t_run(t_plan(), t_cat.blocks("cpu"))

    assert list(got.names) == list(want.names)
    assert [repr(c.dtype) for c in got.columns] == [repr(c.dtype) for c in want.columns]
    assert_tables_equal(got.to_pylists(), want.to_pylists(), ordered=True)
    assert got.to_pylists() == want.to_pylists()
    assert summary.plan_text == j_summary.plan_text
    assert summary.retries == j_summary.retries
    assert summary.overflow_nodes == j_summary.overflow_nodes
    assert summary.result_rows == int(want.num_rows())
    assert t_calls == by_rule(j_calls, ranged)
    assert len(kernel_branch) == kernel_calls(ranged)
    assert TSF.FUSE_STATS["count"] == fused
    return got, summary


@pytest.mark.parametrize("query,seed", CASES)
def test_run_query_matches_reference(catalogs, monkeypatch, query, seed):
    got, summary = check_against_reference(catalogs, monkeypatch, *QUERIES[query], seed)
    if query == "q13":
        # the left join starts at the customer table's capacity and grows
        assert summary.overflow_nodes == ["Join_4"]
    if seed == 16:
        # the cases exist because these return values at this seed
        rows = got.to_pylists()
        assert any(v is not None for v in rows.get("mkt_share", rows.get("value")))


@pytest.mark.parametrize("query", list(QUERIES))
def test_rewritten_tree_matches_reference(query):
    j_plan, t_plan = QUERIES[query]
    want = j_prune(j_eager(j_plan()))
    got = t_prune(t_eager(t_plan()))
    assert _shape(got) == _shape(want)
    assert got.pretty() == want.pretty()
    assert t_plan().pretty() == j_plan().pretty()


@pytest.mark.parametrize("query,seed", [(q, s) for q in NUMPY for s in (0, 16)])
def test_numpy_check_of_chip_smoke_agrees(catalogs, query, seed):
    _, t_cat = catalogs[seed]
    out, _ = t_run(QUERIES[query][1](), t_cat.blocks("cpu"))
    assert out.to_pylists() == NUMPY[query](chip_smoke.tpch8_arrays(t_cat))
