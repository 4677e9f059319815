"""TPC-H Q15-Q21 end to end, and Q18 at TPC-H's own threshold of 300:
the PyTorch port's ``run_query`` against the JAX package's on the
eight-table catalogs both generate from one seed at sf 0.002 (tolerance
zero), with the helpers of ``tests/test_torch_tpch_more_a.py``.

Q18 as the reference builds it compares a decimal(37,2) sum with 21000,
which no order reaches; the variant with 300 selects an order at seed 6.
Q20 selects nothing at seed 0 and is run again at seed 16.  Also: the
rewritten trees node by node, Q15's CTE (its definition runs once, both
CTERefs get the same block, and the DFS ids equal the reference's), and
the numpy versions of Q16 and Q18 in ``chip_smoke.py``.
"""

import pytest

from tiflash_tpu.bench import tpch_queries as JQ
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.rewrite import eager_aggregation as j_eager, prune_columns as j_prune
from tiflash_tpu.runtime.executor import enumerate_plan as j_enumerate

import chip_smoke
from test_torch_rewrite import _dfs, _shape
from test_torch_tpch_more_a import Catalogs, check_against_reference
from tiflash_tpu_torch.bench import tpch_queries as TQ
from tiflash_tpu_torch.plan import compiler as TC
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.plan.rewrite import eager_aggregation as t_eager, prune_columns as t_prune
from tiflash_tpu_torch.runtime.executor import enumerate_plan as t_enumerate
from tiflash_tpu_torch.runtime.executor import run_query as t_run

MIN_QTY = chip_smoke.Q18_MIN_QTY


def j_q18_plan(min_qty: int):
    """The reference's Q18 with its HAVING threshold replaced."""
    plan = JQ.q18_plan()
    for node in _dfs(plan):
        if isinstance(node, JP.Selection):
            node.cond = JE.col("sum_qty") > JE.lit(min_qty, None)
    return plan


QUERIES = {q: (getattr(JQ, f"{q}_plan"), getattr(TQ, f"{q}_plan"))
           for q in ("q15", "q16", "q17", "q18", "q19", "q20", "q21")}
QUERIES["q18_300"] = (lambda: j_q18_plan(MIN_QTY), lambda: TQ.q18_plan(min_qty=MIN_QTY))
CASES = [(q, 0) for q in QUERIES] + [("q20", 16), ("q18_300", 6)]
NUMPY = {"q16": chip_smoke.numpy_q16, "q18_300": chip_smoke.numpy_q18}


@pytest.fixture(scope="module")
def catalogs():
    return Catalogs()


@pytest.mark.parametrize("query,seed", CASES)
def test_run_query_matches_reference(catalogs, monkeypatch, query, seed):
    got, _ = check_against_reference(catalogs, monkeypatch, *QUERIES[query], seed)
    if seed:
        # the cases exist because these select rows at this seed
        assert int(got.num_rows()) > 0


@pytest.mark.parametrize("query", list(QUERIES))
def test_rewritten_tree_matches_reference(query):
    j_plan, t_plan = QUERIES[query]
    want = j_prune(j_eager(j_plan()))
    got = t_prune(t_eager(t_plan()))
    assert _shape(got) == _shape(want)
    assert got.pretty() == want.pretty()
    assert t_plan().pretty() == j_plan().pretty()


@pytest.mark.parametrize("query,seed", [("q16", 0), ("q16", 6), ("q18_300", 0),
                                        ("q18_300", 6)])
def test_numpy_check_of_chip_smoke_agrees(catalogs, query, seed):
    _, t_cat = catalogs[seed]
    out, _ = t_run(QUERIES[query][1](), t_cat.blocks("cpu"))
    assert out.to_pylists() == NUMPY[query](chip_smoke.tpch8_arrays(t_cat))


def test_cte_runs_once_and_shares_its_block(catalogs, monkeypatch):
    """Q15: the revenue CTE is aggregated once, and the keyless max and
    the cross join read the very same block."""
    _, t_cat = catalogs[0]
    agg_inputs, cross_inputs = [], []
    real_agg, real_cross = TC.hash_aggregate, TC.cross_join
    monkeypatch.setattr(TC, "hash_aggregate", lambda b, k, a, ns: (
        agg_inputs.append((list(k), b)) or real_agg(b, k, a, ns)))
    monkeypatch.setattr(TC, "cross_join", lambda p, b, cap: (
        cross_inputs.append(p) or real_cross(p, b, cap)))
    t_run(TQ.q15_plan(), t_cat.blocks("cpu"))
    assert [k for k, _ in agg_inputs] == [["l_suppkey"], []]
    assert len(cross_inputs) == 1
    assert agg_inputs[1][1] is cross_inputs[0]


@pytest.mark.parametrize("rewrite", [False, True])
def test_cte_dfs_ids_match_reference(rewrite):
    """The node ids the runner grows by (overflow keys) are the
    reference's: definitions first, then the child; each CTERef a leaf."""
    j_plan, t_plan = JQ.q15_plan(), TQ.q15_plan()
    if rewrite:
        j_plan, t_plan = j_prune(j_eager(j_plan)), t_prune(t_eager(t_plan))
    want, _ = j_enumerate(j_plan)
    got = t_enumerate(t_plan)
    assert [(i, type(n).__name__, n.describe()) for i, n in got.items()] == \
        [(i, type(n).__name__, n.describe()) for i, n in want.items()]
    kinds = [type(n).__name__ for n in got.values()]
    assert kinds[0] == "WithCTE" and kinds.count("CTERef") == 2
    assert isinstance(got[2], TP.Aggregation)


def test_cross_join_overflow_grows_and_retries(catalogs):
    """A cross join sized below its output reports the capacity it needs;
    the runner grows it and the rows equal an unbounded run."""
    _, t_cat = catalogs[16]  # Q11 selects rows at this seed
    plan = TQ.q11_plan()
    nid, cross = next((i, n) for i, n in t_enumerate(plan).items()
                      if isinstance(n, TP.CrossJoin))
    cross.output_capacity = 3
    small, summary = t_run(plan, t_cat.blocks("cpu"), plan_rewrites=False)
    full, base = t_run(TQ.q11_plan(), t_cat.blocks("cpu"), plan_rewrites=False)
    assert base.retries == 0 and summary.retries == 1
    assert summary.overflow_nodes == [f"CrossJoin_{nid}"]
    assert cross.output_capacity > 3
    assert int(full.num_rows()) > 0
    assert small.to_pylists() == full.to_pylists()
