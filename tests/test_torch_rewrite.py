"""The plan rewrites the runner applies (``eager_aggregation`` and
``prune_columns``), and ``flagged_positions``: the PyTorch port against
the JAX package.

Before the port had ``plan/rewrite.py`` its ``run_query`` ran plans as
given, so wherever a plan joins, its tree differed from the one the
reference runs: joins gathered payload columns the reference prunes,
and DFS node ids (the overflow keys) could differ.  These tests hold the
port's rewritten trees, node by node, to the reference's for Q1, Q6,
Q7, Q7-pairs, Q3, Q10, Q4 and Q22; show that ``run_query`` runs that
tree (its ``summary.plan_text``); that a second rewrite changes nothing;
and that capacity retries land on the rewritten tree's node ids.

Templates: ``tests/test_tpch_e2e.py`` (the Q3 rewrite) and
``tests/test_merge.py`` (``flagged_positions``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiflash_tpu.bench import tpch_queries as JQ
from tiflash_tpu.ops.merge import flagged_positions as j_flagged
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.rewrite import eager_aggregation as j_eager, prune_columns as j_prune
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.runtime.settings import Settings
from tiflash_tpu.storage.tpch import generate_tpch as j_generate

from test_torch_q7 import j_q7_nation_pairs_plan
from tiflash_tpu_torch.bench import tpch_queries as TQ
from tiflash_tpu_torch.ops.merge import flagged_positions as t_flagged
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.plan.rewrite import eager_aggregation as t_eager, prune_columns as t_prune
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate

SF, SEED = 0.002, 0
CATALOG_OF = {"q1": "lineitem", "q6": "lineitem", "q7": "five", "q7_pairs": "five",
              "q3": "three", "q10": "three", "q4": "three", "q22": "three"}
TABLES = {"lineitem": ["lineitem"],
          "five": ["nation", "supplier", "customer", "orders", "lineitem"],
          "three": ["lineitem", "orders", "customer"]}
J_PLANS = {"q1": JQ.q1_plan, "q6": JQ.q6_plan, "q7": JQ.q7_plan,
           "q7_pairs": j_q7_nation_pairs_plan, "q3": JQ.q3_plan, "q10": JQ.q10_plan,
           "q4": JQ.q4_plan, "q22": JQ.q22_plan}
T_PLANS = {"q1": TQ.q1_plan, "q6": TQ.q6_plan, "q7": TQ.q7_plan,
           "q7_pairs": TQ.q7_nation_pairs_plan, "q3": TQ.q3_plan, "q10": TQ.q10_plan,
           "q4": TQ.q4_plan, "q22": TQ.q22_plan}
QUERIES = list(J_PLANS)


def _dfs(node):
    out = [node]
    for c in node.children:
        out.extend(_dfs(c))
    return out


def _shape(plan):
    """Per node in DFS order: its kind, ``describe()``, and for a Join
    its ``build_payload`` (which ``describe()`` does not show)."""
    return [(type(n).__name__, n.describe(),
             list(n.build_payload) if getattr(n, "build_payload", None) is not None
             else None) for n in _dfs(plan)]


@pytest.mark.parametrize("query", QUERIES)
def test_rewritten_tree_matches_reference(query):
    want = j_prune(j_eager(J_PLANS[query]()))
    got = t_prune(t_eager(T_PLANS[query]()))
    assert _shape(got) == _shape(want)
    assert got.pretty() == want.pretty()


@pytest.mark.parametrize("query", QUERIES)
def test_rewrite_is_idempotent(query):
    once = t_prune(t_eager(T_PLANS[query]()))
    twice = t_prune(t_eager(t_prune(t_eager(T_PLANS[query]()))))
    assert _shape(twice) == _shape(once)


@pytest.fixture(scope="module")
def catalogs():
    return {name: t_generate(sf=SF, seed=SEED, tables=t).blocks("cpu")
            for name, t in TABLES.items()}


@pytest.mark.parametrize("query", QUERIES)
def test_run_query_runs_the_reference_tree(catalogs, query):
    """``summary.plan_text`` is the reference's rewritten tree; with
    ``plan_rewrites=False`` it is the tree as given, which differs from
    the reference's wherever the rewrite prunes (the fault repaired)."""
    tables = catalogs[CATALOG_OF[query]]
    want = j_prune(j_eager(J_PLANS[query]())).pretty()
    out, summary = t_run(T_PLANS[query](), tables)
    assert summary.plan_text == want
    raw_out, raw = t_run(T_PLANS[query](), tables, plan_rewrites=False)
    assert raw.plan_text == T_PLANS[query]().pretty()
    assert (raw.plan_text != want) == (query in ("q7", "q7_pairs", "q10", "q4"))
    assert raw_out.to_pylists() == out.to_pylists()


def test_one_plan_object_run_twice(catalogs):
    """The rewrite patches in place the nodes it does not replace; a
    second run of the same plan object runs the same tree."""
    tables = catalogs["three"]
    plan = TQ.q3_plan(rewrite=False)
    first, s1 = t_run(plan, tables)
    second, s2 = t_run(plan, tables)
    assert s1.plan_text == s2.plan_text == TQ.q3_plan().pretty()
    assert first.to_pylists() == second.to_pylists()


@pytest.mark.parametrize("query", ["q3", "q10"])
def test_retries_land_on_the_rewritten_node_ids(catalogs, query):
    """16 slots for the pushed aggregation overflow once; the runner
    grows the node it finds by the rewritten tree's DFS id, like the
    reference, and the caller's plan keeps its setting."""
    j_tables = j_generate(sf=SF, seed=SEED, tables=TABLES["three"]).blocks()
    jo, js = j_run(getattr(JQ, f"{query}_plan")(agg_slots=16), j_tables)
    plan = getattr(TQ, f"{query}_plan")(agg_slots=16)
    to, ts = t_run(plan, catalogs["three"])
    assert ts.retries == js.retries == 1
    assert ts.overflow_nodes == js.overflow_nodes == ["Aggregation_4"]
    assert to.to_pylists() == jo.to_pylists()
    aggs = [n for n in _dfs(plan) if isinstance(n, TP.Aggregation)]
    assert [a.num_slots for a in aggs] == [16]


def test_limit_keeps_its_fields_under_the_rewrite(catalogs):
    """``prune_columns`` rebuilds a Limit as Limit(limit, child).  (The
    reference passes the two the other way round, so it is compared here
    with its rewrites off.)"""
    from tiflash_tpu.ops.sort import SortKey as JSortKey
    from tiflash_tpu_torch.ops.sort import SortKey as TSortKey

    def plan(P, SortKey):
        return P.Limit(7, P.Sort([SortKey("l_extendedprice", True), SortKey("l_orderkey")],
                                 P.TableScan("lineitem", columns=["l_orderkey",
                                                                  "l_extendedprice",
                                                                  "l_tax"])))

    rewritten = t_prune(plan(TP, TSortKey), {"l_orderkey"})
    assert rewritten.limit == 7 and isinstance(rewritten.child, TP.Sort)
    assert rewritten.child.child.columns == ["l_orderkey", "l_extendedprice"]
    j_tables = j_generate(sf=SF, seed=SEED, tables=["lineitem"]).blocks()
    jo, _ = j_run(plan(JP, JSortKey), j_tables, settings=Settings(enable_plan_rewrites=False))
    to, _ = t_run(plan(TP, TSortKey), catalogs["lineitem"])
    assert to.to_pylists() == jo.to_pylists()


# ---------------------------------------------------------------------------
# flagged_positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,num_out,frac", [
    (128, 4, 0.3), (128, 64, 0.3), (128, 200, 0.3),   # the reference's cases
    (5000, 3000, 0.5),     # past the trash lanes, some flags cut off
    (5000, 6000, 0.05),    # more slots than rows
    (16, 8, 0.0),          # none set
    (300, 300, 1.0),       # all set
])
def test_flagged_positions_matches_reference(seed, n, num_out, frac):
    flags = np.random.default_rng(seed).random(n) < frac
    got = t_flagged(torch.from_numpy(flags), num_out)
    want = np.asarray(j_flagged(jnp.asarray(flags), num_out))
    assert got.dtype == torch.int32 and got.shape == (num_out,)
    assert np.array_equal(got.numpy(), want)
    k = min(int(flags.sum()), num_out)
    assert np.array_equal(got.numpy()[:k], np.flatnonzero(flags)[:k])
