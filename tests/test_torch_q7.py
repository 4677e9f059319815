"""TPC-H Q7 and Q7 over all nation pairs end to end: the PyTorch port's
``run_query`` against the JAX package's on the five-table catalog both
generate from one seed (tolerance zero: every output is an integer, a
string or a decimal mantissa).

Also the spots Q7 leans on: ``year()`` around 1970 and year boundaries,
string equality with a literal absent from the dictionary, the fused
stream-agg path declining over a join, the aggregation methods each
query dispatches to, and the independent numpy Q7 of ``chip_smoke.py``.
"""

import datetime

import numpy as np
import pytest

from tiflash_tpu.bench import tpch_queries as JQ
from tiflash_tpu.ops.aggregate import AggDesc as JAgg
from tiflash_tpu.ops.sort import SortKey as JSortKey
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.storage.tpch import generate_tpch as j_generate
from tiflash_tpu.testing.oracle import assert_tables_equal

import chip_smoke
from tiflash_tpu_torch.bench import tpch_queries as TQ
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.ops import stream_fuse as TSF
from tiflash_tpu_torch.ops.cuda import direct_agg as TDA
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate

SF, SEED = 0.002, 0
TABLES = ["nation", "supplier", "customer", "orders", "lineitem"]


def j_q7_nation_pairs_plan():
    """The reference's tree for ``q7_nation_pairs_plan``, from its own
    Q7: the same join graph under the pairs' projection and aggregation."""
    from tiflash_tpu.expr.nodes import col, lit

    joins = JQ.q7_plan().child.child.child.child
    proj = JP.Projection(
        {"supp_nation": col("supp_nation"), "cust_nation": col("cust_nation"),
         "volume": col("l_extendedprice") * (lit(1.0) - col("l_discount"))},
        joins,
    )
    agg = JP.Aggregation(
        keys=["supp_nation", "cust_nation"],
        aggs=[JAgg("sum", "volume", "revenue"), JAgg("avg", "volume", "avg_volume"),
              JAgg("count", None, "n_lines")],
        child=proj,
    )
    return JP.Sort([JSortKey("supp_nation"), JSortKey("cust_nation")], agg)


J_PLANS = {"q7": JQ.q7_plan, "q7_pairs": j_q7_nation_pairs_plan}
T_PLANS = {"q7": TQ.q7_plan, "q7_pairs": TQ.q7_nation_pairs_plan}


@pytest.fixture(scope="module")
def catalogs():
    return (j_generate(sf=SF, seed=SEED, tables=TABLES).blocks(),
            t_generate(sf=SF, seed=SEED, tables=TABLES))


@pytest.fixture(scope="module")
def reference_results(catalogs):
    j_tables, _ = catalogs
    return {q: j_run(make(), j_tables)[0] for q, make in J_PLANS.items()}


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


@pytest.mark.parametrize("query", ["q7", "q7_pairs"])
def test_run_query_matches_reference(catalogs, reference_results, monkeypatch, query):
    j_tables, t_cat = catalogs
    dispatched = []
    real_direct, real_sort = TA.aggregate_direct, TA.aggregate_sort
    monkeypatch.setattr(TA, "aggregate_direct", lambda b, k, a, sd, use_kernel=None: (
        dispatched.append(("direct", sd[1], use_kernel))
        or real_direct(b, k, a, sd, use_kernel)))
    monkeypatch.setattr(TA, "aggregate_sort", lambda b, k, a, ns: (
        dispatched.append(("sort", ns)) or real_sort(b, k, a, ns)))
    kernel_calls = []
    real_sums = TDA.direct_sums
    monkeypatch.setattr(TDA, "direct_sums", lambda *a: (
        kernel_calls.append(a[-1]) or real_sums(*a)))
    fused = TSF.FUSE_STATS["count"]

    out, summary = t_run(T_PLANS[query](), t_cat.blocks("cpu"))

    want = reference_results[query]
    got_rows, got_types = _result(out)
    want_rows, want_types = _result(want)
    assert got_types == want_types
    assert_tables_equal(got_rows, want_rows, ordered=True)
    assert summary.retries == 0 and summary.device == "cpu"
    assert summary.result_rows == int(want.num_rows()) > 0
    assert TSF.FUSE_STATS["count"] == fused  # the fuse declined over the joins
    if query == "q7":
        # the runner's auto-sized capacity, the reference's
        slots = reference_slots(J_PLANS[query](), j_tables)
        assert dispatched == [("sort", slots[0])] and kernel_calls == []
    else:
        # each nation key is nullable after its join: 26 x 26 slots
        assert dispatched == [("direct", 676, None)] and kernel_calls == [676]


def test_join_outputs_get_a_validity(catalogs):
    """The joined nation names carry a validity, as in the reference, so
    their key domain is 26 each (25 names + NULL)."""
    _, t_cat = catalogs
    agg = TQ.q7_nation_pairs_plan().child
    from tiflash_tpu_torch.plan.compiler import execute_plan

    proj = execute_plan(agg.child, t_cat.blocks("cpu"))
    for name in ("supp_nation", "cust_nation"):
        assert proj[name].validity is not None
        assert TA.key_domain_size(proj[name]) == 26


def test_fuse_declines_over_a_join_child(catalogs):
    _, t_cat = catalogs
    for make in T_PLANS.values():
        agg = make().child
        assert TSF.try_fuse_stream_agg(agg, t_cat.blocks("cpu")) is None


def test_plans_match_reference_trees():
    for q in J_PLANS:
        assert T_PLANS[q]().pretty() == J_PLANS[q]().pretty()


@pytest.mark.parametrize("query", ["q7", "q7_pairs"])
def test_numpy_check_of_chip_smoke_agrees(catalogs, query):
    _, t_cat = catalogs
    out, _ = t_run(T_PLANS[query](), t_cat.blocks("cpu"))
    arrays = chip_smoke.q7_arrays(t_cat)
    want = chip_smoke.numpy_q7(arrays) if query == "q7" else \
        chip_smoke.numpy_q7_pairs(arrays)
    assert out.to_pylists() == want


# ---------------------------------------------------------------------------
# year() and string equality, through both evaluators
# ---------------------------------------------------------------------------

DATES = [datetime.date(1969, 12, 31), datetime.date(1970, 1, 1),
         datetime.date(1968, 2, 29), datetime.date(1900, 3, 1),
         datetime.date(1995, 1, 1), datetime.date(1996, 12, 31),
         datetime.date(2000, 2, 29), datetime.date(1, 1, 1),
         datetime.date(9999, 12, 31), datetime.date(1600, 12, 31)]


def _both_blocks(cols):
    from tiflash_tpu.core.block import Block

    from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
    from tiflash_tpu_torch.testing.bridge import export_blocks

    jb = Block.from_dict(cols)
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


def _eval_both(jb, tb, make_expr):
    from tiflash_tpu.expr import nodes as JN
    from tiflash_tpu.expr.compile import ExprEvaluator as JE

    from tiflash_tpu_torch.expr import nodes as TN
    from tiflash_tpu_torch.expr.compile import ExprEvaluator as TE

    j = JE(jb).evaluate(make_expr(JN))
    t = TE(tb).evaluate(make_expr(TN))
    assert repr(t.dtype) == repr(j.dtype)
    assert t.to_pylist() == j.to_pylist()
    return t.to_pylist()


def test_year_matches_reference():
    from tiflash_tpu.core.block import column_from_numpy
    from tiflash_tpu.core.dtypes import DATE, DATETIME

    days = np.array([(d - datetime.date(1970, 1, 1)).days for d in DATES], np.int32)
    valid = np.ones(len(DATES), bool)
    valid[3] = False
    us = days.astype(np.int64) * 86_400_000_000 - 1  # one microsecond earlier
    jb, tb = _both_blocks({
        "d": column_from_numpy(days, DATE.with_nullable(True), validity=valid),
        "t": column_from_numpy(us, DATETIME)})
    got = _eval_both(jb, tb, lambda N: N.call("year", N.col("d")))
    assert got == [d.year if ok else None for d, ok in zip(DATES, valid)]
    # a DATETIME one microsecond before midnight: the day before's year
    got_t = _eval_both(jb, tb, lambda N: N.call("year", N.col("t")))
    assert got_t == [0 if d == datetime.date(1, 1, 1)
                     else (d - datetime.timedelta(days=1)).year for d in DATES]


@pytest.mark.parametrize("op", ["equals", "not_equals", "less", "greater_or_equals"])
@pytest.mark.parametrize("literal", ["ATLANTIS", "FRANCE", "AAA", "ZZZ"])
def test_string_literal_compare_matches_reference(op, literal):
    """A literal inside or outside the column's dictionary, on either side."""
    from tiflash_tpu.core.block import column_from_numpy
    from tiflash_tpu.core.dtypes import STRING

    rng = np.random.default_rng(7)
    names = ["ALGERIA", "FRANCE", "GERMANY", "PERU"]
    valid = rng.random(40) > 0.2
    jb, tb = _both_blocks({"s": column_from_numpy(rng.choice(names, 40).tolist(),
                                                  STRING.with_nullable(True),
                                                  validity=valid)})
    got = _eval_both(jb, tb, lambda N: N.call(op, N.col("s"), N.lit(literal)))
    if literal == "ATLANTIS" and op == "equals":
        assert not any(got)
    _eval_both(jb, tb, lambda N: N.call(op, N.lit(literal), N.col("s")))
