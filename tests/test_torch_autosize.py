"""Capacity auto-sizing: the PyTorch port's ``plan/auto.py`` against the
JAX package's.

Mirrors ``tests/test_autosize.py`` (NDV extrapolation, the filled
aggregation slots and join capacity, explicit capacities kept) and holds
the auto-sized tree equal to the reference's, node by node (kind,
``describe()``, ``num_slots``, ``output_capacity``), for every TPC-H
builder at SF 0.01 and every analytic plan of ``bench/analytics.py``,
each rewritten first as the runner does.  Also the sampled selectivity
and row estimates of the single-device part of ``tests/test_auto_plan.py``
(``AutoPlanConfig.from_settings``; ``distribute_plan`` waits for the
distribution slice).
"""

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as jdt
from tiflash_tpu.bench import tpch_queries as JQ
from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.ops.aggregate import AggDesc as JAgg
from tiflash_tpu.plan import auto as JA
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan import serde as j_serde
from tiflash_tpu.plan.rewrite import eager_aggregation as j_eager, prune_columns as j_prune
from tiflash_tpu.runtime.settings import Settings as JSettings
from tiflash_tpu.storage.tpch import generate_tpch

import chip_smoke
from test_torch_analytics import _ref_partitions
from test_torch_q7 import j_q7_nation_pairs_plan
from test_torch_tpch_spec import to_reference
from torch_runtime_parity import port_settings, rows, to_port
from tiflash_tpu_torch.bench import analytics as A
from tiflash_tpu_torch.bench import tpch_queries as TQ
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg
from tiflash_tpu_torch.plan import auto as TA
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.plan import serde as t_serde
from tiflash_tpu_torch.plan.rewrite import eager_aggregation as t_eager, prune_columns as t_prune
from tiflash_tpu_torch.runtime.executor import run_query

SF = 0.01
TPCH = {q: (getattr(JQ, f"{q}_plan"), getattr(TQ, f"{q}_plan"))
        for q in ("q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10", "q11",
                  "q12", "q13", "q14", "q15", "q16", "q17", "q18", "q19", "q20",
                  "q21", "q22")}
TPCH["q7_pairs"] = (j_q7_nation_pairs_plan, TQ.q7_nation_pairs_plan)
TPCH["topn"] = (lambda: JQ.sort_topn_plan(100), lambda: TQ.sort_topn_plan(100))


@pytest.fixture(scope="module")
def catalogs():
    j8 = generate_tpch(sf=SF, seed=0, tables=chip_smoke.EIGHT_TABLES).blocks()
    jl = generate_tpch(sf=SF, seed=0, tables=["lineitem"]).blocks()
    jl = {**jl, **_ref_partitions(jl["lineitem"])}
    return {"eight": (j8, to_port(j8)), "lineitem": (jl, to_port(jl))}


def _dfs(node):
    out = [node]
    for c in node.children:
        out.extend(_dfs(c))
    return out


def _capacities(plan):
    return [(type(n).__name__, n.describe(), getattr(n, "num_slots", None),
             getattr(n, "output_capacity", None)) for n in _dfs(plan)]


def _same_autosize(j_plan, t_plan, j_tables, t_tables):
    j_plan, t_plan = j_prune(j_eager(j_plan)), t_prune(t_eager(t_plan))
    JA.autosize_plan(j_plan, j_tables, settings=JSettings())
    TA.autosize_plan(t_plan, t_tables, settings=port_settings(JSettings()))
    assert _capacities(t_plan) == _capacities(j_plan)
    return t_plan


@pytest.mark.parametrize("query", sorted(TPCH))
def test_tpch_autosized_tree_matches_reference(catalogs, query):
    j_tables, t_tables = catalogs["eight"]
    j_fn, t_fn = TPCH[query]
    plan = _same_autosize(j_fn(), t_fn(), j_tables, t_tables)
    if any(isinstance(n, TP.Aggregation) and n.keys for n in _dfs(plan)):
        assert all(n.num_slots for n in _dfs(plan)
                   if isinstance(n, TP.Aggregation) and n.keys)


@pytest.mark.parametrize("name", sorted(A.ANALYTICS))
def test_analytics_autosized_tree_matches_reference(catalogs, name):
    fn, cat = A.ANALYTICS[name]
    j_tables, t_tables = catalogs[cat]
    plan = fn()
    j_plan = (to_reference(plan) if name == "partitioned_q1"
              else j_serde.loads(t_serde.dumps(plan)))
    _same_autosize(j_plan, fn(), j_tables, t_tables)


def test_ndv_extrapolation_clustered_and_uniform():
    n = 100_000
    rng = np.random.default_rng(3)
    j = {"t": JBlock.from_dict({
        "clus": column_from_numpy(np.arange(n) // 4, jdt.INT64),  # ndv ~25k
        "tiny": column_from_numpy(rng.integers(0, 7, n), jdt.INT64)})}
    t = to_port(j)["t"]
    for name in ("clus", "tiny"):
        got = TA._sample_ndv(t[name], n, 4096)
        assert got == JA._sample_ndv(j["t"][name], n, 4096)
    assert 20_000 <= TA._sample_ndv(t["clus"], n, 4096) <= 40_000
    assert TA._sample_ndv(t["tiny"], n, 4096) <= 64


def _fk_tables():
    rng = np.random.default_rng(5)
    n = 50_000
    j = {"L": JBlock.from_dict({
        "fk": column_from_numpy(np.sort(rng.integers(0, 2000, n)), jdt.INT64),
        "v": column_from_numpy(rng.integers(0, 100, n), jdt.INT64),
        "flt": column_from_numpy(rng.integers(0, 100, n), jdt.INT64)}),
        "R": JBlock.from_dict({
            "pk": column_from_numpy(np.arange(2000), jdt.INT64),
            "w": column_from_numpy(rng.integers(0, 9, 2000), jdt.INT64)})}
    return j, to_port(j)


def _fk_plan(NP, E, Agg):
    return NP.Aggregation(
        ["fk"], [Agg("sum", "v", "s")],
        NP.Join(kind="inner", probe_keys=["fk"], build_keys=["pk"],
                probe=NP.Selection(E.col("flt") < E.lit(10), NP.TableScan("L")),
                build=NP.TableScan("R")))


def test_autosize_fills_agg_slots_and_join_capacity():
    j_tables, t_tables = _fk_tables()
    j_plan, t_plan = _fk_plan(JP, JE, JAgg), _fk_plan(TP, TE, TAgg)
    JA.autosize_plan(j_plan, j_tables)
    TA.autosize_plan(t_plan, t_tables)
    assert _capacities(t_plan) == _capacities(j_plan)
    # ~10% selectivity x factor 2: far below the 50k default
    assert 4_096 <= t_plan.child.output_capacity <= 32_768
    # keyed on fk, NDV ~2000: slots ~4096, not 50k
    assert 2_048 <= t_plan.num_slots <= 16_384
    # the sized plan answers as the reference's runner does
    from tiflash_tpu.runtime.executor import run_query as j_run

    out, _ = run_query(t_plan, t_tables, plan_rewrites=False)
    want, _ = j_run(j_plan, j_tables, settings=JSettings(enable_plan_rewrites=False))
    assert rows(out) == rows(want)


def test_autosize_respects_explicit_capacities():
    j = {"T": JBlock.from_dict({
        "g": column_from_numpy(np.arange(100) % 5, jdt.INT64),
        "v": column_from_numpy(np.arange(100), jdt.INT64)})}
    plan = TP.Aggregation(["g"], [TAgg("sum", "v", "s")], TP.TableScan("T"),
                          num_slots=12345)
    TA.autosize_plan(plan, to_port(j))
    assert plan.num_slots == 12345  # hand-set values are kept


def test_sampled_selectivity_and_row_estimates():
    """The sampled live fraction of a selective build filter and the row
    estimates it feeds are the reference's (the single-device half of
    ``tests/test_auto_plan.py``'s broadcast decision)."""
    j_tables, t_tables = _fk_tables()
    j_sel = JP.Selection(JE.col("flt") < JE.lit(10), JP.TableScan("L"))
    t_sel = TP.Selection(TE.col("flt") < TE.lit(10), TP.TableScan("L"))
    got = TA._sampled_selectivity(t_sel.cond, t_sel.child, t_tables)
    assert got == JA._sampled_selectivity(j_sel.cond, j_sel.child, j_tables)
    assert 0.05 < got < 0.15
    stats = {"L": 1_000_000, "R": 2000}
    assert TA._estimate_rows(t_sel, stats, t_tables) == \
        JA._estimate_rows(j_sel, stats, j_tables) == int(1_000_000 * got)
    assert TA._estimate_rows(t_sel, stats) == 1_000_000  # no data: selectivity 1


def test_auto_plan_config_from_settings():
    from tiflash_tpu_torch.runtime.settings import Settings

    s = Settings(skew_hot_keys=7, skew_sample_per_device=99, join_output_factor=3.0)
    cfg = TA.AutoPlanConfig.from_settings(s)
    assert cfg.skew_hot_keys == 7 and cfg.skew_sample_per_device == 99
    assert cfg == TA.AutoPlanConfig(**vars(JA.AutoPlanConfig.from_settings(
        JSettings(skew_hot_keys=7, skew_sample_per_device=99, join_output_factor=3.0))))
