"""The port's plan-level oracle (``tiflash_tpu_torch/testing/plan_oracle.py``)
and the jax-free draw of the fuzzers' trees (``tests/torch_plan_draw.py``)
against the reference.

For every seed of the reference fuzzer (``tests/test_fuzz_plans.py``: 60
plan, 16 window and 10 grouping-set seeds):

- the port's ``execute_plan_oracle`` on ``to_port`` of the reference's
  tree gives the reference's ``execute_plan_oracle`` result, row for row
  in order (``_py_eq``, same types);
- the draw helper gives ``to_port`` of the reference's tree (the same
  node and expression classes, every field equal) and the reference's
  tables, value for value;
- the port's CPU ``run_query`` of the tree is judged by the port's oracle
  as the reference's fuzzer judges (``judge``: ``_norm``, a LIMIT by row
  count), with no retry (every overflow flag 0).

The port fuzzer's 40 seeds (``tests/test_torch_fuzz_plans.py``) take the
first and last checks too; the oracle reads their ``mod`` as ``modulo``
(``oracle_plan``), in both packages.  Last, the two kernels' families of
``chip_smoke.py``'s ``oracle_phase`` at a small size on the CPU.
"""

import dataclasses
import enum

import numpy as np
import pytest

import test_fuzz_plans as RF
import torch_plan_draw as DRAW
from test_torch_fuzz_analytic import to_port
from test_torch_fuzz_plans import JNS
from test_torch_oracle import same_table
from tiflash_tpu.testing import oracle as RO
from tiflash_tpu.testing.plan_oracle import execute_plan_oracle as ref_oracle

from tiflash_tpu_torch.runtime.executor import run_query
from tiflash_tpu_torch.testing import oracle as PO
from tiflash_tpu_torch.testing.plan_oracle import execute_plan_oracle as port_oracle


def reference_draw(gen: str, seed: int):
    """(tree, tables) exactly as the reference fuzzer's test draws them."""
    if gen == "reference_plan":
        rng = np.random.default_rng(1000 + seed)
        tables = RF._tables(rng)
        return RF._build_plan(rng)[0], tables
    if gen == "reference_window":
        rng = np.random.default_rng(5000 + seed)
        tables = RF._tables(rng)
        node = RF.P.TableScan("t")
        if rng.random() < 0.5:
            node = RF.P.Selection(RF._rand_pred(rng), node)
        return RF._rand_window(rng, node), tables
    rng = np.random.default_rng(7000 + seed)
    tables = RF._tables(rng)
    node = RF.P.TableScan("t")
    if rng.random() < 0.6:
        node = RF.P.Selection(RF._rand_pred(rng), node)
    sets = [["s", "b"], ["s"], []]
    if rng.random() < 0.5:
        sets = [["b"], []]
    node = RF.P.Expand(sets, node)
    keys = sorted({k for s in sets for k in s}) + ["groupingID"]
    return RF.P.Aggregation(keys=keys, aggs=[
        RF.AggDesc("sum", RF.VAL_COL, "sv"), RF.AggDesc("count", None, "c")],
        child=node), tables


REF_CASES = [(g, s) for g in ("reference_plan", "reference_window",
                              "reference_grouping_sets")
             for s in DRAW.GENERATORS[g][1]]


def dump(x):
    """A tree as nested tuples of class names and init fields (expression
    nodes compare by identity, so ``==`` cannot hold two trees equal)."""
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(dump(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, dump(v)) for k, v in x.items())
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, dump(getattr(x, f.name))) for f in dataclasses.fields(x) if f.init)
    return (type(x).__name__, x)


@pytest.mark.parametrize("gen,seed", REF_CASES)
def test_plan_oracle_matches_reference(gen, seed):
    plan, tables = reference_draw(gen, seed)
    want = ref_oracle(plan, tables)
    same_table(port_oracle(to_port(plan), tables), want)


@pytest.mark.parametrize("gen,seed", REF_CASES)
def test_draw_is_the_reference_tree(gen, seed):
    plan, tables = reference_draw(gen, seed)
    d = DRAW.GENERATORS[gen][0](seed)
    assert dump(d.plan) == dump(to_port(plan))
    assert d.plan.pretty() == plan.pretty()
    assert d.tables == tables
    for name, t in d.tables.items():
        same_table(t, tables[name])


def _judge_cpu_run(d):
    blocks = {n: PO.pytable_to_block(t, d.schemas[n], "cpu") for n, t in d.tables.items()}
    out, summary = run_query(d.plan, blocks)
    assert summary.retries == 0, summary.overflow_nodes
    return DRAW.judge(PO.block_to_pytable(out), DRAW.oracle_rows(d), d.shape, d.plan.pretty())


@pytest.mark.parametrize("gen,seed", REF_CASES)
def test_cpu_run_judged_by_port_oracle(gen, seed):
    d = DRAW.GENERATORS[gen][0](seed)
    assert _judge_cpu_run(d) == ("count" if d.shape == "limit" else "norm")


@pytest.mark.parametrize("seed", DRAW.PORT_SEEDS)
def test_port_fuzzer_oracle_matches_reference(seed):
    j_plan, _ = DRAW.build_plan(seed, JNS)
    d = DRAW.port_plan(seed)
    tables = DRAW.port_tables(seed, RO.random_pytable, RF.dt)
    assert d.tables == tables
    same_table(DRAW.oracle_rows(d), ref_oracle(DRAW.oracle_plan(j_plan), tables))


@pytest.mark.parametrize("seed", DRAW.PORT_SEEDS)
def test_port_fuzzer_cpu_run_judged(seed):
    d = DRAW.port_plan(seed)
    assert _judge_cpu_run(d) in ("count", "norm")


def test_every_generator_and_shape_is_drawn():
    shapes = {}
    for gen, _, d in DRAW.all_draws():
        shapes.setdefault(gen, set()).add(d.shape)
    assert sum(len(s) for s in (DRAW.GENERATORS[g][1] for g in DRAW.GENERATORS)) == 126
    assert shapes["reference_plan"] == {"agg", "topn", "limit", "plain"}
    assert shapes["port_plan"] == {"agg", "topn", "limit", "plain"}


@pytest.mark.parametrize("seed", DRAW.FAMILY_SEEDS)
@pytest.mark.parametrize("family", sorted(DRAW.FAMILIES))
def test_chip_smoke_family_cpu_side(family, seed):
    """``oracle_phase``'s families at 4,000 rows on the CPU: the fused
    kernel (family A) and the direct_agg kernel (family B) are each
    predicted to launch, once, and the CPU run is judged by the oracle."""
    import torch

    import chip_smoke

    threads = torch.get_num_threads()
    try:
        side = chip_smoke.family_cpu_side(family, seed, 4000)
    finally:
        torch.set_num_threads(threads)   # the worker's setting stays in the worker
    kernel = DRAW.FAMILY_KERNEL[family]
    assert side["predicted"] == {**dict.fromkeys(chip_smoke.KERNEL_NAMES, 0), kernel: 1}
    assert side["retries"] == 0
    assert len(side["sources"]) == (family == "a_stream_tile")
    assert DRAW.judge(side["cpu"], side["oracle"], "agg", family) == "norm"
