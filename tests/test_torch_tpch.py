"""TPC-H Q1 and Q6 end to end: the PyTorch port's ``run_query`` against
the JAX package's, with the fused stream-agg path on and off.

Both packages generate the same lineitem table from the same seed; the
results must be equal row for row, in order, with the same column types
(tolerance zero: all outputs are integers and decimals).  The
independent numpy Q1/Q6 of ``chip_smoke.py`` is held against the port
too.
"""

import pytest

from tiflash_tpu.bench import tpch_queries as JQ
from tiflash_tpu.ops import stream_fuse as JSF
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.storage.tpch import generate_tpch as j_generate

import chip_smoke
from tiflash_tpu_torch.bench import tpch_queries as TQ
from tiflash_tpu_torch.ops import stream_fuse as TSF
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate

SF, SEED = 0.002, 0


@pytest.fixture(scope="module")
def tables():
    return (j_generate(sf=SF, seed=SEED, tables=["lineitem"]).blocks(),
            t_generate(sf=SF, seed=SEED, tables=["lineitem"]))


def _result(block):
    return block.to_pylists(), [repr(c.dtype) for c in block.columns]


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("query", ["q1", "q6"])
def test_run_query_matches_reference(tables, monkeypatch, query, fuse):
    monkeypatch.setenv("TIFLASH_TPU_STREAM_KERNEL", "interpret" if fuse else "0")
    j_tables, t_cat = tables
    plan_name = f"{query}_plan"
    j_before, t_before = JSF.FUSE_STATS["count"], TSF.FUSE_STATS["count"]
    j_out, _ = j_run(getattr(JQ, plan_name)(), j_tables)
    t_out, summary = t_run(getattr(TQ, plan_name)(), t_cat.blocks("cpu"),
                           fuse_stream_agg=fuse)
    assert JSF.FUSE_STATS["count"] - j_before == int(fuse)
    assert TSF.FUSE_STATS["count"] - t_before == int(fuse)
    assert _result(t_out) == _result(j_out)
    assert summary.result_rows == int(j_out.num_rows())
    assert summary.retries == 0 and summary.device == "cpu"


@pytest.mark.parametrize("query", ["q1", "q6"])
def test_numpy_check_of_chip_smoke_agrees(tables, query):
    _, t_cat = tables
    out, _ = t_run(getattr(TQ, f"{query}_plan")(), t_cat.blocks("cpu"))
    li = chip_smoke.lineitem_arrays(t_cat)
    want = chip_smoke.numpy_q1(li) if query == "q1" else chip_smoke.numpy_q6(li)
    assert out.to_pylists() == want


def test_q1_fused_layout_is_six_slots_six_planes(tables):
    _, t_cat = tables
    t_run(TQ.q1_plan(), t_cat.blocks("cpu"))
    assert (TSF.FUSE_STATS["slots"], TSF.FUSE_STATS["limbs"],
            TSF.FUSE_STATS["fields"]) == (6, 6, 8)


def test_run_query_retries_an_overflowing_aggregation(tables, monkeypatch):
    """An operator reporting an overflow gets its capacity grown to 1.25x
    what it reported, and the query runs again."""
    import torch

    from tiflash_tpu_torch.ops.aggregate import AggregateResult
    from tiflash_tpu_torch.plan import compiler

    calls = []
    real = compiler.hash_aggregate

    def overflow_once(*args):
        res = real(*args)
        calls.append(args[-1])
        if len(calls) == 1:
            return AggregateResult(res.block, res.num_groups, torch.tensor(100))
        return res

    monkeypatch.setattr(compiler, "hash_aggregate", overflow_once)
    _, t_cat = tables
    plan = TQ.q6_plan()
    out, summary = t_run(plan, t_cat.blocks("cpu"), fuse_stream_agg=False)
    assert summary.retries == 1 and summary.overflow_nodes == ["Aggregation_1"]
    assert calls == [None, 126] and plan.num_slots == 126
    want, _ = t_run(TQ.q6_plan(), t_cat.blocks("cpu"), fuse_stream_agg=False)
    assert out.to_pylists() == want.to_pylists()


def test_run_query_rejects_a_mesh(tables):
    _, t_cat = tables
    with pytest.raises(NotImplementedError):
        t_run(TQ.q6_plan(), t_cat.blocks("cpu"), mesh=object())


def test_plan_pretty_matches_reference():
    assert TQ.q1_plan().pretty() == JQ.q1_plan().pretty()
    assert TQ.q6_plan().pretty() == JQ.q6_plan().pretty()
