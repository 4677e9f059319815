"""The out-of-core grace join and sliced sort through ``QueryRunner``:
the PyTorch port against the JAX package at the same ``Settings``.

Mirrors ``tests/test_outofcore_join.py`` (a Q3-shaped grace join, the
replicated and co-partitioned grace joins per kind, the null-aware
refusal, external sort and top-N, the adaptive repartition).  Each case
asserts the reference's out-of-core mode in ``plan_text``, the
reference's chunk or partition count, the reference's rows, and the
port's in-memory rows (``torch_runtime_parity.assert_same_out_of_core``);
the join kinds also against the python oracle.
"""

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as jdt
from tiflash_tpu.bench import tpch_queries as JQ
from tiflash_tpu.ops.aggregate import AggDesc as JAgg
from tiflash_tpu.ops.sort import SortKey as JSortKey
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.runtime.settings import Settings as JSettings
from tiflash_tpu.storage.tpch import generate_tpch
from tiflash_tpu.testing import oracle as O

from torch_runtime_parity import assert_same_out_of_core, rows, run_both, to_port
from tiflash_tpu_torch.bench import tpch_queries as TQ
from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg
from tiflash_tpu_torch.ops.sort import SortKey as TSortKey
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime import outofcore as TOC


@pytest.fixture(scope="module")
def cat():
    j_tables = generate_tpch(sf=0.005, seed=11,
                             tables=["lineitem", "orders", "customer"]).blocks()
    return j_tables, to_port(j_tables)


def test_q3_shaped_grace_join(cat):
    """Q3 over tables exceeding max_bytes_per_device: the grace join,
    equal to the in-memory run."""
    j_tables, t_tables = cat
    assert_same_out_of_core(JQ.q3_plan, TQ.q3_plan, j_tables,
                            JSettings(max_bytes_per_device=1 << 19), "grace",
                            t_tables)


def _join_tables(seed=3, nl=3000, nr=800):
    rng = np.random.default_rng(seed)
    ls = {"lk": jdt.INT32.with_nullable(True), "lv": jdt.INT64}
    rs = {"rk": jdt.INT32.with_nullable(True), "rv": jdt.INT64}
    lt = O.random_pytable(rng, nl, ls, int_range=(0, 200))
    rt = O.random_pytable(rng, nr, rs, int_range=(0, 200))
    return lt, rt, {"l": O.pytable_to_block(lt, ls), "r": O.pytable_to_block(rt, rs)}


def _join(NP, kind, cap):
    return lambda: NP.Join(kind=kind, probe_keys=["lk"], build_keys=["rk"],
                           probe=NP.TableScan("l"), build=NP.TableScan("r"),
                           output_capacity=cap)


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_grace_join_replicated_build_oracle(kind):
    """Big probe, small replicated build, per join kind."""
    lt, rt, j_tables = _join_tables()
    s = JSettings(max_bytes_per_device=1 << 17)
    _, _, _, out, ts = run_both(_join(JP, kind, 8192)(), _join(TP, kind, 8192)(),
                                j_tables, s)
    assert ts.out_of_core["replicated_build"] is True
    assert_same_out_of_core(_join(JP, kind, 8192), _join(TP, kind, 8192), j_tables, s,
                            "grace")
    O.assert_tables_equal(out.to_pylists(), O.o_join(lt, rt, ["lk"], ["rk"], kind=kind))


@pytest.mark.parametrize("kind", ["inner", "right_outer"])
def test_grace_join_copartitioned_oracle(kind):
    """Both sides partitioned (the build exceeds the budget too), a
    build-tail kind included."""
    lt, rt, j_tables = _join_tables(seed=4, nl=2500, nr=2500)
    s = JSettings(max_bytes_per_device=1 << 15)
    _, _, _, out, ts = run_both(_join(JP, kind, 16384)(), _join(TP, kind, 16384)(),
                                j_tables, s)
    assert ts.out_of_core["replicated_build"] is False
    assert_same_out_of_core(_join(JP, kind, 16384), _join(TP, kind, 16384), j_tables, s,
                            "grace")
    O.assert_tables_equal(out.to_pylists(), O.o_join(lt, rt, ["lk"], ["rk"], kind=kind))


def test_grace_spec_rejects_null_aware():
    from tiflash_tpu.runtime.outofcore import grace_spec as j_spec

    def plan(NP):
        return NP.Join(kind="anti_null_aware", probe_keys=["lk"], build_keys=["rk"],
                       probe=NP.TableScan("l"), build=NP.TableScan("r"))

    assert TOC.grace_spec(plan(TP)) is None and j_spec(plan(JP)) is None


def _scan(NP):
    return NP.TableScan("lineitem", columns=["l_orderkey", "l_extendedprice", "l_shipdate"])


@pytest.mark.parametrize("topn", [False, True])
def test_external_sort_and_topn(cat, topn):
    """Sort and top-N over a table exceeding the budget: sorted runs plus
    a merge pass, the reference's run count and rows."""
    j_tables, t_tables = cat

    def plan(NP, SortKey):
        keys = [SortKey("l_extendedprice", desc=True), SortKey("l_orderkey")]
        return lambda: (NP.TopN(keys, 25, _scan(NP)) if topn
                        else NP.Sort(keys, _scan(NP)))

    assert TOC.sliced_spec(plan(TP, TSortKey)()) is not None
    ts = assert_same_out_of_core(plan(JP, JSortKey), plan(TP, TSortKey), j_tables,
                                 JSettings(max_bytes_per_device=1 << 19), "sliced",
                                 t_tables)
    assert ts.out_of_core["pieces"] > 1


def test_grace_join_adaptive_repartition():
    """Keys clustered mod 256 collide at a small P: the partitioner widens
    P until the largest partition fits, as the reference's."""
    rng = np.random.default_rng(31)
    n, m = 20_000, 50
    lt = {"fk": [int(x) * 256 for x in rng.integers(0, m, n)],
          "v": [int(x) for x in rng.integers(0, 100, n)]}
    rt = {"pk": [k * 256 for k in range(m)], "w": [int(x) for x in rng.integers(0, 9, m)]}
    lsch = {"fk": jdt.INT64, "v": jdt.INT64}
    rsch = {"pk": jdt.INT64, "w": jdt.INT64}
    j_tables = {"L": O.pytable_to_block(lt, lsch), "R": O.pytable_to_block(rt, rsch)}

    def plan(NP, Agg):
        return NP.Aggregation(
            ["fk"], [Agg("sum", "w", "s"), Agg("count", None, "c")],
            NP.Join(kind="inner", probe_keys=["fk"], build_keys=["pk"],
                    probe=NP.TableScan("L"), build=NP.TableScan("R"),
                    unique_build=True))

    from tiflash_tpu.runtime import outofcore as JOC

    seen = []
    real = JOC._partition_block
    JOC._partition_block = lambda b, pid, P_, cap: seen.append(P_) or real(b, pid, P_, cap)
    try:
        want = JOC.run_grace_join(plan(JP, JAgg), j_tables, budget_bytes=200_000)
    finally:
        JOC._partition_block = real
    info = {}
    out = TOC.run_grace_join(plan(TP, TAgg), to_port(j_tables), budget_bytes=200_000,
                             info=info)
    assert info["pieces"] == seen[0] > 1
    assert rows(out) == rows(want)
    oracle = O.o_aggregate(O.o_join(lt, rt, ["fk"], ["pk"], "inner"), ["fk"],
                           [("sum", "w", "s"), ("count", None, "c")])
    O.assert_tables_equal(out.to_pylists(), oracle)
