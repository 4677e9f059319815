"""Out-of-core generality through ``QueryRunner``: the PyTorch port
against the JAX package at the same ``Settings``.

Mirrors ``tests/test_outofcore_generality.py`` (the self-join grace
clone, the group-partitioned aggregation of non-decomposable aggregates,
a top-N over it), and holds ``chip_smoke.py``'s SF10 rehearsal plans at
SF 0.01 and its launch prediction, and the port's partition staging (one
stable sort of the partition ids) against the reference's rows.  Each
case asserts the reference's mode, piece count and rows, and the port's
in-memory rows (``torch_runtime_parity.assert_same_out_of_core``).
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

from torch_runtime_parity import assert_same_out_of_core, to_port
from tiflash_tpu_torch.bench import tpch_queries as TQ
from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg
from tiflash_tpu_torch.ops.sort import SortKey as TSortKey
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime import outofcore as TOC


def test_grace_self_join(tmp_path):
    """A self-join on two columns of one table graces by cloning the
    build-side scan."""
    rng = np.random.default_rng(23)
    n = 2000
    sch = {"a": jdt.INT64, "b": jdt.INT64, "v": jdt.INT64}
    t = {"a": [int(x) for x in rng.integers(0, 100, n)],
         "b": [int(x) for x in rng.integers(0, 100, n)],
         "v": [int(x) for x in rng.integers(0, 50, n)]}
    j_tables = {"T": O.pytable_to_block(t, sch)}

    def plan(NP, Agg):
        return lambda: NP.Aggregation(
            ["a"], [Agg("sum", "v", "s"), Agg("count", None, "c")],
            NP.Join(kind="inner", probe_keys=["a"], build_keys=["b"],
                    probe=NP.TableScan("T"), build=NP.TableScan("T"),
                    output_capacity=1 << 14))

    ts = assert_same_out_of_core(plan(JP, JAgg), plan(TP, TAgg), j_tables,
                                 JSettings(max_bytes_before_external_join=40_000,
                                           spill_dir=str(tmp_path)), "grace")
    assert ts.out_of_core["pieces"] == 16


def _group_tables(seed, n, groups, nullable=True):
    rng = np.random.default_rng(seed)
    sch = {"g": jdt.INT64, "v": jdt.INT64.with_nullable(nullable)}
    t = {"g": [int(x) for x in rng.integers(0, groups, n)],
         "v": [None if nullable and rng.random() < 0.05 else int(rng.integers(0, 40))
               for _ in range(n)]}
    return {"T": O.pytable_to_block(t, sch)}


@pytest.mark.parametrize("specs", [
    [("count_distinct", "v", "cd"), ("sum", "v", "s")],
    [("var_pop", "v", "vp"), ("count", None, "c")],
])
def test_groupagg_partitioned_distinct_and_var(tmp_path, specs):
    """Non-decomposable aggregates go out of core by partitioning on the
    group-key hash (each group is partition-local)."""
    def plan(NP, Agg):
        return lambda: NP.Aggregation(["g"], [Agg(*a) for a in specs], NP.TableScan("T"))

    ts = assert_same_out_of_core(plan(JP, JAgg), plan(TP, TAgg),
                                 _group_tables(31, 6_000, 97),
                                 JSettings(max_bytes_before_external_group_by=20_000,
                                           spill_dir=str(tmp_path)), "groupagg")
    assert ts.out_of_core["pieces"] > 1


def test_groupagg_with_topn_wrapper(tmp_path):
    """A top-N above the aggregation re-applies over the merged partials."""
    def plan(NP, Agg, SortKey):
        return lambda: NP.TopN(
            [SortKey("cd", desc=True), SortKey("g")], 7,
            NP.Aggregation(["g"], [Agg("count_distinct", "v", "cd")], NP.TableScan("T")))

    rng = np.random.default_rng(37)
    n = 4_000
    sch = {"g": jdt.INT64, "v": jdt.INT64}
    t = {"g": [int(x) for x in rng.integers(0, 500, n)],
         "v": [int(x) for x in rng.integers(0, 1000, n)]}
    ts = assert_same_out_of_core(plan(JP, JAgg, JSortKey), plan(TP, TAgg, TSortKey),
                                 {"T": O.pytable_to_block(t, sch)},
                                 JSettings(max_bytes_before_external_group_by=8_000,
                                           spill_dir=str(tmp_path)), "groupagg")
    assert ts.out_of_core["pieces"] > 1


def test_partitions_are_grouped_by_one_stable_sort():
    """The port's partition staging (one stable argsort of the partition
    ids) holds the rows the reference's per-partition ``nonzero`` picks,
    in the same order."""
    from tiflash_tpu.runtime import outofcore as JOC

    j_tables = _group_tables(5, 5000, 300)
    j_block, t_block = j_tables["T"], to_port(j_tables)["T"]
    h = JOC._host_key_hash(j_block, ["g"])
    assert (TOC._host_key_hash(t_block, ["g"]) == h).all()
    P_ = 8
    pid = (h % np.uint64(P_)).astype(np.int64)
    cap = 1024
    parts = TOC._HostPartitions(t_block, pid, P_, cap)
    for p, want in enumerate(JOC._partition_block(j_block, pid, P_, cap)):
        got = parts.block(p)
        assert got.capacity == want.capacity == cap
        assert got.to_pylists() == want.to_pylists()
        assert np.array_equal(got["g"].data.numpy(), np.asarray(want["g"].data))


@pytest.fixture(scope="module")
def rehearsal_cat():
    """The SF10 rehearsal's catalog shape (``chip_smoke.SF10_COLUMNS``) at
    SF 0.01."""
    import chip_smoke

    j_tables = generate_tpch(sf=0.01, seed=0, tables=chip_smoke.Q3_TABLES,
                             column_subset=chip_smoke.SF10_COLUMNS).blocks()
    return j_tables, to_port(j_tables)


def _hc_reference():
    from tiflash_tpu.expr.nodes import col

    return JP.Aggregation(
        ["l_orderkey"], [JAgg("sum", "l_extendedprice", "s"), JAgg("count", None, "c")],
        JP.Selection(col("l_shipdate") > "1995-03-15",
                     JP.TableScan("lineitem",
                                  columns=["l_orderkey", "l_extendedprice", "l_shipdate"])))


def _daily_reference():
    return JP.Aggregation(
        ["l_shipdate"], [JAgg("sum", "l_extendedprice", "revenue"), JAgg("count", None, "n")],
        JP.TableScan("lineitem", columns=["l_shipdate", "l_extendedprice"]))


@pytest.mark.parametrize("run", ["hc_external", "daily_revenue", "q1_partitioned"])
def test_rehearsal_runs_match_reference(rehearsal_cat, tmp_path, run):
    """``chip_smoke.py``'s out-of-core runs at SF 0.01, with its settings:
    the reference's mode, pieces and rows; ``q1_partitioned``'s budget
    (``partition_budget``) gives 2 or 4 partitions in both packages.  (Its
    Q3 grace run is ``test_q3_shaped_grace_join``'s path.)"""
    import chip_smoke

    j_tables, t_tables = rehearsal_cat
    spill = str(tmp_path)
    if run == "q1_partitioned":
        budget, parts, est = chip_smoke.partition_budget(TQ.q1_plan, t_tables)
        assert parts in (2, 4) and budget < est
    cases = {
        "hc_external": (_hc_reference, chip_smoke.hc_plan, "chunked",
                        JSettings(max_bytes_before_external_group_by=1, spill_dir=spill)),
        "daily_revenue": (_daily_reference, chip_smoke.daily_revenue_plan, "chunked",
                          JSettings(max_bytes_before_external_group_by=1)),
        "q1_partitioned": (JQ.q1_plan, TQ.q1_plan, "groupagg",
                           JSettings(max_bytes_per_device=budget if run == "q1_partitioned"
                                     else None)),
    }
    make_j, make_t, mode, s = cases[run]
    ts = assert_same_out_of_core(make_j, make_t, j_tables, s, mode, t_tables)
    if run == "q1_partitioned":
        assert ts.out_of_core["pieces"] == parts


def test_chip_smoke_predicts_launches_per_piece(rehearsal_cat):
    """The CPU dispatch ``chip_smoke.py`` predicts the card's launches
    from: one stream_tile launch per Q1 partition, none for the ship-date
    chunks (no static key domain: the sort method)."""
    import chip_smoke

    _, t_tables = rehearsal_cat
    pred = chip_smoke.outofcore_predictions(t_tables)
    assert pred["q1_partitioned"]["mode"] == "groupagg"
    assert pred["q1_partitioned"]["per_piece"] == (0, 1)
    assert pred["q1_partitioned"]["tail"] == (0, 0)
    assert pred["daily_revenue"]["mode"] == "chunked"
    assert pred["daily_revenue"]["per_piece"] == (0, 0)
