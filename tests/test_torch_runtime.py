"""The runner of the runtime slice: the PyTorch port's ``QueryRunner``
against the JAX package's on the same seeded tables.

Mirrors ``tests/test_runtime.py`` (capacity retries, failpoints,
metrics, summaries, EXPLAIN ANALYZE, chunk sizing, the memory scope),
without its two mesh cases: the port's runner raises on a mesh until the
distribution slice.  Adds ``Catalog.append`` (the reference's
``tests/test_catalog.py`` append case), ``classify``, and the runner's
CPU profile.
"""

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as jdt
from tiflash_tpu.expr.nodes import col as jcol
from tiflash_tpu.ops.aggregate import AggDesc as JAgg
from tiflash_tpu.ops.sort import SortKey as JSortKey
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.runtime.executor import QueryRunner as JRunner
from tiflash_tpu.runtime.memory import plan_chunk_rows as j_chunk_rows
from tiflash_tpu.runtime.settings import Settings as JSettings
from tiflash_tpu.testing import oracle as O

from torch_runtime_parity import port_settings, rows, to_port
import tiflash_tpu_torch.runtime.errors as TE
from tiflash_tpu_torch.expr.nodes import col as tcol
from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg
from tiflash_tpu_torch.ops.sort import SortKey as TSortKey
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime.executor import QueryRunner as TRunner, run_query
from tiflash_tpu_torch.runtime.failpoint import FailPoint, FailPointError, fail_point
from tiflash_tpu_torch.runtime.memory import plan_chunk_rows
from tiflash_tpu_torch.runtime.metrics import METRICS
from tiflash_tpu_torch.runtime.settings import Settings


@pytest.fixture(autouse=True)
def clean_failpoints():
    yield
    FailPoint.disable_all()


def make_join_setup(nl=400, nr=100, hot=False, seed=0):
    rng = np.random.default_rng(seed)
    ls = {"lk": jdt.INT32, "lv": jdt.INT64}
    rs = {"rk": jdt.INT32, "rv": jdt.INT64}
    lt = O.random_pytable(rng, nl, ls, null_prob=0, int_range=(0, 30))
    rt = O.random_pytable(rng, nr, rs, null_prob=0, int_range=(0, 30))
    if hot:  # every build row matches every probe row: a big expansion
        lt["lk"] = [5] * nl
        rt["rk"] = [5] * nr
    j_tables = {"l": O.pytable_to_block(lt, ls), "r": O.pytable_to_block(rt, rs)}
    return lt, rt, j_tables, to_port(j_tables)


def _join(NP, cap):
    return NP.Join(kind="inner", probe_keys=["lk"], build_keys=["rk"],
                   probe=NP.TableScan("l"), build=NP.TableScan("r"),
                   output_capacity=cap)


def test_retry_grows_join_capacity():
    lt, rt, j_tables, t_tables = make_join_setup(nl=64, nr=32, hot=True)
    want, js = JRunner(_join(JP, 64)).run(j_tables)
    out, summary = run_query(_join(TP, 64), t_tables)
    assert summary.retries == js.retries >= 1
    assert summary.overflow_nodes == js.overflow_nodes
    assert rows(out) == rows(want)
    O.assert_tables_equal(out.to_pylists(), O.o_join(lt, rt, ["lk"], ["rk"], kind="inner"))


def test_retry_exhaustion_raises():
    *_, t_tables = make_join_setup(nl=64, nr=32, hot=True)
    with pytest.raises(RuntimeError, match="overflow persisted") as ei:
        run_query(_join(TP, 1), t_tables, settings=Settings(max_capacity_retries=0))
    assert TE.classify(ei.value) == TE.CAPACITY_OVERFLOW


def test_mesh_raises_until_the_distribution_slice():
    *_, t_tables = make_join_setup()
    with pytest.raises(NotImplementedError, match="distribution slice"):
        run_query(TP.TableScan("l"), t_tables, mesh=object())


def test_failpoint_triggers():
    FailPoint.enable("exception_before_fragment_run")
    *_, t_tables = make_join_setup()
    with pytest.raises(FailPointError) as ei:
        run_query(TP.TableScan("l"), t_tables)
    assert TE.classify(ei.value) == TE.FAILPOINT
    assert TE.error_payload(ei.value)["code_name"] == "FAILPOINT"


def test_failpoint_probabilistic():
    FailPoint.enable("random_fragment_failure", probability=1.0)
    with pytest.raises(FailPointError):
        fail_point("random_fragment_failure")
    FailPoint.enable("random_fragment_failure", probability=0.0)
    fail_point("random_fragment_failure")  # never fires


@pytest.mark.parametrize("name", ["exception_after_fragment_run",
                                  "exception_during_retry"])
def test_failpoints_after_run_and_in_retry(name):
    """The reference's other two runner failpoints: after a run, and in
    the retry loop (a run that overflows)."""
    *_, t_tables = make_join_setup(nl=64, nr=32, hot=True)
    FailPoint.enable(name)
    with pytest.raises(FailPointError):
        run_query(_join(TP, 64), t_tables)
    assert FailPoint.get(name).hits == 1


def test_summary_and_metrics():
    before = METRICS.dump()["queries_total"]
    lt, _, j_tables, t_tables = make_join_setup()
    want, js = JRunner(JP.Selection(jcol("lv") > 0, JP.TableScan("l"))).run(j_tables)
    out, summary = run_query(TP.Selection(tcol("lv") > 0, TP.TableScan("l")), t_tables)
    assert summary.result_rows == js.result_rows == sum(1 for v in lt["lv"] if v > 0)
    assert summary.wall_seconds > 0
    assert summary.plan_text == js.plan_text and "Selection" in summary.plan_text
    assert summary.backend == "cpu" and summary.device == "cpu"
    assert summary.compile_seconds == 0.0
    assert METRICS.dump()["queries_total"] == before + 1
    assert summary.to_json() and "rows=" in summary.pretty()
    assert rows(out) == rows(want)


def test_summary_node_rows_explain_analyze():
    """Per-node live-row counts in the summary, the reference's keys."""
    _, _, j_tables, t_tables = make_join_setup(nl=100, nr=40)
    _, js = JRunner(JP.Selection(jcol("lv") > 0, JP.TableScan("l"))).run(j_tables)
    _, summary = run_query(TP.Selection(tcol("lv") > 0, TP.TableScan("l")), t_tables)
    assert summary.node_rows == js.node_rows
    assert summary.node_rows["TableScan_2"] == 100
    assert summary.node_rows["Selection_1"] == summary.result_rows


def _analyze_setup():
    rng = np.random.default_rng(3)
    n = 4096
    table = {"k": rng.integers(0, 9, n).tolist(), "v": rng.integers(0, 100, n).tolist()}
    j_tables = {"t": O.pytable_to_block(table, {"k": jdt.INT32, "v": jdt.INT64})}

    def plan(NP, Agg, SortKey, col):
        return NP.TopN(
            [SortKey("s", desc=True)], 3,
            NP.Aggregation(keys=["k"], aggs=[Agg("sum", "v", "s")],
                           child=NP.Selection(col("v") > 10, NP.TableScan("t"))))

    return plan(JP, JAgg, JSortKey, jcol), plan(TP, TAgg, TSortKey, tcol), j_tables


def test_explain_analyze_per_operator_times():
    """Per-node subtree/self timings by subtree differencing, in the
    reference's report shape."""
    from tiflash_tpu.runtime.analyze import explain_analyze as j_analyze
    from tiflash_tpu_torch.runtime.analyze import explain_analyze, format_analyze

    j_plan, t_plan, j_tables = _analyze_setup()
    report = explain_analyze(t_plan, to_port(j_tables), k1=1, k2=3)
    want = j_analyze(j_plan, j_tables, k1=1, k2=2)
    assert [(r["path"], r["operator"]) for r in report] == \
        [(r["path"], r["operator"]) for r in want]
    assert [r["operator"] for r in report] == ["TopN", "Aggregation", "Selection",
                                               "TableScan"]
    for r in report:
        assert r["subtree_s"] is not None and r["subtree_s"] >= 0
        assert r["self_s"] is not None and r["self_s"] >= 0
    # self times telescope to at least the root's subtree time (clamping
    # at 0 can only push the sum up)
    assert sum(r["self_s"] for r in report) >= report[0]["subtree_s"] - 1e-6
    text = format_analyze(report)
    assert "Aggregation" in text and "ms" in text


def test_plan_chunk_rows_uses_real_row_width():
    """Chunk sizing reads the scanned columns' real widths, the
    reference's numbers."""
    rng = np.random.default_rng(0)
    narrow_schema = {"a": jdt.INT64}
    wide_schema = {c: jdt.INT64 for c in "abcdefgh"}
    j_narrow = {"t": O.pytable_to_block(O.random_pytable(rng, 256, narrow_schema),
                                        narrow_schema)}
    j_wide = {"t": O.pytable_to_block(O.random_pytable(rng, 256, wide_schema),
                                      wide_schema)}
    budget = 1 << 26
    got = [plan_chunk_rows(TP.TableScan("t"), to_port(j_narrow), budget),
           plan_chunk_rows(TP.TableScan("t"), to_port(j_wide), budget),
           plan_chunk_rows(TP.TableScan("t", columns=["a"]), to_port(j_wide), budget)]
    want = [j_chunk_rows(JP.TableScan("t"), j_narrow, budget),
            j_chunk_rows(JP.TableScan("t"), j_wide, budget),
            j_chunk_rows(JP.TableScan("t", columns=["a"]), j_wide, budget)]
    assert got == want
    assert got[1] < got[0] == budget // (8 * 8) == got[2]


def test_block_bytes_is_the_reference_rule():
    """The port's block bytes follow the reference's rule (data, validity,
    sel; no narrow32 shadow), on every column kind of a TPC-H table."""
    from tiflash_tpu.runtime.memory import block_bytes as j_bytes
    from tiflash_tpu.storage.tpch import generate_tpch
    from tiflash_tpu_torch.runtime.memory import block_bytes

    j_tables = generate_tpch(sf=0.001, seed=1, tables=["lineitem", "orders"]).blocks()
    t_tables = to_port(j_tables)
    for name in j_tables:
        assert block_bytes(t_tables[name]) == j_bytes(j_tables[name])
        assert block_bytes(t_tables[name], shadows=True) > block_bytes(t_tables[name])


def test_query_memory_scope_and_summary_fields():
    """The memory scope reads the CUDA allocator; on the CPU it reports
    zeros, and the summary carries both fields."""
    from tiflash_tpu_torch.runtime.memory import QueryMemoryScope, device_memory_stats

    assert device_memory_stats("cpu") == {}
    with QueryMemoryScope("cpu") as mem:
        pass
    assert mem.peak_bytes == 0 and mem.delta_bytes == 0
    schema = {"k": jdt.INT32, "v": jdt.INT64}
    rng = np.random.default_rng(5)
    table = O.random_pytable(rng, 64, schema, null_prob=0.0, int_range=(0, 4))
    plan = TP.Aggregation(["k"], [TAgg("sum", "v", "sv")], TP.TableScan("t"))
    _, summary = TRunner(plan).run(to_port({"t": O.pytable_to_block(table, schema)}))
    assert summary.peak_device_bytes == 0 and summary.device_bytes_delta == 0


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    *_, t_tables = make_join_setup()
    s = Settings(profile_dir=str(tmp_path / "prof"))
    run_query(TP.Selection(tcol("lv") > 0, TP.TableScan("l")), t_tables, settings=s)
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_plan_rewrites_follow_settings():
    """``plan_rewrites=None`` takes ``settings.enable_plan_rewrites``; an
    explicit value wins, and both packages print the same tree."""
    from tiflash_tpu.bench.tpch_queries import q3_plan as j_q3
    from tiflash_tpu.storage.tpch import generate_tpch
    from tiflash_tpu_torch.bench.tpch_queries import q3_plan as t_q3

    j_tables = generate_tpch(sf=0.001, seed=2,
                             tables=["lineitem", "orders", "customer"]).blocks()
    t_tables = to_port(j_tables)
    cases = ((JSettings(enable_plan_rewrites=False), {}, False),
             (JSettings(), {"plan_rewrites": False}, False),
             (JSettings(enable_plan_rewrites=False), {"plan_rewrites": True}, True),
             (JSettings(), {}, True))
    for js_, kw, rewrites in cases:
        _, j_sum = JRunner(j_q3(rewrite=False),
                           settings=JSettings(enable_plan_rewrites=rewrites)).run(j_tables)
        _, t_sum = run_query(t_q3(rewrite=False), t_tables, settings=port_settings(js_),
                             **kw)
        assert t_sum.plan_text == j_sum.plan_text


def test_catalog_append_merges_dictionaries():
    """``Catalog.append``: rows concatenate, string dictionaries merge in
    sorted order, as the reference's."""
    import tiflash_tpu_torch.core.dtypes as tdt
    from tiflash_tpu.storage.catalog import Catalog as JCat, column_from_arrays as jcfa
    from tiflash_tpu.storage.catalog import encode_strings as jenc
    from tiflash_tpu_torch.storage.catalog import Catalog as TCat
    from tiflash_tpu_torch.storage.catalog import column_from_arrays as tcfa
    from tiflash_tpu_torch.storage.catalog import encode_strings as tenc

    first = (np.array(["b", "d", "b"]), np.array([1, 2, 3]))
    second = (np.array(["a", "d", "e"]), np.array([4, 5, 6]))
    cats = []
    for Cat, cfa, enc, dt in ((JCat, jcfa, jenc, jdt), (TCat, tcfa, tenc, tdt)):
        cat = Cat()
        for i, (s, v) in enumerate((first, second)):
            codes, d = enc(s)
            cols = {"s": cfa(codes, dt.STRING, dictionary=d), "v": cfa(v, dt.INT64)}
            if i == 0:
                cat.register("t", cols)
            else:
                cat.append("t", cols)
        cats.append(cat)
    j_cat, t_cat = cats
    got = t_cat.blocks("cpu")["t"]
    assert got.to_pylists() == j_cat.blocks()["t"].to_pylists()
    assert got["s"].dictionary == ("a", "b", "d", "e")
    assert t_cat["t"].row_count == 6
