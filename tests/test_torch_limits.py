"""Resource-limit settings of the PyTorch port's runner against the JAX
package's: the same ``EngineError`` code (``LIMIT_EXCEEDED``) where the
reference raises, the same rows where it passes.

Mirrors ``tests/test_limits.py``: ``max_rows_to_read``,
``max_rows_to_group_by``, ``max_rows_in_join``, ``max_rows_to_sort``,
``max_result_rows`` in ``throw`` and ``break`` mode,
``max_subquery_depth``, ``max_ast_depth`` and
``max_spilled_rows_per_file``.
"""

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as jdt
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.ops.aggregate import AggDesc as JAgg
from tiflash_tpu.ops.sort import SortKey as JSortKey
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.runtime.errors import EngineError as JEngineError
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.runtime.settings import Settings as JSettings
from tiflash_tpu.testing import oracle as O

from torch_runtime_parity import assert_same_out_of_core, port_settings, rows, to_port
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg
from tiflash_tpu_torch.ops.sort import SortKey as TSortKey
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime.errors import LIMIT_EXCEEDED, EngineError
from tiflash_tpu_torch.runtime.executor import run_query


@pytest.fixture(scope="module")
def blk():
    rng = np.random.default_rng(5)
    n = 1000
    j_tables = {"T": O.pytable_to_block(
        {"g": [int(x) for x in rng.integers(0, 50, n)],
         "v": [int(x) for x in rng.integers(0, 100, n)]},
        {"g": jdt.INT64, "v": jdt.INT64})}
    return j_tables, to_port(j_tables)


def AGG(NP=TP, Agg=TAgg):
    return NP.Aggregation(["g"], [Agg("sum", "v", "s")], NP.TableScan("T"))


def _both(j_plan, t_plan, blk, **settings):
    """Run both packages at the same settings: (reference error code or
    rows, port error code or rows)."""
    j_tables, t_tables = blk
    try:
        j = rows(j_run(j_plan, j_tables, settings=JSettings(**settings))[0])
    except JEngineError as e:
        j = e.code
    try:
        t = rows(run_query(t_plan, t_tables,
                           settings=port_settings(JSettings(**settings)))[0])
    except EngineError as e:
        t = e.code
    assert t == j
    return t


def test_max_rows_to_read(blk):
    assert _both(AGG(JP, JAgg), AGG(), blk, max_rows_to_read=999) == LIMIT_EXCEEDED
    assert _both(AGG(JP, JAgg), AGG(), blk, max_rows_to_read=1000)["g"]


def test_max_rows_to_group_by(blk):
    assert _both(AGG(JP, JAgg), AGG(), blk, max_rows_to_group_by=49) == LIMIT_EXCEEDED
    assert len(_both(AGG(JP, JAgg), AGG(), blk, max_rows_to_group_by=50)["g"]) == 50


def _join(NP, E, empty_build):
    build = NP.TableScan("T")
    if empty_build:
        build = NP.Selection(E.col("v") < 0, build)
    return NP.Join(kind="inner", probe_keys=["g"], build_keys=["g"],
                   probe=NP.TableScan("T"), build=build,
                   output_capacity=1 << (12 if empty_build else 16))


def test_max_rows_in_join(blk):
    # no build row survives: the join emits 0 live rows, limit 10 passes
    got = _both(_join(JP, JE, True), _join(TP, TE, True), blk, max_rows_in_join=10)
    assert not any(got.values())
    assert _both(_join(JP, JE, False), _join(TP, TE, False), blk,
                 max_rows_in_join=10) == LIMIT_EXCEEDED


def test_max_rows_to_sort_and_result(blk):
    def plan(NP, SortKey):
        return NP.Sort([SortKey("v")], NP.TableScan("T"))

    assert _both(plan(JP, JSortKey), plan(TP, TSortKey), blk,
                 max_rows_to_sort=999) == LIMIT_EXCEEDED
    assert _both(plan(JP, JSortKey), plan(TP, TSortKey), blk,
                 max_result_rows=999) == LIMIT_EXCEEDED
    # break mode truncates instead: the first 7 live rows
    j_tables, t_tables = blk
    s = JSettings(max_result_rows=7, result_overflow_mode="break")
    want, js = j_run(plan(JP, JSortKey), j_tables, settings=s)
    out, summary = run_query(plan(TP, TSortKey), t_tables, settings=port_settings(s))
    assert summary.result_rows == js.result_rows == 7
    got = out.to_pylists()["v"]
    assert got == want.to_pylists()["v"] and len(got) == 7 and got == sorted(got)


def test_max_subquery_depth(blk):
    assert _both(AGG(JP, JAgg), AGG(), blk, max_subquery_depth=1) == LIMIT_EXCEEDED
    assert _both(AGG(JP, JAgg), AGG(), blk, max_subquery_depth=16)["g"]


def test_max_ast_depth(blk):
    def plan(NP, E):
        deep = E.col("v")
        for _ in range(20):
            deep = deep + 1
        return NP.Projection({"x": deep}, NP.TableScan("T"))

    assert _both(plan(JP, JE), plan(TP, TE), blk, max_ast_depth=5) == LIMIT_EXCEEDED
    assert len(_both(plan(JP, JE), plan(TP, TE), blk, max_ast_depth=64)["x"]) == 1000


def test_max_spilled_rows_per_file(blk, tmp_path):
    """The row cap on out-of-core chunks, on top of the byte budget: ten
    chunks of 100 rows in both packages, the in-memory rows."""
    j_tables, t_tables = blk
    ts = assert_same_out_of_core(
        lambda: AGG(JP, JAgg), AGG, j_tables,
        JSettings(max_bytes_before_external_group_by=1, max_spilled_rows_per_file=100,
                  spill_dir=str(tmp_path)), "chunked", t_tables)
    assert ts.out_of_core["pieces"] == 10 and ts.out_of_core["chunk_rows"] == 100
