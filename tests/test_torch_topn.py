"""Top-N: the PyTorch port's ``top_n`` and ``TopN`` plan node against the
JAX package's, on blocks made with numpy from a seed (tolerance zero:
every output is an integer, a decimal mantissa, a string or a float
copied, never computed).

Template: the reference's ``tests/test_sort.py`` top-N cases.  The sizes
are n >= 8,192, so the reference takes its tiled paths, with limits
<= 128, <= 2,048 and above 2,048; heavy ties (broken by position), NULLs
first and last, selections, and a limit above the live count.  Also the
100M-row top-N block and its plan, at a small n.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiflash_tpu.core.block import Block, column_from_numpy
from tiflash_tpu.core.dtypes import FLOAT64, INT32, INT64, STRING, Decimal
from tiflash_tpu.ops import sort as JS
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.compiler import compile_fragment as j_compile

import chip_smoke
from tiflash_tpu_torch.bench import tpch_queries as TQ
from tiflash_tpu_torch.ops import sort as TS
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.plan.compiler import compile_fragment as t_compile
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 20_000


def _blocks(seed, n=N, sel_frac=None):
    """``a`` int64 with heavy ties, ``b`` nullable int32 with few values,
    ``c`` nullable int64, ``d`` decimal, ``f`` float64, ``s`` string,
    ``v`` = position."""
    rng = np.random.default_rng(seed)
    jb = Block.from_dict({
        "a": column_from_numpy(rng.integers(-50, 50, n), INT64),
        "b": column_from_numpy(rng.integers(-5, 5, n), INT32.with_nullable(True),
                               validity=rng.random(n) > 0.2),
        "c": column_from_numpy(rng.integers(0, 300, n), INT64.with_nullable(True),
                               validity=rng.random(n) > 0.1),
        "d": column_from_numpy(rng.integers(0, 2000, n), Decimal(15, 2)),
        "f": column_from_numpy(rng.integers(0, 40, n) / 4.0, FLOAT64),
        "s": column_from_numpy(rng.choice([f"w{i:02d}" for i in range(30)], n).tolist(),
                               STRING),
        "v": column_from_numpy(np.arange(n), INT64),
    })
    if sel_frac is not None:
        jb = jb.with_sel(jnp.asarray(rng.random(n) < sel_frac))
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


def _keys(SortKey, spec):
    return [SortKey(name, desc, nf) for name, desc, nf in spec]


def _same(jo, to):
    assert to.capacity == jo.capacity
    assert to.to_pylists() == jo.to_pylists()
    assert np.array_equal(to.sel.numpy(), np.asarray(jo.sel))


KEY_SPECS = {
    "int64_asc": [("a", False, None)],              # rank bijection, ties
    "int64_desc": [("a", True, None)],
    "int32_nulls_first": [("b", False, None)],      # packed rank, NULLs first
    "int32_desc_nulls_last": [("b", True, None)],
    "int32_desc_nulls_first": [("b", True, True)],
    "nullable_int64": [("c", True, False)],         # no rank: full sort
    "decimal_desc": [("d", True, None)],
    "multi_key": [("c", True, False), ("f", False, None), ("s", True, None)],
    "string": [("s", False, None)],
}


@pytest.mark.parametrize("limit", [97, 1500, 3000], ids=["le128", "le2048", "gt2048"])
@pytest.mark.parametrize("spec", list(KEY_SPECS), ids=list(KEY_SPECS))
@pytest.mark.parametrize("sel_frac", [None, 0.7], ids=["all_live", "sel"])
def test_top_n_matches_reference(spec, limit, sel_frac):
    jb, tb = _blocks(list(KEY_SPECS).index(spec) * 10_000 + limit, sel_frac=sel_frac)
    keys = KEY_SPECS[spec]
    jo = JS.top_n(jb, _keys(JS.SortKey, keys), limit)
    to = TS.top_n(tb, _keys(TS.SortKey, keys), limit)
    _same(jo, to)
    if not (spec.startswith("int32") and limit <= 128):
        # the first rows of the stable full sort (on the reference's
        # per-tile top-k path NULL keys tie by position instead: the
        # full sort orders them by the payload under the NULL)
        full = TS.sort_block(tb, _keys(TS.SortKey, keys)).to_pylists()
        assert to.to_pylists() == {k: v[:limit] for k, v in full.items()}


@pytest.mark.parametrize("spec", ["int64_desc", "int32_nulls_first", "multi_key"])
@pytest.mark.parametrize("limit", [100, 2500])
def test_limit_above_the_live_count(spec, limit):
    jb, tb = _blocks(44, sel_frac=0.002)  # about 40 live rows
    keys = KEY_SPECS[spec]
    jo = JS.top_n(jb, _keys(JS.SortKey, keys), limit)
    to = TS.top_n(tb, _keys(TS.SortKey, keys), limit)
    _same(jo, to)
    assert int(to.num_rows()) == int(tb.num_rows()) < limit


@pytest.mark.parametrize("limit", [0, 5, 64, 200])
def test_small_input_and_limit_past_capacity(limit):
    jb, tb = _blocks(45, n=64, sel_frac=0.5)
    for spec in ("int64_asc", "int32_desc_nulls_last", "multi_key"):
        jo = JS.top_n(jb, _keys(JS.SortKey, KEY_SPECS[spec]), limit)
        to = TS.top_n(tb, _keys(TS.SortKey, KEY_SPECS[spec]), limit)
        _same(jo, to)
        assert to.capacity == min(limit, 64)


def test_ties_break_by_position():
    """Every key equal: the top rows are the first live positions."""
    n = 9000
    tb = blocks_from_numpy(export_blocks({"t": Block.from_dict({
        "k": column_from_numpy(np.full(n, 7), INT64),
        "v": column_from_numpy(np.arange(n), INT64)})}), "cpu")["t"]
    for desc in (False, True):
        got = TS.top_n(tb, [TS.SortKey("k", desc)], 50).to_pylists()
        assert got["v"] == list(range(50))
    live = torch.arange(n) % 3 == 1
    got = TS.top_n(tb.with_sel(live), [TS.SortKey("k", True)], 50).to_pylists()
    assert got["v"] == list(range(1, 150, 3))


def test_top_n_node_matches_reference():
    jb, tb = _blocks(46, sel_frac=0.8)

    def plan(P, SortKey):
        return P.TopN([SortKey("c", True, False), SortKey("v")], 25, P.TableScan("t"))

    jo, jf = j_compile(plan(JP, JS.SortKey))({"t": jb})
    to, tf = t_compile(plan(TP, TS.SortKey))({"t": tb})
    _same(jo, to)
    assert tf == jf == {}
    assert plan(TP, TS.SortKey).pretty() == plan(JP, JS.SortKey).pretty()


def test_topn_100m_block_and_plan_at_a_small_size():
    """``topn_100m_block`` at n = 20,000: non-negative keys, ``v`` the
    position; the plan is the reference's (``bench.py``'s topn100m) and
    gives the reference's rows and chip_smoke.py's numpy rows."""
    n = 20_000
    tb = TQ.topn_100m_block(n, device="cpu")
    k = tb["k"].data.numpy()
    assert k.dtype == np.int64 and k.min() >= 0 and len(np.unique(k)) == n
    assert np.array_equal(tb["v"].data.numpy(), np.arange(n))
    assert tb["v"].stats == (0, n - 1)
    jplan = JP.TopN([JS.SortKey("k", desc=True, nulls_first=False)], 100,
                    JP.TableScan("big", columns=["k", "v"]))
    assert TQ.topn_100m_plan().pretty() == jplan.pretty()
    jb = Block.from_dict({"k": column_from_numpy(k, INT64),
                          "v": column_from_numpy(np.arange(n), INT64)})
    jo, _ = j_compile(jplan)({"big": jb})
    to, summary = t_run(TQ.topn_100m_plan(), {"big": tb})
    assert to.to_pylists() == jo.to_pylists()
    assert to.to_pylists() == chip_smoke.numpy_topn(k, {"k": k, "v": np.arange(n)}, 100)
    assert summary.result_rows == 100
    # the same seed draws the same keys
    assert torch.equal(TQ.topn_100m_block(n, device="cpu")["k"].data, tb["k"].data)
