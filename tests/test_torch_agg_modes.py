"""``Aggregation.mode``: the PyTorch port against the JAX package.

The reference runs every mode: ``"partial"`` and ``"final"`` are tags
that take the method dispatch (``hash_aggregate``), and ``"auto"`` takes
``auto_passthrough_aggregate``, which aggregates or passes rows through
in partial shape by a sampled key-hash NDV.  The port raised
``NotImplementedError`` for any mode until the runtime slice, whose
chunked out-of-core aggregate builds ``partial``/``final`` plans.  Each
case runs one plan through both packages' ``compile_fragment`` on the
same seeded table and compares the live rows.

Template: ``tests/test_distributed.py`` (the partial/final split) and
``tests/test_aggregate.py`` (auto passthrough).
"""

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as jdt
from tiflash_tpu.ops.aggregate import AggDesc as JAgg
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.compiler import compile_fragment as j_compile
from tiflash_tpu.testing import oracle as O

from torch_runtime_parity import rows, to_port
from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.plan.compiler import compile_fragment as t_compile

N = 3000


def _tables(seed: int, key_range: int):
    rng = np.random.default_rng(seed)
    sch = {"g": jdt.INT64, "h": jdt.INT32.with_nullable(True),
           "v": jdt.INT64.with_nullable(True), "d": jdt.Decimal(15, 2),
           "f": jdt.FLOAT64}
    t = O.random_pytable(rng, N, sch, null_prob=0.1, int_range=(-500, 500))
    t["g"] = [int(x) for x in rng.integers(0, key_range, N)]
    j_tables = {"T": O.pytable_to_block(t, sch)}
    return j_tables, to_port(j_tables)


def _aggs(Agg):
    return [Agg("sum", "v", "s"), Agg("count", None, "c"), Agg("count", "v", "cv"),
            Agg("min", "h", "lo"), Agg("max", "f", "hi"), Agg("sum", "d", "ds")]


def _plan(NP, Agg, mode, keys):
    return NP.Aggregation(keys, _aggs(Agg), NP.TableScan("T"), mode=mode)


def _same(j_plan, t_plan, j_tables, t_tables):
    want, jf = j_compile(j_plan)(j_tables)[:2]
    got, tf = t_compile(t_plan)(t_tables)
    assert [repr(c.dtype) for c in got.columns] == [repr(c.dtype) for c in want.columns]
    assert rows(got) == rows(want)
    assert sorted(tf) == sorted(jf)
    return got


@pytest.mark.parametrize("mode", ["partial", "final", "auto"])
@pytest.mark.parametrize("key_range,keys", [(7, ["g"]), (2500, ["g"]),
                                            (40, ["g", "h"]), (7, [])])
def test_mode_matches_reference(mode, key_range, keys):
    """Low and high key cardinality (auto: aggregate vs pass through), a
    nullable second key, and no key."""
    j_tables, t_tables = _tables(3, key_range)
    _same(_plan(JP, JAgg, mode, keys), _plan(TP, TAgg, mode, keys), j_tables, t_tables)


def test_partial_then_final_equals_one_aggregation():
    """A partial aggregation per half, concatenated, then the final
    merge: the rows of one aggregation, in both packages."""
    from tiflash_tpu_torch.exchange.skew import concat_blocks

    j_tables, t_tables = _tables(5, 300)
    t = t_tables["T"]
    half = t.capacity // 2
    partial = TP.Aggregation(["g"], [TAgg("sum", "v", "s"), TAgg("count", None, "c")],
                             TP.TableScan("T"), mode="partial")
    parts = []
    for lo, hi in ((0, half), (half, t.capacity)):
        sel = t.sel_mask().clone()
        sel[:lo] = False
        sel[hi:] = False
        parts.append(t_compile(partial)({"T": t.with_sel(sel)})[0].compact())
    final = TP.Aggregation(["g"], [TAgg("sum", "s", "s"), TAgg("sum", "c", "c")],
                           TP.TableScan("P"), mode="final")
    merged = t_compile(final)({"P": concat_blocks(parts[0], parts[1])})[0]
    one = t_compile(TP.Aggregation(["g"], [TAgg("sum", "v", "s"), TAgg("count", None, "c")],
                                   TP.TableScan("T")))({"T": t})[0]
    want = j_compile(JP.Aggregation(["g"], [JAgg("sum", "v", "s"), JAgg("count", None, "c")],
                                    JP.TableScan("T")))(j_tables)[0]
    assert rows(merged) == rows(one) == rows(want)


def test_auto_passes_high_cardinality_through():
    """Over 2,500 keys in 3,000 rows the sample sees more than half its
    rows distinct: every live row comes out as its own partial, as in the
    reference."""
    j_tables, t_tables = _tables(3, 2500)
    got = _same(_plan(JP, JAgg, "auto", ["g"]), _plan(TP, TAgg, "auto", ["g"]),
                j_tables, t_tables)
    assert int(got.num_rows()) == N


@pytest.mark.parametrize("func", ["approx_cd_partial", "approx_cd_final"])
def test_distributed_sketch_forms_still_raise(func):
    plan = TP.Aggregation(["g"], [TAgg(func, "v", "x")], TP.TableScan("T"),
                          mode="partial")
    _, t_tables = _tables(3, 7)
    with pytest.raises(NotImplementedError, match="distribution slice"):
        t_compile(plan)(t_tables)
