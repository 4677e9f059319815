"""The fused scan->filter->project->aggregate path: the PyTorch port held
against the JAX package on the twelve cases of ``test_stream_fuse.py``.

Both packages compile the same plan over the same tables (made with numpy
from a seed, carried into the port through ``testing/bridge.py``).  The
JAX side runs its Pallas kernel in interpret mode; the port's kernel
wrapper takes its plain torch version on CPU tensors.  Results must be
equal (tolerance zero: every output is an integer or a decimal), and the
port's fuse must engage exactly where the JAX one does.
"""

import dataclasses
import types

import numpy as np
import pytest

from tiflash_tpu.core.block import Block, column_from_numpy
from tiflash_tpu.core.dtypes import DATE, Decimal, STRING
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.ops import stream_fuse as JSF
from tiflash_tpu.ops.aggregate import AggDesc as JAggDesc
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.compiler import compile_fragment as j_compile
from tiflash_tpu.testing import oracle as O

from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.ops import stream_fuse as TSF
from tiflash_tpu_torch.ops.aggregate import AggDesc as TAggDesc
from tiflash_tpu_torch.ops.cuda import stream_agg as TSA
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.plan.compiler import compile_fragment as t_compile
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

JAX = types.SimpleNamespace(E=JE, P=JP, AggDesc=JAggDesc)
TORCH = types.SimpleNamespace(E=TE, P=TP, AggDesc=TAggDesc)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("TIFLASH_TPU_STREAM_KERNEL", "interpret")


def _run_parity(build, tables, expect_fused=True):
    """Run ``build(pkg)`` through both packages; compare."""
    j_before, t_before = JSF.FUSE_STATS["count"], TSF.FUSE_STATS["count"]
    j_out, j_flags = j_compile(build(JAX))(tables)
    t_tables = blocks_from_numpy(export_blocks(tables), "cpu")
    t_out, t_flags = t_compile(build(TORCH))(t_tables)
    for flags in (j_flags, t_flags):
        for k, v in flags.items():
            assert not bool(v), f"overflow at {k}"
    j_fused = JSF.FUSE_STATS["count"] - j_before
    t_fused = TSF.FUSE_STATS["count"] - t_before
    assert j_fused == t_fused == (1 if expect_fused else 0)
    if expect_fused:
        assert (TSF.FUSE_STATS["slots"], TSF.FUSE_STATS["limbs"]) == (
            JSF.FUSE_STATS["slots"], JSF.FUSE_STATS["limbs"])
    assert [repr(c.dtype) for c in t_out.columns] == \
        [repr(c.dtype) for c in j_out.columns]
    got = O.block_to_pytable(t_out)
    want = O.block_to_pytable(j_out)
    O.assert_tables_equal(got, want, ordered=False)
    return got


def _mktable(n=1000, nulls=False, seed=0):
    rng = np.random.default_rng(seed)
    grp = rng.choice(["aa", "bb", "cc", "dd"], size=n).tolist()
    qty = rng.integers(1, 51, size=n) * 100          # Decimal(15,2)
    price = rng.integers(90_000, 10_500_000, size=n)  # Decimal(15,2)
    disc = rng.integers(0, 11, size=n)                # Decimal(15,2) 0.00-0.10
    day = rng.integers(9000, 11000, size=n)           # DATE days
    flag = rng.choice(["X", "Y"], size=n).tolist()
    vd = rng.random(n) > 0.3 if nulls else None
    vq = rng.random(n) > 0.2 if nulls else None
    cols = {
        "grp": column_from_numpy(grp, STRING),
        "qty": column_from_numpy(qty, Decimal(15, 2, nullable=nulls),
                                 validity=vq),
        "price": column_from_numpy(price, Decimal(15, 2)),
        "disc": column_from_numpy(disc, Decimal(15, 2, nullable=nulls),
                                  validity=vd),
        "day": column_from_numpy(day, DATE),
        "flag": column_from_numpy(flag, STRING),
    }
    return {"t": Block.from_dict(cols)}


def _q1_like(m, keys=("grp",)):
    E, P = m.E, m.P
    disc_price = E.Call("multiply", (
        E.ColumnRef("price"),
        E.Call("minus", (E.Literal(1), E.ColumnRef("disc"))),
    ))
    proj = P.Projection(
        exprs={
            "grp": E.ColumnRef("grp"),
            "qty": E.ColumnRef("qty"),
            "price": E.ColumnRef("price"),
            "disc": E.ColumnRef("disc"),
            "dp": disc_price,
        },
        child=P.Selection(
            cond=E.Call("less_or_equals", (E.ColumnRef("day"),
                                           E.Literal("1998-09-20"))),
            child=P.TableScan("t"),
        ),
    )
    return P.Aggregation(
        keys=list(keys),
        aggs=[
            m.AggDesc("sum", "qty", "sum_qty"),
            m.AggDesc("sum", "dp", "sum_dp"),
            m.AggDesc("avg", "price", "avg_price"),
            m.AggDesc("avg", "disc", "avg_disc"),
            m.AggDesc("count", "disc", "cnt_disc"),
            m.AggDesc("count", None, "cnt"),
        ],
        child=proj,
    )


def _agg_over(m, keys, aggs, cond):
    E, P = m.E, m.P
    child = P.TableScan("t")
    if cond is not None:
        child = P.Selection(cond=cond(E), child=child)
    return P.Aggregation(keys=keys, aggs=[m.AggDesc(*a) for a in aggs],
                         child=child)


def test_q1_like_parity():
    _run_parity(_q1_like, _mktable())


def test_q1_like_with_nulls():
    _run_parity(_q1_like, _mktable(nulls=True, seed=3))


def test_two_keys_and_in_filter():
    def build(m):
        return _agg_over(
            m, ["grp", "flag"], [("sum", "price", "s"), ("count", None, "c")],
            lambda E: E.Call("and", (
                E.Call("in", (E.ColumnRef("grp"), E.Literal("aa"),
                              E.Literal("cc"), E.Literal("zz"))),
                E.Call("greater", (E.ColumnRef("qty"), E.Literal(10))),
            )))

    _run_parity(build, _mktable(seed=5))


def test_string_compare_nonmember_literal():
    def build(m):
        return _agg_over(
            m, ["flag"], [("count", None, "c")],
            lambda E: E.Call("greater_or_equals", (E.ColumnRef("grp"),
                                                   E.Literal("bz"))))

    _run_parity(build, _mktable(seed=6))


def test_static_out_of_range_literal():
    def build(m):
        return _agg_over(
            m, ["grp"], [("sum", "qty", "s")],
            lambda E: E.Call("less", (E.ColumnRef("price"), E.Literal(10 ** 13))))

    _run_parity(build, _mktable(seed=7))


def test_empty_selection():
    def build(m):
        return _agg_over(
            m, ["grp"], [("sum", "qty", "s"), ("count", None, "c")],
            lambda E: E.Call("greater", (E.ColumnRef("qty"), E.Literal(10 ** 9))))

    _run_parity(build, _mktable(seed=8))


def test_no_keys_q6_like():
    def build(m):
        E, P = m.E, m.P
        revenue = E.Call("multiply", (E.ColumnRef("price"), E.ColumnRef("disc")))
        return P.Aggregation(
            keys=[],
            aggs=[m.AggDesc("sum", "rev", "revenue"), m.AggDesc("count", None, "c")],
            child=P.Projection(
                exprs={"rev": revenue},
                child=P.Selection(
                    cond=E.Call("and", (
                        E.Call("greater_or_equals", (E.ColumnRef("disc"),
                                                     E.Literal(0.02))),
                        E.Call("less", (E.ColumnRef("qty"), E.Literal(30))),
                    )),
                    child=P.TableScan("t"),
                ),
            ),
        )

    _run_parity(build, _mktable(seed=9))


def test_fallback_on_large_domain(monkeypatch):
    """Key domain above MAX_SLOTS: both fall back to the general path."""
    monkeypatch.setattr(JSF, "MAX_SLOTS", 2)
    monkeypatch.setattr(TSF, "MAX_SLOTS", 2)

    def build(m):
        return _agg_over(m, ["grp"], [("sum", "qty", "s")], None)

    _run_parity(build, _mktable(seed=10), expect_fused=False)


def test_fallback_missing_stats():
    """Columns without range stats are ineligible: both take the general
    path, whose wide sums go through the digit decomposition."""
    tables = _mktable(seed=11)
    t = tables["t"]
    cols = tuple(dataclasses.replace(c, stats=None) for c in t.columns)
    tables = {"t": dataclasses.replace(t, columns=cols)}

    def build(m):
        return _agg_over(m, ["grp"], [("sum", "qty", "s")], None)

    _run_parity(build, tables, expect_fused=False)


def test_flush_chunking(monkeypatch):
    """Multi-chunk accumulation on both sides: the JAX kernel flushes every
    grid step, the port runs its tile function over 4096-row chunks."""
    from tiflash_tpu.ops.pallas import stream_agg as JSA

    monkeypatch.setattr(JSA, "FLUSH_TILES", 2)
    monkeypatch.setattr(TSA, "CHUNK_ROWS", 4096)
    _run_parity(_q1_like, _mktable(n=5 * 8192 - 7, seed=12))


def test_tpch_q1_q6_fused_parity():
    from tiflash_tpu.bench import tpch_queries as JQ
    from tiflash_tpu.storage.tpch import generate_tpch
    from tiflash_tpu_torch.bench import tpch_queries as TQ

    tables = generate_tpch(sf=0.002, seed=2, tables=["lineitem"]).blocks()
    for name in ("q1_plan", "q6_plan"):
        _run_parity(lambda m, _n=name: getattr(JQ if m is JAX else TQ, _n)(),
                    tables)


def test_fused_wide_recombination_past_int64():
    """Sums whose bound exceeds int64 recombine the SAME plane sums into
    two-limb wide decimals (values near 2^48 at 2^18 rows)."""
    rng = np.random.default_rng(4)
    n = 1 << 18
    big = rng.integers(1 << 47, 1 << 48, size=n)
    grp = rng.choice(["aa", "bb", "cc"], size=n).tolist()
    tables = {"t": Block.from_dict({
        "grp": column_from_numpy(grp, STRING),
        "big": column_from_numpy(big, Decimal(17, 2)),
    })}

    def build(m):
        return _agg_over(m, ["grp"], [("sum", "big", "s"), ("avg", "big", "a"),
                                      ("count", None, "n")], None)

    got = _run_parity(build, tables)
    assert any(abs(v) > (1 << 63) for v in
               [int(x.scaleb(2)) for x in got["s"]])
