"""The stream aggregation method: the PyTorch port's ``aggregate_stream``
and its dispatch on ``Block.clustered_by`` against the JAX package's, on
key-clustered blocks made with numpy from a seed (tolerance zero: keys,
sums, counts and decimal mantissas are integers).

Template: the reference's ``tests/test_aggregate.py`` StreamAgg cases.
Covers int, string and nullable keys (with unequal payloads under
NULL), dead rows interspersed (groups that keep their slot unoccupied),
the -If filter, a ``num_slots`` overflow counted over all rows, running
sums that wrap past 2^63, both wide-decimal strategies of
``_wide_rewrite`` around the method, float sums and averages (within
1e-12 relative) and min/max.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiflash_tpu.core.block import Block, column_from_numpy
from tiflash_tpu.core.dtypes import BOOL, FLOAT64, INT64, STRING, Decimal
from tiflash_tpu.ops import aggregate as JA
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.compiler import compile_fragment as j_compile

from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.plan.compiler import compile_fragment as t_compile
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 3000

AGGS = [("sum", "x", "sx"), ("avg", "x", "ax"), ("count", "x", "cx"),
        ("sum", "y", "sy"), ("avg", "y", "ay"), ("count", None, "c"),
        ("sum", "y", "sy_if", "ok"), ("count", "x", "cx_if", "ok")]
WIDE_AGGS = AGGS + [("sum", "big", "sb"), ("avg", "big", "ab")]


def _port(jb):
    return blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


def _clustered(seed, keys, n=N, sel_frac=None, drop_stats=False, groups=400):
    """Random rows sorted host-side on ``keys``, so equal keys are
    adjacent.  ``k`` int64 with ties, ``kn`` nullable int64 whose NULL
    rows carry unequal payloads, ``g`` a string; arguments ``x``
    (nullable decimal), ``y`` (int64), ``big`` (decimal(18,3)), ``w``
    (int64 near 2^61), ``ok`` (bool filter)."""
    rng = np.random.default_rng(seed)
    kn_valid = rng.random(n) > 0.2
    cols = {
        "k": rng.integers(0, groups, n),
        "kn": rng.integers(-3, 4, n),
        "g": rng.choice([f"s{i:02d}" for i in range(6)], n),
    }
    order = np.lexsort(tuple(
        (cols[k] if k != "kn" else np.where(kn_valid, cols[k], -99))
        for k in reversed(keys)))
    cols = {c: v[order] for c, v in cols.items()}
    kn_valid = kn_valid[order]
    jb = Block.from_dict({
        "k": column_from_numpy(cols["k"], INT64),
        "kn": column_from_numpy(cols["kn"], INT64.with_nullable(True),
                                validity=kn_valid),
        "g": column_from_numpy(cols["g"].tolist(), STRING),
        "x": column_from_numpy(rng.integers(-10 ** 6, 10 ** 6, n), Decimal(15, 2, True),
                               validity=rng.random(n) > 0.25),
        "y": column_from_numpy(rng.integers(-50, 1000, n), INT64),
        "big": column_from_numpy(rng.integers(-(10 ** 16), 10 ** 16, n), Decimal(18, 3)),
        "w": column_from_numpy(rng.integers(2 ** 61 - 2 ** 40, 2 ** 61, n), INT64),
        "ok": column_from_numpy(rng.random(n) > 0.4, BOOL),
    })
    if drop_stats:
        jb = dataclasses.replace(jb, columns=tuple(
            dataclasses.replace(c, stats=None) for c in jb.columns))
    jb = dataclasses.replace(jb, clustered_by=tuple(keys))
    if sel_frac is not None:
        jb = jb.with_sel(jnp.asarray(rng.random(n) < sel_frac))
    return jb, _port(jb)


def _same(j, t):
    """Equal results, slot by slot: names, types, stats, live rows, the
    occupied-slot mask, group count and overflow."""
    assert t.block.names == j.block.names
    assert [repr(c.dtype) for c in t.block.columns] == \
        [repr(c.dtype) for c in j.block.columns]
    assert t.block.to_pylists() == j.block.to_pylists()
    assert np.array_equal(t.block.sel.numpy(), np.asarray(j.block.sel))
    assert int(t.num_groups) == int(j.num_groups)
    assert int(t.overflow) == int(j.overflow)
    for tc, jc in zip(t.block.columns, j.block.columns):
        assert tc.stats == jc.stats


@pytest.mark.parametrize("keys,sel_frac,num_slots", [
    (["k"], None, N),              # int key, every row live
    (["k"], 0.55, N),              # dead rows interspersed
    (["k"], 0.02, N),              # most groups keep no live row
    (["k", "g"], 0.7, N),          # int and string keys
    (["kn", "k"], 0.8, N),         # nullable key, unequal payloads under NULL
    (["k"], 0.6, 150),             # fewer slots than groups: overflow
    (["k"], 0.0, N),               # everything dead
], ids=["int", "dead_rows", "mostly_dead", "int_string", "nullable",
        "overflow", "all_dead"])
def test_stream_method_matches_reference(keys, sel_frac, num_slots):
    jb, tb = _clustered(len(keys) * 10 + int((sel_frac or 0) * 100), keys,
                        sel_frac=sel_frac)
    j = JA.aggregate_stream(jb, keys, [JA.AggDesc(*a) for a in AGGS], num_slots)
    t = TA.aggregate_stream(tb, keys, [TA.AggDesc(*a) for a in AGGS], num_slots)
    _same(j, t)
    if num_slots < N:
        assert int(t.overflow) > num_slots


def test_running_sums_wrap_past_2_63():
    """Sums of ``w`` (near 2^61) wrap the running sum many times; the
    differences at group ends stay exact."""
    jb, tb = _clustered(3, ["k"], sel_frac=0.9, groups=1500)
    aggs = [("sum", "w", "sw"), ("count", "w", "cw")]
    j = JA.aggregate_stream(jb, ["k"], [JA.AggDesc(*a) for a in aggs], N)
    t = TA.aggregate_stream(tb, ["k"], [TA.AggDesc(*a) for a in aggs], N)
    _same(j, t)
    rows = t.block.to_pylists()
    assert max(rows["sw"]) > 2 ** 62  # a group holds several rows near 2^61


@pytest.mark.parametrize("drop_stats", [False, True],
                         ids=["narrow_stored", "digits"])
def test_dispatch_on_clustered_by_with_wide_sums(drop_stats):
    """hash_aggregate takes the stream method when the keys are the
    clustering prefix (in any order), around the wide-decimal rewrite."""
    jb, tb = _clustered(7, ["k", "g"], sel_frac=0.75, drop_stats=drop_stats)
    calls = []
    real = TA.aggregate_stream
    TA.aggregate_stream = lambda b, k, a, ns: calls.append((list(k), ns)) or real(b, k, a, ns)
    try:
        t = TA.hash_aggregate(tb, ["g", "k"], [TA.AggDesc(*a) for a in WIDE_AGGS])
    finally:
        TA.aggregate_stream = real
    j = JA.hash_aggregate(jb, ["g", "k"], [JA.AggDesc(*a) for a in WIDE_AGGS])
    assert calls == [(["g", "k"], N)]
    _same(j, t)
    sx, sb = (t.block[nm] for nm in ("sx", "sb"))
    assert sx.dtype.is_wide_decimal and (sx.data.ndim == 2) == drop_stats
    assert sb.dtype.is_wide_decimal and sb.data.ndim == 2


def test_keys_outside_the_clustering_prefix_take_the_sort_method():
    jb, tb = _clustered(8, ["k", "g"], sel_frac=0.9)
    calls = []
    real_stream, real_sort = TA.aggregate_stream, TA.aggregate_sort
    TA.aggregate_stream = lambda *a: calls.append("stream") or real_stream(*a)
    TA.aggregate_sort = lambda *a: calls.append("sort") or real_sort(*a)
    try:
        t = TA.hash_aggregate(tb, ["k", "y"], [TA.AggDesc("sum", "x", "s")])
    finally:
        TA.aggregate_stream, TA.aggregate_sort = real_stream, real_sort
    j = JA.hash_aggregate(jb, ["k", "y"], [JA.AggDesc("sum", "x", "s")])
    assert calls == ["sort"]
    assert t.block.to_pylists() == j.block.to_pylists()


def test_aggregation_node_over_a_clustered_scan():
    """The compiler's Aggregation over a Selection and Projection of a
    clustered scan: clustering survives the lazy filter and the rename,
    the fused path declines (no static key domain), the stream method
    runs; same rows, overflow flags and node ids as the reference."""
    jb, tb = _clustered(9, ["k"])

    def plan(P, AggDesc):
        from tiflash_tpu_torch.expr import nodes as TN
        from tiflash_tpu.expr import nodes as JN

        N_ = TN if P is TP else JN
        proj = P.Projection({"key": N_.col("k"), "y": N_.col("y")},
                            P.Selection(N_.col("y") > 100, P.TableScan("t")))
        return P.Aggregation(["key"], [AggDesc("sum", "y", "s"),
                                       AggDesc("count", None, "c")], proj)

    calls = []
    real = TA.aggregate_stream
    TA.aggregate_stream = lambda *a: calls.append(a[-1]) or real(*a)
    try:
        to, tf = t_compile(plan(TP, TA.AggDesc))({"t": tb})
    finally:
        TA.aggregate_stream = real
    jo, jf = j_compile(plan(JP, JA.AggDesc))({"t": jb})
    assert calls == [N]
    assert to.to_pylists() == jo.to_pylists()
    assert {k: int(v) for k, v in tf.items()} == {k: int(v) for k, v in jf.items()}


def test_float_and_min_max_raise_naming_the_functions_slice():
    """Float sums and averages by the stream method (they raised before
    this slice of the port) equal the reference's within 1e-12 relative:
    both take a running sum that restarts at each group (a Hillis-Steele
    scan here, XLA's associative scan there), so they add in a different
    tree.  Min and max equal the reference's exactly."""
    jb, tb = _clustered(10, ["k"])
    jf = jb.with_column("f", dataclasses.replace(
        jb["y"], data=jb["y"].data.astype(jnp.float64) / 3.0, dtype=FLOAT64,
        stats=None))
    jf = dataclasses.replace(jf, clustered_by=("k",))
    tf = dataclasses.replace(_port(jf), clustered_by=("k",))
    aggs = [("sum", "f", "s"), ("avg", "f", "a"), ("count", "f", "c")]
    want = JA.aggregate_stream(jf, ["k"], [JA.AggDesc(*a) for a in aggs], N)
    got = TA.aggregate_stream(tf, ["k"], [TA.AggDesc(*a) for a in aggs], N)
    w, g = want.block.to_pylists(), got.block.to_pylists()
    assert list(w) == list(g) and w["k"] == g["k"] and w["c"] == g["c"]
    for name in ("s", "a"):
        assert len(g[name]) == len(w[name])
        for x, y in zip(g[name], w[name]):
            assert (x is None) == (y is None)
            assert y is None or abs(x - y) <= 1e-12 * abs(y), (name, x, y)
    aggs = [("min", "y", "m"), ("max", "y", "mx")]
    want = JA.aggregate_stream(jb, ["k"], [JA.AggDesc(*a) for a in aggs], N)
    got = TA.aggregate_stream(tb, ["k"], [TA.AggDesc(*a) for a in aggs], N)
    assert got.block.to_pylists() == want.block.to_pylists()
    assert [repr(c.dtype) for c in got.block.columns] == \
        [repr(c.dtype) for c in want.block.columns]
