"""The unfused aggregation methods: the PyTorch port's ``hash_aggregate``
against the JAX package's on the same blocks (tolerance zero).

Covers the masked sub-method (key domains <= 64), the segment sub-method
(65..4096), the keyless method, the sort method (keys without a static
domain: NULL keys, ties, a ``num_slots`` overflow), NULL keys and
arguments, dead rows, the -If filter, and both wide-decimal strategies of
``_wide_rewrite`` (narrow-stored when stats bound the sum, base-10^9
digits otherwise).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tiflash_tpu.core.block import Block, column_from_numpy
from tiflash_tpu.core.dtypes import BOOL, INT64, STRING, Decimal
from tiflash_tpu.ops.aggregate import AggDesc as JAgg, hash_aggregate as j_agg

from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg, hash_aggregate as t_agg
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 2000


def _block(seed, n_keys, key_nulls=False, drop_stats=False, with_sel=True):
    rng = np.random.default_rng(seed)
    keys = [f"k{i:03d}" for i in range(n_keys)]
    cols = {
        "g": column_from_numpy(rng.choice(keys, N).tolist(),
                               STRING.with_nullable(key_nulls),
                               validity=(rng.random(N) > 0.1) if key_nulls else None),
        "h": column_from_numpy(rng.random(N) > 0.5, BOOL),
        "x": column_from_numpy(rng.integers(-10 ** 6, 10 ** 6, N), Decimal(15, 2, True),
                               validity=rng.random(N) > 0.25),
        "y": column_from_numpy(rng.integers(-50, 1000, N), INT64),
        "big": column_from_numpy(rng.integers(-(10 ** 16), 10 ** 16, N), Decimal(18, 3)),
        "ok": column_from_numpy(rng.random(N) > 0.4, BOOL),
    }
    blk = Block.from_dict(cols)
    if drop_stats:
        blk = dataclasses.replace(blk, columns=tuple(
            dataclasses.replace(c, stats=None) for c in blk.columns))
    if with_sel:
        blk = blk.with_sel(jnp.asarray(rng.random(N) > 0.3))
    return blk, blocks_from_numpy(export_blocks({"t": blk}), "cpu")["t"]


AGGS = [("sum", "x", "sx"), ("avg", "x", "ax"), ("count", "x", "cx"),
        ("sum", "y", "sy"), ("avg", "y", "ay"), ("count", None, "c"),
        ("sum", "big", "sb"), ("avg", "big", "ab"),
        ("sum", "y", "sy_if", "ok")]


def _compare(jb, tb, keys, aggs):
    j = j_agg(jb, keys, [JAgg(*a) for a in aggs])
    t = t_agg(tb, keys, [TAgg(*a) for a in aggs])
    assert t.block.names == j.block.names
    assert [repr(c.dtype) for c in t.block.columns] == \
        [repr(c.dtype) for c in j.block.columns]
    assert t.block.to_pylists() == j.block.to_pylists()
    assert int(t.num_groups) == int(j.num_groups)
    assert int(t.overflow) == int(j.overflow) == 0
    for tc, jc in zip(t.block.columns, j.block.columns):
        assert tc.stats == jc.stats


@pytest.mark.parametrize("n_keys,key_nulls,drop_stats", [
    (4, False, False),     # masked sub-method
    (4, True, True),       # masked, NULL keys, digit-decomposed wide sums
    (100, False, False),   # segment sub-method
    (150, True, True),     # segment, NULL keys, digit-decomposed wide sums
])
def test_grouped_matches_reference(n_keys, key_nulls, drop_stats):
    jb, tb = _block(n_keys, n_keys, key_nulls, drop_stats)
    _compare(jb, tb, ["g"], AGGS)


def test_two_keys_matches_reference():
    jb, tb = _block(21, 20)
    _compare(jb, tb, ["g", "h"], AGGS)


@pytest.mark.parametrize("drop_stats", [False, True])
def test_keyless_matches_reference(drop_stats):
    jb, tb = _block(31, 3, drop_stats=drop_stats)
    _compare(jb, tb, [], AGGS)


def test_everything_filtered_out():
    jb, tb = _block(41, 5)
    import torch

    jb = jb.with_sel(jnp.zeros(N, dtype=bool))
    tb = tb.with_sel(torch.zeros(N, dtype=torch.bool))
    _compare(jb, tb, ["g"], AGGS)
    _compare(jb, tb, [], AGGS)


def _sort_block(seed, n=1500):
    """Int keys without a static domain: ``y`` with many ties, ``z``
    nullable (and nonzero payload under its NULLs), plus the aggregate
    arguments of ``_block``."""
    jb, _ = _block(seed, 30)
    rng = np.random.default_rng(seed + 1)
    z_valid = rng.random(N) > 0.2
    jb = jb.with_column("ky", column_from_numpy(rng.integers(0, 12, N), INT64))
    jb = jb.with_column("kz", column_from_numpy(rng.integers(-3, 4, N),
                                                INT64.with_nullable(True),
                                                validity=z_valid))
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


@pytest.mark.parametrize("keys,num_slots", [
    (["ky"], None),              # ties: 12 groups
    (["kz", "ky"], None),        # NULL keys group together, first
    (["g", "kz"], None),         # a string key beside a NULL-able int key
    (["kz", "ky"], 40),          # fewer slots than groups: overflow
], ids=["ties", "null_keys", "string_and_int", "overflow"])
def test_sort_method_matches_reference(keys, num_slots):
    import jax

    from tiflash_tpu_torch.ops import aggregate as TA

    jb, tb = _sort_block(51)
    aggs = AGGS
    j = jax.jit(lambda b: (lambda r: (r.block, r.num_groups, r.overflow))(
        j_agg(b, keys, [JAgg(*a) for a in aggs], num_slots)))(jb)
    calls = []
    real = TA.aggregate_sort
    TA.aggregate_sort = lambda *a: calls.append(a[-1]) or real(*a)
    try:
        t = t_agg(tb, keys, [TAgg(*a) for a in aggs], num_slots)
    finally:
        TA.aggregate_sort = real
    assert calls == [num_slots or N]
    assert t.block.names == j[0].names
    assert [repr(c.dtype) for c in t.block.columns] == \
        [repr(c.dtype) for c in j[0].columns]
    assert t.block.to_pylists() == j[0].to_pylists()
    assert int(t.num_groups) == int(j[1])
    assert int(t.overflow) == int(j[2])
    assert (int(t.overflow) > 0) == (num_slots is not None)


def test_unported_aggregates_raise():
    """quantile, var_pop and a float sum by the stream method raised
    before this slice of the port; each now equals the reference's.
    quantile picks a row (exact); var_pop's moments and the float sum
    add in another order, within 1e-12 relative."""
    import dataclasses as dc

    jb, tb = _block(1, 4)
    _compare(jb, tb, ["g"], [("quantile", "y", "m", None, 0.5),
                             ("quantile", "x", "m2", None, 0.25)])
    jw = j_agg(jb, ["y"], [JAgg("var_pop", "x", "d")]).block
    tw = t_agg(tb, ["y"], [TAgg("var_pop", "x", "d")]).block
    assert_rows_close(tw.to_pylists(), jw.to_pylists(), rel=1e-12)
    # keys the block is clustered on take the stream method
    import torch
    from tiflash_tpu.core.dtypes import FLOAT64 as JF64
    from tiflash_tpu_torch.core.dtypes import FLOAT64

    jf = jb.with_column("f", dc.replace(jb["y"], data=jb["y"].data.astype(jnp.float64)
                                        / 7.0, dtype=JF64, stats=None))
    tf = blocks_from_numpy(export_blocks({"t": jf}), "cpu")["t"]
    assert tf["f"].dtype == FLOAT64 and tf["f"].data.dtype == torch.float64
    js = j_agg(dc.replace(jf, clustered_by=("y",)), ["y"], [JAgg("sum", "f", "s")]).block
    ts = t_agg(dc.replace(tf, clustered_by=("y",)), ["y"], [TAgg("sum", "f", "s")]).block
    assert_rows_close(ts.to_pylists(), js.to_pylists(), rel=1e-12)


def assert_rows_close(got: dict, want: dict, rel: float) -> None:
    """Equal column dicts of live rows, floats within ``rel`` relative."""
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for g, w in zip(got[name], want[name]):
            if isinstance(w, float) and g is not None:
                assert abs(g - w) <= rel * abs(w), (name, g, w)
            else:
                assert g == w, (name, g, w)
