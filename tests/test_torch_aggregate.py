"""The unfused aggregation methods: the PyTorch port's ``hash_aggregate``
against the JAX package's on the same blocks (tolerance zero).

Covers the masked sub-method (key domains <= 64), the segment sub-method
(65..4096), the keyless method, NULL keys and arguments, dead rows, the
-If filter, and both wide-decimal strategies of ``_wide_rewrite``
(narrow-stored when stats bound the sum, base-10^9 digits otherwise).
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


def test_unported_aggregates_raise():
    _, tb = _block(1, 4)
    with pytest.raises(NotImplementedError):
        t_agg(tb, ["g"], [TAgg("min", "y", "m")])
    with pytest.raises(NotImplementedError):
        t_agg(tb, ["y"], [TAgg("sum", "y", "s")])
