"""Column and Block of the PyTorch port against the JAX package's: the
same operations on the same data (made with numpy from a seed) must give
the same values, masks, metadata and decoded rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiflash_tpu.core.block import Block, Column as JColumn, column_from_numpy
from tiflash_tpu.core.dtypes import Decimal as JDecimal, INT64, STRING

from tiflash_tpu_torch.core.block import Column as TColumn
from tiflash_tpu_torch.core.dtypes import Decimal as TDecimal
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 64


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(8)
    blk = Block.from_dict({
        "a": column_from_numpy(rng.integers(0, 100, N), INT64.with_nullable(),
                               validity=rng.random(N) > 0.2),
        "s": column_from_numpy(rng.choice(["p", "q", "r"], N).tolist(), STRING),
        "d": column_from_numpy(rng.integers(-999, 999, N), JDecimal(12, 2)),
    })
    blk = blk.with_sel(jnp.asarray(rng.random(N) > 0.3))
    import dataclasses

    blk = dataclasses.replace(blk, clustered_by=("s", "a"))
    return blk, blocks_from_numpy(export_blocks({"t": blk}), "cpu")["t"]


def _same(tb, jb):
    assert tb.names == jb.names
    assert tb.clustered_by == jb.clustered_by
    assert tb.to_pylists() == jb.to_pylists()
    assert int(tb.num_rows()) == int(jb.num_rows())
    np.testing.assert_array_equal(tb.sel_mask().numpy(), np.asarray(jb.sel_mask()))
    for tc, jc in zip(tb.columns, jb.columns):
        assert repr(tc.dtype) == repr(jc.dtype) and tc.stats == jc.stats
        assert tc.dictionary == jc.dictionary


def test_select_with_column_and_sel(pair):
    jb, tb = pair
    _same(tb.select(["s", "d"]), jb.select(["s", "d"]))
    _same(tb.select(["a", "d"]), jb.select(["a", "d"]))
    _same(tb.with_column("a", tb["d"]), jb.with_column("a", jb["d"]))
    _same(tb.with_column("z", tb["a"]), jb.with_column("z", jb["a"]))
    mask = np.arange(N) % 2 == 0
    _same(tb.and_sel(torch.as_tensor(mask)), jb.and_sel(jnp.asarray(mask)))
    _same(tb.with_sel(None), jb.with_sel(None))
    assert tb.as_dict().keys() == jb.as_dict().keys()
    with pytest.raises(KeyError):
        tb.select(["nope"])
    with pytest.raises(KeyError):
        tb["nope"]


@pytest.mark.parametrize("fill_invalid", [False, True])
def test_take_matches_reference(pair, fill_invalid):
    jb, tb = pair
    idx = np.random.default_rng(3).integers(-5 if fill_invalid else 0, N, 40).astype(np.int32)
    jt = jb.take(jnp.asarray(idx), fill_invalid=fill_invalid)
    tt = tb.take(torch.as_tensor(idx), fill_invalid=fill_invalid)
    _same(tt, jt)
    for name in ("a", "s", "d"):
        assert tb[name].take(torch.as_tensor(idx), fill_invalid).to_pylist() == \
            jb[name].take(jnp.asarray(idx), fill_invalid).to_pylist()


def test_wide_decimal_to_pylist_matches_reference():
    limbs = np.array([[0, 5], [-1, 10 ** 18 - 7], [3, 0], [12, 34]], dtype=np.int64)
    valid = np.array([True, True, True, False])
    j = JColumn(jnp.asarray(limbs), jnp.asarray(valid), JDecimal(38, 2))
    t = TColumn(torch.as_tensor(limbs), torch.as_tensor(valid), TDecimal(38, 2))
    assert t.to_pylist() == j.to_pylist() == [5, -7, 3 * 10 ** 18, None]
    sel = np.array([True, False, True, True])
    assert t.to_pylist(sel) == j.to_pylist(sel)
