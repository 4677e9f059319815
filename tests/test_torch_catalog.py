"""The PyTorch port's catalog and TPC-H generator against the JAX package.

Same seed and the same numpy call order must give the same column bytes,
stats, dictionaries and key metadata; Blocks must survive the numpy
bridge (``testing/bridge.py:export_blocks`` ->
``storage/catalog.py:blocks_from_numpy``) unchanged.
"""

import numpy as np
import pytest
import torch

from tiflash_tpu.storage.tpch import generate_tpch as j_generate

from tiflash_tpu_torch.core.dtypes import TypeKind
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate
from tiflash_tpu_torch.testing.bridge import export_blocks

SF = 0.01
TABLES = ["region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem"]


@pytest.fixture(scope="module")
def catalogs():
    return j_generate(sf=SF, seed=3), t_generate(sf=SF, seed=3)


def _assert_column_equal(tc, jc, where):
    assert repr(tc.dtype) == repr(jc.dtype), where
    assert tc.dtype.kind.name == jc.dtype.kind.name, where
    np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data), err_msg=where)
    assert tc.data.numpy().dtype == np.asarray(jc.data).dtype, where
    if jc.validity is None:
        assert tc.validity is None, where
    else:
        np.testing.assert_array_equal(tc.validity.numpy(), np.asarray(jc.validity))
    assert tc.dictionary == jc.dictionary, where
    assert tc.stats == jc.stats, where
    assert tc.ndv == jc.ndv, where
    if jc.narrow32 is None:
        assert tc.narrow32 is None, where
    else:
        # the reference pads its shadow to a TPU grid step; the port's is
        # exactly capacity long
        n = tc.capacity
        assert tc.narrow32.dtype == torch.int32 and tc.narrow32.shape[0] == n
        np.testing.assert_array_equal(tc.narrow32.numpy(),
                                      np.asarray(jc.narrow32)[:n], err_msg=where)


@pytest.mark.parametrize("table", TABLES)
def test_generate_tpch_same_bytes(catalogs, table):
    jcat, tcat = catalogs
    jt, tt = jcat[table], tcat[table]
    assert tt.row_count == jt.row_count
    assert tt.unique_keys == jt.unique_keys
    jb, tb = jt.block, tt.block
    assert tb.names == jb.names
    assert tb.clustered_by == jb.clustered_by
    assert {n: repr(d) for n, d in tt.schema.items()} == \
        {n: repr(d) for n, d in jt.schema.items()}
    for name in jb.names:
        _assert_column_equal(tb[name], jb[name], f"{table}.{name}")


def test_lineitem_row_count_matches_reference_draw_order():
    """Restricting to one table keeps the reference's draw order."""
    j = j_generate(sf=0.002, seed=0, tables=["lineitem"])
    t = t_generate(sf=0.002, seed=0, tables=["lineitem"])
    assert list(t.tables) == list(j.tables) == ["lineitem"]
    assert t["lineitem"].row_count == j["lineitem"].row_count
    np.testing.assert_array_equal(t["lineitem"].block["l_extendedprice"].data.numpy(),
                                  np.asarray(j["lineitem"].block["l_extendedprice"].data))


def test_bridge_round_trip_from_reference(catalogs):
    jcat, tcat = catalogs
    bridged = blocks_from_numpy(export_blocks(jcat), "cpu")
    native = tcat.blocks("cpu")
    assert set(bridged) == set(native)
    for table, tb in native.items():
        bb = bridged[table]
        assert bb.names == tb.names and bb.clustered_by == tb.clustered_by
        assert bb.sel is None
        for name in tb.names:
            _assert_column_equal(bb[name], jcat[table].block[name], f"{table}.{name}")


def test_bridge_round_trip_of_port_blocks_keeps_sel(catalogs):
    _, tcat = catalogs
    blk = tcat.blocks("cpu")["orders"]
    sel = torch.arange(blk.capacity) % 3 == 0
    back = blocks_from_numpy(export_blocks({"orders": blk.with_sel(sel)}), "cpu")
    out = back["orders"]
    assert torch.equal(out.sel, sel)
    assert out.to_pylists() == blk.with_sel(sel).to_pylists()
    for a, b in zip(out.columns, blk.columns):
        assert a.dtype == b.dtype and a.stats == b.stats
        assert torch.equal(a.data, b.data)


def test_blocks_are_cached_per_device(catalogs):
    _, tcat = catalogs
    a = tcat.blocks("cpu")
    b = tcat.blocks(torch.device("cpu"))
    assert a["lineitem"] is b["lineitem"]
    assert a["lineitem"]["l_quantity"].data.device.type == "cpu"


def test_to_pylist_decodes_strings_and_nulls(catalogs):
    _, tcat = catalogs
    col = tcat.blocks("cpu")["nation"]["n_name"]
    names = col.to_pylist()
    assert names[0] == "ALGERIA" and len(names) == 25
    assert col.dtype.kind is TypeKind.STRING
