"""Sort and Limit: the PyTorch port against the JAX package.

``torch.sort`` sorts on one key and is unstable by default, so the port
chains stable argsorts from the last key operand to the first.  Held here
against the reference's one multi-operand stable ``lax.sort`` on keys
with NULLs, descending order, bools, floats, decimals, dead rows and many
ties (a row-id payload column shows the tie order).
"""

import numpy as np
import pytest
import torch

from tiflash_tpu.core.block import Block, column_from_numpy
from tiflash_tpu.core.dtypes import BOOL, FLOAT64, INT64, STRING, Decimal
from tiflash_tpu.ops.sort import SortKey as JKey, limit_block as j_limit, sort_block as j_sort

from tiflash_tpu_torch.ops.sort import SortKey as TKey, lexsort_stable
from tiflash_tpu_torch.ops.sort import limit_block as t_limit, sort_block as t_sort
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 200


def _tables(seed, with_sel):
    rng = np.random.default_rng(seed)
    a = rng.integers(-3, 4, N)                      # few values: many ties
    a_valid = rng.random(N) > 0.2
    f = rng.choice([-1.5, 0.0, 2.25, 7.0], N)
    f_valid = rng.random(N) > 0.3
    s = rng.choice(["x", "yy", "a", "zz"], N).tolist()
    b = rng.random(N) > 0.5
    d = rng.integers(-500, 500, N)
    blk = Block.from_dict({
        "a": column_from_numpy(a, INT64.with_nullable(), validity=a_valid),
        "f": column_from_numpy(f, FLOAT64.with_nullable(), validity=f_valid),
        "s": column_from_numpy(s, STRING),
        "b": column_from_numpy(b, BOOL),
        "d": column_from_numpy(d, Decimal(10, 2)),
        "rid": column_from_numpy(np.arange(N), INT64),
    })
    if with_sel:
        import jax.numpy as jnp

        blk = blk.with_sel(jnp.asarray(rng.random(N) > 0.25))
    return {"t": blk}, blocks_from_numpy(export_blocks({"t": blk}), "cpu")


KEY_SETS = [
    [("a",)],
    [("a", True)],
    [("a", True, True)],
    [("a", False, False)],
    [("s",), ("a", True)],
    [("f", True)],
    [("f",), ("b",)],
    [("b", True), ("a", False, False)],
    [("d", True), ("s",)],
]


@pytest.mark.parametrize("with_sel", [False, True], ids=["all_live", "sel"])
@pytest.mark.parametrize("keys", KEY_SETS, ids=lambda k: "-".join("_".join(map(str, x)) for x in k))
def test_sort_block_matches_reference(keys, with_sel):
    j_tab, t_tab = _tables(seed=len(keys) * 7 + int(with_sel), with_sel=with_sel)
    j_out = j_sort(j_tab["t"], [JKey(*k) for k in keys])
    t_out = t_sort(t_tab["t"], [TKey(*k) for k in keys])
    assert t_out.to_pylists() == j_out.to_pylists()
    assert torch.equal(t_out.sel, torch.as_tensor(np.array(j_out.sel)))


@pytest.mark.parametrize("limit", [0, 7, 1000])
def test_limit_block_matches_reference(limit):
    j_tab, t_tab = _tables(seed=limit, with_sel=True)
    assert t_limit(t_tab["t"], limit).to_pylists() == \
        j_limit(j_tab["t"], limit).to_pylists()


def test_lexsort_is_stable_and_lexicographic():
    k1 = torch.tensor([1, 0, 1, 0, 1, 0], dtype=torch.int8)
    k2 = torch.tensor([5, 5, 3, 3, 5, 3])
    perm = lexsort_stable([k1, k2])
    assert perm.tolist() == [3, 5, 1, 2, 0, 4]
    # bool keys are ordered False < True
    perm = lexsort_stable([torch.tensor([True, False, True, False])])
    assert perm.tolist() == [1, 3, 0, 2]


FLOAT_EDGES = [float("nan"), -0.0, 0.0, float("inf"), float("-inf"), -1.5, 2.25]


def _float_edge_tables(seed, with_sel):
    """``fe``: a nullable double holding NaN, -0.0, 0.0, +-inf and two
    finite values, with many ties; ``a`` nullable int; ``rid`` the row."""
    rng = np.random.default_rng(seed)
    blk = Block.from_dict({
        "fe": column_from_numpy(rng.choice(FLOAT_EDGES, N), FLOAT64.with_nullable(),
                                validity=rng.random(N) > 0.15),
        "a": column_from_numpy(rng.integers(-2, 3, N), INT64.with_nullable(),
                               validity=rng.random(N) > 0.2),
        "rid": column_from_numpy(np.arange(N), INT64),
    })
    if with_sel:
        import jax.numpy as jnp

        blk = blk.with_sel(jnp.asarray(rng.random(N) > 0.25))
    return {"t": blk}, blocks_from_numpy(export_blocks({"t": blk}), "cpu")


@pytest.mark.parametrize("with_sel", [False, True], ids=["all_live", "sel"])
@pytest.mark.parametrize("keys", [[("fe",)], [("fe", True)], [("fe", True, True)],
                                  [("fe", False, False)], [("a",), ("fe", True)],
                                  [("fe",), ("a", True)]],
                         ids=lambda k: "-".join("_".join(map(str, x)) for x in k))
def test_sort_float_edge_keys_match_reference(keys, with_sel):
    """NaN, -0.0, 0.0 and +-inf keys (ROADMAP, section C item 3): the
    reference orders -0.0 and 0.0 as equal (ties by position) and every
    NaN last in both directions; the port's rows come out in the same
    order (``rid``), with the same selection."""
    j_tab, t_tab = _float_edge_tables(seed=len(keys) * 5 + int(with_sel), with_sel=with_sel)
    j_out = j_sort(j_tab["t"], [JKey(*k) for k in keys])
    t_out = t_sort(t_tab["t"], [TKey(*k) for k in keys])
    assert t_out.to_pylists()["rid"] == j_out.to_pylists()["rid"]
    assert torch.equal(t_out.sel, torch.as_tensor(np.array(j_out.sel)))
    fe = t_out.to_pylists()["fe"]
    assert any(v is not None and v != v for v in fe)  # NaN present
    assert any(v == 0.0 and str(v) == "-0.0" for v in fe if v is not None)
