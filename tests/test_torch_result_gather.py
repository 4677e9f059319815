"""``Block.to_pylists`` gathers a block's live rows on its own device
before anything is copied to the host.  For every column kind its answer
equals the decode that copies each column whole and drops dead rows on
the host (``Column.to_pylist`` with the numpy mask), row order, NULLs,
raw decimal mantissas, vectors and group_concat strings included; and
no column handed to ``Column.to_pylist`` holds a dead slot."""

import numpy as np
import pytest
import torch

from tiflash_tpu_torch.core import dtypes as dt
from tiflash_tpu_torch.core.block import Block, Column, column_from_numpy

N = 40


def _kinds():
    """One column of each kind, ``N`` rows, from a fixed seed."""
    rng = np.random.default_rng(18)
    nulls = rng.random(N) > 0.3
    words = [None if rng.random() < 0.25 else str(rng.choice(["ab", "c", "", "zz"]))
             for _ in range(N)]
    floats = rng.normal(size=N)
    floats[::7] = np.nan
    floats[3] = -np.inf
    wide = [int(x) * 10 ** 20 + int(y) for x, y in
            zip(rng.integers(-10 ** 9, 10 ** 9, N), rng.integers(0, 10 ** 18, N))]
    items = 3
    return {
        "int64": Column(torch.as_tensor(rng.integers(-2 ** 62, 2 ** 62, N)),
                        dtype=dt.INT64),
        "nullable_int32": Column(
            torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, N, dtype=np.int32)),
            torch.as_tensor(nulls), dtype=dt.INT32.with_nullable()),
        "uint64_high": Column(
            torch.as_tensor(rng.integers(2 ** 63, 2 ** 64, N, dtype=np.uint64)),
            dtype=dt.UINT64),
        "dict_string_nulls": column_from_numpy(words, dt.STRING.with_nullable(),
                                               device="cpu"),
        "narrow_decimal": Column(torch.as_tensor(rng.integers(-10 ** 11, 10 ** 11, N)),
                                 dtype=dt.Decimal(12, 2)),
        "wide_decimal": column_from_numpy(wide, dt.Decimal(38, 2, nullable=True),
                                          validity=nulls.tolist(), device="cpu"),
        "float64_nan": Column(torch.as_tensor(floats), dtype=dt.FLOAT64),
        "vector": Column(torch.as_tensor(rng.normal(size=(N, 4)).astype(np.float32)),
                         torch.as_tensor(nulls[::-1].copy()),
                         dtype=dt.Vector(4, nullable=True)),
        "group_concat": Column(
            torch.as_tensor(rng.integers(0, 3, (N, items), dtype=np.int32)),
            torch.as_tensor(rng.random((N, items)) > 0.4),
            dtype=dt.STRING.with_nullable(), dictionary=("x", "yy", "z"),
            concat_sep=","),
    }


def _old_decode(blk):
    """Whole columns to the host, dead rows dropped there."""
    sel = None if blk.sel is None else blk.sel.cpu().numpy()
    return {n: c.to_pylist(sel) for n, c in zip(blk.names, blk.columns)}


def _same(got, want):
    # repr compares floats exactly and NaN equal to NaN
    assert list(got) == list(want)
    for n in want:
        assert repr(got[n]) == repr(want[n]), n


KINDS = list(_kinds())


@pytest.mark.parametrize("case", KINDS + ["no_live_rows", "all_live", "no_sel"])
def test_to_pylists_equals_the_host_side_decode(case, monkeypatch):
    cols = _kinds()
    rng = np.random.default_rng(7)
    sel = torch.as_tensor(rng.random(N) > 0.6)
    if case in KINDS:
        blk = Block.from_dict({case: cols[case]}, sel=sel)
    else:
        sel = {"no_live_rows": torch.zeros(N, dtype=torch.bool),
               "all_live": torch.ones(N, dtype=torch.bool), "no_sel": None}[case]
        blk = Block.from_dict(cols, sel=sel)
    if sel is None:
        monkeypatch.setattr(torch, "nonzero", lambda *a, **k: pytest.fail("gathered"))
    got = blk.to_pylists()
    _same(got, _old_decode(blk))
    live = N if sel is None else int(sel.sum())
    assert all(len(v) == live for v in got.values())
    if case in KINDS:
        assert 0 < live < N


def test_dead_slots_never_reach_the_host(monkeypatch):
    n = 1_000_000
    live = [5, 499_999, 999_998]
    sel = torch.zeros(n, dtype=torch.bool)
    sel[live] = True
    ints = torch.arange(n, dtype=torch.int64) * 3 - 7
    valid = torch.ones(n, dtype=torch.bool)
    valid[499_999] = False
    limbs = torch.stack([torch.arange(n, dtype=torch.int64) - n // 2,
                         torch.arange(n, dtype=torch.int64) * 11], dim=1)
    blk = Block.from_dict({
        "i": Column(ints, dtype=dt.INT64),
        "n": Column(ints.to(torch.int32), valid, dtype=dt.INT32.with_nullable()),
        "s": Column((torch.arange(n) % 3).to(torch.int32), dtype=dt.STRING,
                    dictionary=("a", "b", "c")),
        "w": Column(limbs, dtype=dt.Decimal(38, 4)),
    }, sel=sel)
    want = _old_decode(blk)

    seen = []
    decode = Column.to_pylist

    def spy(col, sel=None):
        seen.append((col.capacity, sel))
        return decode(col, sel)

    monkeypatch.setattr(Column, "to_pylist", spy)
    got = blk.to_pylists()
    assert seen == [(3, None)] * 4
    _same(got, want)
    assert got["n"] == [8, None, 2_999_987]
    assert got["s"] == ["c", "b", "c"]
