"""The unique join's dense method (``ops/join.py``: ``join_method``,
``build_join_dense``, ``probe_join_dense``) on the CPU, where
``ops/cuda/join_probe.py`` takes its plain version.

Every output tensor of the dense path equals the sorted path's on the
same inputs (``torch.equal``: data, validity and selection of every
column, dead slots included; the matched flags and the overflow), with
the sorted path forced by taking the rule away.  The cases cover every
join kind (right and full outer through ``hash_join_with_tail``), int32,
int64 and DATE keys, NULL and dead rows on both sides, probe keys below
and above the build key's range (the int64 extremes among them) over a
negative ``lo``, duplicate build keys, both of ``take_sorted``'s plans
(a build smaller and larger than the probe), and payload columns of 1,
2, 4 and 8 bytes beside a 2-D wide decimal.  One case per kind is held
to the JAX package's ``hash_join_with_tail`` as ``test_torch_join.py``
holds the sorted path.  Then the rule itself: which joins take which
method.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
from tiflash_tpu.core.dtypes import (BOOL, DATE, INT16, INT32, INT64, STRING,
                                     Decimal)
from tiflash_tpu.ops import join as JJ

from tiflash_tpu_torch.core import dtypes as tdt
from tiflash_tpu_torch.core.block import Column
from tiflash_tpu_torch.ops import join as TJ
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

KINDS = ["inner", "left", "left_outer", "right_as_probe_outer", "semi", "anti",
         "anti_null_aware", "left_outer_semi", "left_outer_semi_null_aware",
         "right_outer", "full_outer"]
KEYS = {"int32": INT32, "int64": INT64, "date": DATE}
I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)


def _tables(seed, key="int64", n_probe=500, n_build=150, dup=False, lo=-40, span=300):
    """probe(pk, pv, ps) and build(bk + payloads): nullable keys, dead
    rows on both sides, build keys spanning exactly [lo, lo + span)."""
    rng = np.random.default_rng(seed)
    kdt = KEYS[key]
    np_t = np.int64 if key == "int64" else np.int32
    ext = I64 if key == "int64" else I32
    bkeys = (lo + np.concatenate([[0, span - 1], 1 + rng.permutation(span - 2)])[:n_build]
             ).astype(np_t)
    bnull = rng.random(n_build) < 0.1
    bnull[:2] = False
    bsel = rng.random(n_build) > 0.1
    if dup:  # a live duplicate pair
        bkeys[5] = bkeys[6]
        bnull[5:7] = False
        bsel[5:7] = True
    outside = np.array([lo - 1, lo - 7, lo + span, lo + span + 50, ext.min, ext.max,
                        ext.min + 1, ext.max - 1], dtype=np_t)
    absent = np.setdiff1d(np.arange(lo, lo + span), bkeys).astype(np_t)[:20]
    pkeys = rng.choice(np.concatenate([bkeys, bkeys, outside, absent]), n_probe)
    pnull = rng.random(n_probe) < 0.1
    words = [f"w{i:02d}" for i in range(30)]
    probe = JBlock.from_dict({
        "pk": column_from_numpy(pkeys, kdt.with_nullable(True), validity=~pnull),
        "pv": column_from_numpy(rng.integers(0, 1000, n_probe), INT32),
        "ps": column_from_numpy(rng.choice(words[:20], n_probe).tolist(), STRING),
    }).with_sel(jax.numpy.asarray(rng.random(n_probe) > 0.15))
    wide = [int(x) * 10 ** 20 + int(y) for x, y in zip(rng.integers(-10 ** 9, 10 ** 9, n_build),
                                                      rng.integers(0, 10 ** 18, n_build))]
    build = JBlock.from_dict({
        "bk": column_from_numpy(bkeys, kdt.with_nullable(True), validity=~bnull),
        "bv": column_from_numpy(rng.integers(-500, 500, n_build), INT64),
        "bi": column_from_numpy(rng.integers(-9, 9, n_build).astype(np.int32),
                                INT32.with_nullable(True),
                                validity=rng.random(n_build) > 0.2),
        "bh": column_from_numpy(rng.integers(-300, 300, n_build).astype(np.int16), INT16),
        "bb": column_from_numpy(rng.random(n_build) > 0.5, BOOL),
        "ps": column_from_numpy(rng.choice(words[10:], n_build).tolist(), STRING),
        "bw": column_from_numpy(wide, Decimal(38, 2)),
    }).with_sel(jax.numpy.asarray(bsel))
    j = {"probe": probe, "build": build}
    return j, blocks_from_numpy(export_blocks(j), "cpu")


def _join(t, kind, dense, monkeypatch):
    """``hash_join_with_tail`` on the unique path, the rule as it is
    (``dense``) or taken away; the method it took must be the one asked
    for."""
    pk, bk = [t["probe"]["pk"]], [t["build"]["bk"]]
    with monkeypatch.context() as m:
        if not dense:
            m.setattr(TJ, "dense_key_span", lambda *a: None)
        assert TJ.join_method(pk, bk, None) == ("dense" if dense else "sorted")
        return TJ.hash_join_with_tail(t["probe"], t["build"], ["pk"], ["bk"], kind, None)


def _same_tensor(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        assert a.dtype == b.dtype and torch.equal(a, b), what


def _assert_same(got, want):
    (gb, gx), (wb, wx) = got, want
    assert gb.names == wb.names
    _same_tensor(gb.sel, wb.sel, "sel")
    for name, g, w in zip(gb.names, gb.columns, wb.columns):
        _same_tensor(g.data, w.data, name)
        _same_tensor(g.validity, w.validity, name + " validity")
        assert (g.dtype, g.dictionary, g.stats) == (w.dtype, w.dictionary, w.stats), name
    _same_tensor(gx["matched_flags"], wx["matched_flags"], "matched_flags")
    _same_tensor(gx["overflow"], wx["overflow"], "overflow")
    assert bool(gx["build"].unique) is bool(wx["build"].unique)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key", sorted(KEYS))
@pytest.mark.parametrize("sizes", [(500, 150), (200, 260)], ids=["build_smaller",
                                                                  "build_larger"])
@pytest.mark.parametrize("dup", [False, True], ids=["unique", "dup_build"])
def test_dense_equals_sorted_tensor_for_tensor(kind, key, sizes, dup, monkeypatch):
    n_probe, n_build = sizes
    _, t = _tables(KINDS.index(kind) + 17 * n_build, key, n_probe, n_build, dup)
    got = _join(t, kind, True, monkeypatch)
    want = _join(t, kind, False, monkeypatch)
    _assert_same(got, want)
    if dup and kind in ("inner", "left", "left_outer", "right_as_probe_outer"):
        assert int(got[1]["overflow"]) == n_probe + 1
    if kind == "inner":  # not vacuous: rows matched, rows did not
        assert 0 < int(got[0].sel.sum()) < int(t["probe"].sel.sum())


@pytest.mark.parametrize("case", ["all_build_dead", "no_build_nulls", "one_build_row",
                                  "probe_without_sel"])
def test_dense_equals_sorted_at_the_edges(case, monkeypatch):
    _, t = _tables(3, "int32", 300, 120)
    if case == "all_build_dead":
        t["build"] = t["build"].with_sel(torch.zeros(120, dtype=torch.bool))
    elif case == "no_build_nulls":
        bk = t["build"]["bk"]
        t["build"] = t["build"].with_column("bk", dataclasses.replace(bk, validity=None))
    elif case == "one_build_row":
        b = t["build"]
        t["build"] = b.take(torch.tensor([1]))
    else:
        t["probe"] = t["probe"].with_sel(None)
    for kind in KINDS:
        _assert_same(_join(t, kind, True, monkeypatch), _join(t, kind, False, monkeypatch))


def _rows(block):
    return block.to_pylists(), [repr(c.dtype) for c in block.columns]


@pytest.mark.parametrize("kind", KINDS)
def test_dense_matches_the_reference(kind, monkeypatch):
    """The dense path's rows, types, flags and overflow against the JAX
    package's join on the same blocks (its probe is the sorted one)."""
    j, t = _tables(40 + KINDS.index(kind), "int64", 400, 120, dup=kind == "inner")

    def run(probe, build):
        out, x = JJ.hash_join_with_tail(probe, build, ["pk"], ["bk"], kind, None)
        return out, x["overflow"], x["matched_flags"]

    want, w_ovf, w_flags = jax.jit(run)(j["probe"], j["build"])
    got, x = _join(t, kind, True, monkeypatch)
    assert got.names == want.names
    assert _rows(got) == _rows(want)
    assert int(x["overflow"]) == int(w_ovf)
    np.testing.assert_array_equal(x["matched_flags"].numpy(), np.asarray(w_flags))


def _col(kind, cap, stats, dtype=torch.int32):
    """A column of ``cap`` rows (no storage behind them) with range stats:
    the rule reads only the kind, shape and stats."""
    return Column(torch.zeros(1, dtype=dtype).expand(cap), None, kind, stats=stats)


# (probe key, build key): SSB's dimensions and TPC-H's orders at SF10
DENSE = {
    "ssb_date": (_col(tdt.INT32, 64, None), _col(tdt.INT32, 2556, (19920101, 19981230))),
    "ssb_customer": (_col(tdt.INT32, 64, None), _col(tdt.INT32, 300_000, (1, 300_000))),
    "ssb_supplier": (_col(tdt.INT32, 64, None), _col(tdt.INT32, 20_000, (1, 20_000))),
    "ssb_part": (_col(tdt.INT32, 64, None), _col(tdt.INT32, 800_000, (1, 800_000))),
    "tpch_orders": (_col(tdt.INT64, 64, None, torch.int64),
                    _col(tdt.INT64, 15_000_000, (1, 60_000_000), torch.int64)),
    "date_kind": (_col(tdt.DATE, 64, None), _col(tdt.DATE, 2556, (8035, 10591))),
}
SORTED = {
    "no_stats": ([_col(tdt.INT32, 64, None)], [_col(tdt.INT32, 2556, None)]),
    "string_key": ([_col(tdt.STRING, 64, (0, 9))], [_col(tdt.STRING, 64, (0, 9))]),
    "packed_key": ([_col(tdt.INT16, 64, None, torch.int16)] * 2,
                   [_col(tdt.INT16, 2556, (1, 2556), torch.int16)] * 2),
    "span_over_2_26": ([_col(tdt.INT64, 64, None, torch.int64)],
                       [_col(tdt.INT64, 15_000_000, (0, 1 << 26), torch.int64)]),
    "span_over_16_per_row": ([_col(tdt.INT32, 64, None)],
                             [_col(tdt.INT32, 1000, (1, 16 * 1000 + (1 << 16) + 1))]),
    "float_key": ([_col(tdt.FLOAT64, 64, (0, 9), torch.float64)],
                  [_col(tdt.FLOAT64, 64, (0, 9), torch.float64)]),
    "uint_key": ([_col(tdt.UINT32, 64, None)], [_col(tdt.UINT32, 64, (0, 9))]),
}


@pytest.mark.parametrize("name", sorted(DENSE))
def test_the_rule_takes_dense(name):
    pc, bc = DENSE[name]
    lo, hi = bc.stats
    assert TJ.dense_key_span([pc], [bc]) == (lo, hi - lo + 1)
    assert TJ.join_method([pc], [bc], None) == "dense"
    assert TJ.join_method([pc], [bc], 4096) == "general"


@pytest.mark.parametrize("name", sorted(SORTED))
def test_the_rule_keeps_the_sorted_path(name):
    pcs, bcs = SORTED[name]
    assert TJ.dense_key_span(pcs, bcs) is None
    assert TJ.join_method(pcs, bcs, None) == "sorted"


def test_the_caps_are_inclusive():
    """A span of exactly 16 x capacity + 2^16 takes the table; 2^26 is
    the most any build takes."""
    pc = _col(tdt.INT32, 64, None)
    at = _col(tdt.INT32, 1000, (1, 16 * 1000 + (1 << 16)))
    assert TJ.join_method([pc], [at], None) == "dense"
    big = _col(tdt.INT64, 15_000_000, (0, (1 << 26) - 1), torch.int64)
    assert TJ.dense_key_span([pc], [big]) == (0, 1 << 26)
