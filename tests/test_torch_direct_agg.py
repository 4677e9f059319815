"""The direct_agg kernel's contract: the PyTorch port's ``direct_sums``
(plain torch on CPU tensors) against the JAX package's Pallas kernel in
interpret mode, on the same inputs made with numpy from a seed, and the
direct method's kernel branch and segment sub-method against the JAX
package's.  Tolerance zero: every output is an integer sum or count mod
2^64.

The largest domain (S = 4096 with 10 value columns, which the CUDA
wrapper splits into column groups) is held against ``np.add.at`` in
uint64 instead: the interpret-mode kernel's one-hot matrix would be
8,192 x 4,104 float32 per chunk.

The CUDA kernel runs only on a card: ``test_kernel_matches_plain`` is
marked ``cuda`` and skips elsewhere.  On the card (no jax there):
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_direct_agg.py``.
"""

import numpy as np
import pytest
import torch

from tiflash_tpu_torch.ops.cuda import direct_agg as TDA


def _case(n, S, n_vals, seed, null_frac=0.0, dead_frac=0.3, lo=-2 ** 52,
          hi=2 ** 52, oob_dead=False, all_dead=False, hot_frac=0.0):
    """slots int32, values int64 list, masks (bool or None) list, live;
    ``hot_frac`` of the rows in slot 7 (a skewed domain)."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S, n).astype(np.int32)
    if hot_frac:
        slots[rng.random(n) < hot_frac] = 7
    live = np.zeros(n, bool) if all_dead else rng.random(n) > dead_frac
    if oob_dead:  # dead rows may carry any slot, in range or not
        dead = np.flatnonzero(~live)
        slots[dead[::2]] = -7
        slots[dead[1::2]] = 10 ** 6
    vals = [rng.integers(lo, hi, n, dtype=np.int64) for _ in range(n_vals)]
    masks = [(rng.random(n) > null_frac) if null_frac else None for _ in range(n_vals)]
    return slots, vals, masks, live


def _port(slots, vals, masks, live, S, fn=TDA.direct_sums):
    t = torch.as_tensor
    return fn(t(slots), [t(v) for v in vals],
              [None if m is None else t(m) for m in masks], t(live), S)


def _reference(slots, vals, masks, live, S):
    import jax.numpy as jnp
    from tiflash_tpu.ops.pallas.direct_agg import direct_sums

    a = jnp.asarray
    return direct_sums(a(slots), [a(v) for v in vals],
                       [None if m is None else a(m) for m in masks], a(live), S,
                       interpret=True)


def _numpy(slots, vals, masks, live, S):
    """Sums mod 2^64 by np.add.at in uint64, as int64."""
    idx = np.where(live, slots, S)
    sums = []
    for v, m in zip(vals, masks):
        acc = np.zeros(S + 1, np.uint64)
        np.add.at(acc, idx, np.where(m, v, 0).view(np.uint64) if m is not None
                  else v.view(np.uint64))
        sums.append(acc[:S].view(np.int64))
    counts = np.bincount(idx, minlength=S + 1)[:S].astype(np.int64)
    nn = [counts if m is None else
          np.bincount(np.where(live & m, slots, S), minlength=S + 1)[:S]
          for m in masks]
    return np.stack(sums, 1) if sums else np.zeros((S, 0), np.int64), counts, nn


def _assert_same(got, want):
    gs, gc, gn = got
    ws, wc, wn = want
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert len(gn) == len(wn)
    for g, w in zip(gn, wn):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert gs.dtype == gc.dtype == torch.int64


CASES = {
    # tests/test_aggregate.py:170: negatives and 2^52 magnitudes, 5 slots
    "negative_large_s5": dict(n=3000, S=5, n_vals=1, seed=10, dead_frac=0.0),
    # Q7-pairs' domain: 26 x 26 slots, nullable values, dead rows
    "q7_domain_676": dict(n=6000, S=676, n_vals=2, seed=11, null_frac=0.2),
    # dead rows whose slots lie outside [0, S)
    "oob_slots_on_dead_rows": dict(n=5000, S=100, n_vals=1, seed=12, oob_dead=True),
    # values near +-2^62: per-slot sums wrap mod 2^64
    "wrapping_sums": dict(n=4000, S=3, n_vals=2, seed=13, lo=2 ** 62 - 2 ** 20,
                          hi=2 ** 62, dead_frac=0.0),
    "wrapping_negative": dict(n=4000, S=3, n_vals=1, seed=14, lo=-2 ** 62,
                              hi=-2 ** 62 + 2 ** 20, null_frac=0.1),
    "ragged_rows": dict(n=8192 + 77, S=70, n_vals=1, seed=15),
    "all_dead": dict(n=2000, S=80, n_vals=1, seed=16, all_dead=True),
    # 90% of the rows in one slot
    "skew_90pct_one_slot": dict(n=5000, S=676, n_vals=2, seed=17, hot_frac=0.9),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_reference_kernel(name):
    c = CASES[name]
    S = c["S"]
    inputs = _case(**{k: v for k, v in c.items() if k != "S"}, S=S)
    got = _port(*inputs, S)
    _assert_same(got, _reference(*inputs, S))
    if name.startswith("wrapping"):
        exact = [int(np.sum(inputs[1][0][(inputs[0] == s) & inputs[3]].astype(object)))
                 for s in range(S)]
        assert any(abs(x) >= 2 ** 63 for x in exact)  # the sums really wrap
    if name == "all_dead":
        assert not got[0].any() and not got[1].any()


def test_s4096_ten_columns_matches_numpy():
    """The largest domain with more columns than one block's shared
    memory holds: the CUDA wrapper splits them into column groups."""
    S = 4096
    inputs = _case(n=50_000, S=S, n_vals=10, seed=21, null_frac=0.0)
    _assert_same(_port(*inputs, S), _numpy(*inputs, S))
    assert TDA.column_groups(S, 11) == [(0, 7), (7, 11)]
    assert TDA.column_groups(676, 5) == [(0, 5)]
    with pytest.raises(ValueError):
        TDA.column_groups(30_000, 1)


def test_nullable_columns_match_numpy():
    S = 700
    inputs = _case(n=20_000, S=S, n_vals=3, seed=22, null_frac=0.3)
    _assert_same(_port(*inputs, S), _numpy(*inputs, S))


@pytest.mark.parametrize("hot_frac", [0.0, 0.9], ids=["spread", "skew_90pct"])
def test_value_list_equals_stacked(hot_frac):
    """group_sums with the value columns as a list equals the (K, n)
    stacked form, both against np.add.at."""
    S = 676
    slots, vals, masks, live = _case(n=20_000, S=S, n_vals=3, seed=23, hot_frac=hot_frac)
    idx = torch.as_tensor(np.where(live, slots, S).astype(np.int32))
    cols = [torch.as_tensor(v) for v in vals]
    as_list = TDA.group_sums(idx, cols, S, torch.zeros((S, 4), dtype=torch.int64))
    stacked = TDA.group_sums(idx, torch.stack(cols), S, torch.zeros((S, 4), dtype=torch.int64))
    assert torch.equal(as_list, stacked)
    sums, counts, _ = _numpy(slots, vals, [None] * 3, live, S)
    np.testing.assert_array_equal(as_list[:, :3].numpy(), sums)
    np.testing.assert_array_equal(as_list[:, 3].numpy(), counts)
    if hot_frac:
        assert counts[7] > counts.sum() * 0.85


def test_index_add_wraps_in_twos_complement():
    """The plain version relies on int64 ``index_add_`` wrapping mod 2^64."""
    big = 2 ** 62
    slots = torch.zeros(5, dtype=torch.int32)
    vals = torch.tensor([[big, big, big, big, -3]], dtype=torch.int64)
    out = TDA.group_sums_plain(slots, vals, 1, torch.zeros((1, 2), dtype=torch.int64))
    assert out.tolist() == [[(4 * big - 3 + 2 ** 63) % 2 ** 64 - 2 ** 63, 5]]
    assert out[0, 0].item() == -3


def test_group_sums_plain_drops_rows_outside_the_slots():
    slots = torch.tensor([0, 1, -7, 2, 10 ** 6, 1], dtype=torch.int32)
    vals = torch.tensor([[1, 2, 100, 3, 100, 4]], dtype=torch.int64)
    out = TDA.group_sums_plain(slots, vals, 3, torch.zeros((3, 2), dtype=torch.int64))
    assert out.tolist() == [[1, 1], [6, 2], [3, 1]]


def test_wrapper_raises_on_a_device_without_the_kernel():
    """No silent fallback: only CPU tensors take the plain version."""
    slots = torch.zeros(4, dtype=torch.int32, device="meta")
    vals = torch.zeros((1, 4), dtype=torch.int64, device="meta")
    out = torch.zeros((1, 2), dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="no direct_agg kernel"):
        TDA.group_sums(slots, vals, 1, out)


def test_wrapper_checks_shapes():
    with pytest.raises(ValueError):
        TDA.direct_sums(torch.zeros(4, dtype=torch.int32),
                        [torch.zeros(3, dtype=torch.int64)], [None],
                        torch.ones(4, dtype=torch.bool), 2)
    with pytest.raises(TypeError):
        TDA.group_sums(torch.zeros(4, dtype=torch.int64),
                       torch.zeros((1, 4), dtype=torch.int64), 2,
                       torch.zeros((2, 2), dtype=torch.int64))


# ---------------------------------------------------------------------------
# the direct method's kernel branch and segment sub-method
# ---------------------------------------------------------------------------


def _agg_blocks(seed, n=3000):
    """Two nullable 25-word string keys (domain 26 x 26 = 676), a nullable
    decimal, an int and a nullable int only counted; a selection."""
    import jax.numpy as jnp
    from tiflash_tpu.core.block import Block, column_from_numpy
    from tiflash_tpu.core.dtypes import INT64, STRING, Decimal

    from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
    from tiflash_tpu_torch.testing.bridge import export_blocks

    rng = np.random.default_rng(seed)
    words = [f"n{i:02d}" for i in range(25)]
    cols = {
        "a": column_from_numpy(rng.choice(words, n).tolist(), STRING,
                               validity=rng.random(n) > 0.05),
        "b": column_from_numpy(rng.choice(words, n).tolist(), STRING,
                               validity=rng.random(n) > 0.05),
        "v": column_from_numpy(rng.integers(-500, 500, n), Decimal(12, 2, True),
                               validity=rng.random(n) > 0.2),
        "w": column_from_numpy(rng.integers(-10 ** 12, 10 ** 12, n), INT64),
        "u": column_from_numpy(rng.integers(0, 9, n), INT64.with_nullable(True),
                               validity=rng.random(n) > 0.3),
    }
    jb = Block.from_dict(cols).with_sel(jnp.asarray(rng.random(n) < 0.7))
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


AGGS = [("sum", "v", "sv"), ("sum", "w", "sw"), ("count", None, "c"),
        ("count", "v", "cv"), ("avg", "v", "av"), ("avg", "w", "aw"),
        ("count", "u", "cu")]


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "segment"])
def test_aggregate_direct_matches_reference(use_kernel):
    from tiflash_tpu.ops.aggregate import (AggDesc as JAgg, aggregate_direct as j_direct,
                                           pack_keys_direct as j_pack)

    from tiflash_tpu_torch.ops.aggregate import (AggDesc as TAgg,
                                                 aggregate_direct as t_direct,
                                                 pack_keys_direct as t_pack)

    jb, tb = _agg_blocks(31)
    jp, tp = j_pack([jb["a"], jb["b"]]), t_pack([tb["a"], tb["b"]])
    assert jp[1] == tp[1] == 676
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
    j = j_direct(jb, ["a", "b"], [JAgg(*a) for a in AGGS], jp,
                 use_kernel=use_kernel, interpret=True)
    before = TDA.LAUNCHES
    t = t_direct(tb, ["a", "b"], [TAgg(*a) for a in AGGS], tp, use_kernel=use_kernel)
    assert TDA.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert t.block.names == j.block.names
    assert [repr(c.dtype) for c in t.block.columns] == \
        [repr(c.dtype) for c in j.block.columns]
    assert t.block.to_pylists() == j.block.to_pylists()
    assert int(t.num_groups) == int(j.num_groups) > 300


def test_default_choice_takes_the_kernel_branch(monkeypatch):
    """use_kernel=None: an eligible aggregation over 65..4096 slots takes
    the kernel branch; a filtered one the segment sub-method."""
    from tiflash_tpu_torch.ops import aggregate as TA

    _, tb = _agg_blocks(32)
    calls = []
    real = TDA.direct_sums

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(TDA, "direct_sums", spy)
    packed = TA.pack_keys_direct([tb["a"], tb["b"]])
    TA.aggregate_direct(tb, ["a", "b"], [TA.AggDesc(*a) for a in AGGS], packed)
    assert calls == [676]
    TA.aggregate_direct(tb, ["a", "b"], [TA.AggDesc("sum", "w", "s", "u")], packed)
    assert calls == [676]
    with pytest.raises(ValueError):
        TA.aggregate_direct(tb, ["a", "b"], [TA.AggDesc("sum", "w", "s", "u")],
                            packed, use_kernel=True)


@pytest.mark.cuda
def test_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the direct_agg kernel has no CPU form")
    for n, S, k, seed, hot in [(1_000_003, 676, 2, 0, 0.0), (300_001, 4096, 10, 1, 0.0),
                               (50_000, 65, 1, 2, 0.0), (1_000_003, 676, 3, 3, 0.9)]:
        slots, vals, masks, live = _case(n=n, S=S, n_vals=k, seed=seed,
                                         null_frac=0.2, oob_dead=True, hot_frac=hot)
        dev = [torch.as_tensor(x, device="cuda") for x in (slots, live)]
        vs = [torch.as_tensor(v, device="cuda") for v in vals]
        ms = [torch.as_tensor(m, device="cuda") for m in masks]
        before = TDA.LAUNCHES
        got = TDA.direct_sums(dev[0], vs, ms, dev[1], S)
        want = TDA.direct_sums_plain(dev[0], vs, ms, dev[1], S)
        torch.cuda.synchronize()
        assert TDA.LAUNCHES > before
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert all(torch.equal(g, w) for g, w in zip(got[2], want[2]))
        # group_sums itself, value columns as a list and stacked
        idx = torch.where(dev[1], dev[0], S)
        want_g = TDA.group_sums_plain(idx, vs, S, torch.zeros(
            (S, k + 1), dtype=torch.int64, device="cuda"))
        for form in (vs, torch.stack(vs)):
            assert torch.equal(TDA.group_sums(idx, form, S, torch.zeros_like(want_g)),
                               want_g)
    # raw slots outside [0, S) on rows the kernel itself must skip
    slots = torch.tensor([0, -7, 10 ** 6, 3, 4], dtype=torch.int32, device="cuda")
    vals = torch.arange(5, dtype=torch.int64, device="cuda").reshape(1, 5)
    got = TDA.group_sums(slots, vals, 4, torch.zeros((4, 2), dtype=torch.int64,
                                                     device="cuda"))
    assert got.tolist() == [[0, 1], [0, 0], [0, 0], [3, 1]]
