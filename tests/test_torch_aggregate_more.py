"""The aggregate functions of the analytic slice: the PyTorch port's
``hash_aggregate`` against the JAX package's, per aggregation method, on
the same blocks made with numpy from a seed.

first, quantile, var_pop/var_samp/stddev_pop/stddev_samp, bit_and/
bit_or/bit_xor (with a DATE argument, which MySQL takes as its number),
group_concat (plain, DISTINCT, filtered, over a nullable argument, with
an item cap) and approx_count_distinct (exact when grouped; the keyless
KMV estimate bit for bit, below and above its k = 4096) on the masked,
segment, sort, stream and keyless methods, with NULLs, dead rows and
-If filters.  Tolerance zero but for the variance moments, which are
float sums added in another order: ``FLOAT_REL`` relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.core.block import Block, column_from_numpy
from tiflash_tpu.ops import aggregate as JA
from tiflash_tpu.ops import sketch as JSk

from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.ops import sketch as TSk
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 1500
FLOAT_REL = 1e-12


def _block(seed, n=N, clustered=False):
    """g3 (3 strings, nullable: masked method), g100 (100 strings:
    segment), k (int64 with ties: sort; the port's copy has no range
    stats, which would give it a dense domain), st (strings, nullable, for
    group_concat), x (nullable int64), u (int32), f (nullable double), d
    (nullable decimal), dt (date), ok (bool filter); a selection."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 60, n)
    if clustered:
        k = np.sort(k)
    cols = {
        "g3": column_from_numpy(rng.choice(["a", "b", "c"], n).tolist(),
                                JD.STRING.with_nullable(True),
                                validity=rng.random(n) > 0.1),
        "g100": column_from_numpy(rng.choice([f"v{i:03d}" for i in range(100)],
                                             n).tolist(), JD.STRING),
        "k": column_from_numpy(k, JD.INT64),
        "st": column_from_numpy(rng.choice(["x", "yy", "z", "", "ww"], n).tolist(),
                                JD.STRING.with_nullable(True),
                                validity=rng.random(n) > 0.2),
        "x": column_from_numpy(rng.integers(-2 ** 40, 2 ** 40, n),
                               JD.INT64.with_nullable(True),
                               validity=rng.random(n) > 0.15),
        "u": column_from_numpy(rng.integers(-1000, 1000, n).astype(np.int32), JD.INT32),
        "f": column_from_numpy(rng.normal(50.0, 20.0, n), JD.FLOAT64.with_nullable(True),
                               validity=rng.random(n) > 0.1),
        "d": column_from_numpy(rng.integers(-10 ** 6, 10 ** 6, n),
                               JD.Decimal(12, 2, True), validity=rng.random(n) > 0.2),
        "dt": column_from_numpy((rng.integers(0, 4000, n) + 8000).astype(np.int32),
                                JD.DATE),
        "ok": column_from_numpy(rng.random(n) > 0.3, JD.BOOL),
    }
    jb = Block.from_dict(cols).with_sel(jnp.asarray(rng.random(n) > 0.1))
    if clustered:
        jb = dataclasses.replace(jb, clustered_by=("k",))
    tb = blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]
    tb = tb.with_column("k", dataclasses.replace(tb["k"], stats=None))
    if clustered:
        tb = dataclasses.replace(tb, clustered_by=("k",))
    return jb, tb


def _run_both(jb, tb, keys, aggs):
    j = jax.jit(lambda b: JA.hash_aggregate(b, keys, [JA.AggDesc(*a) for a in aggs]).block)(jb)
    t = TA.hash_aggregate(tb, keys, [TA.AggDesc(*a) for a in aggs]).block
    return j, t


def _assert_equal(j, t, floats=()):
    assert t.names == j.names
    assert [repr(c.dtype) for c in t.columns] == [repr(c.dtype) for c in j.columns]
    jr, tr = j.to_pylists(), t.to_pylists()
    for name in jr:
        if name not in floats:
            assert tr[name] == jr[name], name
            continue
        for a, b in zip(tr[name], jr[name]):
            assert (a is None) == (b is None), (name, a, b)
            assert b is None or abs(a - b) <= FLOAT_REL * abs(b), (name, a, b)


MOMENTS = [("var_pop", "f", "vp"), ("var_samp", "d", "vs"), ("stddev_pop", "x", "sp"),
           ("stddev_samp", "f", "ss", "ok")]
BITS = [("bit_and", "x", "ba"), ("bit_or", "u", "bo"), ("bit_xor", "dt", "bx"),
        ("bit_xor", "x", "bxf", "ok")]
FIRSTS = [("first", "x", "fx"), ("first", "st", "fs"), ("first", "d", "fd", "ok")]
QUANTILES = [("quantile", "x", "q50", None, 0.5), ("quantile", "f", "q10", None, 0.1),
             ("quantile", "d", "q90", "ok", 0.9)]

# (name, keys, aggregates, float outputs)
CASES = [
    ("masked_first_bits", ["g3"], FIRSTS + BITS + [("count", None, "c")], ()),
    ("masked_moments", ["g3"], MOMENTS, ("vp", "vs", "sp", "ss")),
    ("segment_quantile_moments", ["g100"], QUANTILES + MOMENTS[:2] + FIRSTS[:1],
     ("vp", "vs")),
    ("segment_bits_go_to_sort", ["g100"], BITS + [("sum", "x", "sx")], ()),
    ("sort_everything", ["k"], FIRSTS + BITS + QUANTILES[:1] + MOMENTS,
     ("vp", "vs", "sp", "ss")),
    ("sort_one_quantile_in_sort", ["k"], [("quantile", "u", "q", None, 0.3),
                                          ("count", None, "c")], ()),
    ("sort_two_keys", ["g3", "k"], QUANTILES + [("count_distinct", "u", "cd")], ()),
    ("keyless_masked", [], FIRSTS + BITS, ()),
    ("keyless_segment", [], QUANTILES + MOMENTS + [("count_distinct", "x", "cd")],
     ("vp", "vs", "sp", "ss")),
    ("approx_grouped_is_exact", ["g3"], [("approx_count_distinct", "u", "a"),
                                         ("approx_count_distinct", "x", "b", "ok")], ()),
    ("group_concat_plain", ["g3"], [("group_concat", "st", "gc")], ()),
    ("group_concat_distinct", ["k"], [("group_concat", "st", "gc", None, None, ";",
                                       True), ("sum", "u", "su")], ()),
    ("group_concat_filtered_capped", ["g100"], [("group_concat", "g3", "gc", "ok", 3,
                                                 "-"), ("group_concat", "g100", "g2")],
     ()),
]


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_new_aggregate_matches_reference(case):
    _, keys, aggs, floats = next(c for c in CASES if c[0] == case)
    jb, tb = _block(sorted(c[0] for c in CASES).index(case))
    j, t = _run_both(jb, tb, keys, aggs)
    _assert_equal(j, t, floats)


@pytest.mark.parametrize("aggs", [FIRSTS + QUANTILES + BITS, MOMENTS,
                                  [("sum", "f", "s"), ("avg", "f", "a"),
                                   ("count", "f", "c")]])
def test_stream_method_new_aggregates(aggs):
    """Keys the block is clustered on: the stream method (its batched form
    for sums, its general form for the rest)."""
    jb, tb = _block(21, clustered=True)
    calls = []
    real = TA.aggregate_stream
    TA.aggregate_stream = lambda *a: calls.append(1) or real(*a)
    try:
        j, t = _run_both(jb, tb, ["k"], aggs)
    finally:
        TA.aggregate_stream = real
    assert calls == [1]
    _assert_equal(j, t, ("vp", "vs", "sp", "ss", "s", "a"))


@pytest.mark.parametrize("n_distinct", [10, 3000, 9000])
def test_keyless_kmv_estimate_is_bit_for_bit(n_distinct):
    """Keyless approx_count_distinct: exact below k = 4096 distinct
    hashes, the KMV estimate above, both the reference's number."""
    rng = np.random.default_rng(n_distinct)
    n = 12000
    vals = rng.integers(0, n_distinct, n) * 7919 - 10 ** 6
    jb = Block.from_dict({
        "v": column_from_numpy(vals, JD.INT64.with_nullable(True),
                               validity=rng.random(n) > 0.05),
        "s": column_from_numpy(rng.choice([f"s{i}" for i in range(5000)], n).tolist(),
                               JD.STRING)}).with_sel(jnp.asarray(rng.random(n) > 0.05))
    tb = blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]
    aggs = [("approx_count_distinct", "v", "av"), ("approx_count_distinct", "s", "as"),
            ("count", None, "c")]
    j, t = _run_both(jb, tb, [], aggs)
    _assert_equal(j, t)
    est = t.to_pylists()["av"][0]
    live = np.asarray(jb.sel) & np.asarray(jb["v"].validity)
    exact = len(np.unique(vals[live]))
    if exact < 4096:
        assert est == exact
    else:
        assert abs(est - exact) < 0.1 * exact


def test_kmv_candidates_and_estimate_match_reference():
    import torch

    rng = np.random.default_rng(5)
    h = rng.integers(0, 2 ** 62, 20000)
    live = rng.random(20000) > 0.3
    for k in (16, 4096):
        jc = np.asarray(JSk.kmv_candidates(jnp.asarray(h), jnp.asarray(live), k))
        tc = TSk.kmv_candidates(torch.as_tensor(h), torch.as_tensor(live), k)
        assert tc.tolist() == jc.tolist()
        assert int(TSk.kmv_estimate(tc)) == int(JSk.kmv_estimate(jnp.asarray(jc)))


def test_distributed_forms_raise_naming_their_slice():
    """The sketch's distributed stages run (they raised before the
    distribution slice): ``approx_cd_partial`` emits the reference's k
    candidate rows, and ``approx_cd_final`` over them (and over the
    concatenation of two shards' candidates) gives the reference's
    estimate."""
    jb, tb = _block(3)
    for k in (None, 64.0):
        part = [TA.AggDesc("approx_cd_partial", "x", "a", param=k),
                TA.AggDesc("approx_cd_partial", "u", "b", param=k)]
        jpart = [JA.AggDesc("approx_cd_partial", "x", "a", param=k),
                 JA.AggDesc("approx_cd_partial", "u", "b", param=k)]
        got = TA.hash_aggregate(tb, [], part)
        want = JA.hash_aggregate(jb, [], jpart)
        assert got.block.to_pylists() == want.block.to_pylists()
        assert int(got.num_groups) == int(want.num_groups)
        halves = [tb.and_sel(torch.arange(tb.capacity) % 2 == i) for i in (0, 1)]
        from tiflash_tpu_torch.exchange.skew import concat_blocks

        cands = concat_blocks(*[TA.hash_aggregate(h, [], part).block for h in halves])
        jcands = JA.hash_aggregate(jb, [], jpart).block
        final = [TA.AggDesc("approx_cd_final", "a", "a", param=k)]
        jfinal = [JA.AggDesc("approx_cd_final", "a", "a", param=k)]
        est = TA.hash_aggregate(cands, [], final).block.to_pylists()
        assert est == TA.hash_aggregate(got.block, [], final).block.to_pylists()
        assert est == JA.hash_aggregate(jcands, [], jfinal).block.to_pylists()
