"""The position table's probe-and-gather (``ops/cuda/join_probe.py``):
its plain version against a row-by-row numpy reading of the contract,
the wrapper's checks, and, on the card, the CUDA kernel
(``csrc/join_probe.cu``) against the plain version, every output tensor
exact.

The card test is marked ``cuda`` and skips elsewhere.  On the card (no
jax there):
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_join_probe.py``.
"""

import numpy as np
import pytest
import torch

from tiflash_tpu_torch.ops.cuda import join_probe as JP

WIDTHS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _inputs(seed, n, span, m, lo, key_dtype=torch.int32, widths=(1, 4, 8), masks=True,
            device="cpu"):
    """Probe keys over and around [lo, lo + span), a table of ``span``
    entries holding ``m`` build positions, a permutation and payload
    columns of the given widths (every other one with a validity)."""
    rng = np.random.default_rng(seed)
    live_keys = rng.choice(span, size=min(m, span), replace=False)
    table = np.full(span, -1, dtype=np.int32)
    table[live_keys] = rng.permutation(m)[:len(live_keys)]
    keys = lo + rng.integers(-span // 8 - 2, span + span // 8 + 2, n)
    perm = rng.permutation(m).astype(np.int32)
    cols = []
    for i, w in enumerate(widths):
        data = rng.integers(-2 ** (8 * w - 2), 2 ** (8 * w - 2), m)
        data = data.astype({1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}[w])
        valid = rng.random(m) > 0.3 if i % 2 else None
        cols.append((torch.as_tensor(data, device=device),
                     None if valid is None else torch.as_tensor(valid, device=device)))

    def put(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=device)

    key_valid = put(rng.random(n) > 0.1) if masks else None
    sel = put(rng.random(n) > 0.2) if masks else None
    return (put(keys, key_dtype), key_valid, sel, put(table), lo, put(perm), cols)


def _numpy_reading(keys, key_valid, sel, table, lo, perm, gather_sorted, cols):
    """The contract, one slot at a time."""
    n, m, span = len(keys), len(perm), len(table)
    matched = np.zeros(n, dtype=bool)
    bidx = np.full(n, -1, dtype=np.int32)
    flags = np.zeros(m, dtype=bool)
    outs = [(np.empty(n, dtype=d.dtype), np.empty(n, dtype=bool)) for d, _ in cols]
    for i in range(n):
        k = int(keys[i])
        live = (sel is None or sel[i]) and (key_valid is None or key_valid[i])
        p = int(table[k - lo]) if live and lo <= k < lo + span else -1
        matched[i] = p >= 0
        bidx[i] = p
        if p >= 0:
            flags[p] = True
        row = int(perm[p]) if p >= 0 else (int(perm[0]) if gather_sorted else 0)
        for (d, v), (od, ov) in zip(cols, outs):
            od[i] = d[row]
            ov[i] = p >= 0 and (v is None or bool(v[row]))
    return matched, bidx, flags, outs


def _np(t):
    return None if t is None else t.cpu().numpy()


@pytest.mark.parametrize("gather_sorted", [False, True], ids=["by_row", "by_sorted_row"])
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("masks", [True, False], ids=["masks", "no_masks"])
def test_plain_follows_the_contract_row_by_row(gather_sorted, key_dtype, masks):
    keys, kv, sel, table, lo, perm, cols = _inputs(5, 700, 300, 120, -37, key_dtype,
                                                   widths=(1, 2, 4, 8), masks=masks)
    matched, bidx, flags, outs = JP.join_probe(keys, kv, sel, table, lo, perm,
                                               gather_sorted, cols, want_bidx=True)
    want = _numpy_reading(_np(keys), _np(kv), _np(sel), _np(table), lo, _np(perm),
                          gather_sorted, [(_np(d), _np(v)) for d, v in cols])
    np.testing.assert_array_equal(matched.numpy(), want[0])
    np.testing.assert_array_equal(bidx.numpy(), want[1])
    np.testing.assert_array_equal(flags.numpy(), want[2])
    assert 0 < int(matched.sum()) < 700
    for (od, ov), (wd, wv), (d, _) in zip(outs, want[3], cols):
        assert od.dtype == d.dtype and ov.dtype == torch.bool
        np.testing.assert_array_equal(od.numpy(), wd)
        np.testing.assert_array_equal(ov.numpy(), wv)
    assert JP.join_probe(keys, kv, sel, table, lo, perm, gather_sorted, cols,
                         want_bidx=False)[1] is None


def test_keys_at_the_int64_extremes_never_wrap_into_the_table():
    lo = 2 ** 62
    table = torch.tensor([0, -1, 1], dtype=torch.int32)
    keys = torch.tensor([-2 ** 63, 2 ** 63 - 1, lo, lo + 2, lo + 3, lo - 1, -2 ** 63 + lo],
                        dtype=torch.int64)
    matched, bidx, flags, _ = JP.join_probe(keys, None, None, table, lo,
                                            torch.tensor([1, 0], dtype=torch.int32),
                                            False, [], want_bidx=True)
    assert matched.tolist() == [False, False, True, True, False, False, False]
    assert bidx.tolist() == [-1, -1, 0, 1, -1, -1, -1]
    assert flags.tolist() == [True, True]


def test_wrapper_checks_its_inputs():
    keys, kv, sel, table, lo, perm, cols = _inputs(1, 50, 40, 10, 0)
    with pytest.raises(TypeError, match="int32 or int64"):
        JP.join_probe(keys.to(torch.int16), kv, sel, table, lo, perm, False, cols, False)
    with pytest.raises(ValueError, match="bool"):
        JP.join_probe(keys, kv[:5], sel, table, lo, perm, False, cols, False)
    with pytest.raises(ValueError, match="non-empty"):
        JP.join_probe(keys, kv, sel, table[:0], lo, perm, False, cols, False)
    with pytest.raises(ValueError, match="1-D"):
        JP.join_probe(keys, kv, sel, table, lo, perm, False,
                      [(torch.zeros(10, 2, dtype=torch.int64), None)], False)


def test_wrapper_raises_on_a_device_without_the_kernel():
    keys, kv, sel, table, lo, perm, cols = _inputs(2, 50, 40, 10, 0, device="meta")
    with pytest.raises(RuntimeError, match="no join_probe kernel"):
        JP.join_probe(keys, kv, sel, table, lo, perm, False, cols, False)


def test_probe_bytes_counts_the_probe_side():
    # SSB's date join: int32 key, a selection, two 4-byte payload columns
    assert JP.probe_bytes(60_010_680, 4, True, False, [4, 4]) == 60_010_680 * 16
    assert JP.probe_bytes(10, 8, False, True, []) == 10 * 10


@pytest.mark.cuda
def test_kernel_matches_plain():
    """Random probes of up to 2^20 slots against tables of SSB's date
    span, customer's and 2^22 entries; payloads of 1, 2, 4 and 8 bytes;
    int32 and int64 keys, with and without masks, both unmatched rows;
    more columns than one launch carries; an empty probe."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(1, 1 << 20, 61_130, 2556, 19920101, torch.int32, (4, 4), True, False),
             (2, 1 << 20, 300_000, 60_000, 1, torch.int32, (1, 2, 4, 8), True, True),
             (3, 777_777, 1 << 22, 3_000_000, -(1 << 21), torch.int64, (8, 1, 4), False, True),
             (4, 100_003, 61_130, 2556, 19920101, torch.int64, (1,) * 40, True, False),
             (5, 0, 1000, 10, 0, torch.int32, (4,), True, True)]
    for seed, n, span, m, lo, kdt, widths, masks, gather_sorted in cases:
        args = _inputs(seed, n, span, m, lo, kdt, widths, masks, device="cuda")
        l0 = JP.LAUNCHES
        got = JP.join_probe(*args[:6], gather_sorted, args[6], want_bidx=True)
        torch.cuda.synchronize()
        assert JP.LAUNCHES - l0 == (0 if n == 0 else -(-len(widths) // JP.MAX_COLUMNS))
        want = JP.join_probe_plain(*args[:6], gather_sorted, args[6], want_bidx=True)
        for g, w, what in zip(got[:3], want[:3], ("matched", "bidx", "flags")):
            assert g.dtype == w.dtype and torch.equal(g, w), (seed, what)
        for c, ((gd, gv), (wd, wv)) in enumerate(zip(got[3], want[3])):
            assert gd.dtype == wd.dtype and torch.equal(gd, wd), (seed, c)
            assert torch.equal(gv, wv), (seed, c)
        if n:
            assert 0 < int(got[0].sum()) < n
