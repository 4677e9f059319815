"""The stream-agg kernel's contract: the PyTorch port's
``stream_group_sums`` (plain torch on CPU tensors) against the JAX
package's Pallas kernel in interpret mode, on the same tile function and
the same inputs made with numpy from a seed.  Tolerance zero: the sums
are integers.

The CUDA kernel itself runs only on a card: ``test_kernel_matches_plain``
is marked ``cuda`` and skips elsewhere.  The JAX package is imported
inside the tests that use it, so on a machine without jax the card test
runs alone:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stream_agg.py``.
"""

import numpy as np
import pytest
import torch

from tiflash_tpu_torch.ops.cuda import stream_agg as TSA

PACKED = [[(0, 14, 0), (14, 15, 1)], [(0, 30, 2)]]


def _inputs(n, S, seed, all_dead=False):
    rng = np.random.default_rng(seed)
    live = np.zeros(n, np.int32) if all_dead else (rng.random(n) > 0.2).astype(np.int32)
    return {
        "k": rng.integers(0, S, n).astype(np.int32),
        "live": live,
        "a": rng.integers(0, 256, n).astype(np.int32),
        "b": rng.integers(0, 512, n).astype(np.int32),
        "c": rng.integers(0, 1 << 24, n).astype(np.int32),
    }


def _jax_tile(S, packed):
    import jax.numpy as jnp

    def mtv(tile, in_bounds):
        live = in_bounds & (tile["live"] != jnp.int32(0))
        slot = jnp.where(live, tile["k"], jnp.int32(S))
        if packed:
            return slot, [tile["a"] + (tile["b"] << jnp.int32(14)), tile["c"]]
        return slot, [tile["a"], tile["c"]]

    return mtv


def _torch_tile(S, packed):
    def mtv(tile, in_bounds):
        live = in_bounds & (tile["live"] != 0)
        slot = torch.where(live, tile["k"], torch.full_like(tile["k"], S))
        if packed:
            return slot, [tile["a"] + (tile["b"] << 14), tile["c"]]
        return slot, [tile["a"], tile["c"]]

    return mtv


def _both(n, S, packed, seed, all_dead=False, headroom=0):
    import jax.numpy as jnp
    from tiflash_tpu.ops.pallas import stream_agg as JSA

    host = _inputs(n, S, seed, all_dead)
    pf = PACKED if packed else None
    want = JSA.stream_group_sums(
        {k: jnp.asarray(v) for k, v in host.items()}, _jax_tile(S, packed),
        S, 2, n, interpret=True, plane_fields=pf)
    got = TSA.stream_group_sums(
        {k: torch.as_tensor(v) for k, v in host.items()}, _torch_tile(S, packed),
        S, 2, n, plane_fields=pf, headroom=headroom)
    return got, np.asarray(want)


SHAPES = [
    (3 * 8192 + 77, 5, True, False),    # ragged row count
    (20_000, 5, True, True),            # every row dead
    (12_345, 1, True, False),           # keyless: one slot
    (9_001, 7, False, False),           # one field per plane
]


@pytest.mark.parametrize("n,S,packed,all_dead", SHAPES)
def test_plain_matches_reference_kernel(n, S, packed, all_dead):
    got, want = _both(n, S, packed, seed=n, all_dead=all_dead)
    assert got.dtype == torch.int64 and want.dtype == np.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if all_dead:
        assert not got.any()


@pytest.mark.parametrize("n,S,packed,all_dead", SHAPES)
def test_plane_list_matches_stacked_and_reference(n, S, packed, all_dead):
    """group_sums_plain with the planes as a list equals the stacked form
    and the JAX kernel in interpret mode, on the tile function's planes."""
    host = _inputs(n, S, n + 1, all_dead)
    inputs = {k: torch.as_tensor(v) for k, v in host.items()}
    slots, planes = _torch_tile(S, packed)(inputs, torch.ones(n, dtype=torch.bool))
    fields = TSA.field_table(PACKED if packed else None, 2)
    as_list = TSA.group_sums_plain(slots, list(planes), fields, S,
                                   torch.zeros((S, len(fields)), dtype=torch.int64))
    stacked = TSA.group_sums_plain(slots, torch.stack(planes), fields, S,
                                   torch.zeros((S, len(fields)), dtype=torch.int64))
    assert torch.equal(as_list, stacked)
    _, want = _both(n, S, packed, seed=n + 1, all_dead=all_dead)
    np.testing.assert_array_equal(as_list.numpy(), want)


@pytest.mark.parametrize("n,S", [(3 * 8192 + 77, 5), (12_345, 1)])
def test_headroom_matches_reference_kernel(n, S):
    """PACKED keeps 6 bits clear above each field's values (a < 2^8 in 14
    bits, b < 2^9 in 15, c < 2^24 in 30): the headroom path is the
    reference's own accumulation."""
    got, want = _both(n, S, True, seed=n + 2, headroom=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_multi_chunk_matches_reference_flushes(monkeypatch):
    """Three grid steps with a flush after each on the JAX side; 16384-row
    chunks of the tile function on the port's side."""
    from tiflash_tpu.ops.pallas import stream_agg as JSA

    monkeypatch.setattr(JSA, "FLUSH_TILES", 2)
    monkeypatch.setattr(JSA, "FLUSH_STEPS", 1)
    monkeypatch.setattr(TSA, "CHUNK_ROWS", 16384)
    got, want = _both(3 * JSA.STEP_ROWS - 5, 6, True, seed=11)
    np.testing.assert_array_equal(got.numpy(), want)


def test_group_sums_plain_drops_rows_outside_the_slots():
    slots = torch.tensor([0, 1, -1, 2, 5, 1], dtype=torch.int32)
    planes = torch.tensor([[1, 2, 100, 3, 100, 4],
                           [(7 << 10) | 1, 2, -1, 3, -1, 4]], dtype=torch.int32)
    fields = TSA.field_table([[(0, 31, 0)], [(0, 10, 2), (10, 5, 1)]], 2)
    out = TSA.group_sums_plain(slots, planes, fields, 3,
                               torch.zeros((3, 3), dtype=torch.int64))
    assert out.tolist() == [[1, 7, 1], [6, 0, 6], [3, 0, 3]]


def test_group_sums_rejects_a_field_outside_the_planes():
    slots = torch.zeros(4, dtype=torch.int32)
    planes = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        TSA.group_sums(slots, planes, [(2, 0, 31, 0)], 1,
                       torch.zeros((1, 1), dtype=torch.int64))


def test_field_table_rejects_fields_past_int31():
    with pytest.raises(ValueError):
        TSA.field_table([[(0, 20, 0), (20, 12, 1)]], 1)
    with pytest.raises(ValueError):
        TSA.field_table([[(0, 10, 0)], [(0, 10, 2)]], 2)
    assert TSA.field_table(None, 2) == [(0, 0, 31, 0), (1, 0, 31, 1)]


def test_wrapper_raises_on_a_device_without_the_kernel():
    """No silent fallback: only CPU tensors take the plain version."""
    slots = torch.zeros(4, dtype=torch.int32, device="meta")
    planes = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    fields = [(0, 0, 31, 0)]
    out = torch.zeros((1, 1), dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="no stream_agg kernel"):
        TSA.group_sums(slots, planes, fields, 1, out)


@pytest.mark.cuda
def test_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream_agg kernel has no CPU form")
    g = torch.Generator(device="cuda").manual_seed(0)
    n, S = 1_000_003, 6
    slots = torch.randint(-1, S + 2, (n,), generator=g, device="cuda", dtype=torch.int32)
    planes = torch.randint(0, 2 ** 31 - 1, (2, n), generator=g, device="cuda",
                           dtype=torch.int32)
    fields = TSA.field_table(PACKED, 2)
    before = TSA.LAUNCHES
    got = TSA.group_sums(slots, planes, fields, S,
                         torch.zeros((S, 3), dtype=torch.int64, device="cuda"))
    want = TSA.group_sums_plain(slots, planes, fields, S, torch.zeros_like(got))
    torch.cuda.synchronize()
    assert TSA.LAUNCHES == before + 1
    assert torch.equal(got, want)
    # the whole contract, tile function included, with and without headroom
    host = _inputs(50_001, S, seed=4)
    inputs = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
    tile = _torch_tile(S, True)
    for h in (0, 6):
        got = TSA.stream_group_sums(inputs, tile, S, 2, 50_001, plane_fields=PACKED,
                                    headroom=h)
        want = TSA.stream_group_sums_plain(inputs, tile, S, 2, 50_001,
                                           plane_fields=PACKED, headroom=h)
        assert torch.equal(got, want)
    # the headroom path: planes as a list, at an odd-row base (scalar head,
    # then 16-byte quads), with phases that differ (scalar path), in
    # registers (S=6) and in shared memory (S=64, S x L = 192)
    layout64 = [[(0, 12, 0), (12, 19, 1)], [(0, 31, 2)],
                [(0, 10, 3), (10, 10, 4), (20, 11, 5)]]
    for S, layout in ((6, PACKED), (64, layout64)):
        m = 700_003
        slots = torch.randint(-1, S + 1, (m + 1,), generator=g, device="cuda",
                              dtype=torch.int32)
        planes = []
        for fs in layout:
            p = torch.zeros(m + 1, dtype=torch.int32, device="cuda")
            for off, cap, _ in fs:
                p |= torch.randint(0, 2 ** (cap - 6), (m + 1,), generator=g,
                                   device="cuda", dtype=torch.int32) << off
            planes.append(p)
        fields = TSA.field_table(layout, len(layout))
        for sl, pl in ((slots, planes), (slots[1:], [p[1:] for p in planes]),
                       (slots[1:], [p[:m] for p in planes])):
            got = TSA.group_sums(sl, pl, fields, S, torch.zeros(
                (S, len(fields)), dtype=torch.int64, device="cuda"), 6)
            want = TSA.group_sums_plain(sl, pl, fields, S, torch.zeros_like(got), 6)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
