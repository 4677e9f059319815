"""What the two CUDA kernels assume, checked without a card: the packed
headroom that stream_agg adds whole planes under, the launch planning of
both kernels (plain Python), and the plain versions on planes and value
columns passed as lists.  Tolerance zero: every output is an integer sum.
"""

import numpy as np
import pytest
import torch

from tiflash_tpu_torch.ops import stream_fuse as TSF
from tiflash_tpu_torch.ops.cuda import direct_agg as TDA
from tiflash_tpu_torch.ops.cuda import stream_agg as TSA

# ---------------------------------------------------------------------------
# the fuse's layouts honor the headroom
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan_name,slots,planes,fields", [
    ("q1_plan", 6, 6, 8),
    ("q6_plan", 1, 2, 3),
])
def test_fuse_layouts_honor_the_headroom(plan_name, slots, planes, fields):
    """Every packed field's largest value (from the parts' ``hi``) is
    below 2^(cap - FIELD_GROWTH_BITS), and the run's live values obey it
    (the plain version raises otherwise)."""
    from tiflash_tpu_torch.bench import tpch_queries as TQ
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    cat = generate_tpch(sf=0.002, seed=0, tables=["lineitem"])
    before = TSF.FUSE_STATS["count"]
    run_query(getattr(TQ, plan_name)(), cat.blocks("cpu"))
    assert TSF.FUSE_STATS["count"] == before + 1
    pf, his = TSF.FUSE_STATS["plane_fields"], TSF.FUSE_STATS["field_hi"]
    assert (TSF.FUSE_STATS["slots"], len(pf), len(his)) == (slots, planes, fields)
    h = TSF.FIELD_GROWTH_BITS
    for plane in pf:
        for off, cap, oi in plane:
            assert his[oi] < 1 << (cap - h), (plan_name, off, cap, his[oi])
    plan = TSA.plan_launch(slots, planes, fields, h)
    assert plan.regime == "registers" and plan.vector


# ---------------------------------------------------------------------------
# the plain version guards the headroom
# ---------------------------------------------------------------------------

LAYOUT = [[(0, 10, 0), (10, 12, 1)], [(0, 31, 2)]]


def _headroom_planes(rng, n, h):
    a = rng.integers(0, 1 << (10 - h), n)
    b = rng.integers(0, 1 << (12 - h), n)
    c = rng.integers(0, 1 << (31 - h), n)
    return [torch.as_tensor((a | (b << 10)).astype(np.int32)),
            torch.as_tensor(c.astype(np.int32))]


def test_planted_violation_raises():
    rng = np.random.default_rng(0)
    n, S = 1000, 5
    slots = torch.as_tensor(rng.integers(-1, S + 1, n).astype(np.int32))
    planes = _headroom_planes(rng, n, 6)
    fields = TSA.field_table(LAYOUT, 2)
    ok = TSA.group_sums(slots, planes, fields, S,
                        torch.zeros((S, 3), dtype=torch.int64), headroom=6)
    live = int(torch.nonzero((slots >= 0) & (slots < S))[0])
    dead = int(torch.nonzero((slots < 0) | (slots >= S))[0])
    # a dead row may break it: dead rows add nothing
    bad = [p.clone() for p in planes]
    bad[0][dead] |= 1 << 9
    again = TSA.group_sums(slots, bad, fields, S,
                           torch.zeros((S, 3), dtype=torch.int64), headroom=6)
    assert torch.equal(ok, again)
    # a live row may not: field (0, 10) keeps its top 6 bits clear
    bad[0][live] |= 1 << 9
    with pytest.raises(ValueError, match="headroom"):
        TSA.group_sums(slots, bad, fields, S, torch.zeros((S, 3), dtype=torch.int64),
                       headroom=6)
    # the same planes without a stated headroom are fine
    TSA.group_sums(slots, bad, fields, S, torch.zeros((S, 3), dtype=torch.int64))


def test_headroom_not_below_a_field_capacity():
    with pytest.raises(ValueError, match="capacity"):
        TSA.group_sums(torch.zeros(4, dtype=torch.int32),
                       [torch.zeros(4, dtype=torch.int32)], [(0, 0, 6, 0)], 1,
                       torch.zeros((1, 1), dtype=torch.int64), headroom=6)


@pytest.mark.parametrize("h", [0, 3, 6])
def test_plane_list_equals_stacked(h):
    rng = np.random.default_rng(h)
    n, S = 5003, 7
    slots = torch.as_tensor(rng.integers(-2, S + 2, n).astype(np.int32))
    planes = _headroom_planes(rng, n, 6)
    fields = TSA.field_table(LAYOUT, 2)
    got = TSA.group_sums(slots, planes, fields, S, torch.zeros((S, 3), dtype=torch.int64), h)
    want = TSA.group_sums(slots, torch.stack(planes), fields, S,
                          torch.zeros((S, 3), dtype=torch.int64), h)
    assert torch.equal(got, want)
    # an odd-row base (a slice), as the kernel's scalar head takes it
    got = TSA.group_sums(slots[1:], [p[1:] for p in planes], fields, S,
                         torch.zeros((S, 3), dtype=torch.int64), h)
    want = TSA.group_sums_plain(slots[1:], torch.stack(planes)[:, 1:], fields, S,
                                torch.zeros((S, 3), dtype=torch.int64), h)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# launch planning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,L,F,regime,variant", [
    (6, 6, 8, "registers", 1),      # Q1
    (1, 2, 3, "registers", 0),      # Q6
    (1, 7, 7, "shared", -1),
    (4, 1, 1, "registers", 1),
    (8, 8, 8, "shared", -1),
    (9, 1, 1, "shared", -1),
    (64, 3, 6, "shared", -1),       # S x L = 192
    (1, 240, 240, "shared", -1),
])
def test_stream_agg_regime_by_shape(S, L, F, regime, variant):
    plan = TSA.plan_launch(S, L, F, 6)
    assert (plan.regime, plan.variant) == (regime, variant)
    assert plan.vector
    assert not TSA.plan_launch(S, L, F, 0).vector
    assert not TSA.plan_launch(S, L, F, TSA.VECTOR_MIN_HEADROOM - 1).vector
    if regime == "registers":
        sm, lm = TSA.REGISTER_SHAPES[variant]
        assert S <= sm and L <= lm and plan.threads == TSA.THREADS
        assert plan.smem == S * F * 8


def test_stream_agg_shared_memory_fits_every_layout():
    """Every S <= 64 with S x L <= 240, one field per plane or four (the
    most a plane holds at 6 bits of headroom), fits 232,448 B."""
    checked = 0
    for S in range(1, 65):
        for L in range(1, 240 // S + 1):
            for per in (1, 4):
                F = min(L * per, TSA.MAX_FIELDS)
                plan = TSA.plan_launch(S, L, F, 6)
                assert plan.smem <= 232_448
                assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
                if plan.regime == "shared":
                    assert plan.smem == S * F * 8 + plan.threads * S * L * 4
                checked += 1
    assert checked > 1000


def test_stream_agg_plan_rejects_what_it_cannot_carry():
    with pytest.raises(ValueError):
        TSA.plan_launch(1, TSA.MAX_PLANES + 1, 1, 0)
    with pytest.raises(ValueError):
        TSA.plan_launch(1, 1, TSA.MAX_FIELDS + 1, 0)
    with pytest.raises(ValueError):
        TSA.plan_launch(1, 1, 1, 31)


def test_stream_agg_packed_field_table():
    """Fields grouped by plane, each as offset | cap << 5 | out << 10."""
    fields = TSA.field_table([[(0, 19, 0), (19, 11, 3)], [(0, 31, 2)], [(0, 30, 1)]], 3)
    begin, packed = TSA._packed_fields(tuple(fields), 3)
    assert list(begin) == [0, 2, 3, 4]
    assert list(packed) == [0 | 19 << 5 | 0 << 10, 19 | 11 << 5 | 3 << 10,
                            0 | 31 << 5 | 2 << 10, 0 | 30 << 5 | 1 << 10]


def test_direct_agg_plan_at_s4096():
    plans = TDA.launch_plan(4096, 11)
    assert [(g.col_begin, g.col_end) for g in plans] == TDA.column_groups(4096, 11) \
        == [(0, 7), (7, 11)]
    assert [g.copies for g in plans] == [1, 1]
    assert [g.smem for g in plans] == [4096 * 7 * 8, 4096 * 4 * 8]
    assert [g.blocks_per_sm for g in plans] == [1, 1]


def test_direct_agg_plan_at_q7_pairs():
    (g,) = TDA.launch_plan(676, 4)
    assert (g.col_begin, g.col_end) == (0, 4)
    assert g.copies == 4 and g.smem == 4 * 676 * 4 * 8
    assert g.blocks_per_sm == TDA.MIN_BLOCKS_PER_SM == 2


@pytest.mark.parametrize("S", [65, 100, 676, 700, 1024, 4096])
@pytest.mark.parametrize("cols", [1, 2, 4, 7, 11])
def test_direct_agg_plan_fits_the_sm(S, cols):
    plans = TDA.launch_plan(S, cols)
    assert plans[0].col_begin == 0 and plans[-1].col_end == cols
    for g in plans:
        assert 1 <= g.copies <= TDA.WARPS and g.smem <= TDA.MAX_SMEM
        assert g.smem == g.copies * S * (g.col_end - g.col_begin) * 8
        assert 1 <= g.blocks_per_sm <= TDA.MAX_BLOCKS_PER_SM
        assert g.blocks_per_sm * (g.smem + TDA.BLOCK_RESERVED) <= TDA.SM_SMEM
        if g.copies > 1:
            assert g.blocks_per_sm >= TDA.MIN_BLOCKS_PER_SM
