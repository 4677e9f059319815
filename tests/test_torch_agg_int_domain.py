"""Integer and date group keys whose range stats prove a small span take
the port's dense (direct) method, where the reference, which gives a
domain only to dictionary strings and bools, sorts.

``ops/aggregate.py``: ``key_range`` gives such a key ``hi - lo + 1``
slots (one more for NULL), ``pack_keys_direct`` packs it as ``v - lo``
and ``unpack_keys_direct`` adds ``lo`` back.  Each case runs the port's
``hash_aggregate`` and the JAX package's on the same block: the rows (in
any order: neither method promises one), the dtypes and the group counts
are equal, and the port's method is the one the rule gives, read from
the ``agg_calls_total_method_<method>`` counters and the ``agg.<method>``
span; ``agg_ranged_calls_total`` counts the dense calls whose domain rests
on range stats.  A ``year()`` of a DATE or DATETIME carries the image of
its argument's stats (``expr/functions.py:_year_image``), so year-keyed
groups, as in TPC-H Q7, Q8 and Q9, take the dense method too.
"""

import dataclasses

import jax
import numpy as np
import pytest

from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.ops import aggregate as JA

from test_torch_aggregate import AGGS as SORT_AGGS, _sort_block
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.runtime import tracing
from tiflash_tpu_torch.runtime.metrics import METRICS
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 3000
AGGS = [("sum", "v", "s"), ("count", None, "c"), ("sum", "w", "sw")]
NATIONS = [f"nation{i:02d}" for i in range(25)]
LIMIT = TA.DIRECT_DOMAIN_LIMIT


def _block(seed, keys, n=N, dead_garbage=None):
    """A block of ``keys`` ({name: (dtype, values, validity)}), an int64
    value ``v``, an int32 value ``w`` and a selection; the port's copy.
    With ``dead_garbage`` the dead rows' first key holds that value, and
    the port's stats cover the live rows alone, as a join's gather may
    leave them."""
    rng = np.random.default_rng(seed)
    sel = rng.random(n) > 0.2
    cols = {}
    for name, (dtype, values, validity) in keys.items():
        if dead_garbage is not None and not cols:
            values = np.where(sel, values, dead_garbage)
        cols[name] = column_from_numpy(values, dtype, validity=validity)
    cols["v"] = column_from_numpy(rng.integers(-10 ** 12, 10 ** 12, n), JD.INT64)
    cols["w"] = column_from_numpy(rng.integers(0, 10 ** 6, n).astype(np.int32), JD.INT32)
    jb = JBlock.from_dict(cols).with_sel(sel)
    tb = blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]
    if dead_garbage is not None:
        first = next(iter(keys))
        live = np.asarray(keys[first][1])[sel]
        tb = tb.with_column(first, dataclasses.replace(
            tb[first], stats=(int(live.min()), int(live.max()))))
    return jb, tb


def _rows(block):
    cols = block.to_pylists()
    return sorted(zip(*cols.values()), key=lambda r: tuple((v is None, v) for v in r))


PREFIX = "agg_calls_total_method_"


def _method_counts():
    return {k: v for k, v in METRICS.dump().items() if k.startswith(PREFIX)}


def _both(jb, tb, keys, aggs=AGGS):
    """Both packages' results; the port's method by its counters."""
    j = jax.jit(lambda b: (lambda r: (r.block, r.num_groups))(
        JA.hash_aggregate(b, keys, [JA.AggDesc(*a) for a in aggs])))(jb)
    before = _method_counts()
    t = TA.hash_aggregate(tb, keys, [TA.AggDesc(*a) for a in aggs])
    after = _method_counts()
    ran = [k[len(PREFIX):] for k in after if after[k] != before.get(k, 0)]
    assert t.block.names == j[0].names
    assert [repr(c.dtype) for c in t.block.columns] == [repr(c.dtype) for c in j[0].columns]
    assert _rows(t.block) == _rows(j[0])
    assert int(t.num_groups) == int(j[1])
    assert len(ran) == 1
    return ran[0], int(t.num_groups)


def _ints(rng, lo, hi, n=N, dtype=JD.INT64, validity=None):
    return dtype, rng.integers(lo, hi + 1, n).astype(dtype.physical), validity


CASES = {
    # name: (keys, the port's method, its domain)
    "one_slot": (lambda r: {"k": _ints(r, 5, 5)}, "masked", 1),
    "year_like": (lambda r: {"d_year": _ints(r, 1992, 1998, dtype=JD.INT32)}, "masked", 7),
    "nullable": (lambda r: {"k": _ints(r, 0, 6, dtype=JD.INT64.with_nullable(True),
                                       validity=r.random(N) > 0.2)}, "masked", 8),
    "negative_lo": (lambda r: {"k": _ints(r, -300, -201)}, "direct", 100),
    "dates": (lambda r: {"day": _ints(r, 8000, 8364, dtype=JD.DATE)}, "direct", 365),
    "at_the_cap": (lambda r: {"k": (JD.INT64, np.concatenate([
        [-17, -17 + LIMIT - 1], r.integers(-17, -17 + LIMIT, N - 2)]), None)},
        "direct", LIMIT),
    "over_the_cap": (lambda r: {"k": (JD.INT64, np.concatenate([
        [-17, -17 + LIMIT], r.integers(-17, -17 + LIMIT + 1, N - 2)]), None)},
        "sort", None),
    "year_x_nation": (lambda r: {
        "d_year": _ints(r, 1992, 1998, dtype=JD.INT32),
        "c_nation": (JD.STRING, [NATIONS[i] for i in r.integers(0, 25, N)], None)},
        "direct", 175),
    "nation_x_nation_x_year": (lambda r: {
        "c_nation": (JD.STRING, [NATIONS[i] for i in r.integers(0, 25, N)], None),
        "s_nation": (JD.STRING, [NATIONS[i] for i in r.integers(0, 25, N)], None),
        "d_year": _ints(r, 1992, 1998, dtype=JD.INT32)}, "direct", 4375),
}


@pytest.mark.parametrize("case", list(CASES))
def test_int_key_domain_matches_reference(case):
    make, method, domain = CASES[case]
    keys = make(np.random.default_rng(len(case)))
    jb, tb = _block(len(case), keys)
    cols = [tb[k] for k in keys]
    packed = TA.pack_keys_direct(cols)
    assert (packed[1] if packed is not None and packed[1] <= LIMIT else None) == domain
    ranged_before = METRICS.dump()["agg_ranged_calls_total"]
    got, groups = _both(jb, tb, list(keys))
    assert got == method
    assert groups > 0
    # a dense domain that rests on range stats counts as ranged
    assert METRICS.dump()["agg_ranged_calls_total"] == ranged_before + (domain is not None)


def test_no_stats_keeps_the_sort_method():
    rng = np.random.default_rng(3)
    keys = {"k": _ints(rng, 0, 6)}
    jb, tb = _block(3, keys)
    tb = tb.with_column("k", dataclasses.replace(tb["k"], stats=None))
    assert TA.key_domain_size(tb["k"]) is None
    assert _both(jb, tb, ["k"])[0] == "sort"


def test_dead_rows_outside_the_stats_are_ignored():
    """Dead rows may hold any key (a gather's unmatched rows): their slot
    is out of the domain and every sub-method drops them."""
    rng = np.random.default_rng(4)
    for lo, hi, method in ((0, 20, "masked"), (0, 400, "direct")):
        keys = {"k": _ints(rng, lo, hi), "g": (JD.STRING, [NATIONS[i] for i in
                                                           rng.integers(0, 2, N)], None)}
        jb, tb = _block(4, keys, dead_garbage=10 ** 9)
        assert TA.key_range(tb["k"]) is not None and TA.key_range(tb["k"])[1] <= hi
        assert _both(jb, tb, ["k", "g"])[0] == method
        if method == "direct":
            aggs = AGGS + [("min", "v", "mn")]  # not the kernel's: the segment sub-method
            assert _both(jb, tb, ["k", "g"], aggs)[0] == "direct_segment"


@pytest.mark.parametrize("keys", [["ky"], ["kz", "ky"], ["g", "kz"]],
                         ids=["ties", "null_keys", "string_and_int"])
def test_sort_method_blocks_with_their_stats_take_the_direct_method(keys):
    """``test_torch_aggregate``'s blocks for the sort method, with the
    port's keys keeping their range stats."""
    jb, tb = _sort_block(51, ranged=True)
    assert _both(jb, tb, keys, SORT_AGGS)[0] in ("masked", "direct", "direct_segment")


def test_clustered_keys_with_stats_keep_the_stream_method():
    rng = np.random.default_rng(5)
    keys = {"k": (JD.INT64, np.sort(rng.integers(0, 50, N)), None)}
    jb, tb = _block(5, keys)
    jb = dataclasses.replace(jb, clustered_by=("k",))
    tb = dataclasses.replace(tb, clustered_by=("k",))
    j = JA.hash_aggregate(jb, ["k"], [JA.AggDesc(*a) for a in AGGS])
    before = _method_counts()
    t = TA.hash_aggregate(tb, ["k"], [TA.AggDesc(*a) for a in AGGS])
    assert _method_counts().get(PREFIX + "stream", 0) == before.get(PREFIX + "stream", 0) + 1
    assert t.block.to_pylists() == j.block.to_pylists()


def test_spans_and_counters_name_the_method():
    """With tracing on, each aggregation records ``agg.<method>`` with the
    block's capacity, the slots and the key count, and adds to its
    method's counters; with tracing off it records nothing."""
    rng = np.random.default_rng(6)
    keys = {"d_year": _ints(rng, 1992, 1998, dtype=JD.INT32),
            "c_nation": (JD.STRING, [NATIONS[i] for i in rng.integers(0, 25, N)], None)}
    _, tb = _block(6, keys)
    aggs = [TA.AggDesc(*a) for a in AGGS]
    rows_before = METRICS.dump().get("agg_rows_total_method_direct", 0)
    tracing.enable()
    try:
        TA.hash_aggregate(tb, ["d_year", "c_nation"], aggs)
        TA.hash_aggregate(tb, [], aggs)
    finally:
        tracing.disable()
    spans = [s for s in tracing.drain() if s["name"].startswith("agg.")]
    assert [(s["name"], s["attrs"]) for s in spans] == [
        ("agg.direct", {"rows": N, "slots": 175, "keys": 2}),
        ("agg.scalar", {"rows": N, "slots": 1, "keys": 0})]
    assert METRICS.dump()["agg_rows_total_method_direct"] == rows_before + N
    TA.hash_aggregate(tb, ["d_year"], aggs)
    assert tracing.drain() == []


# ---------------------------------------------------------------------------
# year(): the image of a date's range stats (expr/functions.py:_year_image)
# ---------------------------------------------------------------------------

DAY_US = 86_400_000_000
ZERO = JD.ZERO_DATE_DAYS


def _day(y, m, d):
    return (np.datetime64(f"{y:04d}-{m:02d}-{d:02d}", "D")
            - np.datetime64("1970-01-01", "D")).astype(np.int64)


def _np_year(days):
    """numpy's proleptic Gregorian year of a day number: an independent
    calendar."""
    return int(np.datetime64(int(days), "D").astype("datetime64[Y]").astype(np.int64)) + 1970


def _spread(rng, lo, hi, n=N):
    """``n`` values in [lo, hi], both ends present."""
    return np.concatenate([[lo, hi], rng.integers(lo, hi + 1, n - 2)])


DATE_N = JD.DATE.with_nullable(True)
YEAR_CASES = {
    # name: (dtype, values (and validity) from a rng, the image, the
    # port's method, its domain)
    "date_one_year": (JD.DATE, lambda r: (_spread(r, _day(1995, 1, 1), _day(1995, 12, 31)), None),
                      (1995, 1995), "masked", 1),
    "date_seven_years": (JD.DATE, lambda r: (_spread(r, _day(1992, 1, 1), _day(1998, 12, 31)),
                                             None), (1992, 1998), "masked", 7),
    "date_year_boundaries": (JD.DATE, lambda r: (_spread(r, _day(1992, 12, 31), _day(2000, 1, 1)),
                                                 None), (1992, 2000), "masked", 9),
    "datetime_one_year": (JD.DATETIME, lambda r: (_spread(
        r, _day(2001, 1, 1) * DAY_US, _day(2002, 1, 1) * DAY_US - 1), None),
        (2001, 2001), "masked", 1),
    "datetime_two_centuries": (JD.DATETIME, lambda r: (_spread(
        r, _day(1900, 12, 31) * DAY_US + DAY_US - 1, _day(2100, 1, 1) * DAY_US), None),
        (1900, 2100), "direct", 201),
    # the ZERO date's year is 0: the image takes 0 in, and the
    # zero-date rows land in the domain
    "date_straddles_zero": (JD.DATE, lambda r: (np.where(
        r.random(N) < 0.3, ZERO, _spread(r, ZERO - 400, ZERO + 400)), None),
        (-8025, 0), "direct", 8026),
    "datetime_straddles_zero": (JD.DATETIME, lambda r: (np.where(
        r.random(N) < 0.3, ZERO * DAY_US, _spread(r, (ZERO - 100) * DAY_US, (ZERO + 100) * DAY_US)),
        None), (-8024, 0), "direct", 8025),
    "nullable": (DATE_N, lambda r: (_spread(r, _day(1992, 1, 1), _day(1998, 12, 31)),
                                    r.random(N) > 0.2), (1992, 1998), "masked", 8),
    "over_the_cap": (JD.DATE, lambda r: (_spread(r, -2_600_000, 2_600_000), None),
                     (-5149, 9088), "sort", None),
}


@pytest.mark.parametrize("case", list(YEAR_CASES))
def test_year_of_a_date_takes_the_image_of_its_stats(case):
    from tiflash_tpu.expr import compile as JC
    from tiflash_tpu.expr import nodes as JE
    from tiflash_tpu_torch.expr import compile as TC
    from tiflash_tpu_torch.expr import nodes as TE

    dtype, make, image, method, domain = YEAR_CASES[case]
    values, validity = make(np.random.default_rng(len(case)))
    jb, tb = _block(len(case), {"d": (dtype, values, validity)})
    jy = jax.jit(lambda b: JC.ExprEvaluator(b).evaluate(JE.call("year", JE.col("d"))))(jb)
    ty = TC.ExprEvaluator(tb).evaluate(TE.call("year", TE.col("d")))
    assert ty.stats == image
    # the image by an independent calendar, from the argument's stats
    lo, hi = (v // DAY_US if dtype.kind is JD.TypeKind.DATETIME else v for v in tb["d"].stats)
    zero = lo <= ZERO <= hi
    assert image == (min(_np_year(lo), 0) if zero else _np_year(lo),
                     max(_np_year(hi), 0) if zero else _np_year(hi))
    # the stats invariant: every live value lies in the interval
    live = tb.sel & ty.valid_mask()
    assert image[0] <= int(ty.data[live].min()) and int(ty.data[live].max()) <= image[1]
    assert zero == bool((ty.data[live] == 0).any())
    assert TA.key_domain_size(ty) == (None if domain is None else domain)
    got, groups = _both(jb.with_column("y", jy), tb.with_column("y", ty), ["y"])
    assert got == method and groups > 0


def test_q8_groups_its_years_on_the_dense_method(monkeypatch):
    """TPC-H Q8 groups by ``year(o_orderdate)``: o_orderdate's 7 years
    (one more slot for NULL) take the masked method, and ``mkt_share``'s
    wide division runs over those slots, not over a sort's capacity.
    The rows are the reference's."""
    import chip_smoke
    from tiflash_tpu.bench import tpch_queries as JQ
    from tiflash_tpu.runtime.executor import run_query as j_run
    from tiflash_tpu.storage.tpch import generate_tpch as j_generate
    from tiflash_tpu_torch.bench import tpch_queries as TQ
    from tiflash_tpu_torch.core import wide as W
    from tiflash_tpu_torch.runtime.executor import run_query as t_run
    from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate

    j_tables = j_generate(sf=0.002, seed=16, tables=chip_smoke.EIGHT_TABLES).blocks()
    t_cat = t_generate(sf=0.002, seed=16, tables=chip_smoke.EIGHT_TABLES)
    divided, slots = [], []
    real_div = W.wide_divmod
    monkeypatch.setattr(W, "wide_divmod", lambda w, d: (
        divided.append(tuple(w.shape)) or real_div(w, d)))
    real_direct = TA.aggregate_direct
    monkeypatch.setattr(TA, "aggregate_direct", lambda b, k, a, sd, use_kernel=None: (
        slots.append(sd[1]) or real_direct(b, k, a, sd, use_kernel)))
    before = METRICS.dump()
    got, _ = t_run(TQ.q8_plan(), t_cat.blocks("cpu"))
    after = METRICS.dump()
    want, _ = j_run(JQ.q8_plan(), j_tables)
    assert len(slots) == 1 and slots[0] <= 9
    assert after["agg_ranged_calls_total"] == before["agg_ranged_calls_total"] + 1
    assert divided and all(shape[0] == slots[0] for shape in divided)
    assert [repr(c.dtype) for c in got.columns] == [repr(c.dtype) for c in want.columns]
    assert got.to_pylists() == want.to_pylists()
    assert len(got.to_pylists()["o_year"]) == 2
