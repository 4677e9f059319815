"""The mechanisms TPC-H Q2-Q21 add to the port, each against the JAX
package on seeded numpy inputs (tolerance zero; the one DOUBLE division
case compares IEEE quotients of the same operands, which are equal):

- ``divide``, narrow and wide, with negatives, half-up rounding and a
  zero divisor (NULL), and the exact long division of ``core/wide.py``
  also against Python integers;
- the six comparisons over wide decimals, narrow and wide operands mixed,
  wide types stored narrow (1-D) included;
- ``in`` with NULL list members and a NULL probe;
- ``LIKE`` with ``%``, ``_`` and escapes;
- ``min``/``max`` and ``count_distinct`` on the keyless, masked direct,
  segment direct, sort and stream methods, with NULLs, all-NULL groups,
  a FILTER column and a two-limb wide argument;
- ``hash_columns_u63`` bit for bit, and a forced hash collision that the
  join's verification drops, in both packages;
- left outer joins on both probe paths, and ``cross_join`` with its
  overflow.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiflash_tpu.core import wide as JW
from tiflash_tpu.core.block import Block as JBlock, Column as JColumn, column_from_numpy
from tiflash_tpu.core.dtypes import BOOL, DATE, FLOAT64, INT32, INT64, STRING, Decimal
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.expr.compile import ExprEvaluator as JEval
from tiflash_tpu.expr.compile import _like_to_regex as j_like_regex
from tiflash_tpu.ops import aggregate as JA
from tiflash_tpu.ops import hashing as JH
from tiflash_tpu.ops import join as JJ

from tiflash_tpu_torch.core import wide as TW
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.expr.compile import ExprEvaluator as TEval
from tiflash_tpu_torch.expr.compile import _like_to_regex as t_like_regex
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.ops import hashing as TH
from tiflash_tpu_torch.ops import join as TJ
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 400


def _port(block):
    return blocks_from_numpy(export_blocks({"t": block}), "cpu")["t"]


def _limbs(values, L):
    """Python ints -> (n, L) int64 limbs in base 10^18 (top limb signed,
    the others in [0, 10^18))."""
    out = np.zeros((len(values), L), dtype=np.int64)
    for i, v in enumerate(values):
        for j in range(L - 1, 0, -1):
            v, out[i, j] = divmod(v, 10 ** 18)
        out[i, 0] = v
    return out


def _wide_col(values, prec, scale, validity=None):
    dt = Decimal(prec, scale, nullable=validity is not None)
    return JColumn(jnp.asarray(_limbs(values, dt.decimal_limbs)),
                   None if validity is None else jnp.asarray(validity), dt)


def _big_ints(rng, n, digits):
    """Signed Python ints of up to ``digits`` digits, some small."""
    out = []
    for _ in range(n):
        d = int(rng.integers(1, digits + 1))
        v = int("".join(str(x) for x in rng.integers(0, 10, d)))
        out.append(-v if rng.random() < 0.4 else v)
    return out


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(11)
    small = rng.integers(-99_999, 99_999, N)
    small[:6] = [0, 1, -1, 5, -5, 0]
    wide_a = _big_ints(rng, N, 30)
    wide_b = _big_ints(rng, N, 30)
    wide_b[:3] = [0, 0, 7]
    quad = _big_ints(rng, N, 44)
    cols = {
        "i": column_from_numpy(rng.integers(-50, 50, N), INT64),
        "j": column_from_numpy(rng.integers(-4, 4, N), INT64.with_nullable(True),
                               validity=rng.random(N) > 0.2),
        "d10": column_from_numpy(rng.integers(-10 ** 6, 10 ** 6, N), Decimal(10, 2)),
        "d10b": column_from_numpy(small, Decimal(10, 2, True), validity=rng.random(N) > 0.1),
        "q": column_from_numpy(rng.integers(-10 ** 12, 10 ** 12, N), Decimal(15, 2)),
        "qb": column_from_numpy(small, Decimal(15, 2)),
        "f": column_from_numpy(rng.random(N) * 100 - 50, FLOAT64),
        "w": _wide_col(wide_a, 40, 4, validity=rng.random(N) > 0.1),
        "wb": _wide_col(wide_b, 40, 4),
        "w38": _wide_col(wide_a, 37, 2),
        "w65": _wide_col(quad, 60, 6),
        # a wide type stored narrow (1-D), as _wide_rewrite leaves sums
        "wn": JColumn(jnp.asarray(rng.integers(-10 ** 9, 10 ** 9, N)), None,
                      Decimal(37, 2, nullable=True)),
        "s": column_from_numpy(rng.choice(["MAIL", "SHIP", "AIR", "RAIL"], N).tolist(),
                               STRING.with_nullable(True), validity=rng.random(N) > 0.1),
        "day": column_from_numpy(rng.integers(9000, 9100, N).astype(np.int32), DATE),
    }
    jb = JBlock.from_dict(cols)
    return jb, _port(jb)


def _eval_both(blocks, make):
    jb, tb = blocks
    j = jax.jit(lambda b: JEval(b).evaluate(make(JE)))(jb)
    t = TEval(tb).evaluate(make(TE))
    return j, t


def _same(j, t):
    assert repr(t.dtype) == repr(j.dtype)
    assert t.to_pylist() == j.to_pylist()
    jv = None if j.validity is None else np.asarray(j.validity)
    tv = None if t.validity is None else t.validity.numpy()
    assert (jv is None) == (tv is None)
    if jv is not None:
        np.testing.assert_array_equal(tv, jv)


DIVIDES = {
    # narrow: the scaled dividend fits 18 digits, int64 half-up division
    "narrow_int64": lambda E: E.col("d10") / E.col("d10b"),
    # narrow operands whose scale shift passes 18 digits: long division
    "narrow_exact": lambda E: E.col("q") / E.col("qb"),
    "int_by_int": lambda E: E.col("i") / E.col("j"),
    "decimal_by_int": lambda E: E.col("q") / E.col("i"),
    "wide_by_wide": lambda E: E.col("w") / E.col("wb"),
    "wide_by_narrow": lambda E: E.col("w") / E.col("qb"),
    "narrow_by_wide": lambda E: E.col("q") / E.col("wb"),
    "wide_stored_narrow": lambda E: E.col("wn") / E.col("d10b"),
    "four_limbs": lambda E: E.col("w65") / E.col("w"),
    "double": lambda E: E.col("f") / (E.col("i") + 0.5),
}


@pytest.mark.parametrize("name", sorted(DIVIDES))
def test_divide_matches_reference(blocks, name):
    j, t = _eval_both(blocks, DIVIDES[name])
    _same(j, t)


def test_divide_rounds_half_up_and_nulls_on_zero(blocks):
    """Against Python integers: q / qb at scale 6 rounds half away from
    zero; a zero divisor is NULL."""
    _, tb = blocks
    t = TEval(tb).evaluate(TE.col("q") / TE.col("qb"))
    q, qb = tb["q"].data.tolist(), tb["qb"].data.tolist()
    want = []
    for a, b in zip(q, qb):
        if b == 0:
            want.append(None)
            continue
        num, den = a * 10 ** 6, b   # (a / 10^2) / (b / 10^2) at scale 6
        mag, r = divmod(abs(num), abs(den))
        mag += 2 * r >= abs(den)
        want.append(mag if (num >= 0) == (den > 0) else -mag)
    assert t.to_pylist() == want
    assert None in want


@pytest.mark.parametrize("L", [2, 4])
def test_wide_long_division_is_exact(L):
    rng = np.random.default_rng(L)
    num = _big_ints(rng, 300, 18 * L - 3)
    den = [d or 3 for d in _big_ints(rng, 300, 18 * L - 10)]
    den[:4] = [1, -1, 2, 10 ** 18 + 7]
    q, r = TW.wide_divmod(torch.as_tensor(_limbs(num, L)), torch.as_tensor(_limbs(den, L)))
    jq, jr = JW.wide_divmod(jnp.asarray(_limbs(num, L)), jnp.asarray(_limbs(den, L)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert TW.wide_to_host_ints(q.numpy()) == [
        (abs(a) // abs(b)) * (1 if (a >= 0) == (b > 0) else -1) for a, b in zip(num, den)]
    h = TW.wide_div_wide_round_half_up(torch.as_tensor(_limbs(num, L)),
                                       torch.as_tensor(_limbs(den, L)))
    jh = JW.wide_div_wide_round_half_up(jnp.asarray(_limbs(num, L)),
                                        jnp.asarray(_limbs(den, L)))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


def test_wide_mul_scale_resize_match_reference():
    rng = np.random.default_rng(4)
    a, b = _big_ints(rng, 200, 18), _big_ints(rng, 200, 19)
    for L in (2, 4):
        ta, tb_ = torch.as_tensor(_limbs(a, L)), torch.as_tensor(_limbs(b, L))
        ja, jb = jnp.asarray(_limbs(a, L)), jnp.asarray(_limbs(b, L))
        for got, want in ((TW.wide_mul(ta, tb_), JW.wide_mul(ja, jb)),
                          (TW.wide_scale_up(ta, 13), JW.wide_scale_up(ja, 13)),
                          (TW.resize_wide(ta, 6 - L), JW.resize_wide(ja, 6 - L))):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(TW.wide_to_f64(ta).numpy(),
                                      np.asarray(JW.wide_to_f64(ja)))
    assert TW.wide_to_host_ints(TW.wide_mul(torch.as_tensor(_limbs(a, 2)),
                                            torch.as_tensor(_limbs(b, 2)))[0].numpy()) == \
        [x * y for x, y in zip(a, b)]


CMP_OPS = ["equals", "not_equals", "less", "less_or_equals", "greater",
           "greater_or_equals"]
CMP_PAIRS = {
    "wide_wide": ("w", "wb"),
    "wide_vs_self": ("w", "w"),
    "narrow_vs_wide": ("q", "w38"),
    "stored_narrow_vs_int": ("wn", "i"),
    "four_limbs_vs_two": ("w65", "w"),
}


@pytest.mark.parametrize("op", CMP_OPS)
@pytest.mark.parametrize("pair", sorted(CMP_PAIRS))
def test_wide_compare_matches_reference(blocks, op, pair):
    a, b = CMP_PAIRS[pair]
    j, t = _eval_both(blocks, lambda E: E.Call(op, (E.col(a), E.col(b))))
    _same(j, t)


def test_wide_compare_against_literals(blocks):
    """Q18's HAVING shape: a decimal(37,2) sum (stored narrow or in limbs)
    against an integer literal, and Q11's against a scaled product."""
    for make in (lambda E: E.col("wn") > E.lit(21000, None),
                 lambda E: E.col("w38") > E.lit(300, None),
                 lambda E: E.col("w") > E.col("wb") * E.lit(0.0001)):
        j, t = _eval_both(blocks, make)
        _same(j, t)


IN_CASES = {
    "ints_with_null_member": lambda E: E.col("i").in_(1, E.lit(None), 3, -7),
    "nullable_probe": lambda E: E.col("j").in_(2, 0, -4),
    "strings": lambda E: E.col("s").in_("MAIL", "SHIP"),
    "strings_with_null_member": lambda E: E.col("s").in_("AIR", E.lit(None)),
    "decimal_vs_ints": lambda E: E.col("d10b").in_(0, 1, 5),
    "not_in": lambda E: ~E.col("i").in_(1, 2, 3),
}


@pytest.mark.parametrize("name", sorted(IN_CASES))
def test_in_matches_reference(blocks, name):
    j, t = _eval_both(blocks, IN_CASES[name])
    _same(j, t)


LIKE_WORDS = ["Brand#23", "Brand#2", "Brand#32", "a%b", "a_b", "axb", "50% off",
              "", "_x", "x\\y", "PROMO BRUSHED"]
LIKE_PATTERNS = [("Brand#2%", None), ("%3_", None), ("a\\%b", None), ("a_b", None),
                 ("%\\%%", None), ("_%", None), ("%", None), ("", None),
                 ("a!%b", "!"), ("x\\\\y", None), ("PROMO%", None)]


@pytest.mark.parametrize("pattern,escape", LIKE_PATTERNS)
def test_like_matches_reference(pattern, escape):
    rng = np.random.default_rng(3)
    n = 200
    jb = JBlock.from_dict({"s": column_from_numpy(
        rng.choice(LIKE_WORDS, n).tolist(), STRING.with_nullable(True),
        validity=rng.random(n) > 0.1)})
    tb = _port(jb)

    def make(E):
        args = (E.col("s"), E.lit(pattern)) + (() if escape is None else (E.lit(escape),))
        return E.Call("like", args)

    j, t = _eval_both((jb, tb), make)
    _same(j, t)
    assert t_like_regex(pattern, escape or "\\") == j_like_regex(pattern, escape or "\\")


# ---------------------------------------------------------------------------
# min / max / count_distinct per aggregation method
# ---------------------------------------------------------------------------


def _agg_block(seed, n_keys, n=1500, clustered=False):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n_keys, n)
    g[g == 3] = 4  # group 3 empty; group 5's arguments all NULL below
    if clustered:
        g = np.sort(g)
    x_valid = (rng.random(n) > 0.3) & (g != 5)
    cols = {
        "g": column_from_numpy([f"k{v:04d}" for v in g], STRING),
        "h": column_from_numpy(rng.integers(0, 3, n) == 0, BOOL),
        "k": column_from_numpy(g.astype(np.int64), INT64),
        "x": column_from_numpy(rng.integers(-10 ** 6, 10 ** 6, n), Decimal(15, 2, True),
                               validity=x_valid),
        "y": column_from_numpy(rng.integers(-50, 40, n), INT64),
        "day": column_from_numpy(rng.integers(8000, 9000, n).astype(np.int32), DATE),
        "s": column_from_numpy(rng.choice(["AIR", "MAIL", "SHIP", "RAIL"], n).tolist(),
                               STRING.with_nullable(True), validity=rng.random(n) > 0.2),
        "ok": column_from_numpy(rng.random(n) > 0.4, BOOL),
        "wx": _wide_col(_big_ints(rng, n, 30), 40, 2, validity=x_valid),
    }
    jb = JBlock.from_dict(cols).with_sel(jnp.asarray(rng.random(n) > 0.2))
    if clustered:
        jb = dataclasses.replace(jb, clustered_by=("k",))
    return jb, _port(jb)


# method -> (keys, block kwargs, the port's method it must dispatch to)
METHODS = {
    "keyless": ([], dict(n_keys=8), "keyless"),
    "masked_direct": (["g"], dict(n_keys=8), "direct"),
    "segment_direct": (["g", "h"], dict(n_keys=40), "direct"),
    "sort": (["k"], dict(n_keys=300), "sort"),
    "sort_two_keys": (["y", "k"], dict(n_keys=7), "sort"),
    "stream": (["k"], dict(n_keys=300, clustered=True), "stream"),
}
MINMAX = [("min", "x", "mn"), ("max", "x", "mx"), ("min", "y", "mny"),
          ("max", "day", "mxd"), ("min", "s", "mns"), ("max", "x", "mx_if", "ok"),
          ("count", "x", "cx"), ("sum", "y", "sy")]
DISTINCT = {
    "one": [("count_distinct", "y", "dy")],
    "nullable_arg": [("count_distinct", "x", "dx"), ("count", None, "c")],
    "filtered": [("count_distinct", "y", "dy_if", "ok"), ("sum", "y", "sy")],
    "two": [("count_distinct", "y", "dy"), ("count_distinct", "s", "ds")],
}


def _agg_both(jb, tb, keys, aggs, monkeypatch):
    calls = []
    for name, tag in (("aggregate_stream", "stream"), ("aggregate_sort", "sort"),
                      ("aggregate_direct", "direct"), ("aggregate_scalar", "keyless")):
        real = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _r=real, _t=tag, **k: (
            calls.append(_t) or _r(*a, **k)))
    j = jax.jit(lambda b: (lambda r: (r.block, r.num_groups, r.overflow))(
        JA.hash_aggregate(b, keys, [JA.AggDesc(*a) for a in aggs])))(jb)
    t = TA.hash_aggregate(tb, keys, [TA.AggDesc(*a) for a in aggs])
    assert t.block.names == j[0].names
    assert [repr(c.dtype) for c in t.block.columns] == \
        [repr(c.dtype) for c in j[0].columns]
    assert t.block.to_pylists() == j[0].to_pylists()
    assert int(t.num_groups) == int(j[1])
    assert int(t.overflow) == int(j[2])
    return calls, t


@pytest.mark.parametrize("method", sorted(METHODS))
def test_min_max_per_method_matches_reference(method, monkeypatch):
    keys, kw, want = METHODS[method]
    jb, tb = _agg_block(len(method), **kw)
    calls, t = _agg_both(jb, tb, keys, MINMAX, monkeypatch)
    assert calls[0] == want
    if keys:
        # an all-NULL group's min is NULL, its count 0
        rows = t.block.to_pylists()
        assert any(c == 0 and m is None for c, m in zip(rows["cx"], rows["mn"]))


@pytest.mark.parametrize("method", ["keyless", "sort", "masked_direct"])
def test_min_max_of_two_limb_wide_matches_reference(method, monkeypatch):
    keys, kw, _ = METHODS[method]
    jb, tb = _agg_block(7, **kw)
    _agg_both(jb, tb, keys, [("min", "wx", "mn"), ("max", "wx", "mx")], monkeypatch)


@pytest.mark.parametrize("aggs", sorted(DISTINCT))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_count_distinct_per_method_matches_reference(method, aggs, monkeypatch):
    keys, kw, want = METHODS[method]
    jb, tb = _agg_block(len(method) + len(aggs), **kw)
    calls, _ = _agg_both(jb, tb, keys, DISTINCT[aggs], monkeypatch)
    assert calls[0] == want


# ---------------------------------------------------------------------------
# hashed join keys, left outer and cross joins
# ---------------------------------------------------------------------------


def test_hash_columns_u63_bits_match_reference():
    rng = np.random.default_rng(8)
    n = 1000
    jb = JBlock.from_dict({
        "a": column_from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64), INT64),
        "b": column_from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32),
                               INT32.with_nullable(True), validity=rng.random(n) > 0.2),
        "c": column_from_numpy(rng.choice(["x", "yy", "Brand#12", ""], n).tolist(), STRING),
        "d": column_from_numpy(rng.random(n) > 0.5, BOOL),
        "e": column_from_numpy(rng.integers(100, 100001, n), Decimal(15, 2)),
    })
    tb = _port(jb)
    for names in (["a"], ["a", "b"], ["c", "e"], ["d", "b", "a"], ["e", "a", "c", "d"]):
        jc, tc = [jb[k] for k in names], [tb[k] for k in names]
        np.testing.assert_array_equal(TH.hash_columns_u63(tc).numpy(),
                                      np.asarray(JH.hash_columns_u63(jc)))
        np.testing.assert_array_equal(
            TH.hash_columns(tc).numpy(),
            np.asarray(JH.hash_columns(jc)).astype(np.int64))
    for col in ("a", "b", "c"):
        np.testing.assert_array_equal(
            TH.hash_array_u32(tb[col].data).numpy(),
            np.asarray(JH.hash_array_u32(jb[col].data)).astype(np.int64))


def _wide_key_tables(seed, n_probe=60, n_build=40):
    """Two int64 key columns (128 bits: hashed) on both sides, with NULL
    keys, dead rows and some probe tuples that share one column with a
    build tuple but not the other."""
    rng = np.random.default_rng(seed)
    bk = np.stack([rng.integers(0, 6, n_build), rng.integers(0, 6, n_build)], 1)
    pk = np.stack([rng.integers(0, 7, n_probe), rng.integers(0, 7, n_probe)], 1)
    probe = JBlock.from_dict({
        "p1": column_from_numpy(pk[:, 0], INT64),
        "p2": column_from_numpy(pk[:, 1], INT64.with_nullable(True),
                                validity=rng.random(n_probe) > 0.1),
        "pv": column_from_numpy(np.arange(n_probe), INT64),
    }).with_sel(jnp.asarray(rng.random(n_probe) > 0.1))
    build = JBlock.from_dict({
        "b1": column_from_numpy(bk[:, 0], INT64),
        "b2": column_from_numpy(bk[:, 1], INT64),
        "bv": column_from_numpy(np.arange(n_build) * 10, INT64),
    }).with_sel(jnp.asarray(rng.random(n_build) > 0.1))
    return probe, build


def _true_pairs(probe, build):
    """The (pv, bv) pairs of the exact-key inner join, from the host."""
    ps = probe.to_pylists()
    bs = build.to_pylists()
    out = []
    for p1, p2, pv in zip(ps["p1"], ps["p2"], ps["pv"]):
        for b1, b2, bv in zip(bs["b1"], bs["b2"], bs["bv"]):
            if p2 is not None and (p1, p2) == (b1, b2):
                out.append((pv, bv))
    return out


@pytest.mark.parametrize("collide", [False, True], ids=["hashed", "forced_collision"])
@pytest.mark.parametrize("kind", ["inner", "semi", "anti"])
def test_hashed_keys_verify_matches(monkeypatch, kind, collide):
    """Keys past 63 bits hash; with every key tuple forced onto one of two
    hash values, every build row is a candidate, and verification keeps
    only the true matches, in both packages."""
    jp, jb = _wide_key_tables(5)
    tp, tb = _port(jp), _port(jb)
    if collide:
        monkeypatch.setattr(JH, "hash_columns_u63",
                            lambda cols, **kw: cols[0].data.astype(jnp.int64) % 2)
        monkeypatch.setattr(TH, "hash_columns_u63",
                            lambda cols, **kw: cols[0].data.to(torch.int64) % 2)
    cap = 2000
    jo, jx = JJ.hash_join(jp, jb, ["p1", "p2"], ["b1", "b2"], kind=kind,
                          output_capacity=cap)
    to, tx = TJ.hash_join(tp, tb, ["p1", "p2"], ["b1", "b2"], kind=kind,
                          output_capacity=cap)
    assert to.to_pylists() == jo.to_pylists()
    assert [repr(c.dtype) for c in to.columns] == [repr(c.dtype) for c in jo.columns]
    assert int(tx["overflow"]) == int(jx["overflow"]) == 0
    np.testing.assert_array_equal(tx["matched_flags"].numpy(),
                                  np.asarray(jx["matched_flags"]))
    pairs = _true_pairs(jp, jb)
    rows = to.to_pylists()
    if kind == "inner":
        assert sorted(zip(rows["pv"], rows["bv"])) == sorted(pairs)
    else:
        hit = {pv for pv, _ in pairs}
        live = jp.to_pylists()["pv"]
        assert rows["pv"] == [v for v in live if (v in hit) == (kind == "semi")]


@pytest.mark.parametrize("capacity", [None, 900, 100, "dup"],
                         ids=["unique", "general", "general_overflow", "unique_dup"])
def test_left_outer_join_matches_reference(capacity):
    """Unmatched and NULL-key probe rows stay in their place with NULL
    build columns; dead probe rows stay dead; a build promised unique
    that is not reports the probe capacity + 1."""
    from test_torch_join import _rows, _tables

    j, t = _tables(seed=12, dup=capacity == "dup")
    cap = None if capacity == "dup" else capacity

    def run(probe, build):
        out, x = JJ.hash_join(probe, build, ["pk"], ["bk"], kind="left",
                              output_capacity=cap)
        return out, x["overflow"], x["matched_flags"]

    jo, jov, jflags = jax.jit(run)(j["probe"], j["build"])
    to, tx = TJ.hash_join(t["probe"], t["build"], ["pk"], ["bk"], kind="left",
                          output_capacity=cap)
    assert int(tx["overflow"]) == int(jov)
    if int(jov) == 0:
        assert _rows(to) == _rows(jo)
        np.testing.assert_array_equal(tx["matched_flags"].numpy(), np.asarray(jflags))
        rows = to.to_pylists()
        assert None in rows["bv"]
        assert len(rows["pv"]) >= int(t["probe"].num_rows())
    if capacity == "dup":
        assert int(jov) == t["probe"].capacity + 1


@pytest.mark.parametrize("capacity", [5000, 40], ids=["fits", "overflow"])
def test_cross_join_matches_reference(capacity):
    rng = np.random.default_rng(6)
    jp = JBlock.from_dict({"a": column_from_numpy(rng.integers(0, 9, 30), INT64)}) \
        .with_sel(jnp.asarray(rng.random(30) > 0.3))
    jb = JBlock.from_dict({"b": column_from_numpy(rng.integers(0, 9, 12), INT64),
                           "a": column_from_numpy(rng.integers(0, 9, 12), INT64)}) \
        .with_sel(jnp.asarray(rng.random(12) > 0.4))
    jo, jn = jax.jit(lambda p, b: JJ.cross_join(p, b, capacity))(jp, jb)
    to, tn = TJ.cross_join(_port(jp), _port(jb), capacity)
    assert int(tn) == int(jn)
    assert _rows_of(to) == _rows_of(jo)
    n_live = int(np.sum(np.asarray(jp.sel))) * int(np.sum(np.asarray(jb.sel)))
    assert int(tn) == (n_live if n_live > capacity else 0)


def _rows_of(block):
    return block.to_pylists(), [repr(c.dtype) for c in block.columns], block.names
