"""The hash joins of every kind: the PyTorch port's
``ops/join.py`` and the Join node of its compiler and runner, against the
JAX package's on the same blocks made with numpy from a seed (tolerance
zero: keys, payloads and flags are integers).

Covers key normalization (int, multi-column and cross-dictionary string
keys), the unique-build and N:M probes with NULL keys, dead rows on both
sides and a real key of 2^63-1, semi and anti joins on both probe paths
(a plain anti join keeps NULL-key probe rows; dead rows stay dead), the
right/full outer joins' unmatched build tail, NOT IN (null-aware anti)
with NULL build keys and an empty build side, EXISTS/IN in the select
list (left outer semi), the overflow of a build promised unique that is
not, and the runner's retry on the general path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
from tiflash_tpu.core.dtypes import INT16, INT32, INT64, STRING
from tiflash_tpu.ops import join as JJ
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.compiler import compile_fragment as j_compile
from tiflash_tpu.runtime.executor import run_query as j_run

from tiflash_tpu_torch.ops import join as TJ
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.plan.compiler import compile_fragment as t_compile
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

BIG = 2 ** 63 - 1


def _port(tables):
    return blocks_from_numpy(export_blocks(tables), "cpu")


def _tables(seed, n_probe=400, n_build=120, dup=False):
    """probe(pk, pv, ps) and build(bk, bv, bs): nullable int keys with a
    real 2^63-1 on both sides, dead rows on both sides, string payloads
    in different dictionaries."""
    rng = np.random.default_rng(seed)
    bkeys = rng.permutation(np.arange(-60, 200, dtype=np.int64))[:n_build]
    if dup:
        bkeys[5] = bkeys[6]
    bkeys[0] = BIG
    bnull = rng.random(n_build) < 0.1
    bnull[0] = False
    bsel = rng.random(n_build) > 0.1
    if dup:  # the duplicate pair is live and not NULL
        bnull[5:7] = False
        bsel[5:7] = True
    pkeys = rng.choice(np.concatenate([bkeys, np.arange(300, 320)]), n_probe)
    pkeys[:3] = BIG
    pnull = rng.random(n_probe) < 0.1
    pnull[:3] = False
    words = [f"w{i:02d}" for i in range(30)]
    probe = JBlock.from_dict({
        "pk": column_from_numpy(pkeys, INT64.with_nullable(True), validity=~pnull),
        "pv": column_from_numpy(rng.integers(0, 1000, n_probe), INT32),
        "ps": column_from_numpy(rng.choice(words[:20], n_probe).tolist(), STRING),
    }).with_sel(jnp.asarray(rng.random(n_probe) > 0.15))
    build = JBlock.from_dict({
        "bk": column_from_numpy(bkeys, INT64.with_nullable(True), validity=~bnull),
        "bv": column_from_numpy(rng.integers(-500, 500, n_build), INT64),
        "ps": column_from_numpy(rng.choice(words[10:], n_build).tolist(), STRING),
    }).with_sel(jnp.asarray(bsel))
    j = {"probe": probe, "build": build}
    return j, _port(j)


def _ref_join(j, capacity=None, build_payload=None, kind="inner"):
    """The reference's hash_join under one jit (its eager op-by-op form
    costs seconds on this CPU): (joined, extras without the build object,
    build's sorted_keys, perm, num_live, unique)."""
    import jax

    def run(probe, build):
        out, x = JJ.hash_join(probe, build, ["pk"], ["bk"], kind=kind,
                              output_capacity=capacity, build_payload=build_payload)
        b = x["build"]
        return out, x["overflow"], x["matched_flags"], (
            b.sorted_keys, b.perm, b.num_live, b.unique)

    return jax.jit(run)(j["probe"], j["build"])


def _rows(block):
    return block.to_pylists(), [repr(c.dtype) for c in block.columns]


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _key_case(case, rng):
    n = 300
    if case == "int":
        left = {"a": column_from_numpy(rng.integers(-2 ** 40, 2 ** 40, n), INT64,
                                       validity=rng.random(n) > 0.2)}
        right = {"a": column_from_numpy(rng.integers(-50, 50, n).astype(np.int32), INT32)}
    elif case == "multi":
        left = {"a": column_from_numpy(rng.integers(-300, 300, n), INT16),
                "b": column_from_numpy(rng.choice(["x", "yy", "zzz", "q"], n).tolist(),
                                       STRING)}
        right = {"a": column_from_numpy(rng.integers(-300, 300, n), INT16,
                                        validity=rng.random(n) > 0.1),
                 "b": column_from_numpy(rng.choice(["yy", "zzz", "aa"], n).tolist(),
                                        STRING)}
    else:  # strings in two dictionaries, some probe strings absent
        left = {"a": column_from_numpy(rng.choice(["m", "n", "o", "p"], n).tolist(),
                                       STRING.with_nullable(True),
                                       validity=rng.random(n) > 0.1)}
        right = {"a": column_from_numpy(rng.choice(["b", "n", "p"], n).tolist(), STRING)}
    return left, right


@pytest.mark.parametrize("case", ["int", "multi", "strings"])
def test_normalize_join_keys_matches_reference(case):
    rng = np.random.default_rng(len(case))
    left, right = _key_case(case, rng)
    jl, jr = JBlock.from_dict(left), JBlock.from_dict(right)
    tl, tr = _port({"l": jl})["l"], _port({"r": jr})["r"]
    names = list(left)
    want = JJ.normalize_join_keys([jl[k] for k in names], [jr[k] for k in names])
    got = TJ.normalize_join_keys([tl[k] for k in names], [tr[k] for k in names])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert TJ.join_keys_need_verify([tl[k] for k in names], [tr[k] for k in names]) \
        is JJ.join_keys_need_verify([jl[k] for k in names], [jr[k] for k in names]) \
        is False


def test_keys_wider_than_63_bits_raise():
    """Keys past 63 bits join on the reference's hashes (bit-equal) with
    re-verification; the join kinds the reference cannot verify (left
    outer among them) still raise."""
    n = 8
    cols = {"a": column_from_numpy(np.arange(n), INT64),
            "b": column_from_numpy(np.arange(n), INT64)}
    jt = JBlock.from_dict(cols)
    t = _port({"t": jt})["t"]
    assert TJ.join_keys_need_verify([t["a"], t["b"]], [t["a"], t["b"]])
    got = TJ.normalize_join_keys([t["a"], t["b"]], [t["a"], t["b"]])
    want = JJ.normalize_join_keys([jt["a"], jt["b"]], [jt["a"], jt["b"]])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    with pytest.raises(NotImplementedError, match="wider than 63 bits"):
        TJ.hash_join(t, t, ["a", "b"], ["a", "b"], kind="left")


@pytest.mark.parametrize("capacity", [None, 700, 150], ids=["unique", "general", "overflow"])
def test_hash_join_matches_reference(capacity):
    j, t = _tables(seed=3)
    jo, j_overflow, j_flags, jb = _ref_join(j, capacity)
    to, tx = TJ.hash_join(t["probe"], t["build"], ["pk"], ["bk"],
                          output_capacity=capacity)
    assert _rows(to) == _rows(jo)
    assert int(tx["overflow"]) == int(j_overflow)
    assert (int(tx["overflow"]) > 0) == (capacity == 150)
    np.testing.assert_array_equal(_np(tx["matched_flags"]), _np(j_flags))
    tb = tx["build"]
    np.testing.assert_array_equal(_np(tb.sorted_keys), _np(jb[0]))
    np.testing.assert_array_equal(_np(tb.perm), _np(jb[1]))
    assert int(tb.num_live) == int(jb[2]) and bool(tb.unique) is bool(jb[3])
    # every live probe row with the real key 2^63-1 matched its one build
    # row, and none matched a NULL/dead build row's sentinel
    pk = t["probe"]["pk"]
    n_big = int((t["probe"].sel & pk.validity & (pk.data == BIG)).sum())
    assert n_big > 0
    if capacity != 150:
        assert sum(k == BIG for k in to.to_pylists()["pk"]) == n_big


def test_build_payload_narrows_the_build_columns():
    j, t = _tables(seed=4)
    jo = _ref_join(j, build_payload=["bv"])[0]
    to, _ = TJ.hash_join(t["probe"], t["build"], ["pk"], ["bk"], build_payload=["bv"])
    assert to.names == jo.names == ("pk", "pv", "ps", "bv")
    assert _rows(to) == _rows(jo)


def test_unique_promise_broken_reports_overflow():
    j, t = _tables(seed=5, dup=True)
    jo, j_overflow, _, _ = _ref_join(j)
    to, tx = TJ.hash_join(t["probe"], t["build"], ["pk"], ["bk"])
    assert not bool(tx["build"].unique)
    assert int(tx["overflow"]) == int(j_overflow) == t["probe"].capacity + 1
    assert _rows(to) == _rows(jo)


def _plan(P, unique):
    return P.Join(kind="inner", probe_keys=["pk"], build_keys=["bk"],
                  probe=P.TableScan("probe"), build=P.TableScan("build"),
                  unique_build=unique)


def test_run_query_retries_a_broken_unique_promise_on_the_general_path():
    """The retry grows the runner's rewritten tree, as the reference's
    does; the caller's plan is left as given."""
    j, t = _tables(seed=5, dup=True)
    jo, j_summary = j_run(_plan(JP, True), j)
    plan = _plan(TP, True)
    to, summary = t_run(plan, t)
    assert summary.retries == j_summary.retries == 1
    assert summary.overflow_nodes == j_summary.overflow_nodes == ["Join_1"]
    assert plan.unique_build is True and plan.output_capacity is None
    assert _rows(to) == _rows(jo)
    # growing the caller's own plan as the retry did gives the same rows
    grown = _plan(TP, False)
    grown.output_capacity = int(401 * 1.25) + 1
    assert _rows(t_run(grown, t)[0]) == _rows(to)
    # the general path's rows are the fast path's plus the duplicate's
    want, _ = t_run(_plan(TP, False), t)
    assert sorted(map(tuple, zip(*to.to_pylists().values()))) == \
        sorted(map(tuple, zip(*want.to_pylists().values())))


def test_overflow_keys_are_the_reference_dfs_ids():
    """Probe subtree first, then build: with a join as the build side the
    ids run Join_1, TableScan_2, Join_3, TableScan_4, TableScan_5."""
    j, t = _tables(seed=6)

    def two_joins(P):
        inner = P.Join(kind="inner", probe_keys=["pk"], build_keys=["bk"],
                       probe=P.TableScan("probe"), build=P.TableScan("build"),
                       output_capacity=150)
        return P.Join(kind="inner", probe_keys=["pv"], build_keys=["pv"],
                      probe=P.TableScan("probe"), build=inner)

    jo, jf = j_compile(two_joins(JP))(j)
    to, tf = t_compile(two_joins(TP))(t)
    assert sorted(tf) == sorted(jf) == ["Join_1", "Join_3"]
    assert {k: int(v) for k, v in tf.items()} == {k: int(v) for k, v in jf.items()}
    assert int(tf["Join_3"]) > 0
    assert _rows(to) == _rows(jo)


@pytest.mark.parametrize("kind", ["semi", "anti"])
@pytest.mark.parametrize("capacity,dup", [(None, False), (None, True), (700, False),
                                          (1, True)],
                         ids=["unique", "unique_dup_build", "general", "general_dup_build"])
def test_semi_and_anti_match_reference(kind, capacity, dup):
    """The probe rows, narrowed: no expansion and no overflow, even when
    the build keys repeat; an anti join keeps selected probe rows whose
    key is NULL, and dead probe rows stay dead."""
    j, t = _tables(seed=8, dup=dup)
    jo, j_overflow, j_flags, _ = _ref_join(j, capacity, kind=kind)
    to, tx = TJ.hash_join_with_tail(t["probe"], t["build"], ["pk"], ["bk"], kind,
                                    capacity)
    assert _rows(to) == _rows(jo)
    assert to.names == t["probe"].names
    np.testing.assert_array_equal(_np(to.sel), _np(jo.sel))
    np.testing.assert_array_equal(_np(tx["matched_flags"]), _np(j_flags))
    assert int(tx["overflow"]) == int(j_overflow) == 0
    probe = t["probe"]
    null_live = probe.sel & ~probe["pk"].validity
    assert bool(null_live.any()) and bool((~probe.sel).any())
    assert not bool((to.sel & ~probe.sel).any())
    assert bool((to.sel[null_live]).all()) == (kind == "anti")


@pytest.mark.parametrize("kind", ["semi", "anti"])
def test_semi_and_anti_join_nodes_match_reference(kind):
    """A semi/anti Join under an aggregation, through both runners."""
    from tiflash_tpu.ops.aggregate import AggDesc as JAgg

    from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg

    j, t = _tables(seed=9)

    def plan(P, AggDesc):
        join = P.Join(kind=kind, probe_keys=["pk"], build_keys=["bk"],
                      probe=P.TableScan("probe"), build=P.TableScan("build"),
                      output_capacity=1)
        return P.Aggregation(["ps"], [AggDesc("count", None, "n"),
                                      AggDesc("sum", "pv", "s")], join)

    jo, js = j_run(plan(JP, JAgg), j)
    to, ts = t_run(plan(TP, TAgg), t)
    assert _rows(to) == _rows(jo)
    assert ts.plan_text == js.plan_text and ts.retries == js.retries == 0


def _ref_join_with_tail(j, kind, capacity):
    import jax

    def run(probe, build):
        out, x = JJ.hash_join_with_tail(probe, build, ["pk"], ["bk"], kind,
                                        capacity)
        return out, x["overflow"]

    return jax.jit(run)(j["probe"], j["build"])


@pytest.mark.parametrize("kind", ["left_outer_semi_null_aware", "right_outer",
                                  "full_outer", "anti_null_aware", "left_outer_semi"])
def test_other_join_kinds_raise(kind):
    """The right, full, null-aware and left-outer-semi kinds (they raised
    before this slice of the port) equal the reference's, rows, order,
    types and overflow, on the unique and the N:M paths: with NULL build
    keys, with an empty build side (every build row dead), and with a
    NULL-free build side."""
    j, t = _tables(seed=7)
    empty = {"probe": j["probe"], "build": j["build"].with_sel(
        jnp.zeros(j["build"].capacity, dtype=bool))}
    bk = j["build"]["bk"]
    no_null = {"probe": j["probe"], "build": j["build"].with_column(
        "bk", type(bk)(bk.data, None, bk.dtype.with_nullable(False)))}
    for jt in (j, empty, no_null):
        tt = _port(jt)
        for cap in (None, 700):
            want, w_ovf = _ref_join_with_tail(jt, kind, cap)
            got, x = TJ.hash_join_with_tail(tt["probe"], tt["build"], ["pk"], ["bk"],
                                            kind, cap)
            assert _rows(got) == _rows(want), (kind, cap)
            assert got.names == want.names
            assert int(x["overflow"]) == int(w_ovf)


def test_runtime_filter_raises_in_the_compiler():
    _, t = _tables(seed=7)
    plan = _plan(TP, True)
    plan.rf_id = "rf0"
    with pytest.raises(NotImplementedError, match="runtime filter.*distribution slice"):
        t_compile(plan)(t)


def test_plan_pretty_matches_reference():
    assert _plan(TP, True).pretty() == _plan(JP, True).pretty()
