"""Window functions, grouping-sets replication and the segment fills: the
PyTorch port's ``ops/window.py``, ``ops/expand.py`` and ``ops/segments.py``
against the JAX package's on the same blocks, made with numpy from a seed.

Every ``WindowDesc`` function and frame type runs over partitions by an
int, a string and a float key, ordered by nullable int, decimal, date and
float keys, ascending and descending, with NULLs (payloads under NULL are
not zero) and dead rows.  The float keys hold NaN, -0.0, 0.0 and +-inf:
the reference orders -0.0 with 0.0 and every NaN last, and so does the
port (ROADMAP, section C item 3).

Tolerance: zero for integers, decimals, dates, strings, ranks and the
IEEE-exact divisions of percent_rank and cume_dist.  Float sums (running
and framed sums and averages of a double) add in another tree than the
reference's associative scan, so they hold within ``FLOAT_REL`` relative
of the reference's value: a frame sum is a difference of two prefix sums
of its partition, and its error is a few ulps of those prefixes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
from tiflash_tpu.ops import expand as JX
from tiflash_tpu.ops import segments as JSeg
from tiflash_tpu.ops import window as JW
from tiflash_tpu.ops.sort import SortKey as JSK

from tiflash_tpu_torch.ops import expand as TX
from tiflash_tpu_torch.ops import segments as TSeg
from tiflash_tpu_torch.ops import window as TW
from tiflash_tpu_torch.ops.sort import SortKey as TSK
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 320
# float sums: the reference's value to this relative distance (the
# partitions' prefixes stay within 2^12 of the frame sums here)
FLOAT_REL = 1e-12
FLOAT_EDGES = [float("nan"), -0.0, 0.0, float("inf"), float("-inf"), 1.5, -2.25]


def _table(seed: int, n: int = N):
    """One block in both packages: partition keys p (nullable int with
    payloads under NULL), s (nullable string), fk (nullable double with
    NaN, -0.0, 0.0 and +-inf); order keys o (nullable int32), o2 (int64,
    ties broken), d (nullable decimal(10,2)), dt (date), f (nullable
    positive double); values v (nullable int64), f; a selection."""
    rng = np.random.default_rng(seed)
    p_valid = rng.random(n) > 0.1
    fk = rng.choice(FLOAT_EDGES, n)
    cols = {
        "p": column_from_numpy(rng.integers(0, 6, n), JD.INT64.with_nullable(True),
                               validity=p_valid),
        "s": column_from_numpy(rng.choice(["aa", "bb", "cc", ""], n).tolist(),
                               JD.STRING.with_nullable(True),
                               validity=rng.random(n) > 0.15),
        "fk": column_from_numpy(fk, JD.FLOAT64.with_nullable(True),
                                validity=rng.random(n) > 0.1),
        "o": column_from_numpy(rng.integers(-20, 20, n).astype(np.int32),
                               JD.INT32.with_nullable(True),
                               validity=rng.random(n) > 0.15),
        "o2": column_from_numpy(rng.permutation(n).astype(np.int64), JD.INT64),
        "d": column_from_numpy(rng.integers(-3000, 3000, n), JD.Decimal(10, 2, True),
                               validity=rng.random(n) > 0.15),
        "dt": column_from_numpy((rng.integers(0, 60, n) + 9000).astype(np.int32),
                                JD.DATE),
        "v": column_from_numpy(rng.integers(-50, 50, n), JD.INT64.with_nullable(True),
                               validity=rng.random(n) > 0.15),
        "f": column_from_numpy(rng.uniform(0.5, 100.0, n), JD.FLOAT64.with_nullable(True),
                               validity=rng.random(n) > 0.15),
    }
    # payloads under NULL partition keys differ: the NULLs must stay one
    # partition
    jb = JBlock.from_dict(cols).with_sel(jnp.asarray(rng.random(n) > 0.12))
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


def _ref_window(jb, part, order, funcs):
    run = jax.jit(lambda b: JW.window_block(b, part, order, funcs))
    return run(jb)


def assert_same_rows(got, want, float_cols=()):
    """Live rows, in order, equal; ``float_cols`` within ``FLOAT_REL``."""
    g, w = got.to_pylists(), want.to_pylists()
    assert list(g) == list(w)
    assert [repr(c.dtype) for c in got.columns] == [repr(c.dtype) for c in want.columns]
    for name in w:
        assert len(g[name]) == len(w[name]), name
        if name not in float_cols:
            assert g[name] == w[name] or _same_floats(g[name], w[name]), name
            continue
        for x, y in zip(g[name], w[name]):
            assert (x is None) == (y is None), (name, x, y)
            if y is not None:
                assert abs(x - y) <= FLOAT_REL * abs(y), (name, x, y)


def _same_floats(a, b):
    """Lists equal, NaN equal to NaN."""
    return len(a) == len(b) and all(
        x == y or (isinstance(x, float) and isinstance(y, float) and x != x and y != y)
        for x, y in zip(a, b))


def _descs(W, specs):
    return [W.WindowDesc(*s[:2], **s[2]) if len(s) > 2 else W.WindowDesc(*s)
            for s in specs]


# (partition, [(order name, desc)], [(func, name, {kw})], float outputs)
CASES = {
    "ranks": (["p"], [("o", True), ("o2", False)],
              [("row_number", "rn"), ("rank", "rk"), ("dense_rank", "dr"),
               ("percent_rank", "pr"), ("cume_dist", "cd"),
               ("ntile", "nt3", {"offset": 3}), ("ntile", "nt7", {"offset": 7})], ()),
    "lead_lag": (["s"], [("o2", False)],
                 [("lag", "lg", {"arg": "v"}), ("lead", "ld", {"arg": "v", "offset": 2,
                                                               "default": 0}),
                  ("lag", "lgs", {"arg": "s", "offset": 3}),
                  ("lead", "ldd", {"arg": "d"}), ("lag", "lgt", {"arg": "dt", "offset": 2})],
                 ()),
    "first_last_nth": (["p"], [("o2", True)],
                       [("first_value", "fv", {"arg": "v"}),
                        ("last_value", "lv", {"arg": "v"}),
                        ("nth_value", "n2", {"arg": "v", "offset": 2}),
                        ("first_value", "fvr", {"arg": "d", "frame": (1, 1)}),
                        ("last_value", "lvr", {"arg": "s", "frame": (None, 0)}),
                        ("nth_value", "n3r", {"arg": "v", "offset": 3, "frame": (2, None)}),
                        ("first_value", "fve", {"arg": "v", "frame": (3, -1)})], ()),
    "running": (["p"], [("o", False)],
                [("sum", "sv", {"arg": "v"}), ("count", "cv", {"arg": "v"}),
                 ("count", "c", {}), ("avg", "av", {"arg": "v"}),
                 ("sum", "sd", {"arg": "d"}), ("avg", "ad", {"arg": "d"}),
                 ("min", "mn", {"arg": "v"}), ("max", "mx", {"arg": "d"}),
                 ("sum", "sf", {"arg": "f"}), ("min", "mnf", {"arg": "f"}),
                 ("max", "mxf", {"arg": "fk"})], ("sf",)),
    "rows_frames": (["s"], [("o2", False)],
                    [("sum", "s22", {"arg": "v", "frame": (2, 2)}),
                     ("count", "c03", {"arg": "v", "frame": (0, 3)}),
                     ("avg", "a_1", {"arg": "d", "frame": (None, 1)}),
                     ("sum", "e31", {"arg": "v", "frame": (3, -1)}),
                     ("sum", "f22", {"arg": "f", "frame": (2, 2)}),
                     ("avg", "fa", {"arg": "f", "frame": (1, None)}),
                     ("min", "m22", {"arg": "v", "frame": (2, 2)}),
                     ("max", "x13", {"arg": "f", "frame": (1, 3)}),
                     ("min", "mu", {"arg": "d", "frame": (None, 0)})],
                    ("f22", "fa")),
    "range_int": (["p"], [("o", False)],
                  [("sum", "r", {"arg": "v", "frame": (3, 2), "frame_type": "range"}),
                   ("count", "rc", {"frame": (0, 0), "frame_type": "range"}),
                   ("min", "rm", {"arg": "v", "frame": (None, 4), "frame_type": "range"}),
                   ("last_value", "rl", {"arg": "o2", "frame": (1, 1),
                                         "frame_type": "range"})], ()),
    "range_int_desc": (["s"], [("o", True)],
                       [("sum", "r", {"arg": "v", "frame": (5, 0), "frame_type": "range"}),
                        ("avg", "ra", {"arg": "f", "frame": (2, 2), "frame_type": "range"}),
                        ("max", "rx", {"arg": "d", "frame": (1, 2),
                                       "frame_type": "range"})], ("ra",)),
    "range_decimal": (["p"], [("d", False)],
                      [("sum", "r", {"arg": "v", "frame": (500, 250),
                                     "frame_type": "range"}),
                       ("count", "rc", {"frame": (None, 100), "frame_type": "range"})], ()),
    "range_date": ([], [("dt", True)],
                   [("sum", "r", {"arg": "d", "frame": (7, 7), "frame_type": "range"}),
                    ("count", "rc", {"arg": "v", "frame": (0, 3), "frame_type": "range"}),
                    ("min", "rm", {"arg": "f", "frame": (2, 0), "frame_type": "range"})],
                   ()),
    "range_float_edges": (["p"], [("fk", False)],
                          [("count", "rc", {"frame": (1, 1), "frame_type": "range"}),
                           ("sum", "rs", {"arg": "v", "frame": (0, 2),
                                          "frame_type": "range"}),
                           ("rank", "rk")], ()),
    "float_partition_and_order": (["fk"], [("fk", True), ("o2", False)],
                                  [("row_number", "rn"), ("rank", "rk"),
                                   ("dense_rank", "dr"), ("sum", "sv", {"arg": "v"}),
                                   ("lag", "lg", {"arg": "fk"})], ()),
    "float_order_asc": (["s"], [("fk", False)],
                        [("rank", "rk"), ("dense_rank", "dr"), ("cume_dist", "cd"),
                         ("first_value", "fv", {"arg": "fk"})], ()),
    "no_partition": ([], [("o", False), ("o2", True)],
                     [("row_number", "rn"), ("ntile", "nt", {"offset": 4}),
                      ("sum", "sv", {"arg": "v"}),
                      ("max", "m", {"arg": "v", "frame": (4, 1)})], ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_function_matches_reference(case):
    part, order, specs, float_cols = CASES[case]
    jb, tb = _table(sorted(CASES).index(case))
    jw = _ref_window(jb, part, [JSK(n, d) for n, d in order], _descs(JW, specs))
    tw = TW.window_block(tb, part, [TSK(n, d) for n, d in order], _descs(TW, specs))
    assert_same_rows(tw, jw, float_cols)


def test_window_default_frame_includes_peers_and_null_partition_is_one():
    """A hand-checked case: the running sum includes the current row's
    peers; rows whose partition key is NULL (with different payloads)
    form one partition."""
    from tiflash_tpu_torch.core.block import Block, Column
    from tiflash_tpu_torch.core.dtypes import INT64

    p = Column(torch.tensor([5, 7, 1, 1, 1]), torch.tensor([False, False, True, True, True]),
               INT64.with_nullable(True))
    o = Column(torch.tensor([1, 1, 2, 2, 3]), None, INT64)
    v = Column(torch.tensor([10, 20, 1, 2, 4]), None, INT64)
    b = Block.from_dict({"p": p, "o": o, "v": v})
    out = TW.window_block(b, ["p"], [TSK("o")], [TW.WindowDesc("sum", "s", arg="v"),
                                                 TW.WindowDesc("rank", "r")])
    got = out.to_pylists()
    # a NULL partition key sorts after the valid ones
    assert got["p"] == [1, 1, 1, None, None]
    assert got["s"] == [3, 3, 7, 30, 30]
    assert got["r"] == [1, 1, 3, 1, 1]


def test_segment_fills_match_reference():
    rng = np.random.default_rng(3)
    for n in (1, 2, 17, 500):
        flags = rng.random(n) < 0.2
        flags[0] = flags[-1] = True
        t = torch.as_tensor(flags)
        assert TSeg.forward_fill_positions(t).tolist() == \
            np.asarray(JSeg.forward_fill_positions(jnp.asarray(flags))).tolist()
        assert TSeg.backward_fill_positions(t).tolist() == \
            np.asarray(JSeg.backward_fill_positions(jnp.asarray(flags))).tolist()


@pytest.mark.parametrize("sets", [[["p", "s"], ["p"], []], [["s"], []], [["fk", "p"]],
                                  [["p"], ["s"], ["p", "s"]]])
def test_expand_matches_reference(sets):
    jb, tb = _table(11, 60)
    jx = JX.expand_block(jb, sets)
    tx = TX.expand_block(tb, sets)
    assert tx.names == jx.names
    assert [repr(c.dtype) for c in tx.columns] == [repr(c.dtype) for c in jx.columns]
    assert _same_rows_nan(tx.to_pylists(), jx.to_pylists())
    assert tx.capacity == jx.capacity == 60 * len(sets)


def _same_rows_nan(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(_same_floats(a[k], b[k]) for k in b)


@pytest.mark.parametrize("part,order", [([], []), (["p"], []), ([], [("o2", False)])])
def test_window_without_selection_matches_reference(part, order):
    """A block with no selection (every row live, so the dead-row flag
    orders nothing), and windows with no partition or no order keys."""
    jb, _ = _table(17, 90)
    jb = JBlock(names=jb.names, columns=jb.columns, sel=None)
    tb = blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]
    specs = [("row_number", "rn"), ("rank", "rk"), ("ntile", "nt", {"offset": 4}),
             ("sum", "sv", {"arg": "v"}), ("lag", "lg", {"arg": "v"}),
             ("count", "c", {"frame": (1, 1)})]
    jw = _ref_window(jb, part, [JSK(n, d) for n, d in order], _descs(JW, specs))
    tw = TW.window_block(tb, part, [TSK(n, d) for n, d in order], _descs(TW, specs))
    assert_same_rows(tw, jw)
    assert tw.sel is None and int(tw.num_rows()) == 90
