"""The port's scalar-function registry against the JAX package's: the
port registers every name the reference registers.  The 34 string and
TIME names the string slice brought, the 3 grouping functions the
analytic slice brought with the Expand node, and the 6 vector names the
vector slice brought each evaluate equal to the reference (the vector
distances within the float32 bound of ``tests/test_torch_vector.py``)."""

import pytest
import torch

import tiflash_tpu.expr.compile  # noqa: F401  (the reference's full registry)
from tiflash_tpu.expr.functions import REGISTRY as J_REGISTRY
from tiflash_tpu.expr.functions import _ALIASES as J_ALIASES

from tiflash_tpu_torch.core.block import Column
from tiflash_tpu_torch.core.dtypes import INT64
from tiflash_tpu_torch.expr.compile import ExprEvaluator
from tiflash_tpu_torch.expr.functions import REGISTRY, _ALIASES, get_function
from tiflash_tpu_torch.expr.nodes import call, col

STRING_NAMES = [
    "upper", "lower", "ucase", "lcase", "reverse", "ltrim", "rtrim", "trim",
    "length", "octet_length", "char_length", "character_length", "ascii",
    "bit_length", "crc32", "md5", "sha1", "sha", "hex", "ord", "month_name",
    "monthname", "day_name", "dayname", "json_valid"]
DURATION_NAMES = ["maketime", "sec_to_time", "timediff", "addtime", "subtime",
                  "time", "to_seconds", "any_value", "time_format"]
VECTOR_NAMES = ["vec_l2_distance", "vec_l1_distance",
                "vec_negative_inner_product", "vec_cosine_distance",
                "vec_l2_norm", "vec_dims"]
GROUPING_NAMES = ["grouping", "grouping_bit_and", "grouping_cmp"]
STRING_SLICE_NAMES = STRING_NAMES + DURATION_NAMES
# the names deferred before the analytic and the vector slices; all are
# registered since
DEFERRED_NAMES = VECTOR_NAMES + GROUPING_NAMES


def test_registry_is_the_reference_less_the_deferred_names():
    """The port registers the reference's names: none is deferred any
    more."""
    assert len(STRING_SLICE_NAMES) == len(set(STRING_SLICE_NAMES)) == 34
    assert len(VECTOR_NAMES) == len(set(VECTOR_NAMES)) == 6
    assert len(J_REGISTRY) == 181
    assert set(REGISTRY) == set(J_REGISTRY)
    assert len(REGISTRY) == 181
    assert set(GROUPING_NAMES) <= set(REGISTRY)
    assert set(VECTOR_NAMES) <= set(REGISTRY)
    import tiflash_tpu_torch.expr.functions as F

    assert not hasattr(F, "DEFERRED")


def test_aliases_are_the_reference_aliases():
    assert _ALIASES == J_ALIASES
    for alias, target in _ALIASES.items():
        if target in REGISTRY:
            assert REGISTRY[alias] is REGISTRY[target], alias
        else:
            assert alias not in REGISTRY or alias in J_REGISTRY, alias


@pytest.fixture(scope="module")
def vectors():
    """Two VECTOR columns (one nullable, with a zero row) in both
    packages, and their float64 copies."""
    import numpy as np

    from tiflash_tpu.core import dtypes as JD
    from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
    from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
    from tiflash_tpu_torch.testing.bridge import export_blocks

    rng = np.random.default_rng(31)
    x = rng.normal(size=(14, 5)).astype(np.float32)
    y = rng.normal(size=(14, 5)).astype(np.float32)
    y[4] = 0.0
    ok = np.arange(14) % 5 != 2
    jb = JBlock.from_dict({
        "v": column_from_numpy([tuple(r) for r in x], JD.Vector(5)),
        "w": column_from_numpy([tuple(r) if k else None for r, k in zip(y, ok)],
                               JD.Vector(5, nullable=True)),
    })
    y[~ok] = 0.0
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"], \
        x.astype(np.float64), y.astype(np.float64)


@pytest.fixture(scope="module")
def blocks():
    """One block in both packages: strings with NULLs and multibyte text,
    dates, datetimes, durations (negative and at +-838:59:59), ints."""
    import numpy as np

    from tiflash_tpu.core import dtypes as JD
    from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
    from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
    from tiflash_tpu_torch.testing.bridge import export_blocks

    pool = ["ab", "", " é ", "中文", "2021-03-04", "0000-01-00", None]
    s = [pool[i % len(pool)] for i in range(14)]
    jb = JBlock.from_dict({
        "s": column_from_numpy(s, JD.STRING.with_nullable(True),
                               [v is not None for v in s]),
        "d": column_from_numpy(np.arange(14, dtype=np.int32) * 97 + 9000, JD.DATE),
        "ts": column_from_numpy(np.arange(14, dtype=np.int64) * 7_777_777_777_777,
                                JD.DATETIME),
        "du": column_from_numpy(np.array([0, -1, 3_020_399_000_000,
                                          -3_020_399_000_000] + [123_456_789] * 10),
                                JD.DURATION),
        "i": column_from_numpy(np.arange(14) * 1001 - 7000, JD.INT64),
    })
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


# each string-slice name with its arguments (columns of ``blocks``)
STRING_SLICE_ARGS = {
    **{n: ("s",) for n in STRING_NAMES},
    "month_name": ("d",), "monthname": ("s",), "day_name": ("ts",),
    "dayname": ("s",), "hex": ("i",), "length": ("i",),
    "maketime": ("i", "i", "i"), "sec_to_time": ("i",),
    "timediff": ("ts", "d"), "addtime": ("ts", "du"), "subtime": ("du", "du"),
    "time": ("ts",), "to_seconds": ("d",), "any_value": ("s",),
}

# grouping-function calls: the gid column, then the marks (literals)
GROUPING_CALLS = {"grouping": [(1,), (2, 3), (4,)],
                  "grouping_bit_and": [(1,), (1, 2), (3, 4, 8)],
                  "grouping_cmp": [(1,), (2, 1), (0, 3, 5)]}


@pytest.mark.parametrize("name", DEFERRED_NAMES)
def test_deferred_name_raises_naming_its_slice(vectors, blocks, name):
    """Each name once deferred evaluates equal to the reference: a
    grouping name over gid values 1..14, for one, two and three marks; a
    vector name over two VECTOR columns, its type and NULLs exactly, its
    values within the float32 bound of ``tests/torch_vector_bounds.py``."""
    from tiflash_tpu.expr import compile as JC
    from tiflash_tpu.expr import nodes as JE

    if name in GROUPING_NAMES:
        from tiflash_tpu.core import dtypes as JD
        from tiflash_tpu.core.block import column_from_numpy
        from tiflash_tpu_torch.expr.nodes import lit

        jb, tb = blocks
        gid = torch.arange(1, 15, dtype=torch.int64)
        jg = jb.with_column("g", column_from_numpy(gid.numpy(), JD.INT64))
        tg = tb.with_column("g", Column(gid, None, INT64))
        for marks in GROUPING_CALLS[name]:
            j = JC.ExprEvaluator(jg).evaluate(
                JE.call(name, JE.col("g"), *[JE.lit(m) for m in marks]))
            t = ExprEvaluator(tg).evaluate(call(name, col("g"), *[lit(m) for m in marks]))
            assert repr(t.dtype) == repr(j.dtype)
            assert t.to_pylist() == j.to_pylist(), (name, marks)
        return
    from torch_vector_bounds import function_bound

    assert get_function(name).name == name
    jb, tb, x, y = vectors
    args = ("v",) if name in ("vec_l2_norm", "vec_dims") else ("v", "w")
    j = JC.ExprEvaluator(jb).evaluate(JE.call(name, *[JE.col(a) for a in args]))
    t = ExprEvaluator(tb).evaluate(call(name, *[col(a) for a in args]))
    assert repr(t.dtype) == repr(j.dtype)
    tv, jv = t.to_pylist(), j.to_pylist()
    assert [v is None for v in tv] == [v is None for v in jv]
    assert any(v is None for v in tv) == (len(args) == 2)
    bound = function_bound(name, x, y)
    for i, (g, w) in enumerate(zip(tv, jv)):
        if g is not None:
            assert abs(g - w) <= bound[i], (name, i, g, w)


@pytest.mark.parametrize("name", STRING_SLICE_NAMES)
def test_string_slice_name_evaluates_equal_to_reference(blocks, name):
    """Each name the string slice took out of ``DEFERRED`` evaluates as
    the reference does (``time_format``: both raise the same guard)."""
    import numpy as np

    from tiflash_tpu.expr import compile as JC
    from tiflash_tpu.expr import nodes as JE

    jb, tb = blocks
    if name == "time_format":
        for ev, E, b in ((JC.ExprEvaluator, JE, jb), (ExprEvaluator, None, tb)):
            mk = E.call if E is not None else call
            cl = E.col if E is not None else col
            with pytest.raises(NotImplementedError,
                               match="time_format is compiled in compile.py"):
                ev(b).evaluate(mk(name, cl("du"), cl("s")))
        return
    args = STRING_SLICE_ARGS[name]
    j = JC.ExprEvaluator(jb).evaluate(JE.call(name, *[JE.col(a) for a in args]))
    t = ExprEvaluator(tb).evaluate(call(name, *[col(a) for a in args]))
    assert repr(t.dtype) == repr(j.dtype)
    assert t.dictionary == (None if j.dictionary is None else tuple(j.dictionary))
    assert t.to_pylist() == j.to_pylist()
    jv = None if j.validity is None else np.asarray(j.validity).tolist()
    assert (None if t.validity is None else t.validity.tolist()) == jv


def test_unknown_name_is_a_key_error():
    with pytest.raises(KeyError, match="not registered"):
        get_function("no_such_function")


def test_error_codes_and_flag_split_match_reference():
    import torch as _torch

    from tiflash_tpu.runtime import errors as JR
    from tiflash_tpu_torch.runtime import errors as TR

    for name in ("OK", "UNKNOWN", "BAD_PLAN", "UNKNOWN_TABLE", "UNKNOWN_COLUMN",
                 "TYPE_MISMATCH", "UNSUPPORTED", "CAPACITY_OVERFLOW",
                 "MEMORY_LIMIT", "CANCELLED", "FAILPOINT", "RESOURCE_EXHAUSTED",
                 "LIMIT_EXCEEDED", "RUNTIME_EVAL", "INTERNAL"):
        code = getattr(TR, name)
        assert code == getattr(JR, name)
        assert TR.error_name(code) == JR.error_name(code) == name
    assert TR.RTERR_PREFIX == JR.RTERR_PREFIX
    flags = {"Join_3": _torch.tensor(0), TR.RTERR_PREFIX + "bad json": _torch.tensor(1)}
    cap, err = TR.split_runtime_errors(flags)
    assert list(cap) == ["Join_3"] and list(err) == ["bad json"]
    with pytest.raises(TR.EngineError, match="bad json") as info:
        TR.raise_runtime_errors(err)
    assert info.value.code == TR.RUNTIME_EVAL
    TR.raise_runtime_errors({"fine": _torch.tensor([0, 0])})
    assert TR.EvalError("m").message == "m"
