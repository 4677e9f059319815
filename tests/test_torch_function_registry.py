"""The port's scalar-function registry against the JAX package's: equal
but for exactly the 9 names that later slices of the port bring, each of
which raises ``NotImplementedError`` naming its slice, whether looked up
or called in an expression.  The 34 string and TIME names the string
slice brought each evaluate equal to the reference."""

import pytest
import torch

import tiflash_tpu.expr.compile  # noqa: F401  (the reference's full registry)
from tiflash_tpu.expr.functions import REGISTRY as J_REGISTRY
from tiflash_tpu.expr.functions import _ALIASES as J_ALIASES

from tiflash_tpu_torch.core.block import Block, Column
from tiflash_tpu_torch.core.dtypes import DATE, FLOAT32, INT64, STRING
from tiflash_tpu_torch.expr.compile import ExprEvaluator
from tiflash_tpu_torch.expr.functions import DEFERRED, REGISTRY, _ALIASES, get_function
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
DEFERRED_NAMES = VECTOR_NAMES + GROUPING_NAMES
SLICE_OF = {**{n: "ops/vector.py" for n in VECTOR_NAMES},
            **{n: "Expand" for n in GROUPING_NAMES}}


def test_registry_is_the_reference_less_the_deferred_names():
    assert len(STRING_SLICE_NAMES) == len(set(STRING_SLICE_NAMES)) == 34
    assert len(DEFERRED_NAMES) == len(set(DEFERRED_NAMES)) == 9
    assert len(J_REGISTRY) == 181
    assert set(REGISTRY) == set(J_REGISTRY) - set(DEFERRED_NAMES)
    assert len(REGISTRY) == 172
    assert set(DEFERRED) == set(DEFERRED_NAMES)


def test_aliases_are_the_reference_aliases():
    assert _ALIASES == J_ALIASES
    for alias, target in _ALIASES.items():
        if target in REGISTRY:
            assert REGISTRY[alias] is REGISTRY[target], alias
        else:
            assert alias not in REGISTRY or alias in J_REGISTRY, alias


@pytest.fixture(scope="module")
def block():
    n = 8
    return Block.from_dict({
        "i": Column(torch.arange(n, dtype=torch.int64), None, INT64),
        "d": Column(torch.arange(n, dtype=torch.int32) + 9000, None, DATE),
        "s": Column(torch.zeros(n, dtype=torch.int32), None, STRING,
                    dictionary=("x",)),
        "v": Column(torch.ones(n, 4, dtype=torch.float32), None, FLOAT32),
    })


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

_ARGS = {"v": VECTOR_NAMES}


@pytest.mark.parametrize("name", DEFERRED_NAMES)
def test_deferred_name_raises_naming_its_slice(block, name):
    with pytest.raises(NotImplementedError, match=SLICE_OF[name]):
        get_function(name)
    arg = next((c for c, names in _ARGS.items() if name in names), "i")
    args = [col(arg)] * (2 if name.startswith("vec_") and name != "vec_l2_norm"
                         and name != "vec_dims" else 1)
    with pytest.raises(NotImplementedError, match=SLICE_OF[name]):
        ExprEvaluator(block).evaluate(call(name, *args))


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
