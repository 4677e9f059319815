"""The port's scalar-function registry against the JAX package's: equal
but for exactly the 43 names that later slices of the port bring, each
of which raises ``NotImplementedError`` naming its slice, whether looked
up or called in an expression."""

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
DEFERRED_NAMES = STRING_NAMES + DURATION_NAMES + VECTOR_NAMES + GROUPING_NAMES
SLICE_OF = {**{n: "string slice" for n in STRING_NAMES + DURATION_NAMES},
            **{n: "ops/vector.py" for n in VECTOR_NAMES},
            **{n: "Expand" for n in GROUPING_NAMES}}


def test_registry_is_the_reference_less_the_deferred_names():
    assert len(DEFERRED_NAMES) == len(set(DEFERRED_NAMES)) == 43
    assert len(J_REGISTRY) == 181
    assert set(REGISTRY) == set(J_REGISTRY) - set(DEFERRED_NAMES)
    assert len(REGISTRY) == 138
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


_ARGS = {"s": STRING_NAMES, "d": DURATION_NAMES, "v": VECTOR_NAMES}


@pytest.mark.parametrize("name", DEFERRED_NAMES)
def test_deferred_name_raises_naming_its_slice(block, name):
    with pytest.raises(NotImplementedError, match=SLICE_OF[name]):
        get_function(name)
    arg = next((c for c, names in _ARGS.items() if name in names), "i")
    args = [col(arg)] * (2 if name.startswith("vec_") and name != "vec_l2_norm"
                         and name != "vec_dims" else 1)
    with pytest.raises(NotImplementedError, match=SLICE_OF[name]):
        ExprEvaluator(block).evaluate(call(name, *args))


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
