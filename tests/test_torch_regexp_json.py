"""The port's copy of ``regexp_json.py`` against the reference module, and
the regexp, JSON and codec functions and the JSON casts through both
packages' expression compilers.

The inputs are those of ``tests/test_regexp_json.py`` (its string and
JSON pools, its regexp, JSON and codec cases) and of
``tests/test_json_casts.py`` (each CastXAsJson and CastJsonAsX
signature's value).  Results are equal: values, ``EvalError`` messages,
and dates by their text (the two packages' date classes differ)."""

import datetime
import inspect

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as JD
from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
from tiflash_tpu.expr import compile as JC
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.expr import regexp_json as JR
from tiflash_tpu.testing import oracle as O

from test_torch_strings import assert_same_column, assert_same_errors
from tiflash_tpu_torch.core import dtypes as TD
from tiflash_tpu_torch.expr import compile as TC
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.expr import regexp_json as TR
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

STR_POOL = (
    "hello world", "Hello World", "", "aXbXc", "2023-04-05",
    "foo123bar456", "line1\nline2", "éàü", "abc,def,ghi", "-1FfZz",
)
JSON_POOL = (
    '{"a": 1, "b": {"c": [10, 20, 30]}, "d": "txt"}',
    '[1, 2, {"x": true}]',
    '"just a string"',
    "42", "3.5", "null", "true",
    "not json at all", "", '{"a": {"b": {"c": 1}}}',
)
DATE_FORMATS = ("%Y-%m-%d", "%d/%m/%Y %H:%i:%s", "%W %M %D %j %U %u %a %b %e %c",
                "%y%m%d", "%h:%i %p %r %T %f")

# module function -> argument tuples (beyond the input string)
MODULE_CALLS = {
    "regexp_like": [("[0-9]+",), ("^[A-Z]",), ("hello", "i"), ("hello", "ic"),
                    ("^line2$", "m"), ("line1.line2", "n"), ("world",)],
    "regexp_instr": [("[0-9]+",), ("[0-9]+", 1, 2), ("[0-9]+", 1, 1, 1),
                     ("[a-z]+", 3)],
    "regexp_substr": [("[0-9]+",), ("[0-9]+", 1, 2), ("zzz+",)],
    "regexp_replace": [("[0-9]+", "#"), ("[aeiou]", "_", 1, 2), ("[a-z]", "*", 4)],
    "json_extract": [("$.a",), ("$.b.c[1]",), ("$[2]",), ("$[0]",), ("$.zzz",),
                     ("$.a", "$.d")],
    "json_unquote": [()], "json_type": [()], "json_valid": [()],
    "json_length": [(), ("$.b.c",)], "json_depth": [()],
    "json_contains_path": [("one", "$.a", "$.zzz"), ("all", "$.a", "$.zzz")],
    "json_keys": [(), ("$.b",)], "json_quote": [()],
    "json_contains": [("1", "$.a"), ('{"c": [10]}', "$.b"), ("true",)],
    "to_base64": [()], "from_base64": [()], "unhex": [()], "quote": [()],
    "soundex": [()], "sha2": [(224,), (256,), (384,), (512,), (0,), (7,)],
    "is_ipv4": [()], "is_ipv6": [()], "inet_aton": [()], "inet6_aton": [()],
    "conv": [(16, 10), (10, 2), (10, -16), (36, 7)],
    "str_to_date": [(f,) for f in DATE_FORMATS],
    "str_to_datetime": [(f,) for f in DATE_FORMATS],
}
INPUTS = STR_POOL + JSON_POOL + (
    '"hello\\ "', '"ok"', "192.168.0.1", "::1", "10.0.0.256", "::ffff:1.2.3.4",
    "2021-03-04", "04/03/2021 10:11:12", "Monday March 4th 063 09 1 Mon Mar 4 3",
    "210304", "10:11 PM 10:11:12 PM 22:11:12 123456", "aGVsbG8=", "!!", "616263",
    "ZZ")


def _same(a, b):
    """Equal values; errors by message; dates and other objects by type
    name and text."""
    if type(a).__name__ == "EvalError":
        return type(b).__name__ == "EvalError" and a.message == b.message
    if isinstance(a, (str, int, float, bool, type(None), bytes, list, tuple)):
        return type(a) is type(b) and a == b
    return type(a).__name__ == type(b).__name__ and str(a) == str(b)


@pytest.mark.parametrize("fname", sorted(MODULE_CALLS))
def test_module_function_matches_reference(fname):
    jf, tf = getattr(JR, fname), getattr(TR, fname)
    for s in INPUTS:
        for extra in MODULE_CALLS[fname]:
            try:
                want = jf(s, *extra)
            except Exception as e:  # the reference raises: so must the port
                with pytest.raises(type(e)):
                    tf(s, *extra)
                continue
            got = tf(s, *extra)
            assert _same(want, got), (fname, s, extra, want, got)


def test_module_number_and_date_helpers_match_reference():
    for v in (0, 1, 3232235521, 2 ** 32 - 1, 2 ** 32, -1, 167773449):
        assert TR.inet_ntoa(v) == JR.inet_ntoa(v)
    for codes in ((65,), (72, 105), (0x4E2D,), (256 + 65,), (-1,), (0xE4B8AD,)):
        assert TR.mysql_char(*codes) == JR.mysql_char(*codes)
    for v in ("20010DB8000000000000000000000001", "7F000001", "zz", ""):
        assert TR.inet6_ntoa(v) == JR.inet6_ntoa(v)
    day = datetime.date(1996, 2, 29)
    for f in DATE_FORMATS + ("%%%x %v %X %V", "plain"):
        assert TR.format_mysql_date(day, f) == JR.format_mysql_date(day, f)
        assert TR.format_has_time(f) == JR.format_has_time(f)
        assert TR.mysql_format_to_strftime(f) == JR.mysql_format_to_strftime(f)
    for doc in ([1, "a", None, {"k": [True, 2.5]}], {"b": 1, "a": "é"}, "x", 3):
        assert TR.json_dumps_mysql(doc) == JR.json_dumps_mysql(doc)
    for path in ("$", "$.a", '$."k y"', "$[3]", "$.a[1].b", "$.*", "$[*]"):
        try:
            want = repr(JR.parse_json_path(path))
        except Exception as e:
            with pytest.raises(type(e)):
                TR.parse_json_path(path)
            continue
        assert repr(TR.parse_json_path(path)) == want


def test_module_has_the_reference_functions():
    def names(mod):
        return {n for n, f in vars(mod).items()
                if inspect.isfunction(f) and f.__module__ == mod.__name__}

    assert names(TR) == names(JR)


SCHEMA = {"s": JD.STRING.with_nullable(True), "j": JD.STRING.with_nullable(True)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    table = O.random_pytable(rng, 300, {"s": SCHEMA["s"]}, str_pool=STR_POOL)
    jt = O.random_pytable(rng, 300, {"j": SCHEMA["j"]}, str_pool=JSON_POOL)
    table["j"] = jt["j"]
    jb = O.pytable_to_block(table, SCHEMA)
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


def _c(name, *args):
    return lambda E: E.call(name, *[E.col(a) if a in ("s", "j") else a
                                    for a in args])


ENGINE_CASES = {
    "like_basic": _c("regexp_like", "s", "[0-9]+"),
    "like_ci": _c("regexp_like", "s", "hello", "i"),
    "like_multiline": _c("regexp_like", "s", "^line2$", "m"),
    "like_dotall": _c("regexp_like", "s", "line1.line2", "n"),
    "alias_rlike": _c("rlike", "s", "world"),
    "instr_retopt": _c("regexp_instr", "s", "[0-9]+", 1, 1, 1),
    "instr_pos": _c("regexp_instr", "s", "[a-z]+", 3),
    "substr_occ2": _c("regexp_substr", "s", "[0-9]+", 1, 2),
    "substr_none": _c("regexp_substr", "s", "zzz+"),
    "replace_occ": _c("regexp_replace", "s", "[aeiou]", "_", 1, 2),
    "column_pattern": _c("regexp_like", "s", "s"),
    "valid": _c("json_valid", "j"), "type": _c("json_type", "j"),
    "depth": _c("json_depth", "j"), "len_path": _c("json_length", "j", "$.b.c"),
    "extract_nested": _c("json_extract", "j", "$.b.c[1]"),
    "extract_scalar_idx0": _c("json_extract", "j", "$[0]"),
    "keys_path": _c("json_keys", "j", "$.b"), "unquote": _c("json_unquote", "j"),
    "unquote_extracted": lambda E: E.call("json_unquote",
                                          E.call("json_extract", E.col("j"), "$.d")),
    "contains_all": _c("json_contains_path", "j", "all", "$.a", "$.zzz"),
    "b64_roundtrip": lambda E: E.call("from_base64", E.call("to_base64", E.col("s"))),
    "hex_unhex": lambda E: E.call("unhex", E.call("hex", E.col("s"))),
    "quote": _c("quote", "s"), "soundex": _c("soundex", "s"),
    "conv_neg_base": _c("conv", "s", 10, -16),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_case_matches_reference(data, case):
    jb, tb = data
    jev, tev = JC.ExprEvaluator(jb), TC.ExprEvaluator(tb)
    assert_same_column(jev.evaluate(ENGINE_CASES[case](JE)),
                       tev.evaluate(ENGINE_CASES[case](TE)))
    assert_same_errors(jev.runtime_errors, tev.runtime_errors)


@pytest.fixture(scope="module")
def cast_row():
    """The row of ``tests/test_json_casts.py``'s table: int, unsigned,
    double, decimal, string, datetime, time(3), and JSON texts."""
    us = round((datetime.datetime(2020, 1, 2, 3, 4, 5)
                - datetime.datetime(1970, 1, 1)).total_seconds() * 1e6)
    cols = {
        "i": column_from_numpy(np.array([-5], np.int64), JD.INT64),
        "u": column_from_numpy(np.array([2 ** 64 - 1], np.uint64), JD.UINT64),
        "r": column_from_numpy(np.array([1.5]), JD.FLOAT64),
        "d": column_from_numpy(np.array([325], np.int64), JD.Decimal(10, 2)),
        "s": column_from_numpy(["[true, null]"], JD.STRING),
        "t": column_from_numpy(np.array([us], np.int64), JD.DATETIME),
        "du": column_from_numpy(np.array([45_000_250_000], np.int64), JD.DURATION),
        "js": column_from_numpy(['{"a": [1, 2]}'], JD.STRING),
        "n123": column_from_numpy(["123"], JD.STRING),
        "n15": column_from_numpy(["1.5"], JD.STRING),
        "qdt": column_from_numpy(['"2020-01-02 03:04:05"'], JD.STRING),
        "qtm": column_from_numpy(['"12:30:00"'], JD.STRING),
    }
    jb = JBlock.from_dict(cols)
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


def _json(c):
    return lambda E, D: E.call("cast_as_json", E.col(c))


def _out_of_json(c, target):
    return lambda E, D: E.cast(E.call("cast_as_json", E.col(c)), target(D))


JSON_CAST_CASES = {
    "CastIntAsJson": _json("i"), "CastIntAsJson/unsigned": _json("u"),
    "CastRealAsJson": _json("r"), "CastDecimalAsJson": _json("d"),
    "CastStringAsJson": _json("s"), "CastTimeAsJson": _json("t"),
    "CastDurationAsJson": _json("du"),
    "CastJsonAsJson": lambda E, D: E.call("cast_as_json",
                                          E.call("cast_as_json", E.col("js"))),
    "CastJsonAsString": _out_of_json("js", lambda D: D.STRING),
    "CastJsonAsInt": _out_of_json("n123", lambda D: D.INT64),
    "CastJsonAsInt/object": _out_of_json("js", lambda D: D.INT64),
    "CastJsonAsReal": _out_of_json("n15", lambda D: D.FLOAT64),
    "CastJsonAsDecimal": _out_of_json("n15", lambda D: D.Decimal(10, 2)),
    "CastJsonAsTime": _out_of_json("qdt", lambda D: D.DATETIME),
    "CastJsonAsDuration": _out_of_json("qtm", lambda D: D.DURATION),
    "JsonValidJsonSig": lambda E, D: E.call("json_valid",
                                            E.call("cast_as_json", E.col("js"))),
}


@pytest.mark.parametrize("sig", sorted(JSON_CAST_CASES))
def test_json_cast_signature_matches_reference(cast_row, sig):
    jb, tb = cast_row
    j = JC.ExprEvaluator(jb).evaluate(JSON_CAST_CASES[sig](JE, JD))
    t = TC.ExprEvaluator(tb).evaluate(JSON_CAST_CASES[sig](TE, TD))
    assert_same_column(j, t)
