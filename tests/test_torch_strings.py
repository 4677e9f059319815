"""The string functions of the port against the JAX package, one case per
function name (aliases included), tolerance zero.

Both packages evaluate the same expression over one seeded block: string
columns with NULLs, empty strings, multibyte UTF-8 (``é``, ``中``),
leading and trailing spaces, dates and JSON as text; integer columns
with range stats or only a value domain; floats, decimals, dates,
datetimes, durations and bools.  Every fifth row is dead, and its string
codes (and one integer column's values) lie outside the dictionary or
the range stats, as narrow32 wraparound leaves them: every LUT must clip
before it gathers.  Results are compared on every row, dead ones
included: type, dictionary (as a tuple), validity, values, range stats,
and the runtime-error masks an ``EvalError`` entry leaves.
"""

import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.core.block import Block as JBlock, column_from_numpy
from tiflash_tpu.expr import compile as JC
from tiflash_tpu.expr import nodes as JE

from tiflash_tpu_torch.expr import compile as TC
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

N = 60
CLOCK_US = 1_700_000_123_456_789
DAY_US = 86_400_000_000

STR_POOL = ("ab", "", "  pad  ", "é", "中文", "Hello World", "12abc", "-4.5",
            "2023-04-05", "a,b,c", "foo123bar456", " x", "AbC")
JSON_POOL = ('{"a": 1, "b": {"c": [10, 20, 30]}, "d": "txt"}',
             '[1, 2, {"x": true}]', '"just a string"', "42", "3.5", "null",
             "true", "not json at all", "", '{"a": {"b": {"c": 1}}}',
             '"esc\\u00e9"')
IP_POOL = ("192.168.0.1", "::1", "bad", "10.0.0.256", "2001:db8::ff00:42:8329",
           "0.0.0.0", "::ffff:1.2.3.4")
DATE_POOL = ("2021-03-04", "1999-12-31 23:59:59", "0000-01-00", "bad",
             "20200229", "2020-02-30", "03-04-2021", "2024-07-15 08:09:10.5")
HEX_POOL = ("61626364", "GG", "7", "", "E4B8AD")


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _pick(rng, pool, nullable=True):
    return [None if nullable and rng.random() < 0.12 else
            str(rng.choice(list(pool))) for _ in range(N)]


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(17)
    live = np.arange(N) % 5 != 4
    valid = lambda p=0.12: rng.random(N) > p  # noqa: E731

    def strings(pool, nullable=True):
        vals = _pick(rng, pool, nullable)
        dt = JD.STRING.with_nullable(nullable)
        c = column_from_numpy(vals, dt, [v is not None for v in vals]
                              if nullable else None)
        # dead rows carry codes outside the dictionary
        codes = np.asarray(c.data).copy()
        codes[~live] = np.where(np.arange(N)[~live] % 2 == 0, -5, 1000)
        return dataclasses.replace(c, data=jnp.asarray(codes), narrow32=None)

    n_live = rng.integers(-3, 9, N)
    n_vals = np.where(live, n_live, 10 ** 6)
    n_ok = valid()
    n_col = column_from_numpy(n_vals.astype(np.int64), JD.INT64.with_nullable(True),
                              n_ok)
    live_ok = live & n_ok
    n_col = dataclasses.replace(n_col, narrow32=None, domain=None, stats=(
        int(n_vals[live_ok].min()), int(n_vals[live_ok].max())))
    big = rng.choice([0, 1, -1, 2 ** 62, -(2 ** 62), 44, 255], N)
    f = rng.choice([1.5, -2.25, 0.1, 3.0, 255.5, -0.5, 1000.0], N)
    g = rng.choice([1.3, -2.5, 0.1, 7.0], N).astype(np.float32)
    du = rng.integers(-3_020_399_000_000, 3_020_399_000_000, N)
    du[:6] = [0, -1, 3_020_399_000_000, -3_020_399_000_000, 3_723_456_789,
              -3_723_456_789]
    ts = rng.integers(_days(1990, 1, 1), _days(2030, 1, 1), N) * DAY_US \
        + rng.integers(0, DAY_US, N)
    ts2 = ts + rng.integers(-400 * DAY_US, 400 * DAY_US, N)
    cols = {
        "s": strings(STR_POOL),
        "t": strings(("x", "ab", "é", "", " 7 ", "-"), nullable=False),
        "p": strings(("%b%", "a_", "", "%", "É%", "[a-z]+", "x")),
        "j": strings(JSON_POOL),
        "ip": strings(IP_POOL),
        "ds": strings(DATE_POOL),
        "hx": strings(HEX_POOL),
        "n": n_col,
        "k": column_from_numpy(rng.integers(1, 8, N), JD.INT64),
        "c": column_from_numpy(rng.integers(60, 100, N), JD.INT64),
        "big": column_from_numpy(big.astype(np.int64), JD.INT64.with_nullable(True),
                                 valid()),
        "f": column_from_numpy(f, JD.FLOAT64.with_nullable(True), valid()),
        "g": column_from_numpy(g, JD.FLOAT32),
        "m": column_from_numpy(rng.integers(-99999, 99999, N),
                               JD.Decimal(10, 2, True), valid()),
        "dt": column_from_numpy(rng.integers(_days(1995, 1, 1), _days(1997, 12, 31), N)
                                .astype(np.int32), JD.DATE.with_nullable(True), valid()),
        "ts": column_from_numpy(ts.astype(np.int64), JD.DATETIME),
        "ts2": column_from_numpy(ts2.astype(np.int64), JD.DATETIME.with_nullable(True),
                                 valid()),
        "du": column_from_numpy(du.astype(np.int64), JD.DURATION.with_nullable(True),
                                valid()),
        "b": column_from_numpy(rng.random(N) > 0.5, JD.BOOL.with_nullable(True),
                               valid()),
        "sec": column_from_numpy(rng.integers(-4_000_000, 4_000_000, N), JD.INT64),
        "msec": column_from_numpy(rng.integers(-10 ** 9, 10 ** 9, N),
                                  JD.Decimal(12, 3)),
        "mi": column_from_numpy(rng.integers(-2, 62, N), JD.INT64),
    }
    jb = JBlock.from_dict(cols, sel=jnp.asarray(live))
    return jb, blocks_from_numpy(export_blocks({"t": jb}), "cpu")["t"]


def C(name, *args):
    """A call whose arguments are column names (str) or literals (lit)."""
    return lambda E: E.call(name, *[E.col(a) if isinstance(a, str) else
                                    E.lit(a.value) for a in args])


class lit:
    def __init__(self, value):
        self.value = value


# the 25 string names of the registry
REGISTRY_NAMES = [
    "upper", "lower", "ucase", "lcase", "reverse", "ltrim", "rtrim", "trim",
    "length", "octet_length", "char_length", "character_length", "ascii",
    "bit_length", "crc32", "md5", "sha1", "sha", "hex", "ord", "month_name",
    "monthname", "day_name", "dayname", "json_valid"]

# the 66 names only the expression compiler handles
COMPILE_NAMES = [
    "bin", "cast_as_json", "char", "concat", "concat_prefix", "concat_ws",
    "connection_id", "conv", "current_user", "database", "date_format", "elt",
    "export_set", "field", "find_in_set", "format", "from_base64", "get_format",
    "ilike", "inet6_aton", "inet6_ntoa", "inet_aton", "inet_ntoa", "insert_str",
    "instr", "is_ipv4", "is_ipv6", "json_array", "json_contains",
    "json_contains_path", "json_depth", "json_extract", "json_keys",
    "json_length", "json_object", "json_quote", "json_type", "json_unquote",
    "left", "locate", "lpad", "make_set", "oct", "position", "quote",
    "regexp_instr", "regexp_like", "regexp_replace", "regexp_substr", "repeat",
    "replace", "right", "rpad", "schema", "sha2", "soundex", "space",
    "str_to_date", "strcmp", "substring", "substring_index", "timestampdiff",
    "to_base64", "unhex", "user", "version"]

ALIASES = ["regexp", "rlike", "mid", "substr", "insert", "json_array_length",
           "curtime", "current_time", "utc_time"]

CASES = {
    # the registry: a string column, and a number's implicit text
    "upper s": C("upper", "s"), "ucase t": C("ucase", "t"),
    "lower s": C("lower", "s"), "lcase s": C("lcase", "s"),
    "reverse s": C("reverse", "s"), "ltrim s": C("ltrim", "s"),
    "rtrim s": C("rtrim", "s"), "trim s": C("trim", "s"),
    "trim concat": lambda E: E.call("trim", E.call("concat", E.col("t"), "  ")),
    "length s": C("length", "s"), "length n": C("length", "n"),
    "length m": C("length", "m"), "octet_length s": C("octet_length", "s"),
    "char_length s": C("char_length", "s"),
    "character_length t": C("character_length", "t"),
    "ascii s": C("ascii", "s"), "ascii k": C("ascii", "k"),
    "bit_length s": C("bit_length", "s"), "crc32 s": C("crc32", "s"),
    "md5 s": C("md5", "s"), "sha1 s": C("sha1", "s"), "sha t": C("sha", "t"),
    "hex s": C("hex", "s"), "hex n": C("hex", "n"), "hex big": C("hex", "big"),
    "hex f": C("hex", "f"), "ord s": C("ord", "s"),
    "monthname dt": C("monthname", "dt"), "month_name ts": C("month_name", "ts"),
    "monthname ds": C("monthname", "ds"), "dayname dt": C("dayname", "dt"),
    "day_name ds": C("day_name", "ds"),
    "json_valid j": C("json_valid", "j"), "json_valid k": C("json_valid", "k"),
    "json_valid col": lambda E: E.call("json_valid", E.call("concat", E.col("j"), "")),
    # transforms with literal parameters
    "concat s": C("concat", "s", lit("-"), lit(7)),
    "concat_prefix s": C("concat_prefix", "s", lit("<")),
    "substring s 2": C("substring", "s", lit(2)),
    "substring s -3 2": C("substring", "s", lit(-3), lit(2)),
    "substr s 0": C("substr", "s", lit(0)), "mid s 2 1": C("mid", "s", lit(2), lit(1)),
    "left s 2": C("left", "s", lit(2)), "right s 3": C("right", "s", lit(3)),
    "replace s": C("replace", "s", lit("a"), lit("é")),
    "repeat t 3": C("repeat", "t", lit(3)),
    "insert_str s": C("insert_str", "s", lit(2), lit(1), lit("中")),
    "insert s": C("insert", "s", lit(1), lit(9), lit("#")),
    "substring_index s": C("substring_index", "s", lit(","), lit(2)),
    "substring_index s -1": C("substring_index", "s", lit(","), lit(-1)),
    "substring_index n": C("substring_index", "s", lit("a"), "n"),
    "lpad s n t": C("lpad", "s", "n", "t"), "lpad s 5 lit": C("lpad", "s", lit(5), lit("*")),
    "rpad t k lit": C("rpad", "t", "k", lit("ab")),
    "rpad s n empty": C("rpad", "s", "n", lit("")),
    "concat_ws cols": C("concat_ws", lit("|"), "s", "t", lit("z")),
    "concat_ws one col": C("concat_ws", lit(", "), lit("a"), "s", lit(None)),
    "concat_ws col sep": C("concat_ws", "t", "s", lit("L")),
    "elt k lits": C("elt", "k", lit("one"), lit("two"), lit("three")),
    "elt n cols": C("elt", "n", "s", "t", lit("zz")),
    # positions and compares
    "locate s": C("locate", lit("b"), "s"), "position s": C("position", lit("a"), "s"),
    "instr s": C("instr", "s", lit("o")), "strcmp s": C("strcmp", "s", lit("ab")),
    "find_in_set t": C("find_in_set", "t", lit("x,ab,é")),
    "field t": C("field", "t", lit("ab"), lit("x")),
    # regexp
    "regexp_like s": C("regexp_like", "s", lit("[0-9]+")),
    "regexp_like s i": C("regexp_like", "s", lit("^h"), lit("i")),
    "regexp_like cols": C("regexp_like", "s", "p"),
    "regexp s": C("regexp", "s", lit("o")), "rlike t": C("rlike", "t", lit("^a")),
    "regexp_instr s": C("regexp_instr", "s", lit("[0-9]+"), lit(1), lit(2)),
    "regexp_substr s": C("regexp_substr", "s", lit("[0-9]+")),
    "regexp_replace s": C("regexp_replace", "s", lit("[aeiou]"), lit("_")),
    # JSON
    "json_extract j": C("json_extract", "j", lit("$.b.c[1]")),
    "json_unquote extract": lambda E: E.call("json_unquote", E.call(
        "json_extract", E.col("j"), "$.d")),
    "json_type j": C("json_type", "j"), "json_length j": C("json_length", "j"),
    "json_array_length j": C("json_array_length", "j"),
    "json_depth j": C("json_depth", "j"), "json_keys j": C("json_keys", "j"),
    "json_quote s": C("json_quote", "s"),
    "json_contains j": C("json_contains", "j", lit("1"), lit("$.a")),
    "json_contains_path j": C("json_contains_path", "j", lit("one"), lit("$.a"),
                              lit("$.zzz")),
    "json_contains_path col": C("json_contains_path", "j", lit("all"), "t"),
    "json_object s": C("json_object", lit("mode"), "s"),
    "json_object k n": C("json_object", lit("k"), "k", lit("n"), "n"),
    "json_array s k": C("json_array", "s", "k", lit(None)),
    "json_array lits": C("json_array", lit(1), lit("a")),
    "cast_as_json n": C("cast_as_json", "n"), "cast_as_json f": C("cast_as_json", "f"),
    "cast_as_json m": C("cast_as_json", "m"), "cast_as_json dt": C("cast_as_json", "dt"),
    "cast_as_json ts": C("cast_as_json", "ts"), "cast_as_json du": C("cast_as_json", "du"),
    "cast_as_json b": C("cast_as_json", "b"),
    "cast_as_json quote": lambda E: E.call("cast_as_json", E.call("json_quote", E.col("s"))),
    "cast_as_json j": C("cast_as_json", "j"),
    # codecs
    "to_base64 s": C("to_base64", "s"),
    "from_base64 roundtrip": lambda E: E.call("from_base64", E.call("to_base64", E.col("s"))),
    "from_base64 s": C("from_base64", "s"), "unhex hx": C("unhex", "hx"),
    "unhex k": C("unhex", "c"), "quote s": C("quote", "s"), "soundex s": C("soundex", "s"),
    "conv s": C("conv", "s", lit(16), lit(10)), "sha2 s": C("sha2", "s", lit(256)),
    "inet_aton ip": C("inet_aton", "ip"), "inet_ntoa big": C("inet_ntoa", "big"),
    "inet6_aton ip": C("inet6_aton", "ip"),
    "inet6_ntoa aton": lambda E: E.call("inet6_ntoa", E.call("inet6_aton", E.col("ip"))),
    "is_ipv4 ip": C("is_ipv4", "ip"), "is_ipv6 ip": C("is_ipv6", "ip"),
    # integers to strings
    "bin n": C("bin", "n"), "bin big": C("bin", "big"), "oct c": C("oct", "c"),
    "format m": C("format", "m", lit(1)), "format f": C("format", "f", lit(2)),
    "format c": C("format", "c", lit(0)), "char c": C("char", "c"),
    "space k": C("space", "k"), "make_set k": C("make_set", "k", lit("a"), lit("b"), lit("c")),
    "export_set k": C("export_set", "k", lit("Y"), lit("N"), lit(","), lit(4)),
    # dates
    "date_format dt": C("date_format", "dt", lit("%Y-%m %W %j")),
    "date_format null": C("date_format", "dt", lit(None)),
    "str_to_date ds": C("str_to_date", "ds", lit("%Y-%m-%d")),
    "str_to_date time": C("str_to_date", "ds", lit("%Y-%m-%d %H:%i:%s")),
    "str_to_date mdy": C("str_to_date", "ds", lit("%m-%d-%Y")),
    "timestampdiff MONTH": C("timestampdiff", lit("MONTH"), "ts", "ts2"),
    "timestampdiff DAY": C("timestampdiff", lit("DAY"), "dt", "ts2"),
    "timestampdiff QUARTER": C("timestampdiff", lit("QUARTER"), "ts2", "dt"),
    "timestampdiff MINUTE": C("timestampdiff", lit("minute"), "ts", "ts2"),
    "get_format DATE": C("get_format", lit("DATE"), lit("EUR")),
    "get_format col": C("get_format", lit("TIME"), "t"),
    "get_format keyword": lambda E: E.call("get_format", E.col("DATETIME"), "ISO"),
    "extract YEAR ds": C("extract", lit("YEAR"), "ds"),
    "extract DAY_SECOND ds": C("extract", lit("DAY_SECOND"), "ds"),
    # LIKE / ILIKE
    "like s": C("like", "s", lit("%b%")), "like cols": C("like", "s", "p"),
    "ilike s": C("ilike", "s", lit("A%")), "ilike cols": C("ilike", "t", "p"),
    "like escape": C("like", "s", lit("a|_%"), lit("|")),
    # session functions
    "curtime": C("curtime"), "current_time": C("current_time"),
    "utc_time": C("utc_time"), "version": C("version"), "database": C("database"),
    "schema t": C("schema", "t"), "user": C("user"), "current_user": C("current_user"),
    "connection_id": C("connection_id"),
    # casts to and from strings
    "cast n char": lambda E: E.cast(E.col("n"), E.STRING),
    "cast f char": lambda E: E.cast(E.col("f"), E.STRING),
    "cast g char": lambda E: E.cast(E.col("g"), E.STRING),
    "cast m char": lambda E: E.cast(E.col("m"), E.STRING),
    "cast dt char": lambda E: E.cast(E.col("dt"), E.STRING),
    "cast b char": lambda E: E.cast(E.col("b"), E.STRING),
    "cast big char": lambda E: E.cast(E.col("big"), E.STRING),
    "cast s int": lambda E: E.cast(E.col("s"), E.INT64),
    "cast s uint": lambda E: E.cast(E.col("s"), E.UINT64),
    "cast s double": lambda E: E.cast(E.col("s"), E.FLOAT64),
    "cast s decimal": lambda E: E.cast(E.col("s"), E.Decimal(10, 2)),
    "cast s bool": lambda E: E.cast(E.col("s"), E.BOOL),
    "cast ds date": lambda E: E.cast(E.col("ds"), E.DATE),
    "cast ds datetime": lambda E: E.cast(E.col("ds"), E.DATETIME),
    "cast ds time": lambda E: E.cast(E.col("ds"), E.DURATION),
    "cast json int": lambda E: E.cast(E.call("cast_as_json", E.col("n")), E.INT64),
    # string operands elsewhere
    "plus s k": C("plus", "s", "k"), "multiply t f": C("multiply", "t", "f"),
    "round s": C("round", "s"), "truncate s 1": C("truncate", "s", lit(1)),
    "equals s t": C("equals", "s", "t"), "less s t": C("less", "s", "t"),
    "equals s k": C("equals", "s", "k"), "less ds dt": C("less", "ds", "dt"),
    "greater ts ds": C("greater", "ts", "ds"),
    "coalesce s n": C("coalesce", "s", "n"), "if b t dt": C("if", "b", "t", "dt"),
    "case_when mixed": lambda E: E.case_when((E.col("b"), E.col("s")),
                                             (E.col("k") > 3, E.col("m")),
                                             default=E.col("f")),
    "coalesce dt k": C("coalesce", "dt", "k"),
    "nullif s t": C("nullif", "s", "t"),
}

class _Types:
    """E.cast targets for either package."""

    def __init__(self, mod, D):
        self.__dict__.update(mod.__dict__)
        for n in ("STRING", "INT64", "UINT64", "FLOAT64", "BOOL", "DATE",
                  "DATETIME", "DURATION", "Decimal"):
            setattr(self, n, getattr(D, n))


def _eval_both(blocks, make):
    from tiflash_tpu_torch.core import dtypes as TD

    jb, tb = blocks
    with JC.query_clock(CLOCK_US):
        jev = JC.ExprEvaluator(jb)
        j = jev.evaluate(make(_Types(JE, JD)))
    with TC.query_clock(CLOCK_US):
        tev = TC.ExprEvaluator(tb)
        t = tev.evaluate(make(_Types(TE, TD)))
    return (j, jev.runtime_errors), (t, tev.runtime_errors)


def _stats(c):
    return None if c.stats is None else tuple(int(x) for x in c.stats)


def assert_same_column(j, t):
    """Type, dictionary, validity, values (bit patterns), stats: all rows."""
    assert repr(t.dtype) == repr(j.dtype)
    assert t.dtype.mysql_json == j.dtype.mysql_json
    assert t.dictionary == (None if j.dictionary is None else tuple(j.dictionary))
    assert _stats(t) == _stats(j)
    jv = None if j.validity is None else np.asarray(j.validity)
    tv = None if t.validity is None else t.validity.numpy()
    assert (jv is None) == (tv is None)
    if jv is not None:
        np.testing.assert_array_equal(tv, jv)
    valid = np.ones(t.data.shape[0], bool) if jv is None else jv
    jd, td = np.asarray(j.data), t.data.numpy()
    assert td.dtype == jd.dtype
    if td.dtype.kind == "f":
        jd, td = jd.view(np.int64 if jd.itemsize == 8 else np.int32), \
            td.view(np.int64 if td.itemsize == 8 else np.int32)
    np.testing.assert_array_equal(td[valid], jd[valid])


def assert_same_errors(jerr, terr):
    assert [m for _, m in terr] == [m for _, m in jerr]
    for (jm, _), (tm, _) in zip(jerr, terr):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("case", sorted(CASES))
def test_string_function_matches_reference(blocks, case):
    (j, jerr), (t, terr) = _eval_both(blocks, CASES[case])
    assert_same_column(j, t)
    assert_same_errors(jerr, terr)


def test_every_string_name_has_a_case():
    named = {c.split()[0] for c in CASES}
    assert len(REGISTRY_NAMES) == 25 and len(COMPILE_NAMES) == 66
    missing = set(REGISTRY_NAMES + COMPILE_NAMES + ALIASES) - named
    assert sorted(missing) == []


def test_json_cast_of_text_records_errors_on_live_and_dead_rows(blocks):
    """CAST(s AS JSON) of text that is not a document: the error masks of
    both packages are equal and cover dead rows too (the fragment compiler
    masks them by the selection)."""
    (j, jerr), (t, terr) = _eval_both(blocks, C("cast_as_json", "s"))
    assert [m for _, m in terr] == [
        "Invalid JSON text: The document root must not be followed by other values."]
    assert_same_errors(jerr, terr)
    assert_same_column(j, t)
    tb = blocks[1]
    assert bool((terr[0][0] & ~tb.sel).any())


def test_concat_gaps_are_the_reference_gaps(blocks):
    """CONCAT takes only (column, literal, ...): a literal first, or a
    second column, is not registered in either package."""
    jb, tb = blocks
    for make in (lambda E: E.call("concat", "a", E.col("s")),
                 lambda E: E.call("concat", E.col("s"), E.col("t"))):
        with pytest.raises(KeyError, match="not registered"):
            JC.ExprEvaluator(jb).evaluate(make(JE))
        with pytest.raises(KeyError, match="not registered"):
            TC.ExprEvaluator(tb).evaluate(make(TE))


def test_refusals_match(blocks):
    """What the reference refuses, the port refuses with the same error:
    DATE_FORMAT of a DATETIME (FROM_UNIXTIME with a format makes one), a
    cross-domain LUT past 65,536 combinations, an empty call of a
    function that takes arguments."""
    from tiflash_tpu.runtime.errors import EngineError as JEngineError
    from tiflash_tpu_torch.runtime.errors import EngineError as TEngineError

    jb, tb = blocks
    n = 5000
    rng = np.random.default_rng(7)
    wide = JBlock.from_dict({
        "a": column_from_numpy(rng.integers(0, 400, n), JD.INT64),
        "b": column_from_numpy(rng.integers(0, 400, n), JD.INT64)})
    twide = blocks_from_numpy(export_blocks({"w": wide}), "cpu")["w"]
    cases = [
        (jb, tb, C("date_format", "ts", lit("%Y")), ValueError, ValueError),
        (jb, tb, lambda E: E.call("from_unixtime", E.col("sec"), "%Y"),
         ValueError, ValueError),
        (jb, tb, C("schema"), JEngineError, TEngineError),
        (wide, twide, lambda E: E.call("lpad", "x", E.col("a"),
                                       E.call("bin", E.col("b"))),
         ValueError, ValueError),
    ]
    for jblock, tblock, make, jerr, terr in cases:
        with pytest.raises(jerr) as je:
            JC.ExprEvaluator(jblock).evaluate(make(JE))
        with pytest.raises(terr) as te:
            TC.ExprEvaluator(tblock).evaluate(make(TE))
        assert str(te.value) == str(je.value)
