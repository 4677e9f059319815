"""The SQL front end's pure-Python layers, port against reference: the
lexer (``tokenize``), the recursive-descent ``SqlParser`` (the ``repr`` of
each expression tree), DDL type parsing (``parse_col_type``,
``parse_create_table``), temporal literals, the statement and tuple
splitters, the recorded-table parser and the rewrites the SELECT builder
applies (``_rewrite``, ``_coerce_temporal``, ``_as_bool``).  No engine
runs here."""

import dataclasses

import pytest

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.testing import reftest as JR

from tiflash_tpu_torch.core import dtypes as TD
from tiflash_tpu_torch.testing import reftest as TR

EXPRESSIONS = [
    "1", "-1", "1.50", "-0.000000000000000000000000000001", "1e3", "-2.5e-3", ".5",
    "0x1F", "x'4142'", "'it''s'", "'a\\nb\\tc\\\\d'", '"dq"', "_utf8mb4'x'", "NULL",
    "true", "false", "a", "`weird col`", "t.a", "db.t.a",
    "a + b * c - d / e", "(a + b) * c", "a div 2", "a mod 3", "a % 3", "-a", "+a",
    "~a", "!a", "a | b", "a & b", "a ^ b", "a << 2", "a >> 1", "a = b", "a <=> b",
    "a <> b", "a != b", "a < b and b <= c", "a > b or not c >= d", "a xor b",
    "a && b || c", "a is null", "a is not null", "a is true", "a is not false",
    "a like 'x%'", "a not like '_y' escape '!'", "a ilike 'X%'", "a regexp '^a+$'",
    "a rlike 'b'", "a in (1, 2, 3)", "a not in ('x', 'y')", "a between 1 and 10",
    "a not between b and c", "(a, b) = (1, 2)", "(a, b) < (1, 2)", "(a, b) <> (c, d)",
    "(a, b) in ((1, 2), (3, 4))", "case when a > 0 then 'p' when a < 0 then 'n' end",
    "case a when 1 then 'one' when 2 then 'two' else 'many' end",
    "case when a then b else c end", "cast(a as signed)", "cast(a as unsigned integer)",
    "cast(a as decimal(65, 30))", "cast(a as decimal)", "cast(a as double)",
    "cast(a as float)", "cast(a as char(3))", "cast(a as date)",
    "cast(a as datetime(3))", "cast(a as time)", "cast(a as json)",
    "convert(a, signed)", "date '2020-01-02'", "timestamp '2020-01-02 03:04:05.5'",
    "time '2020-01-02 03:04:05'", "date '0000-00-00'",
    "date_add(d, interval 1 day)", "date_sub(d, interval '2' month)",
    "adddate(d, 3)", "extract(year from d)", "position('b' in s)", "count(*)",
    "count(distinct a)", "sum(a) + max(b)", "group_concat(distinct s)",
    "row_number() over (partition by a order by b desc)",
    "sum(x) over (order by d range between interval 1 day preceding and current row)",
    "lag(x, 2, 0) over w", "j->'$.a'", "j->>'$.b[0]'", "binary s",
    "ifnull(a, 0) + coalesce(b, c, 1)", "if(a > 0, a, -a)", "f(g(h(1)), k)",
    "a = any_value(b)", "not not a", "1 + 2 + 3 + 4", "2 * 3 / 4 div 5",
]

TYPES = [
    "tinyint", "smallint not null", "mediumint", "int", "integer", "bigint",
    "year", "tinyint unsigned", "smallint unsigned", "int unsigned not null",
    "bigint unsigned", "float", "double", "real", "decimal(10,2)", "numeric(65, 30)",
    "decimal", "bool", "boolean", "enum('a', 'b', 'c')", "binary(4)", "varbinary(8)",
    "blob", "tinyblob", "longblob", "varchar(20)", "char(1) not null", "text",
    "longtext", "set('x')", "date", "datetime", "datetime(3)", "timestamp",
    "timestamp(6)", "time", "time(2)", "bit(8)", "json",
]


def outcome(fn, *args):
    """``repr`` of what ``fn(*args)`` returns, or the name of the exception
    it raises."""
    try:
        return "ok", repr(fn(*args))
    except Exception as e:
        return "raises", type(e).__name__


@pytest.mark.parametrize("sql", EXPRESSIONS)
def test_tokenize_and_parse_expression(sql):
    assert TR.tokenize(sql) == JR.tokenize(sql)
    assert outcome(lambda: TR.SqlParser(sql).parse_expr()) == \
        outcome(lambda: JR.SqlParser(sql).parse_expr())


def test_there_are_enough_expressions():
    assert len(set(EXPRESSIONS)) >= 60


@pytest.mark.parametrize("spec", TYPES)
def test_parse_col_type(spec):
    jt, jf = JR.parse_col_type(" " + spec)
    tt, tf = TR.parse_col_type(" " + spec)
    assert tf == jf
    assert repr(tt) == repr(jt)


def test_unsupported_forms_raise_in_both():
    for bad in ("geometry", "point not null"):
        with pytest.raises(JR.Unsupported):
            JR.parse_col_type(bad)
        with pytest.raises(TR.Unsupported):
            TR.parse_col_type(bad)
    for sql in ("a +", "interval 1 day", "a is what", "cast(a as geometry)", "(a, b"):
        with pytest.raises(JR.Unsupported):
            JR.SqlParser(sql).parse_expr()
        with pytest.raises(TR.Unsupported):
            TR.SqlParser(sql).parse_expr()


def test_parse_create_table():
    sql = ("CREATE TABLE IF NOT EXISTS test.`t1` (id bigint not null, "
           "`price` decimal(12, 2) DEFAULT NULL, s varchar(10) COLLATE utf8_bin, "
           "g int AS (id * 2) VIRTUAL, ts timestamp(3), "
           "PRIMARY KEY (id), KEY(s), UNIQUE KEY u (s, id)) "
           "ENGINE=InnoDB COLLATE=binary PARTITION BY HASH(id) PARTITIONS 4")
    jt, js, jf, jg = JR.parse_create_table(sql)
    tt, ts, tf, tg = TR.parse_create_table(sql)
    assert (tt, tf, tg) == (jt, jf, jg) == ("t1", {"ts": 3}, {"g": "id * 2"})
    assert list(ts) == list(js) == ["id", "price", "s", "g", "ts"]
    assert repr(ts) == repr(js)


@pytest.mark.parametrize("text", [
    "2020-01-02", "2020/1/2 3:04:05", "2020.01.02 03:04:05.123456",
    "2020-01-02T03:04:05.5", "0000-00-00 01:02:03", "0000-01-01", "9999-12-31 23:59:59"])
def test_temporal_literals(text):
    assert outcome(TR._parse_datetime_str, text) == outcome(JR._parse_datetime_str, text)
    for kind in ("date", "timestamp", "datetime"):
        assert outcome(TR._parse_temporal_literal, kind, text) == \
            outcome(JR._parse_temporal_literal, kind, text)


def test_splitters_and_recorded_tables():
    values = "(1, 'a,b', \"x)y\"), (2, 'it\\'s', (3)), (NULL, '', f(1, 2))"
    assert TR._split_tuples(values) == JR._split_tuples(values)
    for tup in JR._split_tuples(values):
        assert TR._split_args(tup) == JR._split_args(tup)
    stmts = "set a = 1; select ';' from t; insert into t values ('x;y');"
    assert TR._split_semicolons(stmts) == JR._split_semicolons(stmts)
    bordered = ["+---+---+", "| a | b |", "+---+---+", "| 1 | x |", "| 2 |   |",
                "+---+---+"]
    assert TR._parse_expected(bordered) == JR._parse_expected(bordered)
    assert TR._split_expected_tables(bordered * 2) == JR._split_expected_tables(bordered * 2)
    tabbed = ["a\tb", "1\tx", "2\t"]
    assert TR._parse_expected(tabbed) == JR._parse_expected(tabbed)


@pytest.mark.parametrize("sql", [
    "date_add(d, interval 2 hour)", "adddate(d, 1.6)", "subdate(d, 2)",
    "timestampdiff(month, a, b)", "datediff('2020-01-01', d)", "year('2020-01-02 00:00:01')",
    "day(s)", "unix_timestamp(dt)", "tm + 0.5", "y = d", "a & b",
    "a", "a and b + 1", "month(null)"])
def test_rewrites(sql):
    jschema = {"d": JD.DATE, "s": JD.STRING, "dt": JD.DATETIME, "tm": JD.DURATION,
               "y": dataclasses.replace(JD.INT16, mysql_year=True),
               "a": JD.INT64, "b": JD.INT64}
    tschema = {"d": TD.DATE, "s": TD.STRING, "dt": TD.DATETIME, "tm": TD.DURATION,
               "y": dataclasses.replace(TD.INT16, mysql_year=True),
               "a": TD.INT64, "b": TD.INT64}
    fsps = {"dt": 3}
    j = JR._as_bool(JR._coerce_temporal(JR._rewrite(JR.SqlParser(sql).parse_expr()),
                                        jschema, fsps))
    t = TR._as_bool(TR._coerce_temporal(TR._rewrite(TR.SqlParser(sql).parse_expr()),
                                        tschema, fsps))
    assert repr(t) == repr(j)
