"""The native C++ loader of the PyTorch port against the JAX package's.

Mirrors ``tests/test_native_loader.py`` case for case: .tbl parse into
typed columns, the sorted string dictionary, skipped fields, the TFC1
cache (here also across packages: a cache written by one loads in the
other), multithreaded parse, engine columns through ``save_table`` and
the catalog's append path.  Every column and dictionary equals the
reference loader's on the same file.  Then TPC-H lineitem, orders and
customer written as .tbl from ``generate_tpch``'s rows load back
bit-exact and give the same Q1, Q6, Q3 and Q10 rows.

The reference's library is built once per test process into a temporary
directory, so this file never races the reference's own tests over
``tiflash_tpu/native/libtflloader.so``.
"""

import datetime
import os

import numpy as np
import pytest
import torch

import tiflash_tpu.core.dtypes as jdt
import tiflash_tpu.storage.native_loader as JNL
from tiflash_tpu.testing import oracle as O

import tiflash_tpu_torch.core.dtypes as dt
from tiflash_tpu_torch.storage import native_loader as NL
from tiflash_tpu_torch.storage.native_loader import load_cached_table, load_table, save_table

TBL = """1|alpha|12.34|1995-03-15|7.5
2|beta|0.5|2001-12-31|-3.25
3|alpha|-99.99|1970-01-01|0
4||1234.567|1999-02-28|1e3
"""

SCHEMA = [
    ("id", dt.INT64),
    ("name", dt.STRING),
    ("amount", dt.Decimal(12, 2)),
    ("day", dt.DATE),
    ("x", dt.FLOAT64),
]
J_SCHEMA = [
    ("id", jdt.INT64),
    ("name", jdt.STRING),
    ("amount", jdt.Decimal(12, 2)),
    ("day", jdt.DATE),
    ("x", jdt.FLOAT64),
]


@pytest.fixture(scope="module", autouse=True)
def reference_library(tmp_path_factory):
    """Load the reference's library, built into a private directory when
    this process has not loaded it yet."""
    if JNL._lib is None:
        saved = JNL._SO
        JNL._SO = str(tmp_path_factory.mktemp("jloader") / "libtflloader.so")
        try:
            JNL.get_lib()
        finally:
            JNL._SO = saved
    yield


@pytest.fixture()
def tbl_file(tmp_path):
    p = tmp_path / "t.tbl"
    p.write_text(TBL)
    return str(p)


def assert_same_columns(t_cols, j_cols):
    """The port's columns equal the reference's: names, dtypes, data and
    dictionaries."""
    assert list(t_cols) == list(j_cols)
    for k, jc in j_cols.items():
        tc = t_cols[k]
        assert repr(tc.dtype) == repr(jc.dtype), k
        assert tc.data.device.type == "cpu"
        j = np.asarray(jc.data)
        assert tc.data.numpy().dtype == j.dtype, k
        np.testing.assert_array_equal(tc.data.numpy(), j, err_msg=k)
        assert tc.dictionary == (None if jc.dictionary is None else tuple(jc.dictionary)), k


def test_parse_types(tbl_file):
    cols = load_table(tbl_file, SCHEMA)
    assert_same_columns(cols, JNL.load_table(tbl_file, J_SCHEMA))
    assert cols["id"].data.tolist() == [1, 2, 3, 4]
    # decimal scale 2: 12.34 -> 1234; 1234.567 truncates to 1234.56
    assert cols["amount"].data.tolist() == [1234, 50, -9999, 123456]
    days = cols["day"].data.tolist()
    assert days[0] == (datetime.date(1995, 3, 15) - datetime.date(1970, 1, 1)).days
    assert days[2] == 0
    assert cols["x"].data.tolist() == [7.5, -3.25, 0.0, 1000.0]
    # the host columns carry the catalog's stats
    assert cols["id"].stats == (1, 4)


def test_string_dictionary_sorted(tbl_file):
    c = load_table(tbl_file, SCHEMA)["name"]
    assert c.dictionary == ("", "alpha", "beta")  # sorted distinct
    assert c.data.tolist() == [1, 2, 1, 0]
    assert c.dictionary == JNL.load_table(tbl_file, J_SCHEMA)["name"].dictionary


def test_skip_column(tbl_file):
    schema = [("id", dt.INT64), ("name", None), ("amount", None),
              ("day", None), ("x", None)]
    cols = load_table(tbl_file, schema)
    assert list(cols) == ["id"]
    jcols = JNL.load_table(tbl_file, [(n, None if t is None else jdt.INT64)
                                      for n, t in schema])
    assert_same_columns(cols, jcols)


def test_cache_roundtrip(tbl_file, tmp_path):
    cache = str(tmp_path / "t.tfc")
    a = load_table(tbl_file, SCHEMA, cache=cache)
    assert os.path.exists(cache)
    # poison the source to prove the cache is used
    with open(tbl_file, "w") as f:
        f.write("999|zzz|1|2020-01-01|0\n")
    b = load_table(tbl_file, SCHEMA, cache=cache)
    for k in a:
        assert torch.equal(a[k].data, b[k].data)
        assert a[k].dictionary == b[k].dictionary
    # the reference reads the port's cache, and the port the reference's
    assert_same_columns(b, JNL.load_table(tbl_file, J_SCHEMA, cache=cache))
    jcache = str(tmp_path / "j.tfc")
    with open(tbl_file, "w") as f:
        f.write(TBL)
    JNL.load_table(tbl_file, J_SCHEMA, cache=jcache)
    with open(tbl_file, "w") as f:
        f.write("999|zzz|1|2020-01-01|0\n")
    assert_same_columns(load_table(tbl_file, SCHEMA, cache=jcache),
                        JNL.load_table(tbl_file, J_SCHEMA, cache=jcache))
    # a corrupt cache is ignored: the port parses the source again
    with open(cache, "wb") as f:
        f.write(b"TFC1garbage")
    assert load_table(tbl_file, SCHEMA, cache=cache)["id"].data.tolist() == [999]


def test_cache_with_a_skipped_field(tmp_path):
    """A parse that skips a field (every TPC-H schema skips the comments)
    saves the field as an empty column.  The port's cache loads it, its
    own and the reference's; the reference's check rejects it and parses
    the source again (a reference defect, recorded in ROADMAP.md)."""
    src = tmp_path / "s.tbl"
    src.write_text("1|a|x\n2|b|y\n")
    schema = [("i", dt.INT64), ("s", dt.STRING), ("c", None)]
    j_schema = [("i", jdt.INT64), ("s", jdt.STRING), ("c", None)]
    cache, jcache = str(tmp_path / "t.tfc"), str(tmp_path / "j.tfc")
    first = load_table(str(src), schema, cache=cache)
    JNL.load_table(str(src), j_schema, cache=jcache)
    src.write_text("9|z|q\n")  # poison the source
    for c in (cache, jcache):
        again = load_table(str(src), schema, cache=c)
        assert list(again) == ["i", "s"]
        assert again["i"].data.tolist() == [1, 2] and again["s"].dictionary == ("a", "b")
        assert_same_columns(again, first)
    assert np.asarray(JNL.load_table(str(src), j_schema, cache=cache)["i"].data).tolist() == [9]


def test_multithreaded_parse_matches(tmp_path):
    rng = np.random.default_rng(0)
    n = 5000
    lines = [f"{i}|s{int(rng.integers(0, 50))}|{rng.integers(0, 10**6)/100:.2f}|"
             f"1995-01-01|{rng.normal():.4f}" for i in range(n)]
    p = tmp_path / "big.tbl"
    p.write_text("\n".join(lines) + "\n")
    one = load_table(str(p), SCHEMA, nthreads=1)
    four = load_table(str(p), SCHEMA, nthreads=4)
    for k in one:
        assert torch.equal(one[k].data, four[k].data)
        assert one[k].dictionary == four[k].dictionary
    assert_same_columns(four, JNL.load_table(str(p), J_SCHEMA, nthreads=4))


def test_save_and_reload_engine_columns(tmp_path):
    """Engine block -> TFC file -> reload: exact round trip, strings
    included, and the reference loads the port's file alike."""
    from tiflash_tpu_torch.core.block import Block
    from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
    from tiflash_tpu_torch.testing.bridge import export_blocks

    schema = {"k": jdt.STRING, "v": jdt.Decimal(12, 2), "d": jdt.DATE,
              "x": jdt.FLOAT64, "i": jdt.INT64}
    t = {
        "k": ["b", "a", "b", "c"],
        "v": [O.D("1.25"), O.D("-3.00"), O.D("0.10"), O.D("99.99")],
        "d": [datetime.date(2020, 1, i + 1) for i in range(4)],
        "x": [0.5, -1.5, 2.0, 3.25],
        "i": [10, -20, 30, -40],
    }
    block = blocks_from_numpy(export_blocks({"t": O.pytable_to_block(t, schema)}), "cpu")["t"]
    path = str(tmp_path / "out.tfc")
    names = save_table(path, block.as_dict())
    port_schema = {"k": dt.STRING, "v": dt.Decimal(12, 2), "d": dt.DATE,
                   "x": dt.FLOAT64, "i": dt.INT64}
    cols = load_cached_table(path, [(n, port_schema[n]) for n in names])
    got = Block.from_dict(cols).to_pylists()
    assert got == block.to_pylists()
    jcols = JNL.load_cached_table(path, [(n, schema[n]) for n in names])
    assert_same_columns(cols, jcols)
    from tiflash_tpu.core.block import Block as JBlock

    O.assert_tables_equal(O.block_to_pytable(JBlock.from_dict(jcols)), t, ordered=True)


def test_catalog_append_write_path():
    """INSERT analog: appended rows visible to queries; merged
    dictionaries; the same rows as the reference's catalog."""
    from tiflash_tpu.ops.aggregate import AggDesc as JAgg
    from tiflash_tpu.plan import nodes as JP
    from tiflash_tpu.plan.compiler import compile_fragment
    from tiflash_tpu.storage.catalog import Catalog as JCatalog

    from tiflash_tpu_torch.ops.aggregate import AggDesc
    from tiflash_tpu_torch.plan import nodes as P
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.catalog import Catalog, blocks_from_numpy
    from tiflash_tpu_torch.testing.bridge import export_blocks

    schema = {"k": jdt.STRING, "v": jdt.INT64}
    b1 = O.pytable_to_block({"k": ["b", "a"], "v": [1, 2]}, schema)
    b2 = O.pytable_to_block({"k": ["c", "a"], "v": [3, 4]}, schema)
    jcat = JCatalog()
    jcat.register("t", dict(zip(b1.names, b1.columns)))
    jcat.append("t", dict(zip(b2.names, b2.columns)))
    cat = Catalog()
    t1, t2 = (blocks_from_numpy(export_blocks({"t": b}), "cpu")["t"] for b in (b1, b2))
    cat.register("t", t1.as_dict())
    cat.append("t", t2.as_dict())
    assert cat["t"].row_count == jcat["t"].row_count == 4
    assert cat["t"].block["k"].dictionary == tuple(jcat["t"].block["k"].dictionary)
    out, _ = run_query(P.Aggregation(["k"], [AggDesc("sum", "v", "s")], P.TableScan("t")),
                       cat.blocks("cpu"))
    jout, _ = compile_fragment(JP.Aggregation(["k"], [JAgg("sum", "v", "s")],
                                              JP.TableScan("t")))(jcat.blocks())
    got = O.sort_pytable(out.to_pylists())
    assert got == O.sort_pytable(O.block_to_pytable(jout))
    assert got == {"k": ["a", "b", "c"], "s": [6, 1, 3]}


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    """SF 0.01 lineitem, orders and customer from ``generate_tpch`` (seed
    3) written as .tbl, the fields it lacks drawn from a seed."""
    from tiflash_tpu_torch.storage.tpch import generate_tpch
    from tiflash_tpu_torch.testing.tbl import fields_of, write_tbl

    cat = generate_tpch(sf=0.01, seed=3, tables=["lineitem", "orders", "customer"])
    rng = np.random.default_rng(3)
    d = tmp_path_factory.mktemp("tpch")
    fills = {
        "lineitem": {"l_shipinstruct": ("string", rng.integers(0, 4, cat["lineitem"].row_count)
                                        .astype(np.int32),
                                        ("COLLECT COD", "DELIVER IN PERSON", "NONE",
                                         "TAKE BACK RETURN"))},
        "orders": {"o_orderstatus": ("string", rng.integers(0, 3, cat["orders"].row_count)
                                     .astype(np.int32), ("F", "O", "P")),
                   "o_totalprice": ("decimal", rng.integers(0, 10**8, cat["orders"].row_count),
                                    2)},
        "customer": {},
    }
    for t, fill in fills.items():
        write_tbl(str(d / f"{t}.tbl"),
                  fields_of(cat[t].block.as_dict(), NL.TPCH_SCHEMAS[t], fill))
    return cat, str(d)


def test_tpch_tbl_loads_as_generated(tpch_dir):
    """Each table loaded from .tbl (parse, then through its TFC1 cache)
    equals the generated one column for column; the reference's loader
    reads the same columns; Q1, Q6, Q3 and Q10 give the same rows."""
    from tiflash_tpu_torch.bench.tpch_queries import q1_plan, q3_plan, q6_plan, q10_plan
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.native_loader import load_tpch_dir
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    cat, d = tpch_dir
    tables = ["lineitem", "orders", "customer"]
    parsed = load_tpch_dir(d, tables, nthreads=3)
    cached = load_tpch_dir(d, tables)
    jcat = JNL.load_tpch_dir(d, tables)
    for t in tables:
        gen = cat[t].block.as_dict()
        for loaded in (parsed, cached):
            cols = loaded[t].block.as_dict()
            for name, c in gen.items():
                assert torch.equal(cols[name].data, c.data), (t, name)
                assert cols[name].dictionary == c.dictionary, (t, name)
                assert cols[name].stats == c.stats, (t, name)
        assert_same_columns(cached[t].block.as_dict(), jcat[t].block.as_dict())
    nation = generate_tpch(sf=0.01, seed=3, tables=["nation"])
    loaded = {**cached.blocks("cpu"), **nation.blocks("cpu")}
    generated = {**cat.blocks("cpu"), **nation.blocks("cpu")}
    for plan_fn in (q1_plan, q6_plan, q3_plan, q10_plan):
        a = run_query(plan_fn(), loaded)[0].to_pylists()
        b = run_query(plan_fn(), generated)[0].to_pylists()
        assert a == b, plan_fn.__name__
