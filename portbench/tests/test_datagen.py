"""The generator's arrays: pinned by checksum at SF 0.01, and held to the
rules of the TPC-H specification's clause 4.2.3."""

import datetime
import hashlib

import numpy as np
import pytest

from portbench import datagen

# SF 0.01, seed 0, on the CPU
PINNED = "80a85bf50ac956a0df4f3040cd9e4a1a340d9c7194a60c6f811b96a5374b5a13"


def digest(tables) -> str:
    h = hashlib.sha256()
    for tname, t in tables.items():
        for cname, col in t.columns.items():
            h.update(f"{tname}.{cname}.{col.kind}.{col.dictionary}".encode())
            h.update(np.ascontiguousarray(col.data).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def tables():
    return datagen.generate(0.01, 4)


def col(tables, name):
    for t in tables.values():
        if name in t.columns:
            return t.columns[name]
    raise KeyError(name)


def values(tables, name):
    c = col(tables, name)
    return np.asarray(c.dictionary)[c.data] if c.dictionary is not None else c.data


def day(iso):
    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


def test_pinned_checksum():
    assert digest(datagen.generate(0.01, 0)) == PINNED


def test_seed_changes_the_data_not_its_sizes():
    a, b = datagen.generate(0.01, 1), datagen.generate(0.01, 2)
    assert digest(a) != digest(b)
    for t in a:
        for c in a[t].columns:
            if t != "lineitem":
                assert a[t].columns[c].data.shape == b[t].columns[c].data.shape


def test_every_column_of_the_specification(tables):
    counts = {t: len(tables[t].columns) for t in datagen.TABLE_ORDER}
    assert counts == {"region": 3, "nation": 4, "supplier": 7, "customer": 8, "part": 9,
                      "partsupp": 5, "orders": 9, "lineitem": 16}


def test_dates(tables):
    o_date = values(tables, "o_orderdate")
    assert o_date.min() >= day("1992-01-01") and o_date.max() <= day("1998-08-02")
    ship = values(tables, "l_shipdate")
    assert ship.max() <= day("1998-12-01") and ship.max() > day("1998-09-02")
    commit, receipt = values(tables, "l_commitdate"), values(tables, "l_receiptdate")
    assert (receipt > ship).all() and (receipt <= ship + 30).all()
    odate = np.repeat(o_date, np.bincount(np.searchsorted(
        values(tables, "o_orderkey"), values(tables, "l_orderkey"))))
    assert ((commit - odate >= 30) & (commit - odate <= 90)).all()
    assert ((ship - odate >= 1) & (ship - odate <= 121)).all()


def test_flags_and_statuses(tables):
    cur = day("1995-06-17")
    flag, status = values(tables, "l_returnflag"), values(tables, "l_linestatus")
    receipt, ship = values(tables, "l_receiptdate"), values(tables, "l_shipdate")
    assert set(flag[receipt <= cur]) == {"R", "A"} and set(flag[receipt > cur]) == {"N"}
    assert (status == np.where(ship > cur, "O", "F")).all()
    per_order = {}
    for k, s in zip(values(tables, "l_orderkey").tolist(), status.tolist()):
        per_order.setdefault(k, set()).add(s)
    for k, s in zip(values(tables, "o_orderkey").tolist(),
                    values(tables, "o_orderstatus").tolist()):
        assert s == ({"F"} == per_order[k] and "F" or {"O"} == per_order[k] and "O" or "P")


def test_keys_and_prices(tables):
    okey = values(tables, "o_orderkey")
    assert okey[:9].tolist() == [1, 2, 3, 4, 5, 6, 7, 32, 33]
    cust = values(tables, "o_custkey")
    assert (cust % 3 != 0).all() and cust.max() <= 1500
    n_supp = 100
    pk, sk = values(tables, "ps_partkey"), values(tables, "ps_suppkey")
    pairs = set(zip(pk.tolist(), sk.tolist()))
    assert len(pairs) == len(pk) == 4 * 2000
    assert set(zip(values(tables, "l_partkey").tolist(),
                   values(tables, "l_suppkey").tolist())) <= pairs
    p = values(tables, "p_partkey")
    retail = values(tables, "p_retailprice")
    assert (retail == 90000 + (p // 10) % 20001 + 100 * (p % 1000)).all()
    qty, price = values(tables, "l_quantity"), values(tables, "l_extendedprice")
    assert (price == qty // 100 * retail[values(tables, "l_partkey") - 1]).all()
    assert sk.min() >= 1 and sk.max() <= n_supp


def test_part_strings(tables):
    mfgr, brand = values(tables, "p_mfgr"), values(tables, "p_brand")
    assert all(b[6] == m[-1] and b[7] in "12345" for m, b in zip(mfgr, brand))
    names = values(tables, "p_name")
    for n in names[:200]:
        words = n.split(" ")
        assert len(words) == 5 == len(set(words)) and set(words) <= set(datagen.COLOURS)
    assert len(datagen.COLOURS) == 92
    assert {t.split(" ")[0] for t in values(tables, "p_type")} <= set(datagen.TYPE_SYLLABLES[0])
    assert len(set(values(tables, "p_container"))) == 40


def test_text_columns(tables):
    for name, (lo, hi) in datagen.COMMENT_LENGTHS.items():
        lens = np.char.str_len(values(tables, name).astype(str))
        assert lens.min() >= lo and lens.max() <= hi, name
    phone = values(tables, "c_phone")
    nation = values(tables, "c_nationkey")
    assert all(p[:2] == str(n + 10) and len(p) == 15 for p, n in zip(phone, nation))
    assert values(tables, "c_name")[0] == "Customer#000000001"
    s_comment = values(tables, "s_comment")
    assert sum("Customer" in s and "Complaints" in s for s in s_comment) >= 1
    for name in ("l_comment", "c_address", "p_name"):
        d = col(tables, name).dictionary
        assert list(d) == sorted(set(d)), name


def test_encoding_matches_numpy_unique():
    text = datagen.Text(9, "cpu")
    rows = text.vstrings(5000, 1, 12)
    rows[::7] = rows[::7].clone()[[0]]          # many equal rows
    enc = text.encode(rows)
    strs = [bytes(r).rstrip(b"\0").decode() for r in rows.numpy()]
    uniq, inv = np.unique(np.asarray(strs), return_inverse=True)
    assert enc.dictionary == tuple(uniq.tolist())
    assert (enc.data == inv.reshape(-1)).all()
