"""TPC-H in its specification's own expressions (``bench/tpch_spec.py``)
and the function sweep, the port's ``run_query`` against the JAX
package's at sf 0.002.

The reference-side plan is built from the port's plan by ``to_reference``,
which maps every node and expression dataclass to the JAX package's
same-named class.  Results match at tolerance zero (every output is an
integer, a decimal mantissa, a date or a string), the aggregation methods
match call by call, and so does the fused stream-agg path's decision:
a spec-form Q1 or Q6 compares a column with a function of a literal,
which the fuse cannot encode, so both packages run it unfused.  Where the
spec form yields the builder's quantity (Q1, Q4, Q6, Q8, Q12's counts)
it also equals the builder's rows.  Seed 0 runs every query; its
suppliers include none in BRAZIL, so Q8 runs again at seed 16.

The sweep runs one family at a time, column by column: exact, except the
transcendental columns, which hold within ``SWEEP_ULPS``.
"""

import dataclasses
import enum

import numpy as np
import pytest

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.expr import nodes as JEN
from tiflash_tpu.ops import aggregate as JA
from tiflash_tpu.ops import sort as JSo
from tiflash_tpu.ops import stream_fuse as JSF
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.storage.tpch import generate_tpch as j_generate

import chip_smoke
from test_torch_tpch_more_a import _dispatch_spy
from tiflash_tpu_torch.bench import tpch_spec as S
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.ops import stream_fuse as TSF
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate

SF = 0.002
CASES = [(q, 0) for q in S.SPEC_QUERIES] + [("q8", 16)]
_REF_MODULES = (JP, JEN, JA, JSo, JD)


def to_reference(x):
    """A port plan (nodes, expressions, AggDescs, SortKeys, DataTypes)
    -> the same tree of the JAX package's classes."""
    if isinstance(x, (list, tuple)):
        return type(x)(to_reference(v) for v in x)
    if isinstance(x, dict):
        return {k: to_reference(v) for k, v in x.items()}
    if isinstance(x, enum.Enum):
        return getattr(JD.TypeKind, x.name)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        name = type(x).__name__
        cls = next(getattr(m, name) for m in _REF_MODULES if hasattr(m, name))
        return cls(**{f.name: to_reference(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    return x


class Catalogs:
    def __init__(self):
        self._cats = {}

    def __getitem__(self, seed):
        if seed not in self._cats:
            self._cats[seed] = (
                j_generate(sf=SF, seed=seed, tables=chip_smoke.EIGHT_TABLES).blocks(),
                t_generate(sf=SF, seed=seed, tables=chip_smoke.EIGHT_TABLES))
        return self._cats[seed]


@pytest.fixture(scope="module")
def catalogs():
    return Catalogs()


def test_to_reference_keeps_the_tree():
    for spec, _, _ in S.SPEC_QUERIES.values():
        plan = spec()
        assert to_reference(plan).pretty() == plan.pretty()
    assert to_reference(S.functions_sweep_plan()).pretty() \
        == S.functions_sweep_plan().pretty()


@pytest.mark.parametrize("query,seed", CASES)
def test_spec_query_matches_reference(catalogs, monkeypatch, query, seed):
    monkeypatch.setenv("TIFLASH_TPU_STREAM_KERNEL", "interpret")
    j_tables, t_cat = catalogs[seed]
    spec, _, _ = S.SPEC_QUERIES[query]
    j_calls, t_calls = [], []
    _dispatch_spy(monkeypatch, JA, j_calls)
    _dispatch_spy(monkeypatch, TA, t_calls)
    j_fused, t_fused = JSF.FUSE_STATS["count"], TSF.FUSE_STATS["count"]

    want, j_summary = j_run(to_reference(spec()), j_tables)
    got, summary = t_run(spec(), t_cat.blocks("cpu"))

    assert TSF.FUSE_STATS["count"] - t_fused == JSF.FUSE_STATS["count"] - j_fused
    assert t_calls == j_calls
    assert list(got.names) == list(want.names)
    assert [repr(c.dtype) for c in got.columns] == [repr(c.dtype) for c in want.columns]
    assert got.to_pylists() == want.to_pylists()
    assert summary.plan_text == j_summary.plan_text
    assert summary.retries == j_summary.retries


@pytest.mark.parametrize("query,seed", [(q, s) for q, s in CASES
                                        if S.SPEC_QUERIES[q][2]])
def test_spec_query_equals_builder(catalogs, query, seed):
    _, t_cat = catalogs[seed]
    spec, builder, _ = S.SPEC_QUERIES[query]
    got, _ = t_run(spec(), t_cat.blocks("cpu"))
    want, _ = t_run(builder(), t_cat.blocks("cpu"))
    if (query, seed) == ("q8", 0):
        # no supplier in BRAZIL: the FILTER sum of no rows is NULL, the
        # CASE sum of zeros is 0 (SQL's own difference); the years agree
        assert got.to_pylists()["mkt_share"] == [0, 0]
        assert want.to_pylists()["mkt_share"] == [None, None]
        assert got.to_pylists()["o_year"] == want.to_pylists()["o_year"]
        return
    assert got.to_pylists() == want.to_pylists()


def test_spec_q1_q6_decline_the_fuse_and_builders_take_it(catalogs, monkeypatch):
    monkeypatch.setenv("TIFLASH_TPU_STREAM_KERNEL", "interpret")
    _, t_cat = catalogs[0]
    for query in ("q1", "q6"):
        spec, builder, _ = S.SPEC_QUERIES[query]
        before = TSF.FUSE_STATS["count"]
        t_run(spec(), t_cat.blocks("cpu"))
        assert TSF.FUSE_STATS["count"] == before
        t_run(builder(), t_cat.blocks("cpu"))
        assert TSF.FUSE_STATS["count"] == before + 1


def _ulp_gap(a, b):
    ia, ib = a.view(np.int64), b.view(np.int64)
    ka = np.where(ia >= 0, ia, np.int64(-(2 ** 63)) - ia)
    kb = np.where(ib >= 0, ib, np.int64(-(2 ** 63)) - ib)
    return np.abs(ka - kb)


def assert_sweep_equal(got, want, ulps):
    """Column by column and row by row; ``ulps`` bounds the named float
    columns, every other column is exact.  Returns the largest ulp gap."""
    worst = 0
    assert list(got.names) == list(want.names)
    for name, g, w in zip(got.names, got.columns, want.columns):
        assert repr(g.dtype) == repr(w.dtype), name
        gv, wv = g.to_pylist(), w.to_pylist()
        if name in ulps:
            assert [v is None for v in gv] == [v is None for v in wv], name
            a = np.array([v for v in gv if v is not None], dtype=np.float64)
            b = np.array([v for v in wv if v is not None], dtype=np.float64)
            gap = int(_ulp_gap(a, b).max(initial=0))
            assert gap <= ulps[name], (name, gap)
            worst = max(worst, gap)
        else:
            assert gv == wv, name
    return worst


@pytest.mark.parametrize("family", list(S.SWEEP_FAMILIES))
def test_sweep_family_matches_reference(catalogs, family):
    j_tables, t_cat = catalogs[0]
    plan = S.functions_sweep_plan([family])
    want, _ = j_run(to_reference(plan), j_tables)
    got, _ = t_run(S.functions_sweep_plan([family]), t_cat.blocks("cpu"))
    assert assert_sweep_equal(got, want, S.SWEEP_ULPS) <= max(S.SWEEP_ULPS.values())
    assert int(got.num_rows()) == t_cat.blocks("cpu")["lineitem"].capacity


def test_sweep_has_a_column_of_every_family():
    plan = S.functions_sweep_plan()
    assert len(plan.exprs) >= 40
    assert set(S.SWEEP_ULPS) <= set(plan.exprs)
    assert all(S.SWEEP_FAMILIES[f] for f in S.SWEEP_FAMILIES)
