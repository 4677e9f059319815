"""The analytic plans of ``bench/analytics.py`` on the CPU at sf 0.01:
the port's ``run_query`` against the JAX package's on the same TPC-H
data (both packages' generators draw the same tables from a seed).

Each plan crosses to the reference as a card run receives it: the port's
``serde.dumps``, then the reference's ``serde.loads``; ``partitioned_q1``
maps node by node instead (``to_reference``), since the reference's
wire format has no ``Union`` codec.  The port runs the ``loads`` of its
own ``dumps``.  ``plan_text`` (the rewritten tree that ran) and the
retries are equal.  Rows are equal, exactly, but for the float columns
of ``FLOAT_COLS``: a double's variance and sums add in another order
than the reference's (a segmented scan in another tree), so they hold
within ``FLOAT_REL`` relative.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest

from tiflash_tpu.plan import serde as j_serde
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.storage.tpch import generate_tpch as j_generate

import chip_smoke
from test_torch_tpch_spec import to_reference
from tiflash_tpu_torch.bench import analytics as A
from tiflash_tpu_torch.plan import serde as t_serde
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate

SF = 0.01
FLOAT_REL = 1e-12
FLOAT_COLS = {"stats_grouped": ("var_price", "sd_price"),
              "stats_stream": ("sum_price", "avg_price")}


def _ref_partitions(lineitem):
    """The reference's lineitem split by ship year, as
    ``ship_year_partitions`` splits the port's."""
    d = np.asarray(lineitem["l_shipdate"].data)
    out = {}
    for year, name in zip(A.SHIP_YEARS, A.PARTITION_TABLES):
        lo = (datetime.date(year, 1, 1) - datetime.date(1970, 1, 1)).days
        hi = (datetime.date(year + 1, 1, 1) - datetime.date(1970, 1, 1)).days
        rows = np.nonzero((d >= lo) & (d < hi))[0].astype(np.int32)
        out[name] = lineitem.take(jnp.asarray(rows))
    return out


@pytest.fixture(scope="module")
def catalogs():
    jl = j_generate(sf=SF, seed=0, tables=["lineitem"]).blocks()
    j8 = j_generate(sf=SF, seed=0, tables=chip_smoke.EIGHT_TABLES).blocks()
    tcat = t_generate(sf=SF, seed=0, tables=["lineitem"])
    tcat8 = t_generate(sf=SF, seed=0, tables=chip_smoke.EIGHT_TABLES)
    return {"lineitem": ({**jl, **_ref_partitions(jl["lineitem"])},
                         A.lineitem_tables(tcat.blocks("cpu"))),
            "eight": (j8, tcat8.blocks("cpu")),
            "arrays": (chip_smoke.analytic_arrays(tcat), chip_smoke.tpch8_arrays(tcat8))}


@pytest.mark.parametrize("name", sorted(A.ANALYTICS))
def test_analytics_plan_matches_reference(catalogs, name):
    fn, cat = A.ANALYTICS[name]
    j_tables, t_tables = catalogs[cat]
    plan = fn()
    text = t_serde.dumps(plan)
    if name == "partitioned_q1":
        with pytest.raises(ValueError, match="Union"):
            j_serde.loads(text)
        j_plan = to_reference(plan)
    else:
        j_plan = j_serde.loads(text)
    want, j_sum = j_run(j_plan, j_tables)
    got, t_sum = t_run(t_serde.loads(text), t_tables)
    assert t_sum.plan_text == j_sum.plan_text
    assert t_sum.retries == j_sum.retries
    assert got.names == want.names
    assert [repr(c.dtype) for c in got.columns] == [repr(c.dtype) for c in want.columns]
    g, w = got.to_pylists(), want.to_pylists()
    floats = FLOAT_COLS.get(name, ())
    for col in w:
        if col not in floats:
            assert g[col] == w[col], col
            continue
        assert len(g[col]) == len(w[col])
        for x, y in zip(g[col], w[col]):
            assert (x is None) == (y is None)
            assert y is None or abs(x - y) <= FLOAT_REL * abs(y), (col, x, y)


def test_analytics_plans_exercise_their_paths(catalogs):
    """The sizes the plans are for: the Expand quadruples the rows, the
    keyless sketch is past its exact range (more than 4096 orders), NOT
    IN with a NULL gives nothing, and Q13's outer forms equal Q13."""
    _, t_l = catalogs["lineitem"]
    _, t8 = catalogs["eight"]
    out, summary = t_run(A.rollup_report_plan(), t_l)
    n = t_l["lineitem"].capacity
    assert any(v == 4 * n for k, v in summary.node_rows.items() if k.startswith("Expand"))
    assert t_l["lineitem"]["l_orderkey"].data.unique().numel() > 4096
    assert t_run(A.not_in_plan(True), t8)[0].to_pylists() == {"n_lines": [0],
                                                               "qty": [None]}
    from tiflash_tpu_torch.bench.tpch_queries import q13_plan

    q13 = t_run(q13_plan(), t8)[0].to_pylists()
    for kind in ("right_outer", "full_outer"):
        assert t_run(A.q13_outer_plan(kind), t8)[0].to_pylists() == q13
    assert sum(b.capacity for k, b in t_l.items() if k in A.PARTITION_TABLES) == n


@pytest.mark.parametrize("name", sorted(A.ANALYTICS))
def test_chip_smoke_numpy_versions_equal_the_port(catalogs, name):
    """The card phase's independent numpy versions (``chip_smoke.py``)
    equal the port's CPU run at sf 0.01, as they must at SF1."""
    fn, cat = A.ANALYTICS[name]
    out, _ = t_run(fn(), catalogs[cat][1])
    li, a8 = catalogs["arrays"]
    assert chip_smoke.analytics_numpy_check(name, out, li, a8).startswith("numpy")
    # and the card's comparison passes a block against itself
    assert chip_smoke.analytic_same(name, out, chip_smoke.block_summary(out)) == 0.0


def test_chip_smoke_cpu_worker_runs_every_plan():
    """``chip_smoke.analytics_cpu_runs`` (the card run's CPU side, run in
    a worker process there) at sf 0.002, in this process: every plan,
    held to numpy, no retry, no kernel branch predicted but one direct_agg
    launch for each outer form of Q13, whose c_custkey range stats give a
    dense domain at this scale."""
    import torch

    threads = torch.get_num_threads()
    try:
        runs = chip_smoke.analytics_cpu_runs(sf=0.002)
    finally:
        torch.set_num_threads(threads)
    assert sorted(runs) == sorted(A.ANALYTICS)
    for name, r in runs.items():
        assert r["checked"].startswith("numpy"), name
        dense = name in ("q13_full", "q13_right")
        assert r["retries"] == 0 and r["predicted"] == ((1, 0) if dense else (0, 0)), name
        assert r["summary"]["names"] == tuple(r["summary"]["arrays"])
