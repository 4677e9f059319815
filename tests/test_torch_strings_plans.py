"""``strings_sweep_plan()`` and ``ship_month_plan()`` (``bench/strings.py``)
through both packages' ``run_query`` at SF 0.01 on the lineitem catalog.

The reference plan is the port's plan mapped onto the JAX package's
classes (``to_reference``).  The sweep runs one family at a time; every
column is exact (codes, integers, dates, durations, NULLs) and its
dictionary equal.  The ship-month report's rows are equal, its group-by
over two string keys takes the direct method's kernel branch (the
kernel's plain version on the CPU) over a domain of months x modes, and
``chip_smoke.numpy_ship_month`` agrees with it.
"""

import pytest

from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.storage.tpch import generate_tpch as j_generate

import chip_smoke
from test_torch_tpch_spec import to_reference
from tiflash_tpu_torch.bench import strings as S
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.tpch import generate_tpch as t_generate

SF = 0.01


@pytest.fixture(scope="module")
def tables():
    return (j_generate(sf=SF, seed=0, tables=["lineitem"]).blocks(),
            t_generate(sf=SF, seed=0, tables=["lineitem"]))


def assert_same_block(got, want):
    assert list(got.names) == list(want.names)
    for name, g, w in zip(got.names, got.columns, want.columns):
        assert repr(g.dtype) == repr(w.dtype), name
        assert g.dictionary == (None if w.dictionary is None
                                else tuple(w.dictionary)), name
    assert got.to_pylists() == want.to_pylists()


def test_to_reference_keeps_the_trees():
    for plan in (S.strings_sweep_plan(), S.ship_month_plan()):
        assert to_reference(plan).pretty() == plan.pretty()


@pytest.mark.parametrize("family", list(S.STRING_SWEEP_FAMILIES))
def test_strings_sweep_family_matches_reference(tables, family):
    j_tables, t_cat = tables
    want, _ = j_run(to_reference(S.strings_sweep_plan([family])), j_tables)
    got, summary = t_run(S.strings_sweep_plan([family]), t_cat.blocks("cpu"))
    assert_same_block(got, want)
    assert summary.retries == 0
    assert int(got.num_rows()) == t_cat.blocks("cpu")["lineitem"].capacity


def test_strings_sweep_covers_the_families():
    plan = S.strings_sweep_plan()
    assert len(plan.exprs) >= 50
    assert all(S.STRING_SWEEP_FAMILIES[f] for f in S.STRING_SWEEP_FAMILIES)
    assert sum(len(f) for f in S.STRING_SWEEP_FAMILIES.values()) == len(plan.exprs)


def test_ship_month_matches_reference_on_the_kernel_branch(tables, monkeypatch):
    j_tables, t_cat = tables
    calls = []
    real = TA._accumulate_direct_kernel

    def spy(aggs, block, slot_ids, live, domain):
        calls.append(domain)
        return real(aggs, block, slot_ids, live, domain)

    monkeypatch.setattr(TA, "_accumulate_direct_kernel", spy)
    want, _ = j_run(to_reference(S.ship_month_plan()), j_tables)
    got, summary = t_run(S.ship_month_plan(), t_cat.blocks("cpu"))
    assert_same_block(got, want)
    assert summary.retries == 0 and summary.result_rows == 547
    # months of the ship-date range x 7 modes, past the masked method's 64
    assert len(calls) == 1 and calls[0] % 7 == 0 and calls[0] > 64


def test_numpy_ship_month_of_chip_smoke_agrees(tables):
    _, t_cat = tables
    out, _ = t_run(S.ship_month_plan(), t_cat.blocks("cpu"))
    assert out.to_pylists() == chip_smoke.numpy_ship_month(
        chip_smoke.lineitem_arrays(t_cat))
