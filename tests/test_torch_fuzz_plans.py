"""Differential plan fuzzing: the port's ``run_query`` against the JAX
package's on seeded random plan trees over random tables with NULLs.

The vocabulary is the reference fuzzer's (``tests/test_fuzz_plans.py``):
Selection, Projection, Join (every kind the reference's fuzzer draws,
right and full outer since the analytic slice), Aggregation (with
``bit_or`` since that slice), TopN and Limit over the same schema, plus
the functions slice's
scalar functions: ``if``, ``negate``, ``case_when``, ``coalesce``, casts
and date parts over a DATE column.  Every tree builds
once for each package from one seed.  Results compare as sorted rows:
exact, but doubles within 1e-12 relative (the float sums of the two
packages may add in another order).  A LIMIT keeps any subset
of its rows, so LIMIT plans run without the plan rewrites (which may
move a LIMIT, ``tiflash_tpu/plan/rewrite.py:238``) against the
reference's ``compile_fragment`` and compare their row counts only.
The generator lives in ``tests/torch_plan_draw.py``, where ``chip_smoke.py``
draws the same trees on the card.
"""

import pytest

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.ops import aggregate as JA
from tiflash_tpu.ops import sort as JS
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.compiler import compile_fragment as j_compile
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.testing import oracle as O

from tiflash_tpu_torch.core import dtypes as TD
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.ops import sort as TS
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks
from torch_plan_draw import (  # noqa: F401  (_rand_pred, _rand_proj: the out-of-core tests)
    Ns, _r_schema, _rand_pred, _rand_proj, _schema, assert_same_rows, build_plan,
    port_tables)


JNS = Ns(JE, JP, JA, JS, JD)
TNS = Ns(TE, TP, TA, TS, TD)


def _tables(seed: int):
    tables = port_tables(seed, O.random_pytable, JD)
    j_blocks = {"t": O.pytable_to_block(tables["t"], _schema(JD)),
                "r": O.pytable_to_block(tables["r"], _r_schema(JD))}
    return j_blocks, blocks_from_numpy(export_blocks(j_blocks), "cpu")


SEEDS = range(40)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_plan_matches_reference(seed):
    j_blocks, t_blocks = _tables(seed)
    j_plan, shape = build_plan(seed, JNS)
    t_plan, t_shape = build_plan(seed, TNS)
    assert t_shape == shape and t_plan.pretty() == j_plan.pretty()
    if shape == "limit":
        want, _ = j_compile(j_plan)(j_blocks)
        got, _ = t_run(t_plan, t_blocks, plan_rewrites=False)
        assert int(got.num_rows()) == int(want.num_rows()), j_plan.pretty()
        return
    want, _ = j_run(j_plan, j_blocks)
    got, _ = t_run(t_plan, t_blocks)
    assert [repr(c.dtype) for c in got.columns] == \
        [repr(c.dtype) for c in want.columns], j_plan.pretty()
    assert_same_rows(got.to_pylists(), want.to_pylists(), j_plan.pretty())


def test_fuzz_vocabulary_reaches_every_projection_and_shape():
    """The seeds above draw every projection of the slice and every plan
    shape at least once."""
    shapes, picks = set(), set()
    for seed in SEEDS:
        plan, shape = build_plan(seed, TNS)
        shapes.add(shape)
        node = plan
        while True:
            if isinstance(node, TP.Projection):
                picks.add(repr(node.exprs["x"]).split("(")[0])
            if not node.children:
                break
            node = node.children[0]
    assert shapes == {"agg", "topn", "limit", "plain"}
    assert {"if", "negate", "case_when", "coalesce", "cast", "plus",
            "datediff", "length"} <= picks, picks
