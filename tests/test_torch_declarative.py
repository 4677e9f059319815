"""The reference's declarative cases (``tests/cases/*.json``) through the
port's ``testing/declarative.py:run_case`` on the CPU: each case's tables
are made by the port's ``oracle.pytable_to_block``, its plan JSON loads
through the port's ``plan/serde.py``, and it runs through
``compile_fragment`` (every overflow flag 0) and ``run_query`` (no
capacity retry), each giving its expected rows (exact: integers,
decimals, dates and strings).  Then the distributed half: unless the case
says ``"distributed": false``, ``distribute_plan`` of its plan runs over
``Mesh([cpu] * 8)`` and gives the expected rows in any order (shuffles
reorder rows): through ``run_case`` with the default exchange (padded
on the CPU), and here once more with the ragged wire mode.  Both results
are judged once more by the reference's oracle.
"""

import os
import types

import pytest

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.testing import declarative as JDecl
from tiflash_tpu.testing import oracle as O

from tiflash_tpu_torch.mpp.mesh import cpu_mesh
from tiflash_tpu_torch.plan import serde
from tiflash_tpu_torch.plan.auto import distribute_plan
from tiflash_tpu_torch.testing.declarative import (_case_blocks, discover_cases,
                                                   load_case, run_case)

from torch_dist_parity import one_torch_thread, run_mesh  # noqa: F401

CASES_DIR = os.path.join(os.path.dirname(__file__), "cases")
CASES = [os.path.basename(p) for p in discover_cases(CASES_DIR)]


def port_pytable(block) -> dict:
    """A port block's live rows decoded as the reference's oracle decodes
    its own blocks (decimals as ``Decimal``, dates as ``datetime.date``):
    the oracle reads only names, dtypes and ``to_pylists()``."""
    view = types.SimpleNamespace(
        names=block.names, to_pylists=block.to_pylists,
        columns=[types.SimpleNamespace(dtype=getattr(JD, "DataType")(
            getattr(JD.TypeKind, c.dtype.kind.name), c.dtype.nullable,
            c.dtype.precision, c.dtype.scale)) for c in block.columns])
    return O.block_to_pytable(view)


@pytest.mark.parametrize("fname", CASES)
def test_declarative_case(fname):
    case = load_case(os.path.join(CASES_DIR, fname))
    mesh = cpu_mesh(8)
    out = run_case(case, device="cpu", mesh=mesh)
    got = port_pytable(out)
    expect = {c: list(vals) for c, vals in case["expect"].items()}
    O.assert_tables_equal(got, JDecl._normalize(expect, got),
                          ordered=case.get("ordered", False))
    if case.get("distributed", True):
        tables = _case_blocks(case, "cpu")
        stats = {t: b.capacity for t, b in tables.items()}
        dist = distribute_plan(serde.plan_from_json(case["plan"]), stats, mesh.size)
        dout, dsum = run_mesh(dist, tables, "ragged", mesh=mesh)
        assert dsum.num_devices == mesh.size
        dgot = port_pytable(dout)
        O.assert_tables_equal(dgot, JDecl._normalize(expect, dgot), ordered=False)


def test_there_are_nine_cases():
    assert len(CASES) == 9
