"""The reference's declarative cases (``tests/cases/*.json``) through the
port: each case's tables are made by the reference's
``oracle.pytable_to_block`` and carried into the port
(``testing/bridge.py:export_blocks`` -> ``blocks_from_numpy``), its plan
JSON loads through the port's ``plan/serde.py``, and it runs through the
port's ``run_query`` on the CPU.  Each gives its expected rows (exact:
integers, decimals, dates and strings), with no capacity retry and every
overflow flag 0.  This is the single-device half of the reference's
``testing/declarative.py:run_case``; the distributed half comes with the
distribution slice of the port.
"""

import os
import types

import pytest

from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.plan import serde as j_serde
from tiflash_tpu.testing import declarative as JDecl
from tiflash_tpu.testing import oracle as O

from tiflash_tpu_torch.plan import serde as t_serde
from tiflash_tpu_torch.plan.compiler import compile_fragment
from tiflash_tpu_torch.runtime.executor import run_query
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

CASES_DIR = os.path.join(os.path.dirname(__file__), "cases")
CASES = sorted(f for f in os.listdir(CASES_DIR) if f.endswith(".json"))


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


def case_tables(case) -> dict:
    """The case's tables as port blocks on the CPU, made by the
    reference's oracle (as its ``run_case`` does)."""
    schemas = {t: {c: j_serde.dtype_from_json(d) for c, d in spec["schema"].items()}
               for t, spec in case["tables"].items()}
    blocks = {}
    for t, spec in case["tables"].items():
        rows = {c: [JDecl._decode_value(v, schemas[t][c]) for v in vals]
                for c, vals in spec["rows"].items()}
        blocks[t] = O.pytable_to_block(rows, schemas[t])
    return blocks_from_numpy(export_blocks(blocks), "cpu")


def run_case(case) -> None:
    """Run one case through the port's serde and ``run_query``; assert its
    expected rows, no retry, and every overflow flag of the tree that ran
    at 0."""
    tables = case_tables(case)
    plan = t_serde.plan_from_json(case["plan"])
    out, summary = run_query(plan, tables)
    assert summary.retries == 0, (case["name"], summary.overflow_nodes)
    got = port_pytable(out)
    expect = {c: list(vals) for c, vals in case["expect"].items()}
    O.assert_tables_equal(got, JDecl._normalize(expect, got),
                          ordered=case.get("ordered", False))
    # the plan as given, through the compiler: every flag is 0
    _, flags = compile_fragment(t_serde.plan_from_json(case["plan"]))(tables)
    assert {k: int(v) for k, v in flags.items() if int(v)} == {}, case["name"]


@pytest.mark.parametrize("fname", CASES)
def test_declarative_case(fname):
    run_case(JDecl.load_case(os.path.join(CASES_DIR, fname)))


def test_there_are_nine_cases():
    assert len(CASES) == 9
