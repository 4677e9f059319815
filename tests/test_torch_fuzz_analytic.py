"""The reference fuzzer's window and grouping-sets shapes
(``tests/test_fuzz_plans.py``: ``test_fuzz_window_matches_oracle``, 16
seeds, and ``test_fuzz_grouping_sets_matches_oracle``, 10 seeds) run
against the port with the reference's own seeds and generators.

Each seed builds the reference's plan and tables exactly as its test
does; ``to_port`` maps the plan onto the port's classes, and the tables
cross through ``testing/bridge.py``.  The port's ``run_query`` and the
reference's ``compile_fragment`` give the same rows, every overflow flag
0, and both equal the reference's oracle (``execute_plan_oracle``),
compared as the reference's test compares them (``_norm``: sorted rows).
"""

import dataclasses
import enum

import numpy as np
import pytest

import test_fuzz_plans as RF
from tiflash_tpu.plan.compiler import compile_fragment as j_compile
from tiflash_tpu.testing import oracle as O
from tiflash_tpu.testing.plan_oracle import execute_plan_oracle

from tiflash_tpu_torch.core import dtypes as TD
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.ops import aggregate as TA
from tiflash_tpu_torch.ops import sort as TS
from tiflash_tpu_torch.ops import window as TW
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime.executor import run_query as t_run
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

_PORT_MODULES = (TP, TE, TA, TS, TW, TD)


def to_port(x):
    """A reference plan (nodes, expressions, AggDescs, SortKeys,
    WindowDescs, DataTypes) -> the same tree of the port's classes."""
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    if isinstance(x, enum.Enum):
        return getattr(TD.TypeKind, x.name)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        name = type(x).__name__
        cls = next(getattr(m, name) for m in _PORT_MODULES if hasattr(m, name))
        return cls(**{f.name: to_port(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    return x


def _check(plan, tables):
    blocks = {n: O.pytable_to_block(t, RF.SCHEMA if n == "t" else RF.R_SCHEMA)
              for n, t in tables.items()}
    want, ov = j_compile(plan)(blocks)
    assert all(int(np.asarray(v)) == 0 for v in ov.values()), plan.pretty()
    tplan = to_port(plan)
    assert tplan.pretty() == plan.pretty()
    got, summary = t_run(tplan, blocks_from_numpy(export_blocks(blocks), "cpu"))
    assert summary.retries == 0, summary.overflow_nodes
    from test_torch_declarative import port_pytable

    g = RF._norm(port_pytable(got))
    assert g == RF._norm(O.block_to_pytable(want)), plan.pretty()
    assert g == RF._norm(execute_plan_oracle(plan, tables)), plan.pretty()


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_window_matches_reference(seed):
    rng = np.random.default_rng(5000 + seed)
    tables = RF._tables(rng)
    node = RF.P.TableScan("t")
    if rng.random() < 0.5:
        node = RF.P.Selection(RF._rand_pred(rng), node)
    _check(RF._rand_window(rng, node), tables)


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_grouping_sets_matches_reference(seed):
    rng = np.random.default_rng(7000 + seed)
    tables = RF._tables(rng)
    node = RF.P.TableScan("t")
    if rng.random() < 0.6:
        node = RF.P.Selection(RF._rand_pred(rng), node)
    sets = [["s", "b"], ["s"], []]
    if rng.random() < 0.5:
        sets = [["b"], []]
    node = RF.P.Expand(sets, node)
    keys = sorted({k for s in sets for k in s}) + ["groupingID"]
    plan = RF.P.Aggregation(keys=keys, aggs=[
        RF.AggDesc("sum", RF.VAL_COL, "sv"), RF.AggDesc("count", None, "c")],
        child=node)
    _check(plan, tables)
