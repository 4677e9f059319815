"""Declarative query-test runner.

Counterpart of ``tiflash_tpu/testing/declarative.py``.  Role analog: the
reference's ``.test`` files (``tests/fullstack-test/*.test``: mysql>
statements + expected tables, run by ``tests/run-test.py``) — here JSON
cases with inline tables, a serialized plan, and expected output rows.
Each case runs through the single-device compiler and ``run_query`` on
the device it is given and, with a mesh, through ``distribute_plan`` and
the runner over that mesh, and must give the expected rows exactly
(order-insensitive unless ``ordered``; in any order over the mesh).

Case format::

    {
      "name": "...",
      "tables": {"t": {"schema": {"k": {"kind": "i64"}}, "rows": {"k": [..]}}},
      "plan": { ... serde plan json ... },
      "expect": {"col": [values...]},
      "ordered": false,
      "distributed": true       # also run on the mesh (default true)
    }

    from tiflash_tpu_torch.mpp.mesh import card_mesh
    for path in discover_cases("tests/cases"):
        run_case(load_case(path), device="cuda", mesh=card_mesh(8))
"""

from __future__ import annotations

import datetime
import json
import os
from decimal import Decimal as D
from typing import Dict, Iterator

from ..core.dtypes import TypeKind
from ..plan import serde
from ..plan.auto import distribute_plan
from ..plan.compiler import compile_fragment
from ..runtime.executor import read_flags, run_query
from . import oracle as O


def _decode_value(v, dt):
    if v is None:
        return None
    if dt.is_decimal:
        return D(str(v))
    if dt.kind is TypeKind.DATE and isinstance(v, str):
        return datetime.date.fromisoformat(v)
    return v


def load_case(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _case_blocks(case: Dict, device="cuda") -> Dict:
    """The case's tables as Blocks on ``device``."""
    schemas = {
        t: {c: serde.dtype_from_json(d) for c, d in spec["schema"].items()}
        for t, spec in case["tables"].items()
    }
    return {
        t: O.pytable_to_block(
            {c: [_decode_value(v, schemas[t][c]) for v in vals]
             for c, vals in spec["rows"].items()}, schemas[t], device)
        for t, spec in case["tables"].items()
    }


def run_case(case: Dict, device="cuda", mesh=None):
    """Run one case on ``device``: the plan through ``compile_fragment``
    (every overflow flag 0) and through ``run_query`` (no capacity
    retry), each giving the expected rows; then, with ``mesh`` and unless
    the case says ``"distributed": false``, ``distribute_plan`` of the
    plan through ``run_query`` over the mesh, giving the expected rows in
    any order (shuffles reorder rows).  Returns the single-device
    ``run_query`` result block."""
    name = case["name"]
    blocks = _case_blocks(case, device)
    expect = {c: list(vals) for c, vals in case["expect"].items()}
    ordered = case.get("ordered", False)

    out, flags = compile_fragment(serde.plan_from_json(case["plan"]))(blocks)
    raised = {k: v for k, v in read_flags(flags).items() if v}
    assert not raised, (name, raised)
    got = O.block_to_pytable(out)
    _assert_tables_equal(got, _normalize(expect, got), ordered=ordered)

    result, summary = run_query(serde.plan_from_json(case["plan"]), blocks)
    assert summary.retries == 0, (name, summary.overflow_nodes)
    got = O.block_to_pytable(result)
    _assert_tables_equal(got, _normalize(expect, got), ordered=ordered)

    if mesh is not None and case.get("distributed", True):
        stats = {t: b.capacity for t, b in blocks.items()}
        dist = distribute_plan(serde.plan_from_json(case["plan"]), stats, mesh.size)
        dout, dsum = run_query(dist, blocks, mesh=mesh)
        assert dsum.num_devices == mesh.size, (name, dsum.num_devices)
        dgot = O.block_to_pytable(dout)
        _assert_tables_equal(dgot, _normalize(expect, dgot), ordered=False)
    return result


def _normalize(expect: Dict, got: Dict) -> Dict:
    """Coerce expected literals to the got-value types (decimal strings,
    ISO dates) so authors can write plain JSON."""
    out = {}
    for cname, vals in expect.items():
        gvals = got.get(cname, [])
        sample = next((g for g in gvals if g is not None), None)
        conv = []
        for v in vals:
            if v is None:
                conv.append(None)
            elif isinstance(sample, D):
                conv.append(D(str(v)))
            elif isinstance(sample, datetime.date) and isinstance(v, str):
                conv.append(datetime.date.fromisoformat(v))
            elif isinstance(sample, bool):
                conv.append(bool(v))
            else:
                conv.append(v)
        out[cname] = conv
    return out


def _sorted_rows(t: Dict) -> Dict:
    """Canonical row order for an orderless comparison."""
    names = list(t.keys())
    rows = list(zip(*[t[n] for n in names]))
    rows.sort(key=lambda r: tuple((v is None, str(type(v)), v) for v in r))
    return {n: [r[i] for r in rows] for i, n in enumerate(names)}


def _assert_tables_equal(actual: Dict, expected: Dict, *, ordered=False) -> None:
    """The case's check (the reference oracle's): the same column names
    and, row by row (after a canonical sort unless ``ordered``), the same
    values; decimals by value, floats within 1e-12."""
    assert set(actual) == set(expected), (sorted(actual), sorted(expected))
    a = actual if ordered else _sorted_rows(actual)
    e = expected if ordered else _sorted_rows(expected)
    for name in e:
        av, ev = a[name], e[name]
        assert len(av) == len(ev), f"{name}: {len(av)} rows vs {len(ev)}"
        for i, (x, y) in enumerate(zip(av, ev)):
            assert O._py_eq(x, y), f"{name}[{i}]: {x!r} != {y!r}"


def discover_cases(directory: str) -> Iterator[str]:
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(".json"):
            yield os.path.join(directory, fn)


__all__ = ["run_case", "load_case", "discover_cases"]
