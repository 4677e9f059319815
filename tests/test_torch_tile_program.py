"""The fused scan's tile program (``ops/tile_program.py``) against the
closures it replaces.

For each fusing case of ``tiflash_tpu_torch/testing/fuse_cases.py`` (the
shapes of ``test_torch_stream_fuse.py``, a ``sel`` table and a
shared-regime layout) and for TPC-H Q1/Q6 at sf 0.002, the same plan
compiles in both packages over the same tables.  The expected slots and
planes are the closures' own output: the JAX package's
``make_tile_values``, caught at its ``stream_group_sums`` call and run on
the call's inputs.  The port's program, caught at its
``fused_group_sums`` call, must give the same slots and planes through
``evaluate``, bit for bit on every row (dead and NULL rows included),
with the same packed layout.  Tolerance zero: int32 values.

Then the source the generator writes: plans that differ only in their
literals give one text (the literals are launch parameters), a change of
structure another.
"""

import types

import numpy as np
import pytest
import torch

from tiflash_tpu.core.block import Block, column_from_numpy
from tiflash_tpu.core import dtypes as JD
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.ops import stream_fuse as JSF
from tiflash_tpu.ops.aggregate import AggDesc as JAggDesc
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.compiler import compile_fragment as j_compile

from tiflash_tpu_torch.ops import tile_program as TP
from tiflash_tpu_torch.ops.cuda import stream_agg as TSA
from tiflash_tpu_torch.ops.cuda import stream_tile as TST
from tiflash_tpu_torch.plan.compiler import compile_fragment as t_compile
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing import fuse_cases as FC
from tiflash_tpu_torch.testing.bridge import export_blocks

JAX = types.SimpleNamespace(E=JE, P=JP, AggDesc=JAggDesc)
TORCH = FC.TORCH


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("TIFLASH_TPU_STREAM_KERNEL", "interpret")


def jax_tables(spec):
    """The case's table in the JAX package (its own dictionaries, stats
    and int32 shadows)."""
    cols, sel = spec
    out = {}
    for name, (values, dt, validity) in cols.items():
        jdt = JD.DataType(JD.TypeKind[dt.kind.name], nullable=dt.nullable,
                          precision=dt.precision, scale=dt.scale)
        vals = values.tolist() if dt.is_string else values
        out[name] = column_from_numpy(vals, jdt, validity)
    return {"t": Block.from_dict(out, sel=None if sel is None else np.asarray(sel))}


def closures_output(monkeypatch, plan, tables):
    """(slots, [planes], plane_fields) of the JAX closures over every row."""
    import jax
    import jax.numpy as jnp

    seen = []

    def spy(inputs, make_tile_values, n_slots, n_limbs, n_rows, interpret=False,
            plane_fields=None):
        seen.append((inputs, make_tile_values, n_rows, plane_fields))
        n_fields = n_limbs if plane_fields is None else sum(map(len, plane_fields))
        return jnp.zeros((n_slots, n_fields), dtype=jnp.int64)

    monkeypatch.setattr(JSF, "stream_group_sums", spy)
    before = JSF.FUSE_STATS["count"]
    with jax.disable_jit():  # the spy sees the call's concrete inputs
        j_compile(plan)(tables)
    assert JSF.FUSE_STATS["count"] == before + 1 and len(seen) == 1
    inputs, mtv, n, pf = seen[0]
    tile = {k: jnp.asarray(np.asarray(v)[:n]).astype(jnp.int32) for k, v in inputs.items()}
    slots, limbs = mtv(tile, jnp.ones(n, dtype=bool))
    return np.asarray(slots), [np.asarray(x) for x in limbs], pf


def port_program(monkeypatch, plan, tables):
    """The port's (arrays, program, plane_fields) at its fused call."""
    seen = []

    def spy(inputs, program, n_slots, n_limbs, n_rows, plane_fields, headroom, device):
        assert device == torch.device("cpu")
        seen.append((inputs, program, plane_fields))
        return torch.zeros((n_slots, len(TSA.field_table(plane_fields, n_limbs))),
                           dtype=torch.int64)

    monkeypatch.setattr(TST, "fused_group_sums", spy)
    t_compile(plan)(tables)
    assert len(seen) == 1
    return seen[0]


def assert_program_matches_closures(monkeypatch, build, tables):
    want_slots, want_planes, want_pf = closures_output(monkeypatch, build(JAX), tables)
    t_tables = blocks_from_numpy(export_blocks(tables), "cpu")
    arrays, program, pf = port_program(monkeypatch, build(TORCH), t_tables)
    assert [list(map(tuple, p)) for p in pf] == [list(map(tuple, p)) for p in want_pf]
    tile = TP.stage(program, arrays)
    slots, planes = TP.evaluate(program, tile, torch.ones(len(want_slots), dtype=torch.bool))
    assert slots.dtype == torch.int32 and all(p.dtype == torch.int32 for p in planes)
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    assert len(planes) == len(want_planes)
    for got, want in zip(planes, want_planes):
        np.testing.assert_array_equal(got.numpy(), want)
    # the old callable contract, with rows out of bounds dead
    n = slots.shape[0]
    in_bounds = torch.arange(n) < n - 3
    s2, p2 = program.as_tile_function()(tile, in_bounds)
    assert torch.equal(s2, torch.where(in_bounds, slots, program.n_slots))
    assert all(torch.equal(a, b) for a, b in zip(p2, planes))
    return program


@pytest.mark.parametrize("name", [c.name for c in FC.CASES])
def test_program_equals_the_closures(monkeypatch, name):
    case = FC.case(name)
    spec = case.columns(case.n, case.seed)
    program = assert_program_matches_closures(monkeypatch, case.plan, jax_tables(spec))
    if name == "shared_layout":
        S, L = program.n_slots, len(program.planes)
        assert TST.plan_tile_launch(S, L, L, 6).regime == "shared"


@pytest.mark.parametrize("name", [c.name for c in FC.CASES])
def test_numpy_tables_equal_the_reference_tables(name):
    """``fuse_cases.numpy_tables`` (what chip_smoke.py builds without jax)
    gives the tables the reference's ``column_from_numpy`` makes."""
    case = FC.case(name)
    spec = case.columns(300, case.seed)
    want = export_blocks(jax_tables(spec))["t"]
    got = FC.numpy_tables(spec)["t"]
    assert got["names"] == want["names"]
    for g, w in zip(got["columns"], want["columns"]):
        np.testing.assert_array_equal(g["data"], w["data"])
        assert g["dictionary"] == w["dictionary"] and g["stats"] == w["stats"]
        assert (g["validity"] is None) == (w["validity"] is None)
        if g["validity"] is not None:
            np.testing.assert_array_equal(g["validity"], w["validity"])
        for k in ("kind", "precision", "scale", "nullable"):
            assert g["dtype"][k] == w["dtype"][k]
    assert (got["sel"] is None) == (want["sel"] is None)


@pytest.mark.parametrize("plan_name", ["q1_plan", "q6_plan"])
def test_tpch_program_equals_the_closures(monkeypatch, plan_name):
    from tiflash_tpu.bench import tpch_queries as JQ
    from tiflash_tpu.storage.tpch import generate_tpch
    from tiflash_tpu_torch.bench import tpch_queries as TQ

    tables = generate_tpch(sf=0.002, seed=2, tables=["lineitem"]).blocks()
    assert_program_matches_closures(
        monkeypatch, lambda m: getattr(JQ if m is JAX else TQ, plan_name)(), tables)


def test_a_program_without_arrays_stays_on_the_tables_device(monkeypatch):
    """A bare ``count(*)`` reads no array: the call names the table's
    device, which decides plain or kernel; it never falls to the CPU."""
    case = FC.case("count_star")
    n = 777
    tables = blocks_from_numpy(FC.numpy_tables(case.columns(n, case.seed)), "cpu")
    arrays, program, pf = port_program(monkeypatch, case.plan(TORCH), tables)
    monkeypatch.undo()
    assert arrays == {} and program.arrays == ()
    L = len(program.planes)
    got = TST.fused_group_sums({}, program, program.n_slots, L, n, pf, 0, "cpu")
    assert got.device.type == "cpu" and got.tolist() == [[n]]
    with pytest.raises(ValueError, match="needs its device"):
        TST.fused_group_sums({}, program, program.n_slots, L, n, pf, 0)
    with pytest.raises(RuntimeError, match="no stream_tile kernel for device meta"):
        TST.fused_group_sums({}, program, program.n_slots, L, n, pf, 0, "meta")
    out = t_compile(case.plan(TORCH))(tables)[0]
    assert out["c"].data.tolist() == [n]


def _q6_source(monkeypatch, tables, **literals):
    from tiflash_tpu_torch.bench import tpch_queries as TQ

    arrays, program, pf = port_program(monkeypatch, TQ.q6_plan(**literals), tables)
    fields = TSA.field_table(pf, len(program.planes))
    return program, TST.kernel_source(program, fields, 6)[0]


def test_literals_are_launch_parameters(monkeypatch):
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    tables = generate_tpch(sf=0.002, seed=0, tables=["lineitem"]).blocks("cpu")
    p1, src1 = _q6_source(monkeypatch, tables)
    p2, src2 = _q6_source(monkeypatch, tables, date="1995-01-01", date_end="1996-01-01",
                          disc_lo=0.02, disc_hi=0.04, quantity=25.0)
    assert src1 == src2 and TP.emit_cuda(p1) == TP.emit_cuda(p2)
    assert p1.params != p2.params and len(p1.params) == len(p2.params) == 5


def test_structure_changes_the_source(monkeypatch):
    """Another operator, or another key, writes another text."""
    case = FC.case("two_keys_in_filter")
    tables = blocks_from_numpy(FC.numpy_tables(case.columns(200, 1)), "cpu")

    def src(build):
        arrays, program, pf = port_program(monkeypatch, build(TORCH), tables)
        return TP.emit_cuda(program)

    base = src(FC.two_keys_in_filter)
    other_op = src(lambda m: FC._agg_over(
        m, ["grp", "flag"], [("sum", "price", "s"), ("count", None, "c")],
        lambda E: E.Call("and", (
            E.Call("in", (E.ColumnRef("grp"), E.Literal("aa"), E.Literal("cc"),
                          E.Literal("zz"))),
            E.Call("greater_or_equals", (E.ColumnRef("qty"), E.Literal(10))),
        ))))
    one_key = src(lambda m: FC._agg_over(
        m, ["grp"], [("sum", "price", "s"), ("count", None, "c")],
        lambda E: E.Call("and", (
            E.Call("in", (E.ColumnRef("grp"), E.Literal("aa"), E.Literal("cc"),
                          E.Literal("zz"))),
            E.Call("greater", (E.ColumnRef("qty"), E.Literal(10))),
        ))))
    assert len({base, other_op, one_key}) == 3


def test_int32_semantics_of_the_nodes():
    """Wrapping arithmetic, arithmetic shifts and signed compares, as
    torch's int32 ops (the C++ side emits them as unsigned arithmetic)."""
    x = torch.tensor([0, 1, -5, 2 ** 31 - 1, -2 ** 31, 123456789], dtype=torch.int32)
    tile = {"x": x}
    v = TP.inp("x")
    cases = [
        (TP.mul(v, TP.const(3)), x * 3),
        (TP.add(TP.shl(v, 7), TP.const(2 ** 31 - 1)), (x << 7) + (2 ** 31 - 1)),
        (TP.shr(v, 9), x >> 9),
        (TP.neg(v), -x),
        (TP.band(v, 0xFFFF), x & 0xFFFF),
        (TP.shl(v, 40), torch.zeros_like(x)),
        (TP.b2i(TP.cmp("lt", v, TP.const(7))), (x < 7).to(torch.int32)),
        (TP.b2i(TP.cmp("ge", TP.const(-5), v)), (x <= -5).to(torch.int32)),
        (TP.where(TP.nz(v), TP.const(2 ** 33 + 5), TP.const(0)),
         torch.where(x != 0, 5, 0).to(torch.int32)),
    ]
    got = TP.evaluate_nodes([c[0] for c in cases], tile, (), x)
    for g, (_, want) in zip(got, cases):
        assert g.dtype == torch.int32 and torch.equal(g, want)
