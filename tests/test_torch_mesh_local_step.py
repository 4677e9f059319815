"""The mesh runs the single-device compiler's local step on every shard
(``plan/compiler.py:apply_local`` through ``mpp/runner.py:_map_local``).

One case per node kind the other mesh test files do not reach (Expand,
Limit, a hash-partitioned Window, Union), and the cases whose mesh
semantics come from the single-device walk:

- a Projection's bare-column rename keeps ``clustered_by`` over shards
  handed in clustered, so each shard's partial aggregation takes the
  stream method;
- a Join with ``build_payload`` emits only the payload build columns;
- a Join and a CrossJoin with no ``output_capacity`` size their output
  by each shard's own probe capacity.

Each case runs through ``run_query(..., mesh=cpu_mesh(4))`` and is held
to the port's single-device run and to the reference's ``run_query`` on
a 4-device mesh (row-sorted, exact: integers, decimal mantissas and
strings).  Two more tests: a shard's bad row gives the reference's
runtime-error flag keys and values, and a CTERef with no enclosing
WithCTE raises one error on both walks.
"""

import dataclasses
import types

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as dt
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.mpp import runner as JR
from tiflash_tpu.ops.aggregate import AggDesc as JAgg
from tiflash_tpu.ops.sort import SortKey as JSK
from tiflash_tpu.ops.window import WindowDesc as JWD
from tiflash_tpu.plan import distribute as JD
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.testing import oracle as O

from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.mpp import runner as TR
from tiflash_tpu_torch.mpp.mesh import cpu_mesh
from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg
from tiflash_tpu_torch.ops.sort import SortKey as TSK
from tiflash_tpu_torch.ops.window import WindowDesc as TWD
from tiflash_tpu_torch.plan import distribute as TD
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime.errors import RTERR_PREFIX
from tiflash_tpu_torch.runtime.executor import run_query
from tiflash_tpu_torch.runtime.metrics import METRICS

from torch_dist_parity import one_torch_thread  # noqa: F401
from torch_dist_parity import flags_of, rows, to_port

J = types.SimpleNamespace(P=JP, E=JE, D=JD, Agg=JAgg, SK=JSK, WD=JWD)
T = types.SimpleNamespace(P=TP, E=TE, D=TD, Agg=TAgg, SK=TSK, WD=TWD)
MESH = cpu_mesh(4)


def _jax_mesh4():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]), ("d",))


def _tables(seed=7, n=203, nu=13):
    """t: a unique ``id``, a key ``k`` in 0..12 with its rows adjacent
    (sorted on ``k``), a nullable decimal, an int and a string; u: a
    unique key ``rk`` in 0..12 and two payloads."""
    rng = np.random.default_rng(seed)
    ts = {"id": dt.INT64, "k": dt.INT32, "v": dt.Decimal(10, 2, nullable=True),
          "w": dt.INT64, "s": dt.STRING}
    t = O.random_pytable(rng, n, ts, int_range=(0, 13))
    t["k"] = sorted(t["k"])
    t["id"] = list(range(n))
    us = {"rk": dt.INT32, "rv": dt.INT64, "rs": dt.STRING}
    u = O.random_pytable(rng, nu, us, int_range=(0, 50))
    u["rk"] = list(range(nu))
    return {"t": O.pytable_to_block(t, ts), "u": O.pytable_to_block(u, us)}


def _x(M, child, keys, kind="hash"):
    """An exchange of ``child``: hashed on ``keys``, or a broadcast or
    passthrough gather."""
    return M.P.ExchangeReceiver(M.P.ExchangeSender(kind, list(keys), child))


def _expand(M, dist):
    sel = M.P.Selection(M.E.col("k") < M.E.lit(9), M.P.TableScan("t"))
    return M.P.Expand([["k"], ["s"]], sel)


def _limit(M, dist):
    """The first 7 rows by ``id``: each shard's, gathered, then the first
    7 of those."""
    local = M.P.Limit(7, M.P.Sort([M.SK("id")], M.P.TableScan("t")))
    if dist:
        local = _x(M, local, [], "passthrough")
    return M.P.Limit(7, M.P.Sort([M.SK("id")], local))


def _window(M, dist):
    funcs = [M.WD("row_number", "rn"), M.WD("sum", "sw", arg="w"),
             M.WD("lag", "lw", arg="w")]
    scan = M.P.TableScan("t")
    if dist:
        return M.D.partitioned_window(["k"], [M.SK("id")], funcs, scan)
    return M.P.Window(["k"], [M.SK("id")], funcs, scan)


def _union(M, dist):
    lo = M.P.Selection(M.E.col("k") < M.E.lit(4), M.P.TableScan("t"))
    hi = M.P.Selection(M.E.col("k") > M.E.lit(9), M.P.TableScan("t"))
    return M.P.Union([lo, _x(M, hi, ["k"]) if dist else hi])


def _projection_clustered(M, dist):
    proj = M.P.Projection({"k2": M.E.col("k"), "w": M.E.col("w")}, M.P.TableScan("t"))
    aggs = [M.Agg("sum", "w", "sw"), M.Agg("count", None, "c")]
    if dist:
        return M.D.split_aggregation(["k2"], aggs, proj)
    return M.P.Aggregation(["k2"], aggs, proj)


def _join_payload(M, dist):
    build = M.P.TableScan("u")
    return M.P.Join(kind="inner", probe_keys=["k"], build_keys=["rk"],
                    probe=M.P.TableScan("t"),
                    build=_x(M, build, [], "broadcast") if dist else build,
                    build_payload=["rv"])


def _default_capacity(M, dist):
    """An N:M join and a cross join, neither given an output capacity."""
    build = M.P.TableScan("u")
    join = M.P.Join(kind="inner", probe_keys=["k"], build_keys=["rk"],
                    probe=M.P.TableScan("t"),
                    build=_x(M, build, [], "broadcast") if dist else build)
    one = M.P.Projection({"top": M.E.col("rv")},
                         M.P.Selection(M.E.col("rk") == M.E.lit(2), M.P.TableScan("u")))
    if dist:
        one = _x(M, one, [], "broadcast")
    return M.P.CrossJoin(probe=join, build=one)


CASES = {
    "Expand": _expand,
    "Limit": _limit,
    "Window": _window,
    "Union": _union,
    "Projection_clustered_by": _projection_clustered,
    "Join_build_payload": _join_payload,
    "Join_CrossJoin_default_capacity": _default_capacity,
}
# the cases run_query distributes itself; the others are given their
# exchanges (``distribute_plan`` has no rule for a Union, a Window it
# would lane, a Join's payload or, in the reference, a Limit)
LOGICAL = {"Expand", "Projection_clustered_by"}


def _rows_of(block, names):
    """Row-sorted live rows of ``names`` only."""
    py = block.compact().to_pylists()
    return O.sort_pytable({n: py[n] for n in names})


@pytest.mark.parametrize("case", sorted(CASES))
def test_local_step_on_the_mesh(case):
    build = CASES[case]
    j = _tables()
    t = to_port(j)
    mesh_tables = t
    if case == "Projection_clustered_by":
        # shards of a table clustered on k stay clustered on k
        mesh_tables = {name: [dataclasses.replace(s, clustered_by=("k",))
                              for s in TR.shard_block(b, MESH)]
                       for name, b in t.items()}
    dist = case not in LOGICAL
    single, _ = run_query(build(T, False), t, plan_rewrites=False)
    streamed = METRICS.counter("agg_calls_total_method_stream").value
    got, summary = run_query(build(T, dist), mesh_tables, mesh=MESH)
    streamed = METRICS.counter("agg_calls_total_method_stream").value - streamed
    want, _ = j_run(build(J, dist), j, mesh=_jax_mesh4())
    assert summary.num_devices == 4
    assert summary.retries == 0
    assert got.names == single.names
    assert rows(got) == rows(single)
    assert _rows_of(want, got.names) == rows(got)
    if case == "Projection_clustered_by":
        # every shard's partial stage saw k2 clustered
        assert streamed >= MESH.size
    if case == "Join_build_payload":
        assert "rs" not in got.names


def test_runtime_error_flags_keep_their_keys_on_the_mesh():
    """A bad row on one shard raises the query: its flag rides the mesh's
    flags under the reference's key, next to the overflow flags."""
    schema = {"flag": dt.INT64, "s": dt.STRING.with_nullable(True)}
    n = 64
    svals = ['"ok"'] * n
    svals[37] = '"bad\\ "'  # one shard holds the poisoned row
    j = {"t": O.pytable_to_block({"flag": list(range(n)), "s": svals}, schema)}

    def plan(M):
        proj = M.P.Projection({"flag": M.E.col("flag"),
                               "r": M.E.call("json_unquote", M.E.col("s"))},
                              M.P.TableScan("t"))
        return M.D.split_aggregation([], [M.Agg("count", "r", "c")], proj)

    jm = _jax_mesh4()
    _, jflags = JR.compile_distributed(plan(J), jm)(JR.shard_catalog_blocks(j, jm))
    _, flags = TR.compile_distributed(plan(T), MESH)(
        TR.shard_catalog_blocks(to_port(j), MESH))
    assert flags_of(flags) == flags_of(jflags)
    assert any(k.startswith(RTERR_PREFIX) and v for k, v in flags_of(flags).items())


def test_cte_ref_without_its_with_raises_one_error_on_both_walks():
    from tiflash_tpu_torch.plan.compiler import compile_fragment

    plan = TP.Selection(TE.col("k") < TE.lit(4), TP.CTERef("missing"))
    msg = "CTE 'missing' not defined by an enclosing WithCTE"
    with pytest.raises(KeyError, match=msg):
        compile_fragment(plan)({})
    with pytest.raises(KeyError, match=msg):
        TR.compile_distributed(plan, MESH)({})
