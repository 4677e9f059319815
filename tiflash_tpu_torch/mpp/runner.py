"""Distributed (MPP) query execution over a mesh of shards.

Counterpart of ``tiflash_tpu/mpp/runner.py``.  The reference traces a
plan with exchanges into one ``shard_map`` function; here one controller
walks the plan once and each node acts on a list with one Block per
local shard (``mpp/mesh.py``):

- a node without an exchange runs the single-device compiler's local
  step (``plan/compiler.py:apply_local``) on each shard (``Mesh.map``:
  replicated inputs are computed once), so what a node does is written
  once for both walks;
- an exchange (``ExchangeReceiver`` over an ``ExchangeSender``), the
  skew join and the collectives inside nodes act across the list;
- a node with a collective in its middle runs in phases: local, combine,
  apply.  That covers the runtime-filter publish
  (``ops/runtime_filter.py``: ``pmin``/``pmax``, the key set's gather;
  the run's filters live in its ``Diagnostics.rf``), the overflow flags'
  ``pmax`` (``_combine_flags``), the skew join's sample gather, the
  shuffle's size matrix and the laned window's carries.
  ``_laned_window`` is written once per shard as a generator that yields
  each collective it needs; ``_lockstep`` runs the shards' generators
  side by side and answers each yield with the mesh's collective, so its
  code stays the reference's line for line.

Node ids follow the reference's DFS counter, so overflow keys
(``Aggregation_3``, ``Exchange_5``) are the reference's.  The fused
stream aggregation never runs here, as in the reference (its SPMD
aggregation calls ``hash_aggregate``); the direct aggregation's kernel
branch does, once per shard and stage.

One departure from the reference: a broadcast or passthrough of rows
that every shard already holds (a replicated subtree, e.g. a scalar
aggregate's final stage under a cross join) passes them through; the
reference gathers them again and every row of such a plan comes back P
times.

``shard_block`` splits a table's rows into P contiguous shards, padding
the row count to a multiple of P with dead rows and dropping column
statistics, as the reference does; ``collect_result`` concatenates the
shards in shard order, the row layout of the reference's global array.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..core.block import Block, Column, as_dtype_bits, signed_bits
from ..exchange.shuffle import allgather_block, shuffle_block
from ..ops.runtime_filter import publish_runtime_filter
from ..ops.window import window_block
from ..plan import nodes as P
from ..plan.compiler import Diagnostics, apply_local, cte_block, flag_dict
from .mesh import Mesh

AXIS = "d"
_I64_MAX = 2 ** 63 - 1
_I64_MIN = -(2 ** 63)


# ---------------------------------------------------------------------------
# table sharding (the Region-shard analog: rows split across shards)
# ---------------------------------------------------------------------------


def _slice_pad(arr: torch.Tensor, lo: int, hi: int, n: int, fill, dev) -> torch.Tensor:
    """Rows [lo, hi) of ``arr`` (n rows), padded with ``fill`` past n."""
    part = arr[min(lo, n): min(hi, n)]
    short = (hi - lo) - part.shape[0]
    if short:
        pad = torch.full((short,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                         device=arr.device)
        part = torch.cat([part, pad])
    return Mesh._to(part, dev)


def shard_block(block: Block, mesh: Mesh) -> List[Block]:
    """Pad the row count to a multiple of P and split it into P contiguous
    shards (this process's local ones); statistics are dropped."""
    n_dev = mesh.size
    n = block.capacity
    per = -(-n // n_dev)
    sel = block.sel_mask()
    out = []
    for i in range(mesh.local_size):
        g = mesh.axis_index(i)
        lo, hi = g * per, (g + 1) * per
        dev = mesh.devices[i]
        cols = []
        for c in block.columns:
            data = as_dtype_bits(_slice_pad(signed_bits(c.data), lo, hi, n, 0, dev),
                                 c.data.dtype)
            validity = (None if c.validity is None
                        else _slice_pad(c.validity, lo, hi, n, False, dev))
            cols.append(Column(data, validity, c.dtype, c.dictionary,
                               concat_sep=c.concat_sep))
        out.append(Block(names=block.names, columns=tuple(cols),
                         sel=_slice_pad(sel, lo, hi, n, False, dev)))
    return out


def shard_catalog_blocks(blocks: Dict[str, Block], mesh: Mesh) -> Dict[str, List[Block]]:
    return {k: shard_block(b, mesh) for k, b in blocks.items()}


def concat_shards(blocks: Sequence[Block], device=None) -> Block:
    """One Block of the shards' rows in shard order, on ``device`` (the
    first shard's by default)."""
    if len(blocks) == 1 and (device is None or blocks[0].device == torch.device(device)):
        return blocks[0]
    dev = torch.device(device) if device is not None else blocks[0].device
    cols = []
    for ci, c0 in enumerate(blocks[0].columns):
        shard_cols = [b.columns[ci] for b in blocks]
        data = as_dtype_bits(torch.cat([Mesh._to(signed_bits(c.data), dev)
                                        for c in shard_cols]), c0.data.dtype)
        validity = None
        if any(c.validity is not None for c in shard_cols):
            validity = torch.cat([Mesh._to(c.valid_mask(), dev) for c in shard_cols])
        stats = None
        if all(c.stats is not None for c in shard_cols):
            stats = (min(c.stats[0] for c in shard_cols),
                     max(c.stats[1] for c in shard_cols))
        nullable = any(c.dtype.nullable for c in shard_cols)
        cols.append(Column(data, validity, c0.dtype.with_nullable(nullable),
                           c0.dictionary, stats=stats, concat_sep=c0.concat_sep))
    sel = torch.cat([Mesh._to(b.sel_mask(), dev) for b in blocks])
    return Block(names=blocks[0].names, columns=tuple(cols), sel=sel)


# ---------------------------------------------------------------------------
# SPMD execution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExchangeConfig:
    """Capacities of exchange outputs (the bounded-output contract), keyed
    by the DFS node counter; missing entries use ``shuffle_factor`` times
    the local capacity.  ``factors`` holds per-exchange multipliers.
    ``mode`` is ``shuffle_block``'s wire mode."""

    shuffle_factor: float = 2.0
    capacities: Dict[int, int] = dataclasses.field(default_factory=dict)
    factors: Dict[int, float] = dataclasses.field(default_factory=dict)
    # the IN-set form is published only for builds at most this big
    rf_in_set_max_build: int = 1 << 20
    mode: str = "auto"


def _put(overflows: Dict[str, list], key: str, values: Sequence) -> None:
    overflows.setdefault(key, []).extend(values)


def _capacity(shards: Sequence[Block]) -> int:
    return shards[0].capacity


def _scaled(cap: int, factor: float) -> int:
    return int(math.ceil(cap * factor))


def _shard_filters(rf: Dict[str, list], mesh: Mesh) -> List[Dict[str, list]]:
    """Each local shard's view of the run's published filters, its own
    entry under each ``rf_id``.  A filter is global, so shards on one
    device share one view and ``Mesh.map`` still runs a replicated input
    once."""
    views: dict = {}
    return [views.setdefault(str(d), {k: [v[i]] for k, v in rf.items()})
            for i, d in enumerate(mesh.devices)]


def _map_local(node: P.PlanNode, nid: str, children: List[List[Block]], mesh: Mesh,
               diag: Diagnostics, overflows: Dict[str, list]) -> List[Block]:
    """The single-device local step (``plan/compiler.py:apply_local``) on
    every shard, one ``Diagnostics`` each; its overflow and error flags
    join ``overflows`` under the same keys, its row counts are dropped."""
    def local(rf, *blocks):
        d = Diagnostics({}, {}, rf=rf)
        return apply_local(node, nid, list(blocks), d), flag_dict(d)

    res = mesh.map(local, _shard_filters(diag.rf, mesh), *children)
    for _, flags in res:
        for k, v in flags.items():
            _put(overflows, k, [v])
    return [r[0] for r in res]


def _exec_spmd_node(node: P.PlanNode, tables: Dict[str, List[Block]], mesh: Mesh,
                    cfg: ExchangeConfig, diag: Diagnostics, overflows: Dict[str, list],
                    ctr: List[int]) -> List[Block]:
    """The mesh walk: scans, exchanges, collectives, the skew join, the
    laned window and CTEs; every other node runs ``_map_local``."""
    ctr[0] += 1
    nid = f"{type(node).__name__}_{ctr[0]}"

    def run(n):
        return _exec_spmd_node(n, tables, mesh, cfg, diag, overflows, ctr)

    if isinstance(node, P.TableScan):
        shards = tables[node.table]
        if node.columns is not None:
            cols = list(node.columns)
            shards = mesh.map(lambda b: b.select(cols), shards)
        return shards

    if isinstance(node, P.Join) and node.rf_id is not None:
        # build first so its filter reaches the probe subtree
        build = run(node.build)
        diag.rf[node.rf_id] = publish_runtime_filter(node.build_keys, build, mesh,
                                                     diag.rf_in_set_max)
        return _map_local(node, nid, [run(node.probe), build], mesh, diag, overflows)

    if isinstance(node, P.SkewShuffleJoin):
        from ..exchange.skew import skew_shuffle_join

        probe = run(node.probe)
        build = run(node.build)
        ctr[0] += 1
        xid = ctr[0]
        shuffle_cap = cfg.capacities.get(xid, _scaled(
            _capacity(probe), cfg.factors.get(xid, cfg.shuffle_factor)))
        ctr[0] += 1
        bxid = ctr[0]
        bshuffle_cap = cfg.capacities.get(bxid, _scaled(
            _capacity(build), cfg.factors.get(bxid, cfg.shuffle_factor)))
        out, ovs = skew_shuffle_join(
            probe, build, list(node.probe_keys), list(node.build_keys),
            node.kind, mesh, shuffle_cap, bshuffle_cap,
            node.output_capacity or _capacity(probe), hot_k=node.hot_k,
            sample_per_device=getattr(node, "sample_per_device", 2048), mode=cfg.mode)
        _put(overflows, f"Exchange_{xid}", ovs["skew_probe_shuffle"])
        _put(overflows, f"Exchange_{bxid}", ovs["skew_build_shuffle"])
        _put(overflows, nid, ovs["skew_cold_join"] + ovs["skew_hot_join"])
        return out

    if isinstance(node, P.LanedWindow):
        child = run(node.child)
        return _lockstep(mesh, [_laned_window(c, node) for c in child])

    if isinstance(node, P.WithCTE):
        tables = dict(tables)
        for name, d in node.defs.items():
            tables["__cte_" + name] = _exec_spmd_node(d, tables, mesh, cfg, diag,
                                                      overflows, ctr)
        return _exec_spmd_node(node.child, tables, mesh, cfg, diag, overflows, ctr)

    if isinstance(node, P.CTERef):
        return cte_block(tables, node.name)

    if isinstance(node, P.ExchangeReceiver):
        sender = node.source
        assert isinstance(sender, P.ExchangeSender), "receiver must wrap a sender"
        ctr[0] += 1
        xid = ctr[0]
        child = run(sender.child)
        if sender.exchange_type == "hash":
            factor = cfg.factors.get(xid, cfg.shuffle_factor)
            cap = cfg.capacities.get(xid, _scaled(_capacity(child), factor))
            out, ov = shuffle_block(child, list(sender.keys), mesh, cap, cfg.mode)
            _put(overflows, f"Exchange_{xid}", ov)
            return out
        if sender.exchange_type in ("broadcast", "passthrough"):
            if plan_distribution(sender.child) == "replicated":
                # every shard holds these rows already: gathering would
                # repeat them P times (the reference does, ROADMAP.md
                # "Known differences")
                return child
            return allgather_block(child, mesh)
        raise NotImplementedError(sender.exchange_type)

    return _map_local(node, nid, [run(c) for c in node.children], mesh, diag, overflows)


def plan_distribution(node: P.PlanNode) -> str:
    """Row distribution of a plan's output: 'sharded' (each shard holds
    distinct rows) or 'replicated' (every shard holds all rows, after a
    broadcast or passthrough exchange)."""
    if isinstance(node, (P.TableScan, P.CTERef)):
        return "sharded"
    if isinstance(node, P.WithCTE):
        return plan_distribution(node.child)
    if isinstance(node, P.ExchangeReceiver):
        sender = node.source
        assert isinstance(sender, P.ExchangeSender)
        if sender.exchange_type in ("broadcast", "passthrough"):
            return "replicated"
        return "sharded"
    if isinstance(node, P.Join):
        return plan_distribution(node.probe)
    return plan_distribution(node.children[0])


def _combine_flags(overflows: Dict[str, list], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The ``pmax`` of every flag across shards (and processes), each a
    0-d int64 on the first shard's device."""
    if not overflows:
        return {}
    d0 = mesh.devices[0]
    local = torch.stack([torch.stack([Mesh._to(torch.as_tensor(v).to(torch.int64).max(),
                                               d0) for v in vals]).max()
                         for vals in overflows.values()])
    glob = mesh._global_reduce(local, "max")
    return {k: glob[i] for i, k in enumerate(overflows)}


class Shards(list):
    """A distributed result: one Block per local shard, or (``replicated``)
    the one Block every shard holds."""

    replicated: bool = False


def compile_distributed(plan: P.PlanNode, mesh: Mesh,
                        cfg: Optional[ExchangeConfig] = None
                        ) -> Callable[[Dict[str, List[Block]]],
                                      Tuple[Shards, Dict[str, torch.Tensor]]]:
    """fn(sharded tables) -> (the result's ``Shards``, the flags combined
    across shards); input tables come from ``shard_catalog_blocks``.
    ``collect_result`` joins the shards."""
    cfg = cfg or ExchangeConfig()

    def run(tables: Dict[str, List[Block]]):
        overflows: Dict[str, list] = {}
        diag = Diagnostics({}, {}, rf_in_set_max=cfg.rf_in_set_max_build)
        out = Shards(_exec_spmd_node(plan, tables, mesh, cfg, diag, overflows, [0]))
        if plan_distribution(plan) == "replicated":
            out = Shards(out[:1])
            out.replicated = True
        return out, _combine_flags(overflows, mesh)

    return run


def collect_result(out: Sequence[Block]) -> Block:
    """One Block of a distributed result, shards in shard order, on the
    first shard's device."""
    return concat_shards(list(out))


# ---------------------------------------------------------------------------
# laned window (fine-grained shuffle analog)
# ---------------------------------------------------------------------------


def _lockstep(mesh: Mesh, gens: List[Iterator]) -> list:
    """Run one generator per local shard side by side: each yields
    ``(op, tensor)`` with op in psum/pmin/pmax, gets the collective's
    result for its shard, and finally returns its block."""
    sends = [None] * len(gens)
    results: list = [None] * len(gens)
    while True:
        reqs, done = [], 0
        for i, g in enumerate(gens):
            try:
                with mesh.on(i):
                    reqs.append(g.send(sends[i]))
            except StopIteration as e:
                results[i] = e.value
                done += 1
        if done == len(gens):
            return results
        assert done == 0 and len({r[0] for r in reqs}) == 1, "shards out of step"
        sends = getattr(mesh, reqs[0][0])([r[1] for r in reqs])


def _seg(vals: torch.Tensor, gid: torch.Tensor, num: int, how: str) -> torch.Tensor:
    """segment sum/min/max of ``vals`` by ``gid`` over ``num`` segments
    (an empty segment holds the identity: 0, the dtype max or min)."""
    if how == "sum":
        return torch.zeros(num, dtype=vals.dtype, device=vals.device).index_add_(
            0, gid, vals)
    if vals.dtype.is_floating_point:
        ident = float("inf") if how == "min" else float("-inf")
    else:
        ident = _I64_MAX if how == "min" else _I64_MIN
    base = torch.full((num,), ident, dtype=vals.dtype, device=vals.device)
    return base.scatter_reduce_(0, gid, vals, "amin" if how == "min" else "amax")


def _laned_window(child: Block, node) -> Iterator:
    """One shard's lane-split window (see ``plan/nodes.LanedWindow``):
    local windows per (partition, lane), then (P x lanes) carry tables,
    reduced across shards, offset ranks and add carry-ins to running
    aggregates.  Lane ids bucket the order-key value, so peers never
    straddle lanes.  A generator: each ``yield (op, t)`` is a collective
    (see ``_lockstep``)."""
    from ..core.dtypes import Decimal as DecimalT
    from ..core.dtypes import FLOAT64, INT64
    from ..expr.functions import _div_round_half_up
    from ..ops.segments import forward_fill_positions

    rep = dataclasses.replace
    L = int(node.n_lanes)
    Pcap = int(node.part_cap)
    G = Pcap * L
    work_funcs = []
    avg_specs = {}
    pr_specs = {}     # percent_rank -> local rank temp
    cd_specs = {}     # cume_dist   -> local cume_dist temp
    nt_specs = {}     # ntile       -> (local row_number temp, k)
    lead_specs = {}   # lead/lag    -> original desc (local runs w/o default)
    head_specs = {}   # first/nth   -> (kind, desc, cume temp or None)
    frame_specs = {}  # bounded-ROWS aggs -> (desc, local valid-count temp)
    favg_specs = {}   # framed avg  -> (sum temp, count temp, desc)
    for f in node.funcs:
        if f.func == "avg" and f.frame is None:
            s, c2 = f.name + "__ls", f.name + "__lc"
            work_funcs += [rep(f, func="sum", name=s), rep(f, func="count", name=c2)]
            avg_specs[f.name] = (s, c2, f)
        elif f.func == "avg":
            s, c2 = f.name + "__fs", f.name + "__fc"
            work_funcs += [rep(f, func="sum", name=s), rep(f, func="count", name=c2)]
            frame_specs[s] = (rep(f, func="sum", name=s), c2)
            favg_specs[f.name] = (s, c2, f)
        elif f.func == "percent_rank":
            t = f.name + "__lr"
            work_funcs.append(rep(f, func="rank", name=t, arg=None, frame=None))
            pr_specs[f.name] = t
        elif f.func == "cume_dist":
            t = f.name + "__lcd"
            work_funcs.append(rep(f, func="cume_dist", name=t, arg=None, frame=None))
            cd_specs[f.name] = t
        elif f.func == "ntile":
            t = f.name + "__lrn"
            work_funcs.append(rep(f, func="row_number", name=t, arg=None, frame=None))
            nt_specs[f.name] = (t, max(int(f.offset), 1))
        elif f.func in ("lead", "lag"):
            # the lane-local window must not apply the default at lane
            # edges (stitched from neighbour lanes); the true partition
            # edge applies it below
            work_funcs.append(rep(f, default=None))
            lead_specs[f.name] = f
        elif f.func == "first_value":
            head_specs[f.name] = ("first", f, None)
        elif f.func == "nth_value":
            t = f.name + "__lcd"
            work_funcs.append(rep(f, func="cume_dist", name=t, arg=None, frame=None,
                                  offset=1))
            head_specs[f.name] = ("nth", f, t)
        elif f.func in ("sum", "count", "min", "max") and f.frame is not None:
            c2 = f.name + "__fc"
            work_funcs.append(f)
            work_funcs.append(rep(f, func="count", name=c2))
            frame_specs[f.name] = (f, c2)
        else:
            work_funcs.append(f)
    local = window_block(child, list(node.partition_by) + [node.lane_col],
                         list(node.order_by), work_funcs)
    n = local.capacity
    dev = local.device
    live = local.sel_mask()
    i64 = torch.int64

    # exact partition slot (first key most significant, as the window's
    # sort: group ids come out sorted)
    pslot = torch.zeros(n, dtype=i64, device=dev)
    for name, spec in zip(node.partition_by, node.part_specs):
        c = local[name]
        if spec[0] == "dict":
            span = int(spec[1])
            s = c.data.to(i64)
        else:
            lo, span = int(spec[1]), int(spec[2])
            s = c.data.to(i64) - lo
        if c.validity is not None:
            s = torch.where(c.validity, s, torch.full_like(s, span))  # NULL last
            span += 1
        pslot = pslot * span + torch.clamp(s, 0, span - 1)
    lane = torch.clamp(local[node.lane_col].data.to(i64), 0, L - 1)
    gid = torch.where(live, pslot * L + lane, torch.full_like(lane, G))

    def seg_sum(vals):
        return _seg(vals, gid, G + 1, "sum")[:G]

    def seg_max(vals):
        # empty segments are the dtype min: clamp to 0 (every real
        # per-lane maximum here is >= 1)
        return torch.clamp(_seg(vals, gid, G + 1, "max")[:G], min=0)

    def carry_of(t):
        """Exclusive prefix along lanes of a reduced (G,) table."""
        t2 = t.reshape(Pcap, L)
        exc = torch.cat([torch.zeros((Pcap, 1), dtype=t.dtype, device=dev),
                         torch.cumsum(t2, 1)[:, :-1]], 1)
        return exc.reshape(G)

    def per_row(vec):
        return vec[torch.clamp(gid, max=G - 1)]

    counts = seg_sum(live.to(i64))
    cnt_carry = per_row(carry_of((yield ("psum", counts))))

    def where_live(x):
        return torch.where(live, x, torch.zeros_like(x))

    handled_later = set(frame_specs) | {c for _, c in frame_specs.values()}
    for _k, (_t, _n) in nt_specs.items():
        handled_later.add(_t)
    handled_later |= set(pr_specs.values()) | set(cd_specs.values())
    handled_later |= {t for _, _, t in head_specs.values() if t is not None}
    out = local
    for f in work_funcs:
        if f.name in handled_later or f.name in lead_specs:
            continue
        c = local[f.name]
        if f.func in ("row_number", "rank"):
            adj = c.data + where_live(cnt_carry)
            out = out.with_column(f.name, Column(adj, c.validity, c.dtype))
        elif f.func == "dense_rank":
            dmax = seg_max(where_live(c.data))
            adj = c.data + where_live(per_row(carry_of((yield ("psum", dmax)))))
            out = out.with_column(f.name, Column(adj, c.validity, c.dtype))
        elif f.func in ("sum", "count"):
            a = local[f.arg]
            valid = a.valid_mask() & live
            vcnt = yield ("psum", seg_sum(valid.to(i64)))
            vcnt_carry = per_row(carry_of(vcnt))
            if f.func == "count":
                adj = c.data + where_live(vcnt_carry)
                out = out.with_column(f.name, Column(adj, c.validity, c.dtype))
            else:
                tot = seg_sum(torch.where(valid, a.data.to(i64),
                                          torch.zeros((), dtype=i64, device=dev)))
                tot = yield ("psum", tot)
                adj = c.data + where_live(per_row(carry_of(tot)))
                validity = None
                if c.validity is not None:
                    validity = c.validity | (vcnt_carry > 0)
                out = out.with_column(f.name, Column(adj, validity, c.dtype))
        elif f.func in ("min", "max"):
            a = local[f.arg]
            valid = a.valid_mask() & live
            vcnt = yield ("psum", seg_sum(valid.to(i64)))
            vcnt_carry = per_row(carry_of(vcnt))
            is_min = f.func == "min"
            ident = _I64_MAX if is_min else _I64_MIN
            masked = torch.where(valid, a.data.to(i64),
                                 torch.full((), ident, dtype=i64, device=dev))
            seg = _seg(masked, gid, G + 1, "min" if is_min else "max")[:G]
            t = yield ("pmin" if is_min else "pmax", seg)
            t2 = t.reshape(Pcap, L)
            cum = (torch.cummin(t2, 1) if is_min else torch.cummax(t2, 1)).values
            exc = torch.cat([torch.full((Pcap, 1), ident, dtype=i64, device=dev),
                             cum[:, :-1]], 1).reshape(G)
            carry = per_row(exc)
            has_carry = vcnt_carry > 0
            local_valid = c.validity if c.validity is not None else live
            base = torch.where(local_valid, c.data.to(i64),
                               torch.full((), ident, dtype=i64, device=dev))
            cval = torch.where(has_carry, carry,
                               torch.full((), ident, dtype=i64, device=dev))
            merged = torch.minimum(base, cval) if is_min else torch.maximum(base, cval)
            new_valid = (local_valid | has_carry) & live
            out = out.with_column(f.name, Column(merged.to(c.data.dtype), new_valid,
                                                 c.dtype, c.dictionary))
        elif f.func == "last_value":
            # peers never straddle value-bucketed lanes: the lane-local
            # last peer is the partition-global one
            pass
        else:  # the planner never lets one through
            raise NotImplementedError(f"laned window func {f.func}")

    # ---- the extended family: global positions and boundary tables ----
    if pr_specs or cd_specs or nt_specs or lead_specs or head_specs or frame_specs:
        H = max(1, int(getattr(node, "boundary_depth", 1)))
        newseg = gid != torch.roll(gid, 1)
        newseg[:1] = True
        seg_start_idx = forward_fill_positions(newseg).to(i64)
        pos = torch.arange(n, dtype=i64, device=dev) - seg_start_idx
        cntG = yield ("psum", counts)
        cnt2 = cntG.reshape(Pcap, L)
        carry2 = torch.cumsum(cnt2, 1) - cnt2  # exclusive lane start
        tot_tab = cnt2.sum(1)
        pslot_c = torch.clamp(pslot, max=Pcap - 1)
        tot_row = tot_tab[pslot_c]
        g_row = cnt_carry + pos
        cnt_local_row = counts[torch.clamp(gid, max=G - 1)]
        GH = G * H
        tables: dict = {}
        # every argument's tables up front: their psums must run in the
        # same order on every shard
        arg_names = []
        for name, f in lead_specs.items():
            arg_names.append(f.arg)
        for _n, (_k, f, _t) in head_specs.items():
            arg_names.append(f.arg)
        for _n, (f, _c) in frame_specs.items():
            if f.arg is not None:
                arg_names.append(f.arg)
        for name in dict.fromkeys(arg_names):
            a = local[name]
            isf = a.dtype.is_float
            vdt = torch.float64 if isf else i64
            vals = a.data.to(vdt)
            av = a.valid_mask() & live
            zero = torch.zeros((), dtype=vdt, device=dev)
            mvals = torch.where(av, vals, zero)
            hs = torch.where(live & (pos < H), gid * H + pos, torch.full_like(pos, GH))
            tpos = H - cnt_local_row + pos
            ts = torch.where(live & (tpos >= 0), gid * H + tpos, torch.full_like(pos, GH))
            head_v = yield ("psum", _seg(mvals, hs, GH + 1, "sum")[:GH])
            head_ok = yield ("psum", _seg(av.to(i64), hs, GH + 1, "sum")[:GH])
            tail_v = yield ("psum", _seg(mvals, ts, GH + 1, "sum")[:GH])
            tail_ok = yield ("psum", _seg(av.to(i64), ts, GH + 1, "sum")[:GH])
            lane_sum = yield ("psum", seg_sum(mvals))
            lane_vcnt = yield ("psum", seg_sum(av.to(i64)))
            big = float("inf") if isf else _I64_MAX
            small = float("-inf") if isf else _I64_MIN
            bigc = torch.full((), big, dtype=vdt, device=dev)
            smallc = torch.full((), small, dtype=vdt, device=dev)
            mn = torch.where(av, vals, bigc)
            mx = torch.where(av, vals, smallc)
            lane_min = yield ("pmin", _seg(mn, gid, G + 1, "min")[:G])
            lane_max = yield ("pmax", _seg(mx, gid, G + 1, "max")[:G])
            t = {"head_v": head_v, "head_ok": head_ok, "tail_v": tail_v,
                 "tail_ok": tail_ok, "lane_sum": lane_sum, "lane_vcnt": lane_vcnt,
                 "lane_min": lane_min, "lane_max": lane_max, "isf": isf,
                 "big": bigc, "small": smallc}
            # prefix/suffix region tables: head_pre*[k] aggregates the
            # first k rows of the lane, tail_suf*[k] the last k (k <= H)
            hv2, ho2 = head_v.reshape(G, H), head_ok.reshape(G, H)
            tv2, to2 = tail_v.reshape(G, H), tail_ok.reshape(G, H)
            zcol = torch.zeros((G, 1), dtype=vdt, device=dev)
            zicol = torch.zeros((G, 1), dtype=i64, device=dev)
            t["head_presum"] = torch.cat([zcol, torch.cumsum(hv2, 1)], 1).reshape(-1)
            t["head_precnt"] = torch.cat([zicol, torch.cumsum(ho2, 1)], 1).reshape(-1)
            t["tail_sufsum"] = torch.cat(
                [zcol, torch.cumsum(tv2.flip(1), 1)], 1).reshape(-1)
            t["tail_sufcnt"] = torch.cat(
                [zicol, torch.cumsum(to2.flip(1), 1)], 1).reshape(-1)
            hmn = torch.where(ho2 > 0, hv2, bigc)
            hmx = torch.where(ho2 > 0, hv2, smallc)
            tmn = torch.where(to2 > 0, tv2, bigc)
            tmx = torch.where(to2 > 0, tv2, smallc)
            fb = torch.full((G, 1), big, dtype=vdt, device=dev)
            fs = torch.full((G, 1), small, dtype=vdt, device=dev)
            t["head_premin"] = torch.cat([fb, torch.cummin(hmn, 1).values], 1).reshape(-1)
            t["head_premax"] = torch.cat([fs, torch.cummax(hmx, 1).values], 1).reshape(-1)
            t["tail_sufmin"] = torch.cat(
                [fb, torch.cummin(tmn.flip(1), 1).values], 1).reshape(-1)
            t["tail_sufmax"] = torch.cat(
                [fs, torch.cummax(tmx.flip(1), 1).values], 1).reshape(-1)
            tables[name] = t

        lane_row = lane
        cnt2f = cnt2.reshape(-1)
        carry2f = carry2.reshape(-1)

        def row_at(name, q, from_tail):
            """(value, valid, exists) at partition-global index q; exact
            when q lies within H rows of its lane's head (or tail)."""
            t = tables[name]
            src_v = t["tail_v"] if from_tail else t["head_v"]
            src_o = t["tail_ok"] if from_tail else t["head_ok"]
            val = torch.zeros(n, dtype=src_v.dtype, device=dev)
            okv = torch.zeros(n, dtype=torch.bool, device=dev)
            ex = torch.zeros(n, dtype=torch.bool, device=dev)
            for m in range(L):
                gi = pslot_c * L + m
                base = carry2f[gi]
                cm = cnt2f[gi]
                within = (q >= base) & (q < base + cm)
                if from_tail:
                    off = torch.clamp(H - cm + (q - base), 0, H - 1)
                else:
                    off = torch.clamp(q - base, 0, H - 1)
                idx = torch.clamp(gi * H + off, max=GH - 1)
                val = torch.where(within, src_v[idx], val)
                okv = torch.where(within, src_o[idx] > 0, okv)
                ex = ex | within
            return val, okv, ex

        def region(name, f_lo, f_hi, before, want):
            """Aggregate over the out-of-lane part of the frame [f_lo,
            f_hi] (global indices): the suffix (prefix) of a partial lane
            plus any fully covered lanes up to the current one."""
            t = tables[name]
            if want == "sum":
                ident = torch.zeros((), dtype=t["lane_sum"].dtype, device=dev)
                full_tab, pre, suf = t["lane_sum"], t["head_presum"], t["tail_sufsum"]
            elif want == "vcnt":
                ident = torch.zeros((), dtype=i64, device=dev)
                full_tab, pre, suf = t["lane_vcnt"], t["head_precnt"], t["tail_sufcnt"]
            elif want == "min":
                ident = t["big"]
                full_tab, pre, suf = t["lane_min"], t["head_premin"], t["tail_sufmin"]
            else:
                ident = t["small"]
                full_tab, pre, suf = t["lane_max"], t["head_premax"], t["tail_sufmax"]

            def comb(a, b):
                if want in ("sum", "vcnt"):
                    return a + b
                return torch.minimum(a, b) if want == "min" else torch.maximum(a, b)

            acc = ident.expand(n).clone()
            for m in range(L):
                gi = pslot_c * L + m
                base = carry2f[gi]
                cm = cnt2f[gi]
                lane_end = base + cm - 1
                side = (lane_row > m) if before else (lane_row < m)
                ov_lo = torch.maximum(f_lo, base)
                ov_hi = torch.minimum(f_hi, lane_end)
                any_ = side & (cm > 0) & (ov_lo <= ov_hi)
                fullc = (ov_lo <= base) & (ov_hi >= lane_end)
                if before:
                    k = torch.clamp(lane_end - ov_lo + 1, 0, H)
                    part = suf[torch.clamp(gi * (H + 1) + k, max=G * (H + 1) - 1)]
                else:
                    k = torch.clamp(ov_hi - base + 1, 0, H)
                    part = pre[torch.clamp(gi * (H + 1) + k, max=G * (H + 1) - 1)]
                cval = torch.where(fullc, full_tab[gi], part)
                acc = comb(acc, torch.where(any_, cval, ident))
            return acc

        def f64(x):
            return x.to(torch.float64)

        for name, tmp in pr_specs.items():
            r_adj = local[tmp].data.to(i64) + where_live(cnt_carry)
            denom = f64(torch.clamp(tot_row - 1, min=1))
            out = out.with_column(name, Column(f64(r_adj - 1) / denom, None, FLOAT64))
        for name, tmp in cd_specs.items():
            cdl = f64(local[tmp].data)
            le_local = torch.round(cdl * f64(cnt_local_row))
            le = le_local + f64(where_live(cnt_carry))
            out = out.with_column(name, Column(
                le / f64(torch.clamp(tot_row, min=1)), None, FLOAT64))
        for name, (tmp, k) in nt_specs.items():
            rn0 = local[tmp].data.to(i64) + where_live(cnt_carry) - 1
            q_ = torch.div(tot_row, k, rounding_mode="floor")
            r_ = tot_row - q_ * k
            bigrows = (q_ + 1) * r_
            bucket = torch.where(
                rn0 < bigrows,
                torch.div(rn0, torch.clamp(q_ + 1, min=1), rounding_mode="floor"),
                torch.where(q_ > 0,
                            r_ + torch.div(rn0 - bigrows, torch.clamp(q_, min=1),
                                           rounding_mode="floor"),
                            rn0))
            out = out.with_column(name, Column(bucket + 1, None, INT64))

        # lead / lag boundary stitching
        for name, f in lead_specs.items():
            c = local[name]
            a = local[f.arg]
            off = int(f.offset)
            if f.func == "lead":
                in_lane = pos + off < cnt_local_row
                q = g_row + off
                beyond = q >= tot_row
                v, ok, ex = row_at(f.arg, q, from_tail=False)
            else:
                in_lane = pos >= off
                q = g_row - off
                beyond = q < 0
                v, ok, ex = row_at(f.arg, q, from_tail=True)
            base_d = c.data
            lv = c.validity if c.validity is not None else torch.ones(
                n, dtype=torch.bool, device=dev)
            stitched = torch.where(in_lane, base_d, v.to(base_d.dtype))
            svalid = torch.where(in_lane, lv, ok & ex & ~beyond)
            if f.default is not None and not a.dtype.is_string:
                dflt = torch.tensor(f.default, dtype=base_d.dtype, device=dev)
                use_d = (~in_lane) & beyond
                stitched = torch.where(use_d, dflt, stitched)
                svalid = svalid | use_d
            out = out.with_column(name, Column(stitched, svalid & live,
                                               a.dtype.with_nullable(True),
                                               a.dictionary))

        # first_value / nth_value from the partition's head rows
        for name, (kind, f, cume_tmp) in head_specs.items():
            a = local[f.arg]
            q = torch.full((n,), 0 if kind == "first" else max(int(f.offset), 1) - 1,
                           dtype=i64, device=dev)
            v, ok, ex = row_at(f.arg, q, from_tail=False)
            valid = ok & ex & live
            if kind == "nth":
                cdl = f64(local[cume_tmp].data)
                le = torch.round(cdl * f64(cnt_local_row)) + f64(where_live(cnt_carry))
                # the default frame ends at the current row's peers: the
                # n-th row must already be inside it
                valid = valid & (le - 1 >= f64(q))
            dt_out = a.dtype.with_nullable(kind == "nth" or a.dtype.nullable)
            out = out.with_column(name, Column(v.to(a.data.dtype), valid, dt_out,
                                               a.dictionary))

        # bounded ROWS frames: the in-lane slice plus out-of-lane regions
        for name, (f, cnt_tmp) in frame_specs.items():
            prec, foll = f.frame
            f_lo = torch.clamp(g_row - int(prec), min=0)
            f_hi = torch.minimum(g_row + int(foll), tot_row - 1)
            c = local[name]
            if f.arg is None:
                # COUNT(*) over a contiguous global row range
                out = out.with_column(name, Column(f_hi - f_lo + 1, None, c.dtype))
                continue
            vb = region(f.arg, f_lo, f_hi, True, "vcnt")
            va = region(f.arg, f_lo, f_hi, False, "vcnt")
            local_cnt = local[cnt_tmp].data.to(i64)
            gcnt = local_cnt + vb + va
            if f.func == "count":
                out = out.with_column(name, Column(gcnt, None, c.dtype))
                continue
            if f.func in ("min", "max"):
                t = tables[f.arg]
                ident = t["big"] if f.func == "min" else t["small"]
                rb = region(f.arg, f_lo, f_hi, True, f.func)
                ra = region(f.arg, f_lo, f_hi, False, f.func)
                lv = c.validity if c.validity is not None else (local_cnt > 0)
                base = torch.where(lv, c.data.to(ident.dtype), ident)
                red = torch.minimum if f.func == "min" else torch.maximum
                merged = red(red(base, rb), ra)
                out = out.with_column(name, Column(
                    merged.to(c.data.dtype), (gcnt > 0) & live,
                    c.dtype.with_nullable(True), c.dictionary))
                continue
            # framed SUM (also the framed avg's numerator)
            sb = region(f.arg, f_lo, f_hi, True, "sum")
            sa = region(f.arg, f_lo, f_hi, False, "sum")
            isf = tables[f.arg]["isf"]
            base = c.data.to(torch.float64 if isf else i64)
            if c.validity is not None:
                base = torch.where(c.validity, base, torch.zeros_like(base))
            tot_s = base + sb + sa
            out = out.with_column(name, Column(tot_s.to(c.data.dtype), (gcnt > 0) & live,
                                               c.dtype.with_nullable(True)))

        # framed AVG from the stitched sum/count temps
        for name, (s, c2, f) in favg_specs.items():
            sc = out[s]
            prec, foll = f.frame
            f_lo = torch.clamp(g_row - int(prec), min=0)
            f_hi = torch.minimum(g_row + int(foll), tot_row - 1)
            vb = region(f.arg, f_lo, f_hi, True, "vcnt")
            va = region(f.arg, f_lo, f_hi, False, "vcnt")
            gcnt = local[c2].data.to(i64) + vb + va
            arg_dt = local[f.arg].dtype
            if arg_dt.is_decimal:
                rdt = DecimalT(18, arg_dt.scale + 4, nullable=True)
                d = _div_round_half_up(sc.data.to(i64) * (10 ** 4),
                                       torch.clamp(gcnt, min=1))
            else:
                rdt = FLOAT64.with_nullable(True)
                d = f64(sc.data) / f64(torch.clamp(gcnt, min=1))
            out = out.with_column(name, Column(d.to(rdt.torch_dtype), (gcnt > 0) & live,
                                               rdt))

    # running AVG = (sum + carry) / (count + carry), typed as the
    # single-device running avg
    for name, (s, c2, f) in avg_specs.items():
        sc = out[s]
        cc = out[c2]
        arg_dt = local[f.arg].dtype
        cnt = cc.data.to(i64)
        ssum = sc.data.to(i64)
        if arg_dt.is_decimal:
            rdt = DecimalT(18, arg_dt.scale + 4, nullable=True)
            d = _div_round_half_up(ssum * (10 ** 4), torch.clamp(cnt, min=1))
        else:
            rdt = FLOAT64.with_nullable(True)
            d = ssum.to(torch.float64) / torch.clamp(cnt, min=1).to(torch.float64)
        out = out.with_column(name, Column(d.to(rdt.torch_dtype), cnt > 0, rdt))
    drop = {node.lane_col}
    for s, c2, _f in avg_specs.values():
        drop |= {s, c2}
    for s, c2, _f in favg_specs.values():
        drop |= {s, c2}
    drop |= set(pr_specs.values()) | set(cd_specs.values())
    drop |= {t for t, _k in nt_specs.values()}
    drop |= {t for _k, _f2, t in head_specs.values() if t is not None}
    drop |= {c for _f2, c in frame_specs.values()}
    keep = [nm for nm in out.names if nm not in drop]
    cols = dict(zip(out.names, out.columns))
    return Block(names=tuple(keep), columns=tuple(cols[nm] for nm in keep), sel=out.sel)


__all__ = [
    "compile_distributed", "shard_block",
    "shard_catalog_blocks", "collect_result", "concat_shards", "plan_distribution",
    "ExchangeConfig", "Shards", "AXIS",
]
