"""QueryRunner: the query executor, on one device or over a mesh.

Counterpart of ``tiflash_tpu/runtime/executor.py`` (``QueryRunner``,
``run_query``).  ``QueryRunner(plan, settings=...)`` does what the
reference's does, in its order:

- the plan rewrites (``prune_columns(eager_aggregation(plan))``,
  ``plan/rewrite.py``) when ``Settings.enable_plan_rewrites``;
- session defaults for per-aggregate knobs (``_apply_agg_defaults``);
- per run: the query clock and time zone, ``cancel_scope`` with the
  ``max_execution_time_ms`` deadline, auto-sizing once
  (``plan/auto.py:autosize_plan``), failpoint
  ``exception_before_fragment_run``, the pre-flight limits, the memory
  check (``runtime/memory.py``) and the per-operator external-memory
  thresholds;
- over the memory limit, the out-of-core paths of
  ``runtime/outofcore.py`` in the reference's order (chunked, groupagg,
  grace, sliced), with a sizing budget no smaller than the inputs / 64;
- resource-group admission (``runtime/resource.py``);
- the capacity-retry loop: when an operator reports that its bounded
  output overflowed, its capacity in the plan that ran grows to 1.25x
  what it reported and the plan runs again, up to
  ``max_capacity_retries`` times (an Aggregation's slots, a Join's or a
  CrossJoin's output capacity; a Join whose unique-build promise was
  false moves to the general path), with sync point ``executor.attempt``,
  failpoint ``exception_during_retry`` and the reference's metrics;
- the operator row limits and ``max_result_rows`` (``throw`` or
  ``break``), then failpoint ``exception_after_fragment_run``;
- ``profile_dir``: the run traced by ``torch.profiler``, a Chrome trace
  written there; ``QueryMemoryScope``: the CUDA allocator's peak during
  the run;
- with tracing on (``runtime/tracing.py``), the spans ``runner.prepare``
  (the rewrites and the aggregate defaults), ``runner.autosize``,
  ``runner.checks`` (the pre-flight limits and the memory check), one
  ``runner.attempt`` per attempt (the plan's run and ``read_flags``,
  after which the op spans' device marks resolve) and ``runner.finish``
  (the row counts and the result's limits).

Every overflow flag and runtime-error flag of a run is read in one host
read (``read_flags``).  An error flag never causes a retry: a run with an
overflow is retried (its rows are garbage), and only a capacity-clean run
raises its runtime errors (``EngineError``, code ``RUNTIME_EVAL``).

The runner runs on the device its tables are on and never moves a query
elsewhere; over the memory limit it splits the input instead.

With ``mesh=`` (``mpp/mesh.py``) the plan runs over the mesh's shards
through ``mpp/runner.py``: tables given as Blocks are sharded
(``shard_catalog_blocks``), or come sharded (a list of Blocks per
table); a logical plan (no exchange) is distributed at the first run
(``plan/auto.py:distribute_for_tables``: row counts, and sampled
estimates from the tables given whole, which the reference's
``run_query`` leaves out and its ``run_grace_join`` passes), and the
tables it scans are sharded; an
overflowing exchange grows its capacity in ``ExchangeConfig.capacities``
(``cfg=``, whose ``mode`` is the hash exchanges' wire mode); the result
is the shards concatenated in shard order (``collect_result``), and
``summary.num_devices`` is the shard count.  Auto-sizing, the memory
check and the limits read a planning view of the tables (statistics
dropped, as the reference's sharded arrays have none; a scanned table
padded to the shards' rows, copied only when padding is needed), which
is let go before the plan runs.  The per-operator
external-memory thresholds are ignored under a mesh, with the
reference's log line; over the memory limit a graceable join runs each
grace partition distributed (``run_grace_join(mesh=...)``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import torch

from ..core.block import Block
from ..ops.cuda import build
from ..plan import nodes as P
from ..plan.compiler import Diagnostics, execute_plan, flag_dict
from . import tracing
from .errors import LIMIT_EXCEEDED, EngineError, raise_runtime_errors, split_runtime_errors
from .failpoint import fail_point
from .metrics import METRICS
from .settings import Settings
from .summary import ExecutionSummary


def enumerate_exchanges(plan: P.PlanNode) -> Tuple[Dict[int, P.PlanNode],
                                                    Dict[int, P.PlanNode]]:
    """(node ids, exchange ids): the DFS pre-order ids the compiler and
    the distributed runner give nodes.  Overflow keys are
    f"{type(node).__name__}_{id}" and f"Exchange_{xid}"; a receiver takes
    an exchange id after its own, a join with a runtime filter walks its
    build side first, a skew join takes two exchange ids after its
    children."""
    nodes: Dict[int, P.PlanNode] = {}
    exchanges: Dict[int, P.PlanNode] = {}
    ctr = [0]

    def walk(node: P.PlanNode):
        ctr[0] += 1
        nodes[ctr[0]] = node
        if isinstance(node, P.ExchangeReceiver):
            ctr[0] += 1
            exchanges[ctr[0]] = node
            walk(node.source.child)  # the sender itself carries no id
            return
        if isinstance(node, P.Join) and node.rf_id is not None:
            walk(node.build)
            walk(node.probe)
            return
        if isinstance(node, P.SkewShuffleJoin):
            walk(node.probe)
            walk(node.build)
            for _ in range(2):  # its probe-side and build-side shuffles
                ctr[0] += 1
                exchanges[ctr[0]] = node
            return
        for c in node.children:
            walk(c)

    walk(plan)
    return nodes, exchanges


def enumerate_plan(plan: P.PlanNode) -> Dict[int, P.PlanNode]:
    """The DFS pre-order ids of the plan's nodes (``enumerate_exchanges``)."""
    return enumerate_exchanges(plan)[0]


def _grow(plan: P.PlanNode, flagged: Dict[str, int], cfg=None) -> None:
    """Overflow values carry the required capacity: grow to 1.25x it (an
    exchange's in ``cfg.capacities``)."""
    nodes = enumerate_plan(plan)
    for key, needed in flagged.items():
        target = max(int(needed * 1.25) + 1, 16)
        kind, _, sid = key.rpartition("_")
        if kind == "Exchange":
            cfg.capacities[int(sid)] = max(target, cfg.capacities.get(int(sid), 0) * 2)
            METRICS.counter("shuffle_overflows_total").inc()
            continue
        node = nodes.get(int(sid))
        if isinstance(node, P.Aggregation):
            node.num_slots = max(target, (node.num_slots or 0) * 2)
        elif isinstance(node, (P.Join, P.CrossJoin, P.SkewShuffleJoin)):
            node.output_capacity = max(target, (node.output_capacity or 0) * 2)
            # an overflow of the unique path means the build keys were
            # not unique: retry on the general (duplicate-correct) path
            if getattr(node, "unique_build", False):
                node.unique_build = False


def read_flags(flags: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Each flag's largest value as a host int, all in one host read."""
    if not flags:
        return {}
    maxes = [torch.as_tensor(v).max().to(torch.int64) for v in flags.values()]
    dev = maxes[0].device
    host = torch.stack([m.to(dev) for m in maxes]).tolist()
    return dict(zip(flags, host))


def _built_seconds(before: Dict[str, float]) -> float:
    """Seconds spent building kernels since ``before`` (a copy of
    ``ops/cuda/build.BUILD_SECONDS``)."""
    return sum(v for k, v in build.BUILD_SECONDS.items() if k not in before)


class QueryRunner:
    """Run a plan with the reference's settings, limits, out-of-core
    fallbacks and capacity retries.  One instance per plan; ``run`` may
    be called again on same-shaped tables.  With ``mesh`` the plan runs
    over its shards; ``logical_plan`` is the exchange-free plan of a
    distributed one (the out-of-core fallback matches its shape), and a
    logical ``plan`` is distributed at the first run.  ``cfg`` is the
    exchanges' ``ExchangeConfig`` (default: from the settings)."""

    def __init__(self, plan: P.PlanNode, mesh=None,
                 settings: Optional[Settings] = None, cancel=None,
                 logical_plan: Optional[P.PlanNode] = None,
                 *, fuse_stream_agg: bool = True, cfg=None):
        from ..mpp.runner import ExchangeConfig

        self.cancel = cancel
        self.settings = settings or Settings()
        self.fuse_stream_agg = fuse_stream_agg
        self.mesh = mesh
        self.logical_plan = logical_plan
        with tracing.span("runner.prepare"):
            # a logical plan handed a mesh: distributed at the first run,
            # from the tables' row counts
            self._to_distribute = mesh is not None and not _has_exchange(plan)
            if self._to_distribute:
                self.logical_plan = plan
            elif self.settings.enable_plan_rewrites and not _has_exchange(plan):
                from ..plan.rewrite import eager_aggregation, prune_columns

                plan = prune_columns(eager_aggregation(plan))
            self._apply_agg_defaults(plan)
        self.plan = plan
        self._autosized = False
        self.cfg = cfg if cfg is not None else ExchangeConfig(
            shuffle_factor=self.settings.default_shuffle_factor,
            rf_in_set_max_build=self.settings.rf_in_set_max_build)

    def _apply_agg_defaults(self, plan: P.PlanNode) -> None:
        """Session-setting defaults for per-aggregate knobs the plan left
        unset (group_concat's item cap, the sketch's k)."""
        for node in enumerate_plan(plan).values():
            if not isinstance(node, P.Aggregation):
                continue
            aggs = list(node.aggs)
            changed = False
            for i, a in enumerate(aggs):
                if a.param is None and a.func == "group_concat":
                    aggs[i] = dataclasses.replace(
                        a, param=float(self.settings.group_concat_max_items))
                    changed = True
                elif a.param is None and a.func in (
                        "approx_count_distinct", "approx_cd_partial",
                        "approx_cd_final"):
                    aggs[i] = dataclasses.replace(
                        a, param=float(self.settings.approx_distinct_sketch_k))
                    changed = True
            if changed:
                node.aggs = aggs

    # -- execution ------------------------------------------------------

    def run(self, tables: Dict[str, Block]) -> Tuple[Block, ExecutionSummary]:
        from ..expr.compile import (parse_tz_offset_us, query_clock, query_now_us,
                                    query_timezone)
        from .cancel import cancel_scope

        self._sharded = self._view = None
        if self.mesh is not None:
            # the run keeps the shards; the planning view lives in
            # ``self._view`` only until the plan runs
            self._view = self._shard(tables)
            tables = None

        # one NOW()/CURDATE()/RAND() for the whole query, retries and
        # out-of-core pieces included
        now_us = self.settings.query_timestamp_us or query_now_us()
        deadline = None
        if self.settings.max_execution_time_ms > 0:
            deadline = time.monotonic() + self.settings.max_execution_time_ms / 1e3
        with cancel_scope(self.cancel, deadline), query_clock(now_us), \
                query_timezone(parse_tz_offset_us(self.settings.time_zone)):
            return self._run_cancellable(tables)

    def _shard(self, tables) -> Dict[str, Block]:
        """Distribute a logical plan; shard over the mesh the Block tables
        the plan scans (a table given as a list of Blocks is sharded
        already) into ``self._sharded``.  Returns the planning view: per
        table, its rows as one Block with no statistics.  A scanned table
        holds the shards' rows in shard order (padded to a multiple of P,
        as the reference's sharded arrays are): the given Block itself
        when it needs no padding, else one copy; a table the plan does
        not scan is only counted, so its Block serves.  A table given
        sharded is its shards concatenated."""
        from ..mpp.runner import concat_shards, shard_block

        if self._to_distribute:
            from ..plan.auto import distribute_for_tables

            self._to_distribute = False
            self.plan = distribute_for_tables(self.logical_plan, tables, self.mesh.size)
            self._apply_agg_defaults(self.plan)
        scanned = {n.table for n in enumerate_plan(self.plan).values()
                   if isinstance(n, P.TableScan)}
        self._sharded, view = {}, {}
        for name, b in tables.items():
            if isinstance(b, (list, tuple)):
                self._sharded[name] = b
                view[name] = concat_shards(b)
                continue
            if name in scanned:
                self._sharded[name] = shard_block(b, self.mesh)
            if name in scanned and b.capacity % self.mesh.size:
                view[name] = concat_shards(self._sharded[name])
            else:
                view[name] = _without_stats(b)
        return view

    def _check_memory(self, tables) -> None:
        """Raise MemoryLimitError when the plan's estimate exceeds
        ``max_bytes_per_device`` or an operator's working set exceeds its
        ``max_bytes_before_external_*`` threshold."""
        from .memory import MemoryLimitError, check_memory, estimate_operator_bytes
        from .outofcore import chunkable, grace_spec, groupagg_spec, sliced_spec

        check_memory(self.plan, tables, self.settings.max_bytes_per_device)
        # per-operator external-memory thresholds (Settings.h:138/140/321):
        # each compares against its operator's own working set
        s = self.settings
        gb, jb, sb = (s.max_bytes_before_external_group_by,
                      s.max_bytes_before_external_join,
                      s.max_bytes_before_external_sort)
        if not (s.enable_spill and (gb or jb or sb)):
            return
        if self.mesh is not None:
            # out-of-core composition under a mesh is the grace join over
            # the memory limit only; say so once
            if not getattr(self, "_warned_mesh_thresholds", False):
                self._warned_mesh_thresholds = True
                from .logging import get_logger

                get_logger("tiflash_tpu_torch.executor").info(
                    "max_bytes_before_external_* thresholds apply to "
                    "single-chip runs only; ignored under a mesh")
            return
        est_gb = estimate_operator_bytes(self.plan, tables, (P.Aggregation,)) if gb else 0
        est_jb = estimate_operator_bytes(
            self.plan, tables, (P.Join, P.CrossJoin)) if jb else 0
        est_sb = estimate_operator_bytes(self.plan, tables, (P.Sort, P.TopN)) if sb else 0
        if (gb and est_gb > gb and (chunkable(self.plan) or groupagg_spec(self.plan))) or \
                (jb and est_jb > jb and grace_spec(self.plan) is not None) or \
                (sb and est_sb > sb and sliced_spec(self.plan) is not None):
            raise MemoryLimitError(
                f"operator working set (agg~{est_gb} join~{est_jb} "
                f"sort~{est_sb} B) exceeds its external-memory threshold")

    def _run_cancellable(self, tables) -> Tuple[Block, ExecutionSummary]:
        from .cancel import checkpoint
        from .memory import MemoryLimitError, QueryMemoryScope

        if self.mesh is not None:
            tables, self._view = self._view, None
        checkpoint()
        if not self._autosized:
            # fill unset capacities from catalog stats and samples; the
            # retry loop stays the safety net
            self._autosized = True
            from ..plan.auto import autosize_plan

            with tracing.span("runner.autosize"):
                try:
                    autosize_plan(self.plan, tables, settings=self.settings)
                except Exception:  # estimation must never sink a query
                    pass
        over_limit = None
        with tracing.span("runner.checks"):
            fail_point("exception_before_fragment_run")
            self._check_preflight_limits(tables)
            try:
                self._check_memory(tables)
            except MemoryLimitError as e:
                over_limit = e
        if over_limit is not None:
            return self._run_out_of_core(tables, over_limit)
        if self.settings.resource_group:
            from .resource import RESOURCE_GROUPS, to_ru

            est_rows = sum(b.capacity for b in tables.values())
            if not RESOURCE_GROUPS.admit(self.settings.resource_group,
                                         to_ru(est_rows, 0.0)):
                raise RuntimeError(
                    f"resource group {self.settings.resource_group!r} "
                    "rejected query (RU budget exhausted)")
        device = next(iter(tables.values())).device if tables else torch.device("cpu")
        summary = ExecutionSummary(plan_text=self.plan.pretty(),
                                   backend=device.type, num_devices=self._num_devices())
        METRICS.counter("queries_total").inc()
        t_start = time.perf_counter()
        if self.mesh is not None:
            tables = self._sharded  # lets the planning view go
        with self._profiler(device), QueryMemoryScope(device) as mem:
            result = self._run_with_retries(tables, summary, t_start)
        summary.peak_device_bytes = mem.peak_bytes
        summary.device_bytes_delta = mem.delta_bytes
        lim = self.settings.max_bytes_per_device
        if lim is not None and mem.peak_bytes > lim:
            from .logging import get_logger

            # the pre-flight estimate undershot: surface it so the
            # estimator can be recalibrated
            get_logger("tiflash_tpu_torch.executor").warning(
                "runtime peak %d bytes exceeded quota %d (pre-flight "
                "estimate undershot)", mem.peak_bytes, lim)
        return result

    def _num_devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def _profiler(self, device):
        """``torch.profiler`` around the run when ``profile_dir`` is set;
        the Chrome trace lands there on exit."""
        d = self.settings.profile_dir
        if not d:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(d, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        path = os.path.join(d, f"query-{os.getpid()}-{time.time_ns()}.json")
        return profile(activities=acts,
                       on_trace_ready=lambda p: p.export_chrome_trace(path))

    def _run_out_of_core(self, tables, err) -> Tuple[Block, ExecutionSummary]:
        """The out-of-core fallbacks, in the reference's order: chunked
        partial aggregation, group-partitioned aggregation, grace hash
        join, sliced sort.  Re-raises ``err`` when none applies."""
        from .logging import get_logger
        from .memory import QueryMemoryScope, block_bytes, plan_chunk_rows
        from . import outofcore as OC

        s = self.settings
        mode = None
        if self.mesh is not None:
            # grace partitions x distributed execution in each
            if s.enable_spill and OC.grace_spec(self.logical_plan or self.plan) is not None:
                mode = "grace"
        elif s.enable_spill:
            if OC.chunkable(self.plan):
                mode = "chunked"
            elif OC.groupagg_spec(self.plan) is not None:
                mode = "groupagg"
            elif OC.grace_spec(self.plan) is not None:
                mode = "grace"
            elif OC.sliced_spec(self.plan) is not None:
                mode = "sliced"
        if mode is None:
            raise err
        get_logger("tiflash_tpu_torch.executor").info(
            "memory limit exceeded: switching to %s out-of-core execution", mode)
        budget = s.max_bytes_per_device or (1 << 32)
        per_op = {"chunked": s.max_bytes_before_external_group_by,
                  "groupagg": s.max_bytes_before_external_group_by,
                  "grace": s.max_bytes_before_external_join,
                  "sliced": s.max_bytes_before_external_sort}[mode]
        if per_op:
            budget = min(budget, per_op)
        # the threshold is a trigger; as a sizing budget it stays
        # proportional to the inputs (a 1-byte force-spill setting would
        # otherwise make thousands of tiny partitions)
        budget = max(budget, sum(block_bytes(b) for b in tables.values()) // 64)
        chunk_rows = plan_chunk_rows(self.plan, tables, budget,
                                     work_factor=s.outofcore_work_factor)
        if s.max_spilled_rows_per_file:
            chunk_rows = min(chunk_rows, s.max_spilled_rows_per_file)
        device = next(iter(tables.values())).device
        info: Dict[str, object] = {"mode": mode, "budget_bytes": budget}
        fuse = self.fuse_stream_agg
        built_before = dict(build.BUILD_SECONDS)
        t_start = time.perf_counter()
        with QueryMemoryScope(device) as mem:
            if mode == "chunked":
                info["chunk_rows"] = chunk_rows
                out = OC.run_chunked_aggregate(self.plan, tables, chunk_rows,
                                               fuse_stream_agg=fuse, info=info,
                                               spill_dir=s.spill_dir,
                                               nthreads=s.max_threads)
            elif mode == "groupagg":
                out = OC.run_groupagg(self.plan, tables, budget, spill_dir=s.spill_dir,
                                      nthreads=s.max_threads, fuse_stream_agg=fuse,
                                      info=info)
            elif mode == "grace":
                plan = (self.logical_plan or self.plan) if self.mesh is not None \
                    else self.plan
                out = OC.run_grace_join(plan, tables, budget, mesh=self.mesh,
                                        spill_dir=s.spill_dir, nthreads=s.max_threads,
                                        fuse_stream_agg=fuse, info=info, cfg=self.cfg)
            else:
                info["chunk_rows"] = chunk_rows
                out = OC.run_sliced(self.plan, tables, chunk_rows, spill_dir=s.spill_dir,
                                    nthreads=s.max_threads, info=info)
        summary = ExecutionSummary(
            plan_text=self.plan.pretty() + f"\n  [{mode} out-of-core]",
            backend=device.type, num_devices=self._num_devices(), out_of_core=info)
        summary.result_rows = int(out.num_rows())
        summary.wall_seconds = time.perf_counter() - t_start
        summary.compile_seconds = _built_seconds(built_before)
        summary.peak_device_bytes = mem.peak_bytes
        summary.device_bytes_delta = mem.delta_bytes
        summary.device = str(out.device) if out.columns else ""
        METRICS.counter("queries_total").inc()
        return out, summary

    def _check_preflight_limits(self, tables) -> None:
        """max_rows_to_read / max_subquery_depth / max_ast_depth: host-known
        facts, checked before launch."""
        s = self.settings
        if s.max_rows_to_read:
            scanned, seen = 0, set()

            def walk(n):
                nonlocal scanned
                if isinstance(n, P.TableScan) and n.table not in seen \
                        and n.table in tables:
                    seen.add(n.table)
                    scanned += tables[n.table].capacity
                for c in n.children:
                    walk(c)

            walk(self.plan)
            if scanned > s.max_rows_to_read:
                raise EngineError(
                    f"query reads {scanned} rows > max_rows_to_read="
                    f"{s.max_rows_to_read}", LIMIT_EXCEEDED)
        if s.max_subquery_depth:
            def depth(n):
                return 1 + max((depth(c) for c in n.children), default=0)

            d = depth(self.plan)
            if d > s.max_subquery_depth:
                raise EngineError(
                    f"plan depth {d} > max_subquery_depth="
                    f"{s.max_subquery_depth}", LIMIT_EXCEEDED)
        if s.max_ast_depth:
            from ..expr.nodes import Call, Cast

            def edepth(e):
                if isinstance(e, Call):
                    return 1 + max((edepth(a) for a in e.args), default=0)
                if isinstance(e, Cast):
                    return 1 + edepth(e.arg)
                return 1

            def plan_exprs(n):
                for attr in ("exprs", "predicate", "condition"):
                    v = getattr(n, attr, None)
                    if isinstance(v, dict):
                        yield from v.values()
                    elif v is not None and v.__class__.__module__.endswith("expr.nodes"):
                        yield v
                for c in n.children:
                    yield from plan_exprs(c)

            worst = max((edepth(e) for e in plan_exprs(self.plan)), default=0)
            if worst > s.max_ast_depth:
                raise EngineError(
                    f"expression depth {worst} > max_ast_depth="
                    f"{s.max_ast_depth}", LIMIT_EXCEEDED)

    def _check_row_limits(self, summary) -> None:
        """Operator row limits against the per-node row counters
        (throw-after: kernels already queued run to completion)."""
        s = self.settings
        checks = (("Aggregation", s.max_rows_to_group_by, "max_rows_to_group_by"),
                  ("Join", s.max_rows_in_join, "max_rows_in_join"),
                  ("Sort", s.max_rows_to_sort, "max_rows_to_sort"))
        for prefix, lim, name in checks:
            if not lim:
                continue
            for nid, rows in summary.node_rows.items():
                if nid.startswith(prefix) and rows > lim:
                    raise EngineError(f"{nid} produced {rows} rows > {name}={lim}",
                                      LIMIT_EXCEEDED)

    def _run_with_retries(self, tables, summary, t_start):
        from .cancel import checkpoint
        from .logging import get_logger
        from .syncpoint import sync_point

        log = get_logger("tiflash_tpu_torch.executor")
        built_before = dict(build.BUILD_SECONDS)
        retries = self.settings.max_capacity_retries
        for attempt in range(retries + 1):
            sync_point("executor.attempt")
            checkpoint()  # between retry attempts
            with tracing.span("runner.attempt", attempt=attempt):
                if self.mesh is None:
                    diag = Diagnostics({}, {}, rf_in_set_max=self.settings.rf_in_set_max_build)
                    out = execute_plan(self.plan, tables, diag, self.fuse_stream_agg)
                    flags = flag_dict(diag)
                else:
                    from ..mpp.runner import compile_distributed

                    diag = Diagnostics({}, {})
                    out, flags = compile_distributed(self.plan, self.mesh, self.cfg)(tables)
                overflows, errors = split_runtime_errors(read_flags(flags))
                tracing.resolve_device()
            checkpoint()
            flagged = {k: v for k, v in overflows.items() if v > 0}
            if not flagged:
                # capacity clean: surface any per-row evaluation errors (a
                # retry-worthy overflow wins: its rows are garbage)
                raise_runtime_errors(errors)
                break
            fail_point("exception_during_retry")
            log.info("capacity overflow, retrying: %s", flagged)
            summary.retries += 1
            summary.overflow_nodes.extend(flagged)
            METRICS.counter("capacity_retries_total").inc()
            if attempt == retries:
                raise RuntimeError(
                    f"capacity overflow persisted after {retries} retries: {flagged}")
            _grow(self.plan, flagged, self.cfg)
        summary.wall_seconds = time.perf_counter() - t_start
        with tracing.span("runner.finish"):
            summary.compile_seconds = _built_seconds(built_before)
            summary.node_rows = {k: int(v) for k, v in diag.rows.items()}
            log.info("query done: wall=%.3fs retries=%d", summary.wall_seconds,
                     summary.retries)
            METRICS.counter("query_seconds_total").inc(summary.wall_seconds)
            if self.mesh is None:
                result = out
            else:
                from ..mpp.runner import collect_result

                result = collect_result(out)
            summary.result_rows = int(result.num_rows())
            summary.device = str(result.device) if result.columns else ""
            self._check_row_limits(summary)
            s = self.settings
            if s.max_result_rows and summary.result_rows > s.max_result_rows:
                if s.result_overflow_mode == "break":
                    # the first max_result_rows live rows (OverflowMode::BREAK)
                    keep = torch.cumsum(result.sel_mask().to(torch.int64), 0) \
                        <= s.max_result_rows
                    result = result.and_sel(keep)
                    summary.result_rows = s.max_result_rows
                else:
                    raise EngineError(
                        f"result has {summary.result_rows} rows > "
                        f"max_result_rows={s.max_result_rows}", LIMIT_EXCEEDED)
            METRICS.counter("rows_returned_total").inc(summary.result_rows)
            fail_point("exception_after_fragment_run")
            return result, summary


def _has_exchange(plan: P.PlanNode) -> bool:
    return "Exchange" in plan.pretty()


def _without_stats(block: Block) -> Block:
    """``block``'s columns with no statistics (no copy), as a shard's."""
    from ..core.block import Column

    return Block(names=block.names, sel=block.sel, columns=tuple(
        Column(c.data, c.validity, c.dtype, c.dictionary, concat_sep=c.concat_sep)
        for c in block.columns))


def run_query(plan: P.PlanNode, tables: Dict[str, Block], mesh=None,
              settings: Optional[Settings] = None, *,
              fuse_stream_agg: bool = True,
              plan_rewrites: Optional[bool] = None) -> Tuple[Block, ExecutionSummary]:
    """Run ``plan`` over ``tables`` (Blocks, all on one device) through a
    ``QueryRunner``.  ``plan_rewrites=None`` means
    ``settings.enable_plan_rewrites``; ``fuse_stream_agg=False`` takes
    the unfused aggregation path.  Capacity growth and auto-sizing land on
    the tree that runs: with rewrites off, ``plan`` itself.

    With ``mesh`` the tables are sharded over it, and a logical plan (no
    exchange) is distributed first (run as-is it would return each
    shard's own answer)."""
    settings = settings or Settings()
    if plan_rewrites is not None and plan_rewrites != settings.enable_plan_rewrites:
        settings = dataclasses.replace(settings, enable_plan_rewrites=plan_rewrites)
    return QueryRunner(plan, mesh=mesh, settings=settings,
                       fuse_stream_agg=fuse_stream_agg).run(tables)


__all__ = ["QueryRunner", "run_query", "enumerate_plan", "enumerate_exchanges",
           "read_flags", "ExecutionSummary"]
