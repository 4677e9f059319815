"""Engine settings.

Counterpart of ``tiflash_tpu/runtime/settings.py``: every field, with the
same defaults, the same ``TIFLASH_TPU_<NAME>`` environment variables and
the same TOML layout (``etc/config-template.toml``), so one deployment's
settings steer both packages alike.  ``profile_dir`` wraps a run in
``torch.profiler`` and exports a Chrome trace there.

Role analog: the 235-setting X-macro ``Interpreters/Settings.h:59-345`` and
the layered TOML config (``Server/StorageConfigParser.cpp``).  Here: one
typed dataclass with env-var overrides (``TIFLASH_TPU_<NAME>``) — the
subset that actually steers this engine, growing as features land.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Settings:
    # --- operator knobs ---
    direct_agg_domain_limit: int = 4096      # direct vs sort agg method cutoff
    default_shuffle_factor: float = 2.0      # exchange out-capacity multiplier
    join_output_factor: float = 2.0          # N:M join expansion multiplier
    max_capacity_retries: int = 4            # overflow re-run doublings
    rf_in_set_max_build: int = 1 << 20       # IN-set runtime-filter size gate
    # group_concat item cap when the plan doesn't set one — the
    # group_concat_max_len analog (truncation, not error)
    group_concat_max_items: int = 64
    # KMV sketch size for approx_count_distinct (std err ~ 1/sqrt(k-2))
    approx_distinct_sketch_k: int = 4096
    # skew-aware join: heavy-hitter detection sample + hot-set size
    skew_sample_per_device: int = 2048
    skew_hot_keys: int = 128
    # out-of-core chunk sizing: transient-copy multiplier over raw bytes
    outofcore_work_factor: int = 8
    # --- execution ---
    mesh_axis: str = "d"
    topn_fast_path: bool = True
    # logical-plan optimizer (eager agg pushdown + column pruning)
    enable_plan_rewrites: bool = True
    # --- auto-planner (plan/auto.py AutoPlanConfig.from_settings) ---
    broadcast_threshold_rows: int = 100_000
    skew_aware_joins: bool = False
    runtime_filters: bool = True
    auto_passthrough_agg: bool = False
    selectivity_sample_rows: int = 4096   # 0 disables sampling
    # --- query limits (reference max_execution_time / timestamp pinning) ---
    max_execution_time_ms: int = 0        # 0 = unlimited; checked at every
                                          # cancellation checkpoint
    query_timestamp_us: Optional[int] = None  # pin NOW()/CURDATE()/RAND()
    # session time zone, '+HH:MM'/'-HH:MM'/'UTC' (Settings timezone /
    # DAGContext tz offset analog): TIMESTAMP (tz-aware DATETIME) columns
    # shift into this zone at read; UNIX_TIMESTAMP/FROM_UNIXTIME convert
    # through it
    time_zone: str = "UTC"
    enable_spill: bool = True             # gate out-of-core fallbacks
    # per-operator external-memory thresholds (Settings.h:138/140/321 —
    # max_bytes_before_external_group_by/-sort/-join): 0 = only the global
    # quota triggers out-of-core; >0 forces the matching operator shape to
    # the out-of-core path once its estimated working set exceeds it
    max_bytes_before_external_group_by: int = 0
    max_bytes_before_external_sort: int = 0
    max_bytes_before_external_join: int = 0
    # host-side parser/spiller thread count (Settings.h:64 max_threads);
    # 0 = hardware concurrency
    max_threads: int = 0
    # out-of-core chunk/partition row cap (Settings.h
    # max_spilled_rows_per_file): caps how many rows any chunked /
    # sliced out-of-core round stages at once, on top of the byte
    # budget.  0 = bytes-only
    max_spilled_rows_per_file: int = 0
    # --- resource limits (Settings.h max_rows_to_read/-group_by/-sort,
    # max_rows_in_join, max_result_rows + overflow modes).  0 = off.
    # The engine runs whole static-shape programs, so read/depth limits
    # check pre-flight and operator limits check the EXPLAIN ANALYZE row
    # counters after the program ran (throw-after, not stop-mid-stream —
    # a jitted program can't be interrupted) ---
    max_rows_to_read: int = 0        # sum of scanned table rows (pre-flight)
    max_rows_to_group_by: int = 0    # groups produced by any Aggregation
    max_rows_in_join: int = 0        # rows out of any Join
    max_rows_to_sort: int = 0        # rows through any full Sort
    max_result_rows: int = 0         # final result rows
    result_overflow_mode: str = "throw"  # throw | break (truncate result)
    max_subquery_depth: int = 0      # plan tree depth guard (pre-flight)
    max_ast_depth: int = 0           # expression tree depth guard
    # --- service ---
    service_max_concurrency: int = 4      # admission slots (MinTSO analog)
    service_queue_timeout_s: float = 0.0  # 0 = wait forever when QUEUED
    # --- memory (the MemoryTracker quota analog; enforced host-side) ---
    max_bytes_per_device: Optional[int] = None
    # disk spill tier for out-of-core partition buffers (Core/Spiller.h
    # analog; native zlib chunk files); empty = stage in host RAM
    spill_dir: str = ""
    # --- observability ---
    collect_summaries: bool = True
    # when set, each run() is traced by torch.profiler and a Chrome trace
    # written into dir (open with Perfetto; the pprof analog)
    profile_dir: str = ""

    # resource control (runtime/resource.py); empty group = unlimited
    resource_group: str = ""

    @staticmethod
    def from_toml(path: str, **overrides) -> "Settings":
        """Layered TOML config (the Poco-TOML analog,
        ``etc/config-template.toml``): file values < env < overrides."""
        import tomllib

        with open(path, "rb") as f:
            data = tomllib.load(f)
        s = Settings.from_env()
        for k, v in data.get("engine", data).items():
            if hasattr(s, k):
                setattr(s, k, v)
        for k, v in overrides.items():
            setattr(s, k, v)
        return s

    def with_overrides(self, overrides: dict) -> "Settings":
        """Per-request settings copy (the reference applies tipb flags
        over the session settings per query,
        ``Flash/Coprocessor/DAGContext.h:163``).  Unknown names and
        un-coercible values raise ``ValueError`` so callers can 400."""
        valid = {f.name: f for f in dataclasses.fields(self)}
        patch = {}
        for k, v in (overrides or {}).items():
            if k not in valid:
                raise ValueError(f"unknown setting '{k}'")
            cur = getattr(self, k)
            try:
                if isinstance(cur, bool):
                    if isinstance(v, str):
                        v = v.lower() in ("1", "true", "yes")
                    else:
                        v = bool(v)
                elif isinstance(cur, int):
                    v = int(v)
                elif isinstance(cur, float):
                    v = float(v)
                elif cur is None:  # Optional[int] fields
                    v = None if v is None else int(v)
                else:
                    v = type(cur)(v)
            except (TypeError, ValueError) as e:
                raise ValueError(f"bad value for setting '{k}': {e}")
            patch[k] = v
        return dataclasses.replace(self, **patch)

    @staticmethod
    def from_env(**overrides) -> "Settings":
        s = Settings(**overrides)
        for f in dataclasses.fields(s):
            env = os.environ.get("TIFLASH_TPU_" + f.name.upper())
            if env is None:
                continue
            t = f.type if isinstance(f.type, type) else type(getattr(s, f.name))
            if t is bool or isinstance(getattr(s, f.name), bool):
                setattr(s, f.name, env.lower() in ("1", "true", "yes"))
            elif isinstance(getattr(s, f.name), int):
                setattr(s, f.name, int(env))
            elif isinstance(getattr(s, f.name), float):
                setattr(s, f.name, float(env))
            else:
                setattr(s, f.name, env)
        return s


__all__ = ["Settings"]
