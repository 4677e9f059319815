"""The PyTorch port must run where jax is not installed: importing every
``tiflash_tpu_torch`` module and ``chip_smoke``'s helpers, and the draw
helper ``tests/torch_plan_draw.py`` as ``chip_smoke.load_draw`` loads it,
must pull in neither ``jax`` nor the JAX package ``tiflash_tpu``.
Checked in a fresh interpreter, since this test process has both
loaded."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import tiflash_tpu_torch
names = ["tiflash_tpu_torch"]
for m in pkgutil.walk_packages(tiflash_tpu_torch.__path__, "tiflash_tpu_torch."):
    names.append(m.name)
for n in names:
    importlib.import_module(n)
import chip_smoke
assert callable(chip_smoke.main) and callable(chip_smoke.numpy_q1)
assert callable(chip_smoke.numpy_q7) and callable(chip_smoke.check_direct_agg)
assert callable(chip_smoke.numpy_q3) and callable(chip_smoke.numpy_topn)
assert callable(chip_smoke.check_stream_tile) and callable(chip_smoke.sf10_q1_phase)
for f in ("numpy_q2", "numpy_q9", "numpy_q13", "numpy_q14", "numpy_q16",
          "numpy_q18", "eight_table_phase"):
    assert callable(getattr(chip_smoke, f)), f
for f in ("spec_phase", "sweep_phase", "compare_sweep", "cpu_run_with_spy",
          "card_run_checked", "string_phase", "numpy_ship_month",
          "device_busy_ms"):
    assert callable(getattr(chip_smoke, f)), f
for m in ("ops.join", "ops.merge", "ops.cuda.direct_agg", "plan.rewrite",
          "ops.hashing", "runtime.errors", "bench.tpch_spec", "expr.regexp_json",
          "expr.duration", "bench.strings", "ops.tile_program", "ops.cuda.stream_tile",
          "testing.fuse_cases", "ops.segments", "ops.window", "ops.expand",
          "ops.sketch", "exchange.skew", "plan.serde", "bench.analytics",
          "runtime.settings", "runtime.summary", "runtime.metrics", "runtime.logging",
          "runtime.failpoint", "runtime.syncpoint", "runtime.cancel", "runtime.resource",
          "runtime.memory", "runtime.distribute_helpers", "runtime.spill",
          "runtime.outofcore", "runtime.analyze", "plan.auto", "ops.vector",
          "storage.native_loader", "storage.system", "mpp.service", "cli",
          "runtime.native", "testing.tbl", "mpp.mesh", "mpp.runner",
          "mpp.multihost", "exchange.shuffle", "plan.distribute", "demo",
          "testing.reftest", "testing.oracle", "testing.declarative",
          "testing.plan_oracle"):
    assert "tiflash_tpu_torch." + m in names, m
for f in ("analytics_phase", "numpy_rollup", "numpy_window_report",
          "numpy_stats_grouped", "numpy_stats_first", "numpy_stats_stream",
          "numpy_not_in", "analytics_cpu_runs", "start_analytics_cpu_runs",
          "block_summary", "analytic_same"):
    assert callable(getattr(chip_smoke, f)), f
for f in ("outofcore_phase", "outofcore_predictions", "runtime_controls_phase",
          "explain_phase", "sf10_catalog", "partition_budget", "ooc_spy", "hc_plan",
          "daily_revenue_plan", "same_rows"):
    assert callable(getattr(chip_smoke, f)), f
for f in ("vector_phase", "loader_phase", "service_phase", "mesh_phase", "mesh_cpu_runs",
          "mesh_runner", "mesh_run", "mesh_direct_agg_check", "mesh_sf10_phase",
          "exchange_bytes"):
    assert callable(getattr(chip_smoke, f)), f
for f in ("sql_phase", "sql_script_runs", "sql_scripts_check", "sql_query_phase",
          "held_kernel_run", "planes_equal_plain"):
    assert callable(getattr(chip_smoke, f)), f
for f in ("oracle_phase", "oracle_trees", "oracle_families", "family_cpu_side",
          "load_draw", "spied_cpu_run", "launches_of"):
    assert callable(getattr(chip_smoke, f)), f
draw = chip_smoke.load_draw()
assert sum(len(seeds) for _, seeds in draw.GENERATORS.values()) == 126
for f in ("all_draws", "oracle_rows", "judge", "assert_same_rows", "family_a",
          "family_b", "execute_plan_oracle"):
    assert callable(getattr(draw, f)), f
from tiflash_tpu_torch.testing import oracle as O
for f in ("o_filter", "o_project", "o_aggregate", "o_join", "o_sort", "o_window",
          "o_expand", "o_cross_join", "o_anti_null_aware", "random_pytable",
          "assert_tables_equal", "sort_pytable", "eval_expr_table"):
    assert callable(getattr(O, f)), f
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "tiflash_tpu."))
             or m == "tiflash_tpu")
print(len(names), "modules")
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "BAD []", proc.stdout
    assert int(lines[0].split()[0]) >= 72, proc.stdout


def test_port_sources_name_no_jax():
    """No source line of the port imports jax or the JAX package."""
    offenders = []
    for path in list((ROOT / "tiflash_tpu_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py", ROOT / "tests" / "torch_plan_draw.py"]:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")) and (
                    " jax" in s or "jaxlib" in s or "tiflash_tpu " in s
                    or "tiflash_tpu." in s):
                offenders.append(f"{path.relative_to(ROOT)}:{i}: {s}")
    assert not offenders, offenders
