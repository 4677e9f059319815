"""Time two checkouts of the port against each other on one CUDA card.

    python3 tiflash_tpu_torch/bench/compare_trees.py OLD_DIR NEW_DIR

Each DIR is the root of a checkout (for example a parent commit unpacked
with ``git archive`` into a directory ``.gitignore`` lists).  In turns
OLD, NEW, NEW, OLD, three times over, a fresh process
imports that checkout's ``tiflash_tpu_torch``, builds its kernels and,
at SF1 from seed 0, measures TPC-H Q1 and Q6 (the fused stream_agg
path: the kernel generated per plan, ``ops/cuda/stream_tile.py``, where
the checkout has it, else the planes kernel) and Q7 over all nation pairs
(the direct_agg kernel):

- the ``run_query`` median of 30 warm runs;
- one ``torch.profiler`` window of 5 runs: wall, device busy time (the
  sum of the device events' spans), idle share and device events per run
  (the profiler's own overhead is in its wall);
- the kernel: every call of the checkout's wrapper (``fused_group_sums``
  or ``group_sums``) that one run makes is captured and replayed through
  that same wrapper,
  median of 20 CUDA-event timings, the L2 flushed by a read before each.

Each checkout runs its own wrapper on the arguments its own query made,
so no launch signature is assumed; the launch steps the wrapper takes
(a table copy, a stack) are in its time.  Every run's results must be
equal.  Prints each metric as every reading of each checkout and their
median, then one JSON line with all runs.  The wall time of a query that
the host bounds varies between processes by more than the kernels'
gain, hence the rounds.  The timing helpers are this checkout's
``chip_smoke.py``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROFILE_RUNS = 5
QUERY_RUNS = 30
ROUNDS = 3
QUERIES = ("q1", "q6", "q7_pairs")


def smoke_helpers():
    """This checkout's ``chip_smoke.py``, loaded by path (it imports only
    the standard library at module level)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_idle(run, runs: int = PROFILE_RUNS):
    """(wall ms, device busy ms, idle share, device events) per run of
    ``run()`` under torch.profiler: busy is the sum of the device events'
    spans, wall the host clock around the runs and a final sync."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / runs
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / runs
    return wall, busy, (1 - busy / wall) if dev else None, len(dev) / runs


def worker(tree: str) -> dict:
    """The measurements of one checkout, in this process."""
    tree_path = Path(tree).resolve()
    sys.path.insert(0, str(tree_path))
    import torch

    import tiflash_tpu_torch
    from tiflash_tpu_torch.bench.tpch_queries import q1_plan, q6_plan, q7_nation_pairs_plan
    from tiflash_tpu_torch.ops.cuda import build, direct_agg as DA, stream_agg as SA
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    pkg = Path(tiflash_tpu_torch.__file__).resolve()
    if tree_path not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the package of {tree_path}")
    if not torch.cuda.is_available():
        raise RuntimeError("compare_trees needs one CUDA card")
    smoke = smoke_helpers()
    build.build_libraries(("stream_agg", "direct_agg"))
    flush = smoke.L2Flush()
    out = {"tree": str(tree_path), "card": smoke.card_line()}
    try:
        from tiflash_tpu_torch.ops.cuda import stream_tile
        fused = (stream_tile, "fused_group_sums")
    except ImportError:  # a checkout from before the generated kernel
        fused = (SA, "group_sums")
    phases = ((["lineitem"], (("q1", q1_plan, fused), ("q6", q6_plan, fused))),
              (smoke.Q7_TABLES, (("q7_pairs", q7_nation_pairs_plan, (DA, "group_sums")),)))
    for tables, queries in phases:
        gpu = generate_tpch(sf=smoke.SF, seed=smoke.SEED, tables=tables).blocks("cuda")
        for name, plan_fn, (mod, fn_name) in queries:
            plan = plan_fn()

            def run():
                return run_query(plan, gpu)

            result = smoke.block_result(run()[0])
            q_ms = smoke.time_ms(run, QUERY_RUNS)
            wall, busy, idle, events = profile_idle(run)
            captured = smoke.capture_calls(mod, fn_name, run)
            k_ms = smoke.time_ms(lambda: [getattr(mod, fn_name)(*c) for c in captured],
                                 smoke.KERNEL_REPS, flush)
            out[name] = {"run_query_ms": q_ms, "kernel_ms": k_ms,
                         "kernel_calls": len(captured), "profile_wall_ms": wall,
                         "busy_ms": busy, "idle": idle, "events": events,
                         "result": hashlib.sha256(repr(result).encode()).hexdigest()}
        del gpu
    return out


def _fmt(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1])))
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"old": argv[0], "new": argv[1]}
    runs = []
    for label in ("old", "new", "new", "old") * ROUNDS:
        proc = subprocess.run([sys.executable, __file__, "--worker", trees[label]],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(f"{label} ({trees[label]}) failed:\n{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    print(runs[0][1]["card"])
    for q in QUERIES:
        if len({r[q]["result"] for _, r in runs}) != 1:
            print(f"{q}: the results differ between runs", file=sys.stderr)
            return 1
        for metric in ("run_query_ms", "kernel_ms", "busy_ms", "idle", "events",
                       "kernel_calls"):
            read = {lab: [r[q][metric] for lb, r in runs if lb == lab] for lab in trees}
            text = {lab: "/".join(map(_fmt, xs)) + (
                f" (median {_fmt(statistics.median(xs))})" if None not in xs else "")
                for lab, xs in read.items()}
            print(f"{q} {metric}: old {text['old']}, new {text['new']}")
    print(json.dumps({"runs": [{"label": lab, **r} for lab, r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
