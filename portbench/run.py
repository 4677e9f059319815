"""One run of one benchmark cell on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``configs/<config>.json``, its mix in
``mixes/<traffic>.json`` (``traffic.py``), each query shape in
``queries/<shape>.json`` with its reference ``reference/<shape>.py``,
each metric's reader in ``metrics/<metric>.py``, and the configuration's
data generator, ``portbench/<generator>.py`` (``dataset.py``).

Set-up, timed from the start of this process: the tables made from the
seed by the configuration's generator, the port's catalog built from
them, its query service started on the card (``system.py``) and every
request of the mix's warm set sent once through HTTP, which copies the
tables to the card and builds every kernel the mix needs.  The window: the load
generator (``client.py``) in a process of its own, for ``--seconds``.
With ``--trace 1`` the same window runs with the profiler over the mix's
slice, and the per-layer metrics are reported instead of the end-to-end
ones.  Then the service is stopped and its tables freed, and every
answer of the window is compared with the plain reference's
(``check.py``).  The last line of standard output is the result.

Exits non-zero with no result when no card (or too few) is found, when
the port is not importable, or when ``jax``, ``jaxlib``, ``flax`` or
``tiflash_tpu`` is loaded once the window has closed.  ``--rehearse SF``
runs the same on the CPU at scale factor SF, for the benchmark's own
tests; it is no measurement.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.dataset import RunError, config  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tiflash_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(name: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = config(cell["config"])

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return cell, conf, [m for m in bench["end_to_end"] if applies(m)], \
        [m for m in bench["per_layer"] if applies(m)]


def post(port: int, plan: dict):
    body = json.dumps({"plan": plan}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/query", body,
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``)."""

    def __init__(self):
        self.setup_s = None
        self.t0 = self.t1 = None
        self.records = []
        self.peak_window_bytes = None
        self.trace = None          # trace.reduce(...) of a traced run
        self.tables = None         # reference/_common.Tables over the run's data
        self.references = {}       # shape -> reference module
        self.scan_bytes = None     # bytes_model.ScanBytes

    @property
    def answered(self):
        return [r for r in self.records if r["status"] == 200]

    def latencies_ms(self):
        return [(r["t_done"] - r["t_send"]) * 1e3 for r in self.records]


def run_window(port: int, mix_name: str, seed: int, seconds: float, sl, slice_spec):
    """The load generator's window, with the profiled slice when ``sl`` is
    a ``trace.Slice``; returns (t0, t1, records)."""
    from portbench import trace

    cfg = {"port": port, "mix": mix_name, "seed": seed, "seconds": seconds,
           "parent": os.getpid()}
    proc = subprocess.Popen([sys.executable, str(HERE / "client.py"), json.dumps(cfg)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        if not first:
            raise RunError("the load generator ended before its window: "
                           + proc.stderr.read()[-2000:])
        t0 = json.loads(first)["t0"]
        if sl is not None:
            trace.run_slice(sl, t0, seconds, slice_spec)
        out, err = proc.communicate(timeout=seconds + 600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RunError(f"load generator exited {proc.returncode}: {err[-2000:]}")
    last = json.loads(out.strip().splitlines()[-1])
    return t0, last["t1"], last["records"]


def judge(run: Run, log) -> int:
    """Compare every answer of the window with the reference's; returns
    how many are wrong."""
    from portbench import check

    memo = {}
    wrong, shown = 0, 0
    t = time.monotonic()
    for r in run.answered:
        ref = run.references[r["shape"]]
        if r["key"] not in memo:
            memo[r["key"]] = ref.answer(run.tables, r["params"])
        err = check.compare(r["columns"], memo[r["key"]], ref.ORDER_BY, ref.LIMIT)
        if err:
            wrong += 1
            if shown < 5:
                shown += 1
                log(f"wrong answer: {r['shape']} {r['params']}: {err}")
    log(f"reference: {len(run.answered)} answers compared, {len(memo)} distinct "
        f"requests worked out in {time.monotonic() - t:.3f} s")
    return wrong


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", type=float, default=None,
                    help="run on the CPU at this scale factor (the benchmark's tests)")
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    if args.trace:
        from portbench.trace import CUPTI_ENV

        os.environ.update(CUPTI_ENV)
    try:
        return _main(args, log)
    except RunError as e:
        log(f"portbench: {e}")
        return 2
    except Terminated as e:
        # the clean-up on the way here ended the load generator and waited
        # for it; the service's threads may still be inside a request,
        # so the interpreter is not wound down around them
        log(f"portbench: ended by signal {e.signum}; no result")
        sys.stdout.flush()
        os._exit(128 + e.signum)


class Terminated(BaseException):
    """SIGTERM, raised in the main thread so that every clean-up on the way
    out runs (a crash or SIGKILL ends the load generator through
    ``client.py``'s ``die_with_parent`` instead)."""

    def __init__(self, signum):
        super().__init__(signum)
        self.signum = signum


def _terminated(signum, frame):
    raise Terminated(signum)


def _main(args, log) -> int:
    import torch

    cell, conf, e2e, per_layer = load_cell(args.workload)
    seed = args.seed % (1 << 63)
    if args.rehearse is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
                           f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device, sf = "cuda", float(conf["scale_factor"])
    else:
        device, sf = "cpu", float(args.rehearse)
    try:
        from portbench import system
    except ImportError as e:
        raise RunError(f"the system under test is not importable: {e}")
    from portbench import bytes_model, dataset, traffic
    from portbench.reference._common import Tables

    gen = dataset.generator(conf)
    mix = traffic.Mix(cell["traffic"], seed)
    refs = {s: importlib.import_module(f"portbench.reference.{s}") for s in mix.queries}
    metric_mods = {m["name"]: importlib.import_module(f"portbench.metrics.{m['name']}")
                   for m in (per_layer if args.trace else e2e)}

    t = time.monotonic()
    tables = gen.generate(sf, seed, device)
    if device == "cuda":
        torch.cuda.empty_cache()
    gen_s = time.monotonic() - t
    t = time.monotonic()
    cat = system.build_catalog(tables)
    cat_s = time.monotonic() - t
    service, httpd, port = system.start(cat, device)
    t = time.monotonic()
    warm = mix.warm_set()
    for shape, params in warm:
        try:
            post(port, traffic.bind(mix.queries[shape], params))
        except urllib.error.HTTPError as e:
            log(f"warm request {shape} {params} failed: {e.code} {e.read()[:500]!r}")
    if device == "cuda":
        torch.cuda.synchronize()
    warm_s = time.monotonic() - t
    before = system.counters()
    peak_setup = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    log(f"set-up: tables {gen.total_bytes(tables)} B made in {gen_s:.3f} s, "
        f"catalog {cat_s:.3f} s, {len(warm)} warm requests {warm_s:.3f} s "
        f"(copy to the device and kernel builds), counters {before}")

    run = Run()
    sl = None
    if args.trace:
        from portbench import trace

        sl = trace.Slice(device)
    try:
        run.t0, run.t1, run.records = run_window(
            port, cell["traffic"], seed, args.seconds, sl, mix.spec.get("trace"))
    finally:
        httpd.shutdown()
        httpd.server_close()
    run.setup_s = run.t0 - T_START
    if device == "cuda":
        torch.cuda.synchronize()
        run.peak_window_bytes = torch.cuda.max_memory_allocated()
    after = system.counters()
    log(f"window: {len(run.records)} requests, {len(run.answered)} answered, "
        f"{run.t1 - run.t0:.3f} s; counters {after}")
    by_shape = {}
    for rec in run.records:
        by_shape.setdefault(rec["shape"], []).append((rec["t_done"] - rec["t_send"]) * 1e3)
    log("latency by shape (n, median ms): " + ", ".join(
        f"{s} {len(v)} {sorted(v)[len(v) // 2]:.3f}" for s, v in sorted(by_shape.items())))
    if after["builds"] != before["builds"]:
        log(f"kernels built inside the window: {after['builds'] - before['builds']}")
    if sl is not None:
        t = time.monotonic()
        run.trace = trace.reduce(sl, run.records)
        log(f"trace: slice {run.trace['window_s']:.3f} s, kernels {run.trace['busy_s']:.6f} s, "
            f"copies {run.trace['copy_s']:.6f} s ({run.trace['kernel_events']} kernels, "
            f"{run.trace['copy_events']} copies and sets), "
            f"{len(run.trace['requests_done'])} requests done in it, clock offset "
            f"{run.trace['offset_ns']} ns within {run.trace['offset_err_ns']} ns, "
            f"reduced in {time.monotonic() - t:.3f} s")
        del sl
    bad = forbidden_modules()
    if bad:
        raise RunError(f"loaded once the window closed: {', '.join(bad)}")

    # the program's state goes before the reference runs
    del service, httpd, cat
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    run.tables = Tables(tables, device)
    run.references = refs
    run.scan_bytes = bytes_model.ScanBytes(run.tables.host)
    wrong = judge(run, log)
    failed = len(run.records) - len(run.answered)
    for r in [r for r in run.records if r["status"] != 200][:5]:
        log(f"failed request: {r['shape']} {r['params']}: {r['status']} {r.get('error')}")

    metrics = {}
    units = {m["name"]: m["unit"] for m in (per_layer if args.trace else e2e)}
    for name, mod in metric_mods.items():
        value = mod.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    run.tables.release()

    limits = {"wrong_answers": {"value": wrong, "limit": 0},
              "failed_requests": {"value": failed, "limit": 0}}
    correct = len(run.records) > 0 and wrong <= 0 and failed <= 0
    result = {
        "correct": correct,
        "attempted": len(run.records),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu rehearsal",
            "count": cell["chips"] if device == "cuda" else 0,
            "memory_peak_bytes": max(peak_setup, run.peak_window_bytes or 0),
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["limits"] = limits
    for name, lim in limits.items():
        log(f"{name} {lim['value']} limit {lim['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.enable()   # a crash leaves its Python stack on standard error
    signal.signal(signal.SIGTERM, _terminated)
    sys.exit(main())
