"""Command-line tools of the PyTorch port.

Counterpart of ``tiflash_tpu/cli.py``.  Role analog: the operator CLIs
(DTTool inspect) and the debug client: inspect tables, run JSON plans,
serve the HTTP service, dump metrics.  Every command runs on
``--device`` (``cuda`` unless the caller asks for the CPU).

    python -m tiflash_tpu_torch.cli tables --tpch-sf 0.01
    python -m tiflash_tpu_torch.cli --tbl-dir DIR --tables lineitem query plan.json
    python -m tiflash_tpu_torch.cli --tpch-sf 0.01 serve --port 8123
    python -m tiflash_tpu_torch.cli --tpch-sf 0.01 repl

``--distributed`` raises ``NotImplementedError``: the distributed runner
comes with the distribution slice of the port.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time


def _build_catalog(args):
    if args.tbl_dir:
        from .runtime.settings import Settings
        from .storage.native_loader import load_tpch_dir

        return load_tpch_dir(args.tbl_dir, args.tables.split(","),
                             nthreads=Settings.from_env().max_threads)
    from .storage.tpch import generate_tpch

    return generate_tpch(sf=args.tpch_sf,
                         tables=args.tables.split(",") if args.tables else None)


def _check_single_device(args) -> None:
    if args.distributed:
        raise NotImplementedError(
            "--distributed comes with the distribution slice of the port; "
            "the port's CLI runs on one device")


def _print_block(out, limit):
    cols = out.to_pylists()
    names = list(cols)
    print("\t".join(names))
    n = len(cols[names[0]]) if names else 0
    for i in range(min(n, limit)):
        print("\t".join(str(cols[c][i]) for c in names))
    if n > limit:
        print(f"... ({n} rows total)")


def _repl(cat, mesh, limit, inp=None, outp=None, device="cuda"):
    """Interactive loop (the debug-client analog).

    Commands:
      tables                      list catalog tables
      explain <json-plan>         print the plan tree
      <json-plan>                 execute and print rows (one line of JSON)
      \\i FILE                     execute a JSON plan from a file
      summary                     EXPLAIN ANALYZE of the last query
      quit / EOF                  exit

    ``mesh`` keeps the reference's signature and must be None."""
    from .plan import serde
    from .runtime.executor import run_query

    inp = inp or sys.stdin
    outp = outp or sys.stdout
    last_summary = None

    def say(*a):
        print(*a, file=outp)

    say(f"tiflash-tpu-torch repl ({device}): {len(cat.tables)} tables; "
        "'tables' to list, 'quit' to exit")
    while True:
        try:
            print(f"{device}> ", end="", file=outp, flush=True)
            line = inp.readline()
        except KeyboardInterrupt:
            break
        if not line:
            break
        line = line.strip()
        if not line:
            continue
        if line in ("quit", "exit"):
            break
        try:
            if line == "tables":
                for name, t in cat.tables.items():
                    say(f"{name}  rows={t.row_count}")
                continue
            if line == "summary":
                say(last_summary.pretty() if last_summary else "no query yet")
                continue
            if line.startswith("\\i "):
                with open(line[3:].strip()) as f:
                    line = f.read()
            explain = line.startswith("explain ")
            if explain:
                line = line[len("explain "):]
            plan = serde.plan_from_json(json.loads(line))
            if explain:
                say(plan.pretty())
                continue
            out, last_summary = run_query(plan, cat.blocks(device), mesh=mesh)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _print_block(out, limit)
            print(buf.getvalue(), end="", file=outp)
        except Exception as e:  # the REPL reports and keeps running
            say(f"error: {type(e).__name__}: {e}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tiflash-tpu-torch")
    ap.add_argument("--tpch-sf", type=float, default=0.01)
    ap.add_argument("--tbl-dir", help="load dbgen .tbl files instead of generating")
    ap.add_argument("--tables", default=None, help="comma-separated table subset")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--distributed", action="store_true",
                    help="not in the port yet: raises")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("tables", help="list catalog tables")

    q = sub.add_parser("query", help="execute a JSON plan file")
    q.add_argument("plan_file")
    q.add_argument("--limit", type=int, default=20, help="rows to print")
    q.add_argument("--summary", action="store_true")

    s = sub.add_parser("serve", help="run the HTTP query service")
    s.add_argument("--port", type=int, default=8123)

    sub.add_parser("metrics", help="dump metrics counters")

    r = sub.add_parser("repl", help="interactive JSON-plan REPL")
    r.add_argument("--limit", type=int, default=20)

    args = ap.parse_args(argv)

    if args.cmd == "metrics":
        from .runtime.metrics import METRICS

        print(json.dumps(METRICS.dump(), indent=2))
        return 0

    _check_single_device(args)
    cat = _build_catalog(args)

    if args.cmd == "tables":
        for name, t in cat.tables.items():
            cols = ", ".join(f"{c}:{d!r}" for c, d in t.schema.items())
            print(f"{name}  rows={t.row_count}  [{cols}]")
        return 0

    if args.cmd == "query":
        from .plan import serde
        from .runtime.executor import run_query

        with open(args.plan_file) as f:
            plan = serde.plan_from_json(json.load(f))
        out, summary = run_query(plan, cat.blocks(args.device))
        _print_block(out, args.limit)
        if args.summary:
            print(summary.pretty(), file=sys.stderr)
        return 0

    if args.cmd == "repl":
        return _repl(cat, None, args.limit, device=args.device)

    if args.cmd == "serve":
        from .mpp.service import QueryService, serve_background

        httpd, port = serve_background(QueryService(cat, device=args.device), args.port)
        print(f"serving on http://127.0.0.1:{port} ({args.device}; Ctrl-C to stop)",
              flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            httpd.shutdown()
        return 0


if __name__ == "__main__":
    sys.exit(main())
