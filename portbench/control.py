"""The control of the comparison that decides ``correct``: the plain
reference put in the system's place, with DECIMAL arithmetic in float64
(the nearest precision below the exact decimals the configurations
state), judged by ``check.py`` against the exact reference.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--requests N]

For each seed it makes the cell's tables with its configuration's
generator (``dataset.py``), takes the first ``N`` requests of each of
the mix's clients (the order a run sends them in), answers each with the
control and counts the answers ``check.compare`` rejects.
Prints one JSON line per seed, then one with the least count: the upper
reading of ``wrong_answers``, whose limit is 0.  ``--rehearse SF`` runs
on the CPU at that scale factor.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import check, dataset, traffic  # noqa: E402
from portbench.reference._common import Tables  # noqa: E402
from portbench.run import load_cell  # noqa: E402


def control_counts(cell_name: str, seed: int, n_requests: int, sf: float, device: str) -> dict:
    cell, conf, _, _ = load_cell(cell_name)
    gen = dataset.generator(conf)
    mix = traffic.Mix(cell["traffic"], seed)
    refs = {s: importlib.import_module(f"portbench.reference.{s}") for s in mix.queries}
    t0 = time.monotonic()
    tables = Tables(gen.generate(sf, seed, device), device)
    exact, lower, wrong, total = {}, {}, 0, 0
    by_shape = {}
    for k in range(mix.clients):
        gen = mix.requests(k)
        for _ in range(n_requests):
            shape, params, _ = next(gen)
            key = traffic.params_key(shape, params)
            ref = refs[shape]
            if key not in exact:
                exact[key] = ref.answer(tables, params)
                lower[key] = ref.answer(tables, params, control=True)
            err = check.compare(lower[key], exact[key], ref.ORDER_BY, ref.LIMIT)
            total += 1
            if err:
                wrong += 1
                by_shape[shape] = by_shape.get(shape, 0) + 1
    return {"workload": cell_name, "seed": seed, "requests": total, "wrong_answers": wrong,
            "wrong_by_shape": by_shape, "seconds": round(time.monotonic() - t0, 3),
            "scale_factor": sf}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=22,
                    help="requests per client: a pass of a stream, or draws")
    ap.add_argument("--rehearse", type=float, default=None)
    args = ap.parse_args(argv)
    try:
        return _main(args)
    except dataset.RunError as e:
        print(f"control.py: {e}", file=sys.stderr)
        return 2


def _main(args) -> int:
    import torch

    _, conf, _, _ = load_cell(args.workload)
    if args.rehearse is None:
        if not torch.cuda.is_available():
            print("control.py: no CUDA card", file=sys.stderr)
            return 2
        device, sf = "cuda", float(conf["scale_factor"])
    else:
        device, sf = "cpu", args.rehearse
    least = None
    for s in args.seeds.split(","):
        res = control_counts(args.workload, int(s), args.requests, sf, device)
        print(json.dumps(res), flush=True)
        least = res["wrong_answers"] if least is None else min(least, res["wrong_answers"])
    print(json.dumps({"workload": args.workload, "control_least_wrong_answers": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
