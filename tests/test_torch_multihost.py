"""The port's multi-process execution: two OS processes joined by gloo,
two CPU shards each (a 4-shard ``ProcessMesh``), as
``tests/test_multihost.py`` spawns the reference.  Each worker
(``tests/torch_multihost_worker.py``) holds only its half of the rows,
runs a distributed aggregation, a shuffle join and a right outer join (in
both shuffle wire modes) and a laned window, and must print the oracle's rows (exact: integers).  The
workers have a time limit of their own.
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import tiflash_tpu.core.dtypes as dt
from tiflash_tpu.ops.window import WindowDesc
from tiflash_tpu.testing import oracle as O

WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
WORKER_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(WORKER))
    procs = [subprocess.Popen([sys.executable, WORKER, str(pid), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env, text=True) for pid in (0, 1)]
    # drain both workers at once: a full pipe would block one of them
    with ThreadPoolExecutor(len(procs)) as pool:
        futs = [pool.submit(p.communicate, timeout=WORKER_TIMEOUT_S) for p in procs]
        try:
            return [(p, f.result()) for p, f in zip(procs, futs)]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise


def _expected():
    rng = np.random.default_rng(11)
    t = O.random_pytable(rng, 512, {"k": dt.INT32, "v": dt.INT64}, int_range=(0, 23))
    r = O.random_pytable(rng, 128, {"rk": dt.INT32, "rv": dt.INT64}, int_range=(0, 23))
    tw = dict(t, p2=[k % 2 for k in t["k"]])
    return {
        "agg": O.o_aggregate(t, ["k"], [("sum", "v", "s"), ("count", None, "c")]),
        "join": O.o_join(t, r, ["k"], ["rk"], kind="inner"),
        "right_outer": O.o_join(t, r, ["k"], ["rk"], kind="right_outer"),
        "join_ragged": O.o_join(t, r, ["k"], ["rk"], kind="inner"),
        "right_outer_ragged": O.o_join(t, r, ["k"], ["rk"], kind="right_outer"),
        "window": O.o_window(tw, ["p2"], [("v", False)],
                             [WindowDesc("row_number", "rn"), WindowDesc("rank", "rk2"),
                              WindowDesc("sum", "rs", arg="v")]),
    }


def test_two_process_multihost():
    want = _expected()
    for p, (out, err) in _spawn():
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert line, f"worker {p.args[2]} printed no RESULT:\n{err[-3000:]}"
        got = json.loads(line[-1][len("RESULT"):])
        for name, table in want.items():
            O.assert_tables_equal(got[name], table)


def test_no_card_raises_instead_of_a_cpu_group():
    """Without a card, the defaults (NCCL, the process's card) raise; the
    CPU is taken only when the caller names it, as the worker above does."""
    import pytest
    import torch
    import torch.distributed as dist

    from tiflash_tpu_torch.mpp.multihost import global_mesh, init_multihost

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the defaults take it")
    with pytest.raises(RuntimeError, match="NCCL needs a card"):
        init_multihost("127.0.0.1:1", num_processes=1, process_id=0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no card is visible"):
        global_mesh(local_shards=2)
