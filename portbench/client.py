"""The load generator: closed-loop clients in a process of their own, so
their work does not take the server's interpreter lock.

    python portbench/client.py '<json settings>'

Settings: ``port``, ``mix``, ``seed``, ``seconds``, ``parent``.  Each
client is a thread that sends its next request when the last reply has
been parsed.
A request is timed on this process's clock (``time.monotonic``, which
the server's process shares) from just before it is sent to its parsed
reply.  The window opens when every client is ready; a client sends no
request once ``seconds`` have passed, but with the mix's
``finish_pass`` it first finishes the pass it is in.  Requests in flight
at the close are waited for, and count.

Prints ``{"t0": ...}`` when the window opens, then, at the end, one JSON
line with every request's record and ``t1``, the last reply's time.

It ends with the process that started it (``parent`` in the settings):
the kernel kills it once that process is gone, however that ended, so
a run that dies leaves no load generator behind.
"""

from __future__ import annotations

import ctypes
import http.client
import json
import os
import signal
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.traffic import Mix, bind, params_key  # noqa: E402

# a request that takes longer than this has hung: it is recorded as failed
REQUEST_TIMEOUT_S = 300.0


def post(port: int, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=REQUEST_TIMEOUT_S)
    try:
        conn.request("POST", "/query", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def run_client(k: int, mix: Mix, cfg: dict, start: threading.Barrier, box: dict,
               out: list) -> None:
    bodies = {}
    gen = mix.requests(k)
    stream_len = len(mix.spec["streams"][k]) if "streams" in mix.spec else 0
    start.wait()
    deadline = box["t0"] + cfg["seconds"]
    i = 0
    while True:
        shape, params, n_pass = next(gen)
        now = time.monotonic()
        if now >= deadline and not (mix.finish_pass and i % max(stream_len, 1)):
            break
        key = params_key(shape, params)
        rid = f"{k}-{i}"
        body = bodies.get(key)
        if body is None:
            body = bodies[key] = json.dumps(
                {"plan": bind(mix.queries[shape], params)}).encode()
        rec = {"id": rid, "client": k, "shape": shape, "params": params,
               "key": key, "pass": n_pass}
        t_send = time.monotonic()
        try:
            status, reply = post(cfg["port"], body)
        except (OSError, http.client.HTTPException, ValueError) as e:
            status, reply = 0, {"error": f"{type(e).__name__}: {e}"}
        rec["t_send"], rec["t_done"] = t_send, time.monotonic()
        rec["status"] = status
        if status == 200:
            rec["columns"] = reply["columns"]
            rec["wall_seconds"] = reply["summary"]["wall_seconds"]
            rec["retries"] = reply["summary"]["retries"]
        else:
            rec["error"] = str(reply.get("error", reply))[:500]
        out.append(rec)
        i += 1


PR_SET_PDEATHSIG = 1


def die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when ``parent`` ends; exit now if
    it has ended already (this process then has another parent)."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != parent:
        sys.exit(1)


def main(cfg: dict) -> None:
    die_with_parent(cfg["parent"])
    mix = Mix(cfg["mix"], cfg["seed"])
    n = mix.clients
    box: dict = {}
    start = threading.Barrier(n + 1)
    outs = [[] for _ in range(n)]
    threads = [threading.Thread(target=run_client, args=(k, mix, cfg, start, box, outs[k]),
                                daemon=True) for k in range(n)]
    for t in threads:
        t.start()
    box["t0"] = time.monotonic()
    print(json.dumps({"t0": box["t0"]}), flush=True)
    start.wait()
    for t in threads:
        t.join()
    records = [r for o in outs for r in o]
    t1 = max((r["t_done"] for r in records), default=box["t0"])
    print(json.dumps({"t0": box["t0"], "t1": t1, "records": records}), flush=True)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
