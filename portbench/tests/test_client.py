"""The load generator ends with the run that started it, however the run
ended: a run that crashes or is killed leaves no process behind."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

CLIENT = Path(__file__).resolve().parents[1] / "client.py"

# starts the load generator against a port where nothing listens (every
# request fails at once, so it would run its whole window), prints its
# pid and waits to be killed
PARENT = f"""
import json, os, subprocess, sys, time
cfg = {{"port": 9, "mix": "shapes22_1client", "seed": 1, "seconds": 120,
        "parent": os.getpid()}}
p = subprocess.Popen([sys.executable, {str(CLIENT)!r}, json.dumps(cfg)],
                     stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
p.stdout.readline()
print(p.pid, flush=True)
time.sleep(600)
"""


def running(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError):
        return False
    return state != "Z"


@pytest.mark.parametrize("sig", [signal.SIGKILL, signal.SIGSEGV])
def test_load_generator_ends_with_its_run(sig):
    parent = subprocess.Popen([sys.executable, "-c", PARENT], stdout=subprocess.PIPE, text=True)
    try:
        child = int(parent.stdout.readline())
        assert running(child)
        os.kill(parent.pid, sig)
        parent.wait(timeout=30)
        deadline = time.monotonic() + 10
        while running(child) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not running(child)
    finally:
        if parent.poll() is None:
            parent.kill()
            parent.wait()


def test_load_generator_started_by_a_process_already_gone_exits():
    cfg = {"port": 9, "mix": "shapes22_1client", "seed": 1, "seconds": 120,
           "parent": 2 ** 22 + 1}
    out = subprocess.run([sys.executable, str(CLIENT), json.dumps(cfg)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 1 and out.stdout == ""


def children(pid: int):
    try:
        return [int(c) for c in Path(f"/proc/{pid}/task/{pid}/children").read_text().split()]
    except FileNotFoundError:
        return []


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGKILL])
def test_a_run_ended_in_its_window_leaves_no_load_generator(sig):
    """``run.py`` ended from outside while its load generator runs: no
    result, and the load generator is gone."""
    run = subprocess.Popen([sys.executable, str(CLIENT.parent / "run.py"), "--workload",
                            "tpch_sf10.shapes22_1client", "--seed", "3", "--seconds", "120",
                            "--rehearse", "0.01"],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 240
        while not children(run.pid) and time.monotonic() < deadline and run.poll() is None:
            time.sleep(0.1)
        (client,) = children(run.pid)
        time.sleep(2)   # inside the window
        os.kill(run.pid, sig)
        out, err = run.communicate(timeout=60)
        assert run.returncode == (128 + sig if sig == signal.SIGTERM else -sig), (run.returncode, err[-3000:])
        assert out == ""
        deadline = time.monotonic() + 10
        while running(client) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not running(client)
    finally:
        if run.poll() is None:
            run.kill()
            run.wait()
