"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point.
At first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``tiflash_tpu_torch/build/`` (named by the hash of source
and flags, so an edited source rebuilds) and loaded with ``ctypes``.
``build_libraries`` builds several sources at once, one ``nvcc`` process
each.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when it was
# already on disk); read by chip_smoke.py
BUILD_SECONDS: Dict[str, float] = {}
# what nvcc printed while building (register and shared-memory use)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by the hash of source and
    flags, so an edited source rebuilds."""
    text = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_libraries(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build every ``csrc/<name>.cu`` that is not on disk yet, one
    ``nvcc`` per source, all started together, then load them all."""
    todo = [n for n in dict.fromkeys(names) if n not in _LOADED]
    jobs = []
    for name in todo:
        lib_path = _lib_path(name)
        BUILD_SECONDS[name] = 0.0
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib_path, tmp, proc, time.perf_counter()))
    failed = []
    try:
        for name, lib_path, tmp, proc, t0 in jobs:
            BUILD_LOG[name] = proc.communicate()[0]
            BUILD_SECONDS[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"nvcc failed on csrc/{name}.cu "
                              f"({proc.returncode}):\n{BUILD_LOG[name]}")
            else:
                os.replace(tmp, lib_path)  # atomic: no half-written library
    finally:
        for _, _, tmp, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in todo:
        _LOADED[name] = ctypes.CDLL(str(_lib_path(name)))
    return {n: _LOADED[n] for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    return build_libraries([name])[name]


__all__ = ["load_library", "build_libraries", "BUILD_SECONDS", "BUILD_LOG",
           "BUILD_DIR"]
