"""Build and load the port's hand-written CUDA kernels.

Each fixed kernel is one ``csrc/<name>.cu`` file with a plain C entry
point; a generated kernel is a source text made at run time (the fused
scan's kernel of one plan, ``ops/cuda/stream_tile.py``), written to
``tiflash_tpu_torch/build/``.  Either is compiled at first use with
``nvcc`` for ``sm_90a`` (``-I csrc``, so both may include the shared
headers) into a shared library under ``tiflash_tpu_torch/build/`` named by
the hash of source text, the ``csrc`` headers and flags, so an edit
rebuilds, and loaded with ``ctypes``.  ``build_libraries`` builds several
sources at once, one ``nvcc`` process each, under a module lock: service
threads that meet the same new plan shape at once build it once.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC))

_LOADED: Dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()
# seconds each library took to build in this process (0.0 when it was
# already on disk), by name (``stream_agg``) or, for a generated source,
# ``<prefix>-<tag>``; read by chip_smoke.py
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


@functools.lru_cache(maxsize=1)
def _headers() -> bytes:
    """The shared headers' text (read once per process)."""
    return b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))


def source_tag(text: str) -> str:
    """The hash that names a library: source text, headers and flags
    (the flags without the checkout's own include path)."""
    flags = " ".join(NVCC_FLAGS[:-2]).encode()
    return hashlib.sha256(text.encode() + _headers() + flags).hexdigest()[:16]


def _lib_path(key: str, text: str) -> Path:
    return BUILD_DIR / f"lib{key}-{source_tag(text)}.so"


def _build(jobs_in: Sequence[Tuple[str, Path, str]]) -> None:
    """Build every (key, source path, text) whose library is not on disk
    yet, one ``nvcc`` per source, all started together."""
    jobs = []
    for key, src, text in jobs_in:
        lib_path = _lib_path(key, text)
        BUILD_SECONDS[key] = 0.0
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((key, src, lib_path, tmp, proc, time.perf_counter()))
    failed = []
    try:
        for key, src, lib_path, tmp, proc, t0 in jobs:
            BUILD_LOG[key] = proc.communicate()[0]
            BUILD_SECONDS[key] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src} ({proc.returncode}):\n"
                              f"{BUILD_LOG[key]}")
            else:
                os.replace(tmp, lib_path)  # atomic: no half-written library
    finally:
        for _, _, _, tmp, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


def _generated(prefix: str, text: str) -> Tuple[str, Path, str]:
    """Write a generated source under BUILD_DIR: (key, path, text)."""
    key = f"{prefix}-{source_tag(text)}"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"{key}.cu"
    if not path.exists() or path.read_text() != text:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".cu")
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return key, path, text


def build_libraries(names: Sequence[str] = (),
                    generated: Sequence[Tuple[str, str]] = ()) -> Dict[str, ctypes.CDLL]:
    """Build every ``csrc/<name>.cu`` of ``names`` and every generated
    ``(prefix, text)`` that is not on disk yet, one ``nvcc`` per source,
    all started together, then load them all.  Returns the libraries by
    name and by generated key (``<prefix>-<tag>``)."""
    with _BUILD_LOCK:
        return _build_libraries(names, generated)


def _build_libraries(names, generated) -> Dict[str, ctypes.CDLL]:
    jobs = []
    for name in dict.fromkeys(names):
        if name not in _LOADED:
            src = CSRC / f"{name}.cu"
            jobs.append((name, src, src.read_text()))
    for prefix, text in generated:
        key = f"{prefix}-{source_tag(text)}"
        if key not in _LOADED and all(j[0] != key for j in jobs):
            jobs.append(_generated(prefix, text))
    _build(jobs)
    for key, _, text in jobs:
        _LOADED[key] = ctypes.CDLL(str(_lib_path(key, text)))
    keys = list(names) + [f"{p}-{source_tag(t)}" for p, t in generated]
    return {k: _LOADED[k] for k in keys}


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    return build_libraries([name])[name]


def build_generated(prefix: str, text: str) -> ctypes.CDLL:
    """Build a generated source if needed and load it (once per process)."""
    key = f"{prefix}-{source_tag(text)}"
    return build_libraries(generated=[(prefix, text)])[key]


__all__ = ["load_library", "build_libraries", "build_generated", "source_tag",
           "BUILD_SECONDS", "BUILD_LOG", "BUILD_DIR", "CSRC"]
