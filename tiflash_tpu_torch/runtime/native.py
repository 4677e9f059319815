"""Build and load the port's host C++ libraries (``native/*.cpp``).

Each library is compiled with ``g++`` at first use into
``tiflash_tpu_torch/build/``, named by the hash of its source and flags
(an edit rebuilds), never next to its source, and loaded with
``ctypes``.  A failed build raises: the spiller and the loader have no
other implementation.  Two processes that build at once each write a
temporary file and rename it into place, so neither loads half a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence, Tuple

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path(src: Path, stem: str, link: Sequence[str] = ()) -> Path:
    text = src.read_bytes() + " ".join(FLAGS + tuple(link)).encode()
    return BUILD_DIR / f"lib{stem}-{hashlib.sha256(text).hexdigest()[:16]}.so"


def _build(src: Path, path: Path, link: Sequence[str]) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, str(src), "-o", tmp, *link],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: no half-written library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(src: Path, stem: str, link: Sequence[str] = ()) -> Tuple[ctypes.CDLL, float]:
    """Build ``src`` if its library is not on disk, load it; returns the
    library and the seconds the build took (0.0 when it was on disk).
    Callers hold their own lock and keep the library."""
    path = library_path(src, stem, link)
    t0 = time.perf_counter()
    built = not path.exists()
    if built:
        _build(src, path, link)
    return ctypes.CDLL(str(path)), (time.perf_counter() - t0) if built else 0.0


__all__ = ["load", "library_path", "NATIVE_DIR", "BUILD_DIR", "FLAGS"]
