"""Disk spill tier for the host out-of-core driver.

Counterpart of ``tiflash_tpu/runtime/spill.py``.  Role analog:
``Core/Spiller.h:87`` / ``Core/SpillHandler.h``, partition-wise spill
files of compressed blocks with background IO.  Kernels never spill
mid-flight; the host driver (``runtime/outofcore.py``) stages partition
buffers, and when ``Settings.spill_dir`` is set those buffers go through
the port's own copy of the native spiller (``native/spiller.cpp``: zlib
chunks, CRC-checked, a background writer pool) instead of host RAM.

The library is built at first use with ``g++ ... -lz`` into
``tiflash_tpu_torch/build/``, named by the hash of its source and flags
(an edit rebuilds), never next to the source.  A failed build raises:
there is no other spill implementation.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import native

_SRC = native.NATIVE_DIR / "spiller.cpp"
_LINK = ("-lz",)

_lock = threading.Lock()
_lib = None
# seconds the library took to build in this process (0.0 when it was on
# disk already); None until first use
BUILD_SECONDS: Optional[float] = None


def library_path() -> Path:
    return native.library_path(_SRC, "tflspill", _LINK)


def get_lib() -> ctypes.CDLL:
    global _lib, BUILD_SECONDS
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = native.load(_SRC, "tflspill", _LINK)
        lib.spl_open.restype = ctypes.c_void_p
        lib.spl_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.spl_write.restype = ctypes.c_int
        lib.spl_write.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int]
        lib.spl_sync.restype = ctypes.c_int
        lib.spl_sync.argtypes = [ctypes.c_void_p]
        lib.spl_chunk_raw_size.restype = ctypes.c_int64
        lib.spl_chunk_raw_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.spl_read.restype = ctypes.c_int64
        lib.spl_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.spl_stats.restype = None
        lib.spl_stats.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.POINTER(ctypes.c_uint64)]
        lib.spl_close.restype = None
        lib.spl_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return lib


class Spiller:
    """One spill scope.  Arrays spill as compressed chunks; their dtype
    and shape stay on the host here."""

    def __init__(self, directory: str, nthreads: int = 0):
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._lib = get_lib()
        self._h = self._lib.spl_open(directory.encode(), nthreads)
        if not self._h:
            raise IOError(f"cannot open spill dir {directory}")
        self._meta: Dict[int, Tuple[str, Tuple[int, ...]]] = {}
        self._closed = False

    def spill_array(self, arr: np.ndarray, partition: int = 0) -> int:
        a = np.ascontiguousarray(arr)
        cid = self._lib.spl_write(
            self._h, partition, a.ctypes.data_as(ctypes.c_void_p), a.nbytes, 1)
        if cid < 0:
            raise IOError("spill write failed")
        self._meta[cid] = (str(a.dtype), a.shape)
        return cid

    def restore_array(self, chunk_id: int) -> np.ndarray:
        dt, shape = self._meta[chunk_id]
        raw = self._lib.spl_chunk_raw_size(self._h, chunk_id)
        if raw < 0:
            raise IOError(f"spill chunk {chunk_id} failed or corrupt")
        out = np.empty(raw, dtype=np.uint8)
        got = self._lib.spl_read(self._h, chunk_id,
                                 out.ctypes.data_as(ctypes.c_void_p))
        if got != raw:
            raise IOError(f"spill chunk {chunk_id} corrupt (CRC/size)")
        return out.view(np.dtype(dt)).reshape(shape)

    def sync(self) -> None:
        if self._lib.spl_sync(self._h) != 0:
            raise IOError("background spill write failed")

    def stats(self) -> Tuple[int, int]:
        """(raw bytes, compressed bytes) written so far."""
        raw = ctypes.c_uint64()
        comp = ctypes.c_uint64()
        self._lib.spl_stats(self._h, ctypes.byref(raw), ctypes.byref(comp))
        return raw.value, comp.value

    def close(self, remove_files: bool = True) -> None:
        if not self._closed:
            self._lib.spl_close(self._h, 1 if remove_files else 0)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class PartStore:
    """Per-partition host row buffers of the out-of-core driver.  With a
    spill directory each part's arrays stream to disk through the
    spiller and restore at merge time; without one they stay in host
    RAM."""

    def __init__(self, spill_dir: str = "", nthreads: int = 0):
        self._spiller: Optional[Spiller] = (
            Spiller(spill_dir, nthreads) if spill_dir else None)
        self._parts: List = []
        self._chunks = 0

    def add(self, names: Tuple[str, ...], arrays: List[np.ndarray],
            partition: int = 0) -> None:
        from .metrics import METRICS

        METRICS.counter("spill_parts_total").inc()
        METRICS.counter("spill_bytes_total").inc(
            sum(int(a.nbytes) for a in arrays if a is not None))
        if self._spiller is None:
            self._parts.append((names, arrays))
            return
        METRICS.counter("spill_files_total").inc()
        cids = [None if a is None else self._spiller.spill_array(a, partition)
                for a in arrays]
        self._chunks += sum(c is not None for c in cids)
        self._parts.append((names, cids))

    def parts(self) -> List[Tuple[Tuple[str, ...], List[np.ndarray]]]:
        if self._spiller is None:
            return self._parts
        self._spiller.sync()
        return [(names, [None if c is None else self._spiller.restore_array(c)
                         for c in cids])
                for names, cids in self._parts]

    def stats(self) -> Tuple[int, int]:
        return (0, 0) if self._spiller is None else self._spiller.stats()

    def close(self) -> None:
        if self._spiller is not None and not self._spiller._closed:
            from .metrics import METRICS

            sp = self._spiller
            sp._lib.spl_sync(sp._h)  # wait for the writers; a failure raised at parts()
            METRICS.counter("spill_chunk_files_total").inc(self._chunks)
            METRICS.counter("spill_disk_bytes_total").inc(self._spiller.stats()[1])
            self._spiller.close()


__all__ = ["Spiller", "PartStore", "get_lib", "library_path"]
