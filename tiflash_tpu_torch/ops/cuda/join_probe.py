"""The unique join's probe by direct addressing, with the gather of the
matched build rows: the position table's kernel.

Replaces no TPU kernel: the JAX reference probes a unique build with two
sorted-merge range searches (``tiflash_tpu/ops/merge.py``,
``probe_ranges_fast``) and a take per build column.  Where a build key's
range stats prove a dense span, ``ops/join.py`` also builds a position
table (``table[key - lo]``: the first sorted build position of the key,
-1 where no live build row has it), and ``join_probe`` looks each probe
key up in it and gathers every 1-D payload column in one pass of the
hand-written CUDA kernel ``tiflash_tpu_torch/csrc/join_probe.cu``
(Hopper, ``sm_90a``).

Contract, ``join_probe(keys, key_valid, sel, table, lo, perm,
gather_sorted, columns, want_bidx) -> (matched, bidx, flags, outs)``:

- ``keys``: (n,) int32 or int64 probe keys, read at their own width;
  ``key_valid`` and ``sel``: (n,) bool or None;
- ``table``: (span,) int32, covering the keys ``[lo, lo + span)``;
  ``perm``: (m,) int32, sorted build position -> build row, m >= 1;
- ``matched``: (n,) bool, a live slot whose key the table holds;
  ``bidx``: (n,) int32 sorted position or -1 (None unless
  ``want_bidx``); ``flags``: (m,) bool, the sorted positions hit;
- ``columns``: (data, validity or None) of 1-D build columns in row
  order, elements of 1, 2, 4 or 8 bytes; each output is (data[row],
  matched & validity[row]) with ``row`` = perm[bidx] where matched, and
  where not perm[0] if ``gather_sorted`` else 0: the rows
  ``JoinBuild.take_sorted``'s two plans read for an index of -1, so
  every slot, dead ones included, equals the sorted path's.

Bound: device-memory bytes, the probe side's: key, selection and
validity read, the matched flag and each column's value and validity
written (``probe_bytes``); the build side's table, perm and columns are
read once and stay in L2 for SSB's dimensions.

``join_probe_plain`` is the same contract in plain torch; the wrapper
uses it only for CPU tensors, and a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ...core.block import as_dtype_bits, signed_bits

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
THREADS = 256
ROWS = 4             # slots a thread takes per step (csrc/join_probe.cu)
MAX_COLUMNS = 32     # payload columns one launch carries (csrc/join_probe.cu)
# blocks of THREADS threads launched per SM (a grid-stride loop covers
# the rest).  On an H100 at SSB's date, customer and part joins
# (bench/kernel_variants.py) 4 read 0.545 / 0.986 / 0.576 ms, 8 read
# 0.573 / 1.122 / 0.666 and 16 read 0.502 / 1.058 / 0.594: 16 wins only
# at the date join, 4 has the lowest sum
BLOCKS_PER_SM = 4

_lib = None

Columns = Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]
Result = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
               List[Tuple[torch.Tensor, torch.Tensor]]]


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load_library

        lib = load_library("join_probe")
        c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.join_probe_launch.argtypes = [
            c_ptr, c_int, c_ptr, c_ptr, c_ptr, c_ll, c_ll, c_ptr, c_int,
            c_ptr, c_ptr, c_ptr, c_ll, c_int, c_ptr, c_ptr, c_int, c_int, c_ptr]
        lib.join_probe_launch.restype = c_int
        _lib = lib
    return _lib


def _check(keys, key_valid, sel, table, perm, columns) -> None:
    if keys.dim() != 1 or keys.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"keys must be 1-D int32 or int64, got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    n = keys.shape[0]
    for t in (key_valid, sel):
        if t is not None and (t.dtype != torch.bool or tuple(t.shape) != (n,)):
            raise ValueError(f"masks must be ({n},) bool")
    if table.dtype != torch.int32 or table.dim() != 1 or table.shape[0] < 1:
        raise ValueError("table must be a non-empty 1-D int32 tensor")
    if perm.dtype != torch.int32 or perm.dim() != 1 or perm.shape[0] < 1:
        raise ValueError("perm must be a non-empty 1-D int32 tensor")
    for data, valid in columns:
        if data.dim() != 1 or data.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"payload columns must be 1-D of 1, 2, 4 or 8-byte "
                             f"elements, got {data.dtype} {tuple(data.shape)}")
        if valid is not None and tuple(valid.shape) != tuple(data.shape):
            raise ValueError("a payload column's validity must match its data")
    devices = {t.device for t in (keys, key_valid, sel, table, perm) if t is not None}
    devices |= {t.device for c in columns for t in c if t is not None}
    if len(devices) != 1:
        raise ValueError("all inputs must be on one device")


def join_probe(keys: torch.Tensor, key_valid: Optional[torch.Tensor],
               sel: Optional[torch.Tensor], table: torch.Tensor, lo: int,
               perm: torch.Tensor, gather_sorted: bool, columns: Columns,
               want_bidx: bool) -> Result:
    """Look each probe key up in the position table and gather the
    matched build rows' columns (the module's contract).  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if keys.device.type == "cpu":
        return join_probe_plain(keys, key_valid, sel, table, lo, perm, gather_sorted,
                                columns, want_bidx)
    columns = list(columns)
    _check(keys, key_valid, sel, table, perm, columns)
    if keys.device.type != "cuda":
        raise RuntimeError(f"no join_probe kernel for device {keys.device}")
    tensors = [keys, key_valid, sel, table, perm] + [t for c in columns for t in c]
    if not all(t.is_contiguous() for t in tensors if t is not None):
        raise ValueError("join_probe kernel takes contiguous tensors")
    n, dev = keys.shape[0], keys.device
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    bidx = torch.empty(n, dtype=torch.int32, device=dev) if want_bidx else None
    flags = torch.zeros(perm.shape[0], dtype=torch.bool, device=dev)
    outs = [(torch.empty(n, dtype=d.dtype, device=dev),
             torch.empty(n, dtype=torch.bool, device=dev)) for d, _ in columns]
    if n == 0:
        return matched, bidx, flags, outs
    lib = _kernel_lib()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(-(-n // (THREADS * ROWS)), n_sm * BLOCKS_PER_SM)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    global LAUNCHES
    # more columns than one launch carries: again over the next ones
    for c0 in range(0, max(1, len(columns)), MAX_COLUMNS):
        part = list(zip(columns[c0:c0 + MAX_COLUMNS], outs[c0:c0 + MAX_COLUMNS]))
        ptrs = (ctypes.c_longlong * max(1, 4 * len(part)))(
            *[p for (d, v), (od, ov) in part for p in (ptr(d), ptr(v), ptr(od), ptr(ov))])
        widths = (ctypes.c_int * max(1, len(part)))(*[d.element_size() for (d, _), _ in part])
        rc = lib.join_probe_launch(
            keys.data_ptr(), keys.element_size(), ptr(key_valid), ptr(sel), table.data_ptr(),
            lo, lo + table.shape[0] - 1, perm.data_ptr(), int(gather_sorted),
            matched.data_ptr(), ptr(bidx) if c0 == 0 else 0, flags.data_ptr() if c0 == 0 else 0,
            n, len(part), ptrs, widths, blocks, THREADS, stream)
        if rc != 0:
            raise RuntimeError(f"join_probe kernel launch failed: cudaError {rc}")
        LAUNCHES += 1
    return matched, bidx, flags, outs


def join_probe_plain(keys: torch.Tensor, key_valid: Optional[torch.Tensor],
                     sel: Optional[torch.Tensor], table: torch.Tensor, lo: int,
                     perm: torch.Tensor, gather_sorted: bool, columns: Columns,
                     want_bidx: bool) -> Result:
    """Plain torch version of ``join_probe``, on any device (the
    reference for the kernel)."""
    columns = list(columns)
    _check(keys, key_valid, sel, table, perm, columns)
    n, dev = keys.shape[0], keys.device
    k = keys.to(torch.int64)
    live = torch.ones(n, dtype=torch.bool, device=dev) if sel is None else sel
    if key_valid is not None:
        live = live & key_valid
    # compared in 64 bits before the subtraction, which then cannot wrap
    inside = live & (k >= lo) & (k <= lo + table.shape[0] - 1)
    pos = table[torch.where(inside, k - lo, torch.zeros_like(k))]
    matched = inside & (pos >= 0)
    bidx = torch.where(matched, pos, torch.full_like(pos, -1))
    m = perm.shape[0]
    hit = torch.zeros(m + 1, dtype=torch.bool, device=dev)
    hit[torch.where(matched, bidx.long(), torch.full_like(k, m))] = True
    unmatched = perm[:1].long() if gather_sorted else torch.zeros(1, dtype=torch.int64,
                                                                    device=dev)
    row = torch.where(matched, perm[bidx.clamp(min=0).long()].long(), unmatched)
    outs = []
    for data, valid in columns:
        got = as_dtype_bits(signed_bits(data)[row], data.dtype)
        outs.append((got, matched.clone() if valid is None else matched & valid[row]))
    return matched, bidx if want_bidx else None, hit[:m], outs


def probe_bytes(n: int, key_bytes: int, has_sel: bool, has_valid: bool,
                column_bytes: Sequence[int]) -> int:
    """The probe side's device-memory bytes of one call: the bound's
    numerator."""
    return n * (key_bytes + int(has_sel) + int(has_valid) + 1
                + sum(b + 1 for b in column_bytes))


__all__ = ["join_probe", "join_probe_plain", "probe_bytes", "LAUNCHES", "MAX_COLUMNS"]
