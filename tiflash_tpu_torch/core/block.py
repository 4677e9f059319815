"""Columnar batch types: ``Column`` and ``Block``, over torch tensors.

Counterpart of ``tiflash_tpu/core/block.py``.  The same contracts hold:

- a column is a fixed-width tensor plus an optional validity mask
  (True == value present);
- a block has a fixed row capacity and an optional lazy selection mask
  ``sel``; rows where ``sel`` is False are dead and every consumer
  ignores them;
- ``Column.stats`` is an invariant: every live value lies in
  ``[vmin, vmax]``.  Transformations drop it unless they re-supply it.

Every tensor lives on the device its producer put it on; the block keeps
no device of its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .dtypes import DataType


# torch's unsigned 16/32/64-bit tensors support few operations on CUDA
# (no indexing, no cat): code that only moves values moves their signed
# bit patterns
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def signed_bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or an unsigned tensor's bits as the signed type of
    its width (a view)."""
    v = _SIGNED_VIEW.get(t.dtype)
    return t if v is None else t.view(v)


def as_dtype_bits(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``signed_bits``: ``t``'s bits viewed as ``dtype``."""
    return t.view(dtype) if dtype in _SIGNED_VIEW else t


@dataclasses.dataclass
class Column:
    """One column: fixed-width values + optional validity mask.

    ``data``       tensor (n,) of the physical dtype, (n, L) int64 limbs
                   for a wide decimal, or (n, dims) float32 for a VECTOR.
    ``validity``   optional bool tensor (n,); None means all valid.
    ``dictionary`` for STRING columns, the sorted tuple of strings the
                   int32 codes index.
    ``stats``      (vmin, vmax) of the live physical values, host ints.
    ``narrow32``   int32 shadow of ``data`` of length ``capacity``, set
                   only when ``stats`` prove the range fits [0, 2^31).
                   Rows outside the range (dead or NULL) hold wrapped
                   values; consumers mask them.
    ``domain``     exact host-known value set (sorted tuple).
    ``ndv``        proven upper bound on the number of distinct values.
    ``concat_sep`` set on a ``group_concat`` result: ``data`` is then
                   (n, max_items) dictionary codes and ``validity`` the
                   matching item mask; a row decodes to its valid items
                   joined with this separator (NULL when it has none).
    """

    data: torch.Tensor
    validity: Optional[torch.Tensor] = None
    dtype: DataType = dataclasses.field(default=None)  # type: ignore[assignment]
    dictionary: Optional[Tuple[str, ...]] = None
    stats: Optional[Tuple[int, int]] = None
    narrow32: Optional[torch.Tensor] = None
    domain: Optional[Tuple[int, ...]] = None
    ndv: Optional[int] = None
    concat_sep: Optional[str] = None

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def valid_mask(self) -> torch.Tensor:
        """Always-materialized bool mask (all-True if validity is None)."""
        if self.validity is None:
            return torch.ones(self.data.shape[0], dtype=torch.bool,
                              device=self.data.device)
        return self.validity

    def with_data(self, data, validity="_keep", stats=None) -> "Column":
        """New data, same metadata; ``stats`` must be re-supplied."""
        v = self.validity if validity == "_keep" else validity
        return Column(data=data, validity=v, dtype=self.dtype,
                      dictionary=self.dictionary, stats=stats,
                      concat_sep=self.concat_sep)

    def take(self, indices: torch.Tensor, fill_invalid: bool = False) -> "Column":
        """Gather rows.  With ``fill_invalid`` negative indices give NULL
        rows.  A gather only permutes or subsets values, so stats hold."""
        safe = indices.clamp(min=0).long()
        data = as_dtype_bits(signed_bits(self.data)[safe], self.data.dtype)
        validity = None if self.validity is None else self.validity[safe]
        if fill_invalid:
            ok = indices >= 0
            validity = ok if validity is None else (validity & ok)
        return self.with_data(data, validity, stats=self.stats)

    def to_pylist(self, sel: Optional[np.ndarray] = None) -> list:
        """Decode to python values: strings decoded, decimals left as raw
        scaled mantissas (python ints)."""
        data = self.data.cpu().numpy()
        if self.dtype.is_wide_decimal and data.ndim == 2:
            from .wide import wide_to_host_ints

            valid = None if self.validity is None else self.validity.cpu().numpy()
            if sel is not None:
                data = data[sel]
                valid = None if valid is None else valid[sel]
            return wide_to_host_ints(data, valid)
        if data.ndim == 2 and self.concat_sep is not None:
            # a group_concat column: each row's valid dictionary items
            valid = (np.ones(data.shape, dtype=bool) if self.validity is None
                     else self.validity.cpu().numpy())
            if sel is not None:
                data = data[sel]
                valid = valid[sel]
            out = []
            for row, ok_row in zip(data.tolist(), valid.tolist()):
                items = [self.dictionary[c] for c, ok in zip(row, ok_row) if ok]
                out.append(self.concat_sep.join(items) if items else None)
            return out
        valid = (np.ones(len(data), dtype=bool) if self.validity is None
                 else self.validity.cpu().numpy())
        if sel is not None:
            data = data[sel]
            valid = valid[sel]
        if self.dtype.is_vector:
            return [tuple(row) if ok else None
                    for row, ok in zip(data.tolist(), valid.tolist())]
        out = []
        for v, ok in zip(data.tolist(), valid.tolist()):
            if not ok:
                out.append(None)
            elif self.dictionary is not None:
                out.append(self.dictionary[v])
            else:
                out.append(v)
        return out


def make_narrow32(host: np.ndarray, stats: Optional[Tuple[int, int]],
                  device) -> Optional[torch.Tensor]:
    """int32 shadow when the PROVEN range fits non-negative int31; values
    outside the range (dead/NULL slots) wrap harmlessly — consumers mask
    them.  Unpadded: the kernel masks the ragged edge itself."""
    if stats is None or stats[0] < 0 or stats[1] >= 2 ** 31:
        return None
    with np.errstate(over="ignore"):
        arr = host.astype(np.int32)
    return torch.as_tensor(arr, device=device)


def _json_order_key(s: str):
    """Total order matching MySQL JSON comparison precedence (number <
    string < object < array < boolean)."""
    import json

    def k(v):
        if v is None:
            return (0,)
        if isinstance(v, bool):
            return (6, v)
        if isinstance(v, (int, float)):
            return (1, float(v))
        if isinstance(v, str):
            return (2, v)
        if isinstance(v, dict):
            return (3, len(v),
                    tuple(sorted((kk, k(vv)) for kk, vv in v.items())))
        return (4, tuple(k(x) for x in v), len(v))

    try:
        return k(json.loads(s)) if s else (0,)
    except Exception:
        return (9, s)


def column_from_numpy(values: Sequence, dtype: DataType,
                      validity: Optional[Sequence[bool]] = None,
                      device="cuda") -> Column:
    """A Column on ``device`` from host values, with the reference's
    statistics (range, int32 shadow, exact domain of up to 4096 values
    in columns of up to 65536 rows).  STRING values are python strings,
    dictionary-encoded here by rank in their sorted set (JSON columns by
    MySQL's JSON order), so code order is string order.  A wide decimal
    takes python int mantissas."""
    def put(host):
        return torch.as_tensor(host, device=device)

    if dtype.is_vector:
        dims = dtype.precision
        rows = [np.zeros(dims, dtype=np.float32) if v is None
                else np.asarray(v, dtype=np.float32) for v in values]
        data = np.stack(rows) if rows else np.zeros((0, dims), dtype=np.float32)
        if validity is None and any(x is None for x in values):
            validity = [x is not None for x in values]
        v = None if validity is None else put(np.asarray(validity, dtype=bool))
        return Column(put(data), v, dtype)
    codes = dictionary = None
    if dtype.is_string:
        values = list(values)
        strs = ["" if s is None else s for s in values]
        uniq = sorted(set(strs), key=_json_order_key if dtype.mysql_json else None)
        rank = {s: i for i, s in enumerate(uniq)}
        codes = np.fromiter((rank[s] for s in strs), dtype=np.int32, count=len(strs))
        data = codes
        dictionary = tuple(uniq)
    elif dtype.is_wide_decimal:
        # python int mantissas -> L int64 limbs, top limb signed, the
        # others in [0, 10^18) (core/wide.py's layout)
        W18 = 10 ** 18
        L = dtype.decimal_limbs
        data = np.zeros((len(values), L), dtype=np.int64)
        for i, x in enumerate(values):
            x = 0 if x is None else int(x)
            for j in range(L - 1, 0, -1):
                data[i, j] = x % W18
                x //= W18
            data[i, 0] = x
    else:
        data = np.asarray(values, dtype=dtype.physical)
    if validity is None and dtype.is_string and any(s is None for s in values):
        validity = [s is not None for s in values]
    v = None if validity is None else put(np.asarray(validity, dtype=bool))
    stats = narrow = domain = None
    if dtype.is_string:
        narrow = make_narrow32(codes, (0, max(0, len(dictionary) - 1)), device)
    elif not dtype.is_wide_decimal:
        host = data if validity is None else data[np.asarray(validity, dtype=bool)]
        if host.size and np.issubdtype(host.dtype, np.integer):
            stats = (int(host.min()), int(host.max()))
            narrow = make_narrow32(data, stats, device)
            if host.size <= 65536:
                uniq = np.unique(host)
                if uniq.size <= 4096:
                    domain = tuple(int(x) for x in uniq)
        elif host.size and np.issubdtype(host.dtype, np.floating) \
                and np.isfinite(host).all():
            # the integer envelope of a float column (the rounded
            # int-LUT string producers over doubles read it)
            stats = (int(np.floor(host.min() + 0.5)) - 1,
                     int(np.floor(host.max() + 0.5)) + 1)
            if host.size <= 65536:
                uniq = np.unique(host)
                if uniq.size <= 4096:
                    domain = tuple(float(x) for x in uniq)
    return Column(put(data), v, dtype, dictionary, stats=stats, narrow32=narrow,
                  domain=domain)


@dataclasses.dataclass
class Block:
    """An ordered set of equal-length named columns + optional row mask."""

    names: Tuple[str, ...]
    columns: Tuple[Column, ...]
    sel: Optional[torch.Tensor] = None  # bool (n,) or None == all rows live
    # rows with equal values in these columns are adjacent
    clustered_by: Tuple[str, ...] = ()

    @staticmethod
    def from_dict(cols: Dict[str, Column], sel=None) -> "Block":
        return Block(names=tuple(cols.keys()), columns=tuple(cols.values()), sel=sel)

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def __getitem__(self, name: str) -> Column:
        try:
            return self.columns[self.names.index(name)]
        except ValueError:
            raise KeyError(f"column {name!r} not in block {self.names}") from None

    def as_dict(self) -> Dict[str, Column]:
        return dict(zip(self.names, self.columns))

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return self.columns[0].capacity

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device

    def num_rows(self) -> torch.Tensor:
        """Live row count (a 0-d int32 tensor)."""
        if self.sel is None:
            return torch.tensor(self.capacity, dtype=torch.int32,
                                device=self.device)
        return torch.sum(self.sel, dtype=torch.int32)

    def sel_mask(self) -> torch.Tensor:
        if self.sel is None:
            return torch.ones(self.capacity, dtype=torch.bool,
                              device=self.device)
        return self.sel

    def with_sel(self, sel: Optional[torch.Tensor]) -> "Block":
        return Block(names=self.names, columns=self.columns, sel=sel,
                     clustered_by=self.clustered_by)

    def and_sel(self, mask: torch.Tensor) -> "Block":
        """Narrow the selection (a lazy filter; clustering survives)."""
        new = mask if self.sel is None else (self.sel & mask)
        return self.with_sel(new)

    def select(self, names: Sequence[str]) -> "Block":
        missing = [n for n in names if n not in self.names]
        if missing:
            raise KeyError(f"columns {missing} not in block {list(self.names)}")
        cols = self.as_dict()
        kept = self.clustered_by
        if kept and any(k not in names for k in kept):
            # clustering by a prefix still holds if only a suffix is dropped
            keep_n = 0
            for k in kept:
                if k in names:
                    keep_n += 1
                else:
                    break
            kept = kept[:keep_n]
        return Block(
            names=tuple(names),
            columns=tuple(cols[n] for n in names),
            sel=self.sel,
            clustered_by=kept,
        )

    def with_column(self, name: str, col: Column) -> "Block":
        d = self.as_dict()
        d[name] = col
        kept = self.clustered_by
        if name in kept:
            kept = kept[: kept.index(name)]
        return Block(names=tuple(d.keys()), columns=tuple(d.values()),
                     sel=self.sel, clustered_by=kept)

    def take(self, indices: torch.Tensor, fill_invalid: bool = False) -> "Block":
        """Gather rows by index into a new block (sel dropped)."""
        cols = tuple(c.take(indices, fill_invalid) for c in self.columns)
        return Block(names=self.names, columns=cols, sel=None)

    def compact(self) -> "Block":
        """Pack live rows to the front, in order (same capacity); rows at
        or past the live count are dead."""
        if self.sel is None:
            return self
        from ..ops.merge import flagged_positions

        n = self.capacity
        count = torch.sum(self.sel, dtype=torch.int32)
        out = self.take(flagged_positions(self.sel, n).clamp(min=0))
        out = dataclasses.replace(out, clustered_by=self.clustered_by)
        return out.with_sel(torch.arange(n, dtype=torch.int32,
                                         device=self.sel.device) < count)

    def to_pylists(self) -> Dict[str, list]:
        """Decode live rows to python lists (host copy; tests/output).
        With a selection the live rows are first gathered, in order, on
        the block's own device, so dead slots never cross to the host.
        The gather is one ``index_select`` per tensor: ``take``'s indexing
        costs several times its host time, which small results would pay."""
        cols = self.columns
        if self.sel is not None and cols:
            idx = torch.nonzero(self.sel).squeeze(1)

            def rows(t):
                return as_dtype_bits(signed_bits(t).index_select(0, idx), t.dtype)

            cols = tuple(c.with_data(rows(c.data),
                                     None if c.validity is None else rows(c.validity))
                         for c in cols)
        return {n: c.to_pylist() for n, c in zip(self.names, cols)}

    def pylists_bytes(self, rows: int) -> Dict[str, int]:
        """What ``to_pylists`` copies from the device, for a block with
        ``rows`` live rows: ``host_bytes``, the live rows' data and
        validity plus, with a selection, the live count that
        ``torch.nonzero`` reads to size the gather (counted as 8 bytes),
        and ``live_bytes``, the live rows' data and validity alone."""
        row_bytes = 0
        for c in self.columns:
            row_bytes += c.data.element_size() * math.prod(c.data.shape[1:])
            if c.validity is not None:
                row_bytes += c.validity.element_size() * math.prod(c.validity.shape[1:])
        live = rows * row_bytes
        return {"host_bytes": live + (0 if self.sel is None else 8),
                "live_bytes": live}


__all__ = ["Column", "Block", "make_narrow32", "column_from_numpy", "signed_bits",
           "as_dtype_bits"]
