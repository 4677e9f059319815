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
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .dtypes import DataType


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
        if self.data.dtype == torch.uint64:
            # CUDA torch cannot index uint64: gather the int64 bit patterns
            data = self.data.view(torch.int64)[safe].view(torch.uint64)
        else:
            data = self.data[safe]
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
        """Decode live rows to python lists (host copy; tests/output)."""
        sel = None if self.sel is None else self.sel.cpu().numpy()
        return {n: c.to_pylist(sel) for n, c in zip(self.names, self.columns)}


__all__ = ["Column", "Block", "make_narrow32"]
