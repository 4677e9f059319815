"""Host-side table provider.

Counterpart of ``tiflash_tpu/storage/catalog.py``.  Tables are built from
numpy arrays into CPU tensors; ``Catalog.blocks(device)`` hands them out
on the device the caller names (one copy per device, kept).
``Catalog.append`` adds rows, merging string dictionaries.

``blocks_from_numpy`` builds port Blocks from plain numpy arrays and type
descriptors — the form ``testing/bridge.py:export_blocks`` produces — so a
table from any other engine can be carried across without this package
importing that engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.block import Block, Column, make_narrow32
from ..core.dtypes import DataType, TypeKind


def column_from_arrays(
    data: np.ndarray,
    dtype: DataType,
    validity: Optional[np.ndarray] = None,
    dictionary: Optional[Tuple[str, ...]] = None,
) -> Column:
    """CPU column from numpy, with the reference's stats rules.

    STRING columns take int32 codes + the sorted dictionary.  Integer
    columns get (vmin, vmax) range stats, and an int32 shadow when the
    range fits [0, 2^31)."""
    cpu = torch.device("cpu")
    stats = None
    narrow = None
    if dtype.is_string:
        assert dictionary is not None, "string columns need a dictionary"
        assert data.dtype == np.int32
        narrow = make_narrow32(data, (0, max(0, len(dictionary) - 1)), cpu)
    else:
        data = np.ascontiguousarray(data, dtype=dtype.physical)
        if data.size and np.issubdtype(data.dtype, np.integer):
            stats = (int(data.min()), int(data.max()))
            narrow = make_narrow32(data, stats, cpu)
    v = None if validity is None else torch.as_tensor(
        np.ascontiguousarray(validity, dtype=bool), device=cpu)
    return Column(torch.as_tensor(data, device=cpu), v, dtype, dictionary,
                  stats=stats, narrow32=narrow)


def encode_strings(values: np.ndarray) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Sort-order dictionary encoding of a numpy string array."""
    uniq, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int32), tuple(uniq.tolist())


def _merge_dictionaries(a: Column, b: Column):
    """Re-encode two dictionary string columns into one merged sorted
    dictionary (codes stay order-preserving)."""
    da = a.dictionary or ()
    db = b.dictionary or ()
    merged = tuple(sorted(set(da) | set(db)))
    rank = {s: i for i, s in enumerate(merged)}

    def remap(col, src):
        table = torch.tensor([rank[s] for s in src] or [0], dtype=torch.int32,
                             device=col.data.device)
        data = table[col.data.clamp(0, max(len(src) - 1, 0)).long()]
        return Column(data, col.validity, col.dtype, merged)

    return remap(a, da), remap(b, db)


def _to_device(block: Block, device) -> Block:
    def mv(t):
        return None if t is None else t.to(device)

    cols = tuple(dataclasses.replace(c, data=mv(c.data), validity=mv(c.validity),
                                     narrow32=mv(c.narrow32))
                 for c in block.columns)
    return dataclasses.replace(block, columns=cols, sel=mv(block.sel))


@dataclasses.dataclass
class TableDef:
    name: str
    block: Block
    schema: Dict[str, DataType]
    unique_keys: Tuple[Tuple[str, ...], ...] = ()
    row_count: int = 0


class Catalog:
    """In-memory schema + data registry."""

    def __init__(self):
        self.tables: Dict[str, TableDef] = {}
        self._on_device: Dict[Tuple[str, str], Block] = {}

    def register(
        self,
        name: str,
        columns: Dict[str, Column],
        unique_keys: Sequence[Sequence[str]] = (),
        clustered_by: Sequence[str] = (),
    ) -> TableDef:
        """``clustered_by``: rows with equal values in these columns are
        adjacent.  Key columns get an exact NDV, as in the reference."""
        block = Block.from_dict(columns)
        if clustered_by:
            block = dataclasses.replace(block, clustered_by=tuple(clustered_by))
        ndvs: Dict[str, int] = {}
        for uk in unique_keys:
            if len(uk) == 1 and uk[0] in block.names:
                ndvs[uk[0]] = block.capacity
        lead = tuple(clustered_by)[:1]
        if lead and lead[0] in block.names and lead[0] not in ndvs:
            c = block[lead[0]]
            if c.data.ndim == 1 and not c.dtype.is_string:
                host = c.data.numpy()
                if host.size:
                    ndvs[lead[0]] = int((host[1:] != host[:-1]).sum()) + 1
        if ndvs:
            cols2 = {n: (dataclasses.replace(c, ndv=ndvs[n])
                         if n in ndvs else c)
                     for n, c in zip(block.names, block.columns)}
            block = dataclasses.replace(
                block, columns=tuple(cols2[n] for n in block.names))
        td = TableDef(
            name=name,
            block=block,
            schema={n: c.dtype for n, c in columns.items()},
            unique_keys=tuple(tuple(k) for k in unique_keys),
            row_count=block.capacity,
        )
        self.tables[name] = td
        self._on_device = {k: v for k, v in self._on_device.items()
                           if k[0] != name}
        return td

    def append(self, name: str, columns: Dict[str, Column]) -> TableDef:
        """Append rows to a table (host-side block concatenation; string
        dictionaries merge order-preservingly).  The appended table has
        no stats and no clustering, as the reference's."""
        td = self.tables[name]
        new_block = Block.from_dict(columns)
        merged_cols: Dict[str, Column] = {}
        for cname in td.block.names:
            a = td.block[cname]
            b = new_block[cname]
            if a.dtype.is_string:
                a, b = _merge_dictionaries(a, b)
            data = torch.cat([a.data, b.data])
            if a.validity is None and b.validity is None:
                validity = None
            else:
                validity = torch.cat([a.valid_mask(), b.valid_mask()])
            merged_cols[cname] = Column(data, validity, a.dtype, a.dictionary)
        # appended rows break adjacency at the seam: clustering is dropped
        td.block = Block.from_dict(merged_cols)
        td.row_count = td.block.capacity
        self._on_device = {k: v for k, v in self._on_device.items()
                           if k[0] != name}
        return td

    def blocks(self, device) -> Dict[str, Block]:
        """Every table as a Block on ``device`` (copied once per device)."""
        dev = str(torch.device(device))
        out = {}
        for n, t in self.tables.items():
            key = (n, dev)
            if key not in self._on_device:
                self._on_device[key] = _to_device(t.block, device)
            out[n] = self._on_device[key]
        return out

    def __getitem__(self, name: str) -> TableDef:
        return self.tables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tables


def _dtype_from_desc(desc: dict) -> DataType:
    return DataType(TypeKind[desc["kind"]], nullable=bool(desc["nullable"]),
                    precision=int(desc["precision"]), scale=int(desc["scale"]),
                    tz_aware=bool(desc.get("tz_aware", False)),
                    mysql_json=bool(desc.get("mysql_json", False)),
                    mysql_blob=int(desc.get("mysql_blob", 0)))


def blocks_from_numpy(tables: Dict[str, dict], device) -> Dict[str, Block]:
    """Port Blocks from plain numpy arrays plus type descriptors.

    ``tables`` maps a table name to ``{"names", "columns", "sel",
    "clustered_by"}``; each column is ``{"data", "validity", "dtype",
    "dictionary", "stats", "domain", "ndv"}`` with ``dtype`` a dict of ``kind``
    (a ``TypeKind`` member name), ``precision``, ``scale``, ``nullable``
    and optionally ``tz_aware``, ``mysql_json`` and ``mysql_blob``.  Stats
    and NDV are taken as given (they are invariants
    the producer proved); the int32 shadow follows the reference's rule.
    """
    out: Dict[str, Block] = {}
    for tname, tb in tables.items():
        cols = []
        for cd in tb["columns"]:
            dt = _dtype_from_desc(cd["dtype"])
            host = np.array(cd["data"])  # a writable copy
            stats = None if cd["stats"] is None else tuple(int(x) for x in cd["stats"])
            dictionary = (None if cd["dictionary"] is None
                          else tuple(cd["dictionary"]))
            if dt.is_string:
                rng = (0, max(0, len(dictionary or ()) - 1))
                narrow = make_narrow32(host, rng, device)
            elif host.ndim == 1 and np.issubdtype(host.dtype, np.integer):
                narrow = make_narrow32(host, stats, device)
            else:
                narrow = None
            v = cd["validity"]
            cols.append(Column(
                torch.as_tensor(host, device=device),
                None if v is None else torch.as_tensor(
                    np.array(v, dtype=bool), device=device),
                dt, dictionary, stats=stats, narrow32=narrow,
                domain=cd.get("domain"), ndv=cd.get("ndv")))
        sel = tb.get("sel")
        out[tname] = Block(
            names=tuple(tb["names"]), columns=tuple(cols),
            sel=None if sel is None else torch.as_tensor(
                np.array(sel, dtype=bool), device=device),
            clustered_by=tuple(tb.get("clustered_by", ())))
    return out


__all__ = ["Catalog", "TableDef", "column_from_arrays", "encode_strings",
           "blocks_from_numpy"]
