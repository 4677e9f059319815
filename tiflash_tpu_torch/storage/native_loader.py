"""ctypes bindings for the native C++ columnar loader.

Counterpart of ``tiflash_tpu/storage/native_loader.py``.  Role analog:
the host-side table-read path (DMFileReader and the IO parse helpers).
The library is the port's own copy of the loader,
``tiflash_tpu_torch/native/loader.cpp``: the same C ABI, type codes and
TFC1 cache format, so a cache written by either package loads in the
other.  It is built with ``g++`` at first use into
``tiflash_tpu_torch/build/`` (``runtime/native.py``), never next to its
source; a failed build raises.

Columns come back as host tensors (``storage/catalog.column_from_arrays``,
with its stats rules); ``load_tpch_dir`` returns a ``Catalog`` whose
``blocks(device)`` puts them on the card.  Strings are ranks in the
sorted distinct set, as ``generate_tpch``'s dictionaries are; decimals
are truncated at the scale (``1234.567`` -> ``123456`` at scale 2).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import dtypes as dt
from ..core.block import Column
from ..runtime import native
from .catalog import Catalog, column_from_arrays

_SRC = native.NATIVE_DIR / "loader.cpp"

_lock = threading.Lock()
_lib = None
# seconds the library took to build in this process (0.0 when it was on
# disk already); None until first use
BUILD_SECONDS: Optional[float] = None

# type codes shared with loader.cpp
_T_INT64, _T_DECIMAL, _T_DATE, _T_FLOAT64, _T_STRING, _T_SKIP = range(6)
_PHYSICAL = {_T_INT64: np.int64, _T_DECIMAL: np.int64, _T_DATE: np.int32,
             _T_FLOAT64: np.float64, _T_STRING: np.int32}


def library_path():
    return native.library_path(_SRC, "tflloader")


def get_lib() -> ctypes.CDLL:
    global _lib, BUILD_SECONDS
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = native.load(_SRC, "tflloader")
        vp = ctypes.c_void_p
        lib.tfl_parse_file.restype = vp
        lib.tfl_parse_file.argtypes = [
            ctypes.c_char_p, ctypes.c_char,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.tfl_num_rows.restype = ctypes.c_int64
        lib.tfl_num_rows.argtypes = [vp]
        lib.tfl_copy_column.restype = ctypes.c_int64
        lib.tfl_copy_column.argtypes = [vp, ctypes.c_int, vp]
        lib.tfl_dict_size.restype = ctypes.c_int64
        lib.tfl_dict_size.argtypes = [vp, ctypes.c_int]
        lib.tfl_copy_dict.restype = None
        lib.tfl_copy_dict.argtypes = [vp, ctypes.c_int, ctypes.c_char_p]
        lib.tfl_free.restype = None
        lib.tfl_free.argtypes = [vp]
        lib.tfl_save_cache.restype = ctypes.c_int
        lib.tfl_save_cache.argtypes = [vp, ctypes.c_char_p]
        lib.tfl_load_cache.restype = vp
        lib.tfl_load_cache.argtypes = [ctypes.c_char_p]
        lib.tfl_table_create.restype = vp
        lib.tfl_table_create.argtypes = [ctypes.c_int64]
        lib.tfl_table_add_column.restype = ctypes.c_int
        lib.tfl_table_add_column.argtypes = [vp, ctypes.c_int, ctypes.c_int, vp,
                                             ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
        return lib


def _type_code(t: dt.DataType) -> Tuple[int, int]:
    if t.is_decimal:
        return _T_DECIMAL, t.scale
    if t.kind is dt.TypeKind.DATE:
        return _T_DATE, 0
    if t.is_float:
        return _T_FLOAT64, 0
    if t.is_string:
        return _T_STRING, 0
    if t.is_integer:
        return _T_INT64, 0
    raise TypeError(f"native loader: unsupported type {t}")


def _extract_columns(lib, h, schema: Sequence[Tuple[str, Optional[dt.DataType]]],
                     n: int) -> Dict[str, Column]:
    cols: Dict[str, Column] = {}
    for i, (name, t) in enumerate(schema):
        if t is None:
            continue
        code, _ = _type_code(t)
        buf = np.empty(n, dtype=_PHYSICAL[code])
        got = lib.tfl_copy_column(h, i, buf.ctypes.data_as(ctypes.c_void_p))
        if got != n:
            raise IOError(f"native loader: column {name!r} has {got} rows, "
                          f"the table {n}")
        if code == _T_STRING:
            raw = ctypes.create_string_buffer(lib.tfl_dict_size(h, i))
            lib.tfl_copy_dict(h, i, raw)
            blob = raw.raw.decode("utf-8")
            dictionary = tuple(blob.split("\n")[:-1]) if blob else ()
            cols[name] = column_from_arrays(buf, t, dictionary=dictionary or ("",))
        else:
            cols[name] = column_from_arrays(buf, t)
    return cols


def load_table(
    path: str,
    schema: Sequence[Tuple[str, Optional[dt.DataType]]],
    delim: str = "|",
    nthreads: int = 0,
    cache: Optional[str] = None,
) -> Dict[str, Column]:
    """Parse a delimited file (or its binary cache) into host columns.

    ``schema``: ordered (name, dtype) per file field; dtype None skips the
    field.  ``cache``: path of the TFC1 binary cache, loaded if present
    and sound, written after the parse otherwise.  ``nthreads``: parser
    threads (0 = the host's hardware concurrency)."""
    lib = get_lib()
    h = None
    if cache and os.path.exists(cache):
        h = lib.tfl_load_cache(cache.encode())
    if not h:
        codes = [(_type_code(t) if t is not None else (_T_SKIP, 0)) for _, t in schema]
        types = (ctypes.c_int * len(schema))(*[c for c, _ in codes])
        scales = (ctypes.c_int * len(schema))(*[s for _, s in codes])
        h = lib.tfl_parse_file(path.encode(), delim.encode(), types, scales,
                               len(schema), nthreads)
        if not h:
            raise IOError(f"native loader failed to parse {path}")
        if cache:
            lib.tfl_save_cache(h, cache.encode())
    try:
        return _extract_columns(lib, h, schema, lib.tfl_num_rows(h))
    finally:
        lib.tfl_free(h)


def save_table(path: str, columns: Dict[str, Column]) -> List[str]:
    """Write engine columns (copied to the host) to a TFC1 file.

    Returns the column names in the order written: TFC1 stores no names,
    so pair them with a schema when reloading (``load_cached_table``)."""
    lib = get_lib()
    rows = int(next(iter(columns.values())).data.shape[0])
    h = lib.tfl_table_create(rows)
    names = []
    try:
        for name, col in columns.items():
            code, scale = _type_code(col.dtype)
            data = np.ascontiguousarray(col.data.cpu().numpy(), dtype=_PHYSICAL[code])
            blob = b""
            if code == _T_STRING and col.dictionary:
                blob = ("\n".join(col.dictionary) + "\n").encode()
            rc = lib.tfl_table_add_column(h, code, scale,
                                          data.ctypes.data_as(ctypes.c_void_p),
                                          blob, len(blob))
            if rc != 0:
                raise IOError(f"native loader: cannot add column {name!r}")
            names.append(name)
        if lib.tfl_save_cache(h, path.encode()) != 0:
            raise IOError(f"native loader: cannot write {path}")
    finally:
        lib.tfl_free(h)
    return names


def load_cached_table(path: str,
                      schema: Sequence[Tuple[str, dt.DataType]]) -> Dict[str, Column]:
    """Load a TFC1 file written by ``save_table`` (the schema supplies the
    names)."""
    lib = get_lib()
    h = lib.tfl_load_cache(path.encode())
    if not h:
        raise IOError(f"cannot load TFC cache {path}")
    try:
        return _extract_columns(lib, h, list(schema), lib.tfl_num_rows(h))
    finally:
        lib.tfl_free(h)


TPCH_SCHEMAS: Dict[str, List[Tuple[str, Optional[dt.DataType]]]] = {
    "lineitem": [
        ("l_orderkey", dt.INT64), ("l_partkey", dt.INT64),
        ("l_suppkey", dt.INT64), ("l_linenumber", dt.INT64),
        ("l_quantity", dt.Decimal(15, 2)), ("l_extendedprice", dt.Decimal(15, 2)),
        ("l_discount", dt.Decimal(15, 2)), ("l_tax", dt.Decimal(15, 2)),
        ("l_returnflag", dt.STRING), ("l_linestatus", dt.STRING),
        ("l_shipdate", dt.DATE), ("l_commitdate", dt.DATE),
        ("l_receiptdate", dt.DATE), ("l_shipinstruct", dt.STRING),
        ("l_shipmode", dt.STRING), ("l_comment", None),
    ],
    "orders": [
        ("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
        ("o_orderstatus", dt.STRING), ("o_totalprice", dt.Decimal(15, 2)),
        ("o_orderdate", dt.DATE), ("o_orderpriority", dt.STRING),
        ("o_clerk", None), ("o_shippriority", dt.INT64), ("o_comment", None),
    ],
    "customer": [
        ("c_custkey", dt.INT64), ("c_name", None), ("c_address", None),
        ("c_nationkey", dt.INT64), ("c_phone", None),
        ("c_acctbal", dt.Decimal(15, 2)), ("c_mktsegment", dt.STRING),
        ("c_comment", None),
    ],
}


def load_tpch_dir(dirpath: str, tables: Sequence[str], use_cache: bool = True,
                  nthreads: int = 0) -> Catalog:
    """Load dbgen ``<table>.tbl`` files from a directory into a Catalog.

    With ``use_cache`` each table's TFC1 cache is ``<table>.tbl.tfc``
    beside it.  ``nthreads``: parser threads (0 = hardware concurrency);
    the ``max_threads`` setting routes here."""
    cat = Catalog()
    for t in tables:
        path = os.path.join(dirpath, t + ".tbl")
        cache = path + ".tfc" if use_cache else None
        cat.register(t, load_table(path, TPCH_SCHEMAS[t], cache=cache,
                                   nthreads=nthreads))
    return cat


__all__ = ["load_table", "load_tpch_dir", "save_table", "load_cached_table",
           "get_lib", "library_path", "TPCH_SCHEMAS"]
