"""Write dbgen-format ``.tbl`` text from columns, with vectorized numpy.

A ``.tbl`` line is each field's text followed by ``|``: integers in
decimal, decimals with exactly ``scale`` fraction digits (``17.00``),
dates as ``YYYY-MM-DD``, strings as they are.  Each field is rendered as
a byte matrix with a keep mask (leading zeros and short strings masked
out), so a chunk of rows becomes text in a few array operations.  Used to
hold ``storage/native_loader.py`` against ``storage/tpch.py``'s tables on
the same rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_POW10 = 10 ** np.arange(18, -1, -1, dtype=np.int64)  # 10^18 .. 10^0


def _digits(a: np.ndarray, min_digits: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Decimal digits of non-negative int64 ``a``: (n, w) bytes, keep mask."""
    top = int(a.max()) if a.size else 0
    w = max(min_digits, len(str(top)))
    p = _POW10[-w:]
    mat = ((a[:, None] // p[None, :]) % 10 + ord("0")).astype(np.uint8)
    keep = (a[:, None] >= p[None, :]) | (np.arange(w) >= w - min_digits)[None, :]
    return mat, keep


def _signed(v: np.ndarray, body) -> Tuple[np.ndarray, np.ndarray]:
    neg = v < 0
    mat, keep = body(np.abs(v))
    if not neg.any():
        return mat, keep
    sign = np.full((len(v), 1), ord("-"), dtype=np.uint8)
    return np.hstack([sign, mat]), np.hstack([neg[:, None], keep])


def _decimal(scale: int):
    def body(a):
        ip, ik = _digits(a // 10 ** scale)
        parts = [ip, np.full((len(a), 1), ord("."), dtype=np.uint8)]
        keeps = [ik, np.ones((len(a), 1), dtype=bool)]
        if scale:
            fp, fk = _digits(a % 10 ** scale, min_digits=scale)
            parts.append(fp[:, -scale:])
            keeps.append(np.ones((len(a), scale), dtype=bool))
        return np.hstack(parts), np.hstack(keeps)
    return body


def _date(days: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    text = days.astype("datetime64[D]").astype("S10")
    mat = np.frombuffer(text.tobytes(), dtype=np.uint8).reshape(len(days), 10)
    return mat, np.ones(mat.shape, dtype=bool)


def _strings(codes: np.ndarray, dictionary: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    enc = [s.encode() for s in dictionary]
    w = max([len(b) for b in enc] + [1])
    table = np.zeros((len(enc), w), dtype=np.uint8)
    for i, b in enumerate(enc):
        table[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    lengths = np.array([len(b) for b in enc], dtype=np.int64)
    return table[codes], np.arange(w)[None, :] < lengths[codes][:, None]


# a field: ("int", int64 values) | ("decimal", int64 mantissas, scale) |
# ("date", int32 days) | ("string", int32 codes, dictionary)
Field = Tuple


def _render(field: Field, rows: slice) -> Tuple[np.ndarray, np.ndarray]:
    kind, data = field[0], np.asarray(field[1])[rows]
    if kind == "int":
        return _signed(data.astype(np.int64), _digits)
    if kind == "decimal":
        return _signed(data.astype(np.int64), _decimal(field[2]))
    if kind == "date":
        return _date(data)
    if kind == "string":
        return _strings(data, field[2])
    raise ValueError(f"unknown field kind {kind!r}")


def write_tbl(path: str, fields: List[Field], chunk_rows: int = 1 << 20) -> int:
    """Write the fields as ``.tbl`` lines; returns the bytes written."""
    n = len(fields[0][1])
    bar = np.full((1, 1), ord("|"), dtype=np.uint8)
    written = 0
    with open(path, "wb") as f:
        for start in range(0, n, chunk_rows):
            rows = slice(start, min(n, start + chunk_rows))
            m = rows.stop - rows.start
            mats, keeps = [], []
            for field in fields:
                mat, keep = _render(field, rows)
                mats += [mat, np.repeat(bar, m, axis=0)]
                keeps += [keep, np.ones((m, 1), dtype=bool)]
            mats.append(np.full((m, 1), ord("\n"), dtype=np.uint8))
            keeps.append(np.ones((m, 1), dtype=bool))
            text = np.hstack(mats)[np.hstack(keeps)]
            f.write(text.tobytes())
            written += text.size
    return written


def fields_of(columns: Dict, schema: Sequence[Tuple[str, Optional[object]]],
              fill: Optional[Dict[str, Field]] = None) -> List[Field]:
    """The fields of ``schema`` (``native_loader.TPCH_SCHEMAS`` form) from
    port columns by name; ``fill`` supplies the fields the columns lack
    (a skipped field defaults to the text ``x``)."""
    fill = fill or {}
    n = next(iter(columns.values())).data.shape[0]
    out: List[Field] = []
    for name, t in schema:
        if name in fill:
            out.append(fill[name])
            continue
        if t is None:
            out.append(("string", np.zeros(n, dtype=np.int32), ("x",)))
            continue
        c = columns[name]
        data = c.data.cpu().numpy()
        if t.is_string:
            out.append(("string", data, c.dictionary))
        elif t.is_decimal:
            out.append(("decimal", data, t.scale))
        elif t.is_temporal:
            out.append(("date", data))
        else:
            out.append(("int", data))
    return out


__all__ = ["write_tbl", "fields_of"]
