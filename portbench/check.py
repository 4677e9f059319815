"""The comparison that decides ``correct``: one answer of the service
against the plain reference's answer for the same request.

Every value is compared exactly (the answers are integers, DECIMAL
mantissas, DATE day numbers and strings).  Order is held where the query
fixes it: the answer's ORDER BY key columns, row by row, equal the
reference's; rows that tie on those keys may come in any order; and under
a LIMIT the rows kept from the last tied group may be any of that group,
since the reference hands over all of it.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence


def _rows(cols: Dict[str, list], names: Sequence[str], n: Optional[int] = None) -> List[tuple]:
    return list(zip(*(cols[c][:n] for c in names))) if names else []


def _count(cols: Dict[str, list]) -> int:
    return len(next(iter(cols.values()))) if cols else 0


def compare(got: Dict[str, list], want: Dict[str, list], order_by: Sequence[str],
            limit: Optional[int]) -> Optional[str]:
    """None if ``got`` is a correct answer, else what is wrong with it."""
    if set(got) != set(want):
        return f"columns {sorted(got)} != {sorted(want)}"
    names = list(want)
    n_want = _count(want)
    n = n_want if limit is None else min(limit, n_want)
    n_got = _count(got)
    if n_got != n:
        return f"{n_got} rows, expected {n}"
    g_rows = _rows(got, names)
    if not order_by:
        if Counter(g_rows) != Counter(_rows(want, names)):
            return "rows differ"
        return None
    g_keys = _rows(got, order_by)
    if g_keys != _rows(want, order_by, n):
        first = next(i for i, (a, b) in enumerate(zip(g_keys, _rows(want, order_by, n)))
                     if a != b)
        return f"order key of row {first}: {g_keys[first]} != reference"
    # rows of each key group: the answer's may be any of the reference's
    pool = Counter(_rows(want, names))
    for row in g_rows:
        if pool[row] <= 0:
            return f"row {row} is not in the reference's answer"
        pool[row] -= 1
    return None
