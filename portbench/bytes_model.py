"""The bytes a scan must read, worked out from the query and the data,
whatever implements it.

A reference module may declare ``SCAN = {"predicates": [...], "values":
[...]}`` and ``live(t, params)``, the mask of rows that pass the query's
filter.  Each column is counted at the fewest whole bytes (1, 2, 4 or 8)
that hold every value it has in this data.  A predicate column is read
once, whole.  A value column (not also a predicate) is read only in the
32-byte sectors that hold a live row: a sector holds 32 / width rows.

The same sector arithmetic as ``chip_smoke.py``'s ``_sector_bytes``, taken
from the query's columns and live mask instead of the port's tile
program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SECTOR = 32
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, NVIDIA's data sheet


def width(arr: np.ndarray) -> int:
    lo, hi = int(arr.min()), int(arr.max())
    for w in (1, 2, 4):
        if -(1 << (8 * w - 1)) <= lo and hi < (1 << (8 * w - 1)):
            return w
    return 8


def live_sectors(live: torch.Tensor, rows_per_sector: int) -> int:
    n = len(live)
    pad = (-n) % rows_per_sector
    m = torch.nn.functional.pad(live, (0, pad)) if pad else live
    return int(m.reshape(-1, rows_per_sector).any(dim=1).sum())


class ScanBytes:
    """Bytes per request of shapes whose reference declares a scan; one
    figure per distinct request."""

    def __init__(self, host_columns: Dict[str, np.ndarray]):
        self._host = host_columns
        self._width: Dict[str, int] = {}
        self._memo: Dict[str, int] = {}

    def _w(self, name: str) -> int:
        if name not in self._width:
            self._width[name] = width(self._host[name])
        return self._width[name]

    def bytes(self, key: str, ref, t, params) -> int:
        if key not in self._memo:
            scan = ref.SCAN
            live = ref.live(t, params)
            n = len(live)
            total = sum(n * self._w(c) for c in scan["predicates"])
            for c in scan["values"]:
                if c in scan["predicates"]:
                    continue
                w = self._w(c)
                total += SECTOR * live_sectors(live, SECTOR // w)
            self._memo[key] = total
        return self._memo[key]
