"""The data of ``sensors_toy``, a second schema for the harness's own
tests: readings of sensors at sites.

- ``site``: ``st_sitekey`` (1..N, its key) and ``st_region``, one of four;
- ``reading``: ``rd_sitekey`` (a site), ``rd_day`` (a day of 2020-2023)
  and ``rd_value``, a DECIMAL(12,4) between -10,000 and 10,000.

``sf`` x 1,000 sites and ``sf`` x 100,000 readings, drawn from ``seed``."""

from __future__ import annotations

import datetime

import numpy as np

from portbench.datagen import Col, Table, categorical, total_bytes  # noqa: F401

REGIONS = ["east", "north", "south", "west"]
FIRST_DAY = (datetime.date(2020, 1, 1) - datetime.date(1970, 1, 1)).days
LAST_DAY = (datetime.date(2023, 12, 31) - datetime.date(1970, 1, 1)).days


def generate(sf: float, seed: int, device="cpu"):
    rng = np.random.default_rng(seed % (1 << 63))
    n_site, n_read = max(4, int(1000 * sf)), max(16, int(100_000 * sf))
    site = Table({
        "st_sitekey": Col(np.arange(1, n_site + 1, dtype=np.int64), "INT64"),
        "st_region": categorical(REGIONS, rng.integers(0, len(REGIONS), n_site)),
    }, [["st_sitekey"]], ["st_sitekey"])
    reading = Table({
        "rd_sitekey": Col(rng.integers(1, n_site + 1, n_read, dtype=np.int64), "INT64"),
        "rd_day": Col(rng.integers(FIRST_DAY, LAST_DAY, n_read, dtype=np.int32, endpoint=True),
                      "DATE"),
        "rd_value": Col(rng.integers(-10 ** 8, 10 ** 8, n_read, dtype=np.int64), "DECIMAL(12,4)"),
    }, [], [])
    return {"site": site, "reading": reading}
