"""A configuration's data, made by the generator the configuration names.

A configuration file (``configs/<name>.json``) names its generator with
``"generator": "<module>"``: the module ``portbench/<module>.py``, which
exposes

- ``generate(sf, seed, device) -> {table: Table}``: the tables at scale
  factor ``sf`` from ``seed``, as ``datagen.Table`` and ``datagen.Col``
  (numpy arrays, a kind that ``system.py`` maps to the port's types, a
  dictionary for strings, unique keys and clustering), the shape that
  ``system.build_catalog``, ``reference/_common.Tables`` and
  ``bytes_model.ScanBytes`` read;
- ``total_bytes(tables)``: the bytes of those arrays.

A file with no such key is TPC-H's: ``datagen.py``.  This module is the
only place where ``run.py``, ``control.py`` and the benchmark's tests
find the generator, so a configuration of another schema is added as
files: its generator, configuration, query shapes with their references,
a mix, and entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = "datagen"
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


class RunError(Exception):
    """A run that cannot give a result."""


def config(name: str) -> Dict:
    """The file of configuration ``name`` of ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((c for c in bench["configs"] if c["name"] == name), None)
    if entry is None:
        raise RunError(f"no configuration {name!r} in BENCHMARK.json")
    return json.loads((ROOT / entry["file"]).read_text())


def generator(conf: Dict):
    """The module that makes the tables of configuration ``conf``."""
    name = conf.get("generator", DEFAULT)
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise RunError(f"generator {name!r} is not the name of a module of portbench/")
    if importlib.util.find_spec(f"portbench.{name}") is None:
        raise RunError(f"no generator {name!r}: portbench/{name}.py does not exist")
    mod = importlib.import_module(f"portbench.{name}")
    missing = [f for f in ("generate", "total_bytes") if not callable(getattr(mod, f, None))]
    if missing:
        raise RunError(f"generator {name!r} (portbench/{name}.py) lacks {', '.join(missing)}")
    return mod
