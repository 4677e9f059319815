"""The general traffic generator: a mix file and a seed in, per-client
request sequences out.  Standard library only, so the load generator's
process starts fast.

A mix (``mixes/<name>.json``) is one of two kinds:

- ``"streams"``: one closed-loop client per list; each list names query
  shapes (``"q14"``), sent in that order with the shape's own parameters
  (the query file's ``params``), over and over.  With ``"finish_pass"``
  a client that sees the window's time run out finishes the pass it is
  in, so a run covers whole passes.
- ``"draw"``: ``"clients"`` closed-loop clients, each drawing every
  request from its own seeded generator: a shape by ``weight``, then
  each parameter from its distribution: ``{"int": [lo, hi]}`` (both
  included) or ``{"choice": [...]}``.

A query shape (``queries/<shape>.json``) is a frozen plan whose literals
may be placeholders (a string ``"$NAME"``), each worked out from the
parameters by the rule under ``literals``:

- ``["date_minus_days", "1998-12-01", "DELTA"]``: that date less DELTA days;
- ``["year_start", "YEAR", k]``: January 1 of YEAR + k;
- ``["add", "P", x, places]``: P + x, rounded to ``places`` decimals;
- ``["float", "P"]``: P as a float.
"""

from __future__ import annotations

import copy
import datetime
import json
import random
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

HERE = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> Dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def literal(rule: List, params: Dict):
    op = rule[0]
    if op == "date_minus_days":
        base = datetime.date.fromisoformat(rule[1])
        return (base - datetime.timedelta(days=int(params[rule[2]]))).isoformat()
    if op == "year_start":
        return f"{int(params[rule[1]]) + int(rule[2]):04d}-01-01"
    if op == "add":
        return round(params[rule[1]] + rule[2], rule[3])
    if op == "float":
        return float(params[rule[1]])
    raise ValueError(f"unknown literal rule {op!r}")


def _substitute(node, values: Dict):
    if isinstance(node, dict):
        return {k: _substitute(v, values) for k, v in node.items()}
    if isinstance(node, list):
        return [_substitute(v, values) for v in node]
    if isinstance(node, str) and node.startswith("$") and node[1:] in values:
        return values[node[1:]]
    return node


def bind(query: Dict, params: Dict) -> Dict:
    """The query's plan JSON with every placeholder replaced."""
    values = {name: literal(rule, params) for name, rule in query["literals"].items()}
    return _substitute(copy.deepcopy(query["plan"]), values)


def params_key(shape: str, params: Dict) -> str:
    """A request's identity: its shape and parameters, as one string."""
    return shape + json.dumps(params, sort_keys=True)


def _draw(spec, rng: random.Random):
    if "int" in spec:
        lo, hi = spec["int"]
        return rng.randint(lo, hi)
    if "choice" in spec:
        return rng.choice(spec["choice"])
    raise ValueError(f"unknown distribution {spec!r}")


class Mix:
    """Per-client request sequences of one mix under one seed."""

    def __init__(self, name: str, seed: int):
        self.name = name
        self.spec = load_json("mixes", name)
        self.seed = seed
        shapes = set()
        if "streams" in self.spec:
            for s in self.spec["streams"]:
                shapes.update(s)
        else:
            shapes.update(d["shape"] for d in self.spec["draw"])
        self.queries = {s: load_json("queries", s) for s in sorted(shapes)}

    @property
    def clients(self) -> int:
        if "streams" in self.spec:
            return len(self.spec["streams"])
        return int(self.spec["clients"])

    @property
    def finish_pass(self) -> bool:
        return bool(self.spec.get("finish_pass", False))

    def requests(self, client: int) -> Iterator[Tuple[str, Dict, int]]:
        """Endless (shape, params, pass number) of one client."""
        if "streams" in self.spec:
            stream = self.spec["streams"][client]
            n = 0
            while True:
                for shape in stream:
                    yield shape, dict(self.queries[shape]["params"]), n
                n += 1
        rng = random.Random(f"{self.seed}:{self.name}:{client}")
        draws = self.spec["draw"]
        weights = [d.get("weight", 1) for d in draws]
        while True:
            d = rng.choices(draws, weights)[0]
            params = dict(self.queries[d["shape"]]["params"])
            for pname, dist in d.get("params", {}).items():
                params[pname] = _draw(dist, rng)
            yield d["shape"], params, 0

    def warm_set(self) -> List[Tuple[str, Dict]]:
        """What set-up sends before the window: every shape with its own
        parameters, and each drawn shape again with ``warm_draws`` draws
        from a generator of its own (not the clients')."""
        out = [(s, dict(q["params"])) for s, q in self.queries.items()]
        rng = random.Random(f"{self.seed}:{self.name}:warm")
        for d in self.spec.get("draw", []):
            for _ in range(int(self.spec.get("warm_draws", 0))):
                params = dict(self.queries[d["shape"]]["params"])
                for pname, dist in d.get("params", {}).items():
                    params[pname] = _draw(dist, rng)
                out.append((d["shape"], params))
        return out
