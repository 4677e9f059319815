"""No module of the benchmark imports JAX or the JAX package, and no
reference imports the system under test.  Names are compared whole, by
their top-level part: ``tiflash_tpu_torch`` is not ``tiflash_tpu``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tiflash_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 30
    bad = {str(p.relative_to(PKG)): sorted(set(imported_tops(p)) & FORBIDDEN) for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_references_import_nothing_of_the_port():
    refs = sorted((PKG / "reference").glob("*.py"))
    shapes = {p.stem for p in (PKG / "queries").glob("*.json")}
    assert {p.stem for p in refs} == shapes | {"_common", "__init__"}
    for p in refs:
        tops = set(imported_tops(p))
        assert "tiflash_tpu_torch" not in tops, p.name
        assert tops <= {"torch", "numpy", "datetime", "typing", "__future__"}, (p.name, tops)


def test_loaded_modules_at_run_time():
    """Importing every module of the benchmark, the port with it, loads
    no forbidden top-level module."""
    mods = [f"portbench.{p.stem}" for p in PKG.glob("*.py") if p.stem != "__init__"]
    mods += [f"portbench.reference.{p.stem}" for p in (PKG / "reference").glob("q*.py")]
    mods += [f"portbench.metrics.{p.stem}" for p in (PKG / "metrics").glob("*.py")]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert "tiflash_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
