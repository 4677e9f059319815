"""The port's layers import downward only: no module under ``core/``,
``expr/``, ``ops/`` or ``plan/`` imports from ``tiflash_tpu_torch.mpp``
(the mesh runner sits above the single-device compiler and calls its
local step; the runtime filter both walks use lives in
``ops/runtime_filter.py``).  Read from each module's source, deferred
imports inside functions included."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1] / "tiflash_tpu_torch"
FORBIDDEN = "tiflash_tpu_torch.mpp"


def _imported_modules(path: pathlib.Path):
    """Every module an ``import`` or ``from ... import`` in ``path`` names,
    relative imports resolved against the module's package."""
    package = ("tiflash_tpu_torch",) + path.relative_to(ROOT).parent.parts
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package[:len(package) - node.level + 1]
                base = ".".join(parts + ((base,) if base else ()))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


def test_the_check_sees_a_relative_import():
    mod = ROOT / "plan" / "compiler.py"
    found = list(_imported_modules(mod))
    assert "tiflash_tpu_torch.ops.join" in found
    assert "tiflash_tpu_torch.plan.nodes" in found


@pytest.mark.parametrize("layer", ["core", "expr", "ops", "plan"])
def test_layer_does_not_import_the_mesh(layer):
    bad = []
    for path in sorted((ROOT / layer).rglob("*.py")):
        for name in _imported_modules(path):
            if name == FORBIDDEN or name.startswith(FORBIDDEN + "."):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad
