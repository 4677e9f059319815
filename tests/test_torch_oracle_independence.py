"""Independence lint of the port's judges, as
``tests/test_oracle_independence.py`` holds the reference's.

The port's ``testing/oracle.py`` and ``testing/plan_oracle.py`` may take
from the port only what the reference's may take from the reference: AST
node types (``expr.nodes``, ``plan.nodes``), logical types
(``core.dtypes``), the data containers (``Block``, ``Column``,
``column_from_numpy``) and ``SortKey``; and nothing of ``jax`` or the
JAX package.  The draw helper ``tests/torch_plan_draw.py``, which
``chip_smoke.py`` loads on the card, imports numpy, the standard library
and the port only.
"""

import ast
import pathlib
import sys

import test_oracle_independence as REF

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE_FILES = [ROOT / "tiflash_tpu_torch" / "testing" / "oracle.py",
                ROOT / "tiflash_tpu_torch" / "testing" / "plan_oracle.py"]
DRAW_FILE = ROOT / "tests" / "torch_plan_draw.py"


def _imports(path):
    """(module as written, level, names, line) of every import."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            out.append((node.module or "", node.level, [a.name for a in node.names],
                        node.lineno))
        elif isinstance(node, ast.Import):
            out.extend((a.name, 0, ["*"], node.lineno) for a in node.names)
    return out


def _port_module(mod: str, level: int):
    """The port module an import names, relative to ``tiflash_tpu_torch``
    (``None`` for one outside the package)."""
    if level >= 2:
        return mod
    if level == 1:
        return "testing." + mod if mod else "testing"
    if mod == "tiflash_tpu_torch" or mod.startswith("tiflash_tpu_torch."):
        return mod.removeprefix("tiflash_tpu_torch").removeprefix(".")
    return None


def _foreign(mod: str) -> bool:
    return mod.split(".")[0] in ("jax", "jaxlib", "tiflash_tpu")


def test_port_oracle_imports_only_node_types():
    for path in ORACLE_FILES:
        for mod, level, names, lineno in _imports(path):
            where = f"{path.name}:{lineno}"
            assert not (level == 0 and _foreign(mod)), f"{where} imports {mod}"
            pm = _port_module(mod, level)
            if pm is None:
                continue
            if pm in ("testing", "testing.oracle"):  # the oracle's own modules
                assert set(names) <= {"oracle"} or pm == "testing.oracle", where
                continue
            assert pm in REF.ALLOWED_ENGINE_MODULES, (
                f"{where} imports engine module '{pm}': the oracle must not share "
                "computation code with the engine")
            allowed = REF.ALLOWED_NAMES_PER_MODULE.get(pm)
            if allowed is not None:
                assert not set(names) - allowed, (
                    f"{where} imports {sorted(set(names) - allowed)} from '{pm}'")


def test_draw_helper_imports_numpy_and_the_port_only():
    std = set(sys.stdlib_module_names)
    for mod, level, names, lineno in _imports(DRAW_FILE):
        top = mod.split(".")[0]
        assert level == 0, f"{DRAW_FILE.name}:{lineno}"
        assert top in std or top in ("numpy", "tiflash_tpu_torch"), (
            f"{DRAW_FILE.name}:{lineno} imports {mod}")


def test_the_lint_sees_a_forbidden_import():
    """The lint's own check: an engine module or the JAX package is caught."""
    assert _port_module("ops.aggregate", 2) not in REF.ALLOWED_ENGINE_MODULES
    assert _port_module("tiflash_tpu_torch.runtime.executor", 0) == "runtime.executor"
    assert _foreign("jax.numpy") and _foreign("tiflash_tpu.testing.oracle")
    assert not _foreign("tiflash_tpu_torch.testing")


def test_port_oracle_substring_matches_mysql_semantics():
    from tiflash_tpu_torch.testing.oracle import _oracle_substring

    # MySQL manual examples + edge cases, as the reference's lint checks
    assert _oracle_substring("Quadratically", 5) == "ratically"
    assert _oracle_substring("foobarbar", 4) == "barbar"
    assert _oracle_substring("Quadratically", 5, 6) == "ratica"
    assert _oracle_substring("Sakila", -3) == "ila"
    assert _oracle_substring("Sakila", -5, 3) == "aki"
    assert _oracle_substring("Sakila", 0) == ""
    assert _oracle_substring("Sakila", 2, 0) == ""
    assert _oracle_substring("Sakila", 2, -1) == ""
    assert _oracle_substring("abc", -99) == ""
    assert _oracle_substring("abc", 99) == ""
