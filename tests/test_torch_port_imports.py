"""The PyTorch port imports no JAX: an AST scan of every module of
``cross_scale_mae_torch`` and of ``chip_smoke.py``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cross_scale_mae_tpu"}
FILES = sorted((ROOT / "cross_scale_mae_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    assert path.exists()
    assert not _imported_roots(path) & FORBIDDEN


def test_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from cross_scale_mae_tpu.ops import attention\n"
                   "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert _imported_roots(bad) >= {"cross_scale_mae_tpu", "jax"}
