"""The PyTorch port imports no JAX, and reads the JAX package's Orbax
checkpoints without orbax, tensorstore, zstandard or msgpack (none is on
the GPU host): an AST scan of every module of ``cross_scale_mae_torch`` and
of ``chip_smoke.py``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard", "msgpack",
             "cross_scale_mae_tpu"}
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


TRAINING_MODULES = [
    "cross_scale_mae_torch/ops/masking.py", "cross_scale_mae_torch/losses/recon.py",
    "cross_scale_mae_torch/losses/ntxent.py", "cross_scale_mae_torch/train/schedule.py",
    "cross_scale_mae_torch/train/optim.py", "cross_scale_mae_torch/train/state.py",
    "cross_scale_mae_torch/train/pretrain.py", "cross_scale_mae_torch/utils/flops.py",
    "cross_scale_mae_torch/cli/pretrain.py", "cross_scale_mae_torch/models/vit.py",
    "cross_scale_mae_torch/train/mixup.py", "cross_scale_mae_torch/train/classify.py",
    "cross_scale_mae_torch/utils/metrics.py", "cross_scale_mae_torch/data/datasets.py",
    "cross_scale_mae_torch/cli/finetune.py", "cross_scale_mae_torch/data/loader.py",
    "cross_scale_mae_torch/cli/common.py", "cross_scale_mae_torch/utils/logging.py",
    "cross_scale_mae_torch/cli/linprobe.py", "cross_scale_mae_torch/parallel/dist.py",
    "cross_scale_mae_torch/parallel/mesh.py", "cross_scale_mae_torch/parallel/collectives.py",
    "cross_scale_mae_torch/utils/checkpoint.py", "cross_scale_mae_torch/utils/params.py",
    "cross_scale_mae_torch/cli/launch.py", "cross_scale_mae_torch/data/native/__init__.py",
    "cross_scale_mae_torch/serving.py", "cross_scale_mae_torch/quant.py",
    "cross_scale_mae_torch/cli/serve.py", "cross_scale_mae_torch/cli/export.py",
    "cross_scale_mae_torch/cli/embed.py", "cross_scale_mae_torch/cli/export_torch.py",
    "cross_scale_mae_torch/utils/torch_export.py", "cross_scale_mae_torch/utils/torch_import.py",
    "cross_scale_mae_torch/ops/pos_embed.py", "cross_scale_mae_torch/ops/ssim.py",
    "cross_scale_mae_torch/losses/perceptual.py", "cross_scale_mae_torch/viz/__init__.py",
    "cross_scale_mae_torch/viz/recon.py", "cross_scale_mae_torch/viz/temporal.py",
    "cross_scale_mae_torch/cli/evalviz.py", "cross_scale_mae_torch/utils/profiling.py",
]


def test_scan_covers_the_training_modules():
    scanned = {str(p.relative_to(ROOT)) for p in FILES}
    assert set(TRAINING_MODULES) <= scanned


def test_importing_the_training_path_loads_no_jax():
    """Import every module of the pretrain, finetune and linear-probe paths,
    of serving, export and embedding, and of evaluation in a fresh interpreter and check
    that no JAX module was loaded along the way."""
    import subprocess
    import sys

    mods = [m[:-3].replace("/", ".") for m in TRAINING_MODULES]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(sorted(FORBIDDEN)) + ")\nassert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
