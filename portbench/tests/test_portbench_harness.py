"""The harness as a whole on the CPU: what it imports, how it refuses a
machine without the cards a cell asks for, and that a configuration, a
traffic mix and a per-layer metric are added as new files, with nothing
edited, and run."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.tests import _tiny

BENCH = _tiny.REPO / "portbench"
JAX = {"jax", "jaxlib", "flax", "cross_scale_mae_tpu"}


def _imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not (_imported(f) & JAX), f
        text = f.read_text()
        if "tests" not in f.parts:
            assert "bench.py" not in text and "benchmarks/" not in text, f
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "cross_scale_mae_torch" not in _imported(f), f


def test_loaded_modules_are_compared_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "cross_scale_mae_torchvision", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.loaded_forbidden() == [] or set(run.loaded_forbidden()) <= JAX
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "cross_scale_mae_tpu.ops", sys)
    assert "cross_scale_mae_tpu" in run.loaded_forbidden()


def _env(root: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{_tiny.REPO}", CUDA_VISIBLE_DEVICES="")
    env.pop("BENCH_RUN", None)
    return env


def test_without_a_card_the_run_exits_and_prints_no_result(tmp_path):
    root = _tiny.make(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "tiny_pre",
                           "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                          cwd=root, env=_env(root), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_alone_in_its_folder_the_run_exits_and_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder:
    the program is not there to run."""
    _tiny.make(tmp_path)
    code = ("import torch; from pathlib import Path; from portbench import run, cell; "
            "c = cell.load(Path('.').resolve(), 'tiny_pre'); "
            "run.emit(run.measure(c, 3, 0.2, False, torch.device('cpu')))")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "cross_scale_mae_torch" in proc.stderr and proc.stdout.strip() == ""


def test_new_config_mix_and_metric_are_files_the_harness_runs(tmp_path):
    """A configuration (the tiny MAE at mask 0.5), a mix (batch 4) and a
    per-layer metric (steps in the traced window), each a new file beside
    the others and an entry in BENCHMARK.json, run with --trace 1."""
    root = _tiny.make(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    pb = root / "portbench"
    conf = json.loads((pb / "configs/tiny_mae.json").read_text())
    conf["mask_ratio"] = 0.5
    (pb / "configs/tiny_mae_m50.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "mixes/tiny_pretrain.json").read_text())
    mix.update(batch=4, pool=16)
    (pb / "mixes/tiny_pretrain_b4.json").write_text(json.dumps(mix))
    (pb / "metrics/traced_steps.py").write_text(
        '"""Steps in the traced window."""\n\n\ndef read(t):\n    return float(t.steps)\n')
    (pb / "limits/tiny_new.json").write_text(json.dumps(_tiny.LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_mae_m50", "source": "test", "why": "test",
                             "file": "portbench/configs/tiny_mae_m50.json", "reduced": []})
    bench["workloads"].append({"name": "tiny_new", "config": "tiny_mae_m50",
                               "traffic": "tiny_pretrain_b4", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "traced_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step",
                               "moves": "images_per_s", "workloads": ["tiny_new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import torch; from pathlib import Path; from portbench import run, cell; "
            "torch.set_num_threads(1); c = cell.load(Path('.').resolve(), 'tiny_new'); "
            "run.emit(run.measure(c, 2**31 + 5, 0.2, True, torch.device('cpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=_env(root),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metrics"]["traced_steps"] == {"value": 2.0, "unit": "steps"}
    assert "checks" in out and list(out)[-1] == "checks"
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == []


@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct():
    """On a card: the pretraining cell, a short window, a fresh seed."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the CUDA kernels")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "pretrain_vitb_128_b512", "--seed", str(2 ** 31 + 3),
                           "--seconds", "5", "--trace", "0"], cwd=_tiny.REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
