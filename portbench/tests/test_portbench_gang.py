"""The launch path of a cell on several cards, rehearsed on the CPU: four
ranks over gloo, each a process of ``portbench/rank.py`` started by
``run.launch``, the same path NCCL takes on four cards. A sound gang is
correct; with the exchange of gradients between ranks left out it is not;
and a rank that fails stops the others and is named."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench.tests import _tiny

LAUNCH = ("import sys, argparse; from pathlib import Path; from portbench import run, cell; "
          "c = cell.load(Path('.').resolve(), sys.argv[1]); "
          "a = argparse.Namespace(seed=2**31 + 21, seconds=0.3, trace=int(sys.argv[2])); "
          "out = run.launch(c, a, device_type='cpu'); "
          "sys.exit(1) if out is None else run.emit(out)")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = _tiny.make(tmp_path_factory.mktemp("gang"))
    pb = root / "portbench"
    (pb / "tasks/pretrain_noexchange.py").write_text(
        '"""The pretrain task with the gradient exchange between ranks left out."""\n\n'
        "import cross_scale_mae_torch.train.pretrain as step\n\n"
        "from portbench.tasks.pretrain import Task  # noqa: F401\n\n"
        "step.average_gradients = lambda flat, grads, specs: (flat, grads)\n")
    (pb / "tasks/pretrain_rank2_fails.py").write_text(
        '"""The pretrain task, failing on rank 2."""\n\n'
        "from portbench.tasks import pretrain\n\n\n"
        "class Task(pretrain.Task):\n"
        "    def __init__(self, cell, seed, device, rank=0, world=1, coordinator=None):\n"
        "        if rank == 2:\n"
        "            raise RuntimeError('rank 2 cannot start')\n"
        "        super().__init__(cell, seed, device, rank, world, coordinator)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((pb / "configs/tiny_mae.json").read_text())
    for task in ("pretrain_noexchange", "pretrain_rank2_fails"):
        (pb / f"configs/tiny_{task}.json").write_text(json.dumps({**conf, "task": task}))
        bench["configs"].append({"name": f"tiny_{task}", "source": "test", "why": "test",
                                 "file": f"portbench/configs/tiny_{task}.json", "reduced": []})
        bench["workloads"].append({"name": f"dp_{task}", "config": f"tiny_{task}",
                                   "traffic": "tiny_pretrain_dp", "chips": 4, "why": "test"})
        (pb / f"limits/dp_{task}.json").write_text(json.dumps(_tiny.LIMITS))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _launch(root, workload, trace=0):
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{_tiny.REPO}", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", LAUNCH, workload, str(trace)], cwd=root,
                          env=env, capture_output=True, text=True, timeout=600)


def test_four_gloo_ranks_are_correct(root):
    proc = _launch(root, "tiny_dp", trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4 and out["attempted"] >= 10
    assert proc.stderr.strip().splitlines()[-1].startswith("check grad_err")


def test_without_the_exchange_the_gang_is_not_correct(root):
    proc = _launch(root, "dp_pretrain_noexchange")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not out["correct"], out["checks"]


def test_a_failing_rank_stops_the_gang_and_is_named(root):
    proc = _launch(root, "dp_pretrain_rank2_fails")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "rank 2 of 4 failed" in proc.stderr and "rank 2 cannot start" in proc.stderr
