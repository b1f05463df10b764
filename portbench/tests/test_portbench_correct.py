"""The comparison that decides ``correct``, at test size on the CPU: each
task's step against the plain reference passes; the float8 control fails;
and a run driven end to end with the timed path broken underneath (half of
each batch left out, the mean over the rest; a step that returns its state
unchanged) comes out not correct."""

from __future__ import annotations

import pytest
import torch

from portbench import cell as cells
from portbench import compare, run
from portbench.reference.common import Arith
from portbench.tests import _tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return _tiny.make(tmp_path_factory.mktemp("bench"))


def _measure(root, workload):
    return run.measure(cells.load(root, workload), _tiny.SEED, 0.3, False, torch.device("cpu"))


@pytest.mark.parametrize("workload", list(_tiny.CELLS))
def test_sound_step_is_correct(root, workload):
    out = _measure(root, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"images_per_s", "step_ms_p90", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("workload", list(_tiny.CELLS))
def test_control_is_not_correct(root, workload):
    """The reference with float8 products in the program's place."""
    cell = cells.load(root, workload)
    task = cell.task().Task(cell, _tiny.SEED, torch.device("cpu"))
    task.release()
    ref = task.reference(Arith(fp8=False))
    correct, checks = compare.judge(compare.gaps(task.reference(Arith(fp8=True)), ref),
                                    cell.limits)
    assert not correct, checks


def _half_batch(task_cls):
    """The program's step on the first half of each batch and its draws."""
    original = task_cls.step

    def step(self, k):
        from portbench import inputs

        n = self.batch // 2
        full_rows, full_draws = inputs.step_rows, self.draws

        def rows(*a, **kw):
            return full_rows(*a, **kw)[:n]

        def draws(k):
            d = full_draws(k)
            keep = {"hflip", "vflip", "crop_boxes", "ms_boxes"}
            out = {key: (v[:n] if key in keep else v) for key, v in d.items()}
            if "noise" in d:
                out["noise"] = torch.cat([d["noise"][:n], d["noise"][self.batch:self.batch + n]])
            if "drop_masks" in d:
                out["drop_masks"] = d["drop_masks"][:, :n]
                out["mixup"] = {key: v[:n] for key, v in d["mixup"].items()}
            return out

        inputs.step_rows, self.draws = rows, draws
        try:
            return original(self, k)
        finally:
            inputs.step_rows, self.draws = full_rows, full_draws

    return step


def _unchanged(task_cls):
    """The program's step with its optimizer update left out."""
    original = task_cls.step

    def step(self, k):
        state = self.run.state
        state.apply_gradients = lambda grads, model_state=None: state
        return original(self, k)

    return step


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
@pytest.mark.parametrize("workload", list(_tiny.CELLS))
def test_broken_step_is_not_correct(root, workload, fault, monkeypatch):
    cell = cells.load(root, workload)
    module = cell.task()
    monkeypatch.setattr(cells.Cell, "task", lambda self: module)
    broken = {"half_batch": _half_batch, "unchanged": _unchanged}[fault](module.Task)
    monkeypatch.setattr(module.Task, "step", broken)
    out = run.measure(cell, _tiny.SEED, 0.3, False, torch.device("cpu"))
    assert not out["correct"], out["checks"]
