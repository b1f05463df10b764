"""The span readers (``portbench/spans.py`` and the four metrics that read
the program's spans) on hand-made traces and spans: device gaps inside and
outside the step, microbatches repeating under one step, and nothing read
without the program's recorder."""

from __future__ import annotations

import sys
import types

import pytest

from portbench import cell as cells
from portbench import spans
from portbench.spans import Span
from portbench.tests import _tiny
from portbench.trace import Activity, Trace, Traced

NAMES = ("host_enqueue_ms_per_step", "host_bound_idle_ms_per_step", "augment_ms_per_step",
         "optimizer_ms_per_step")


def _reader(name):
    return cells.load_module(_tiny.REPO / "portbench" / "metrics" / f"{name}.py")


def _traced(device, steps=2):
    return Traced([Trace(device)], steps, 1, 1000.0, 1e9, {})


def _kernel(start, end):
    return Activity("elementwise_kernel", "kernel", start, end)


def _steps(*phases):
    """Spans of one step per entry of ``phases``: (host start, host end,
    [(name, device ms), ...] of its children)."""
    out = []
    for start, end, children in phases:
        top = len(out)
        out.append(Span("step", None, start, end, None))
        out += [Span(name, top, start, end, ms) for name, ms in children]
    return out


@pytest.fixture
def recorded(monkeypatch):
    """Set the spans the readers see."""

    def put(value):
        monkeypatch.setattr(spans, "program_spans", lambda: value)

    return put


def test_host_enqueue_is_the_median_step_span(recorded):
    recorded(_steps((0, 30, []), (40, 90, []), (100, 140, [])))
    assert _reader("host_enqueue_ms_per_step").read(_traced([_kernel(5, 150)], 3)) \
        == pytest.approx(40e-3)


def test_host_bound_idle_counts_only_gaps_inside_a_step(recorded):
    """Busy 0-20, 30-50, 60-100: of the gaps 20-30 and 50-60, the step
    spans -10..25 and 45..70 cover 20-25 and 50-60; 25-30 falls between
    steps, in the harness."""
    device = [_kernel(0, 20), _kernel(30, 50), _kernel(40, 45), _kernel(60, 100)]
    recorded(_steps((-10, 25, []), (45, 70, [])))
    assert _reader("host_bound_idle_ms_per_step").read(_traced(device)) \
        == pytest.approx(15e-3 / 2)
    # No gap at all: none of the step is idle.
    assert _reader("host_bound_idle_ms_per_step").read(_traced([_kernel(0, 100)])) == 0


def test_host_bound_idle_needs_the_host_ahead_of_the_device(recorded):
    """The draws' kernels before the first step span are fine; a device
    that finished before the host began the last step is a clock out of
    step with the host's, and nothing is read."""
    recorded(_steps((5, 25, []), (45, 70, [])))
    assert _reader("host_bound_idle_ms_per_step").read(
        _traced([_kernel(0, 20), _kernel(30, 100)])) == pytest.approx(5e-3 / 2)
    assert _reader("host_bound_idle_ms_per_step").read(
        _traced([_kernel(0, 20), _kernel(30, 45)])) is None
    assert _reader("host_bound_idle_ms_per_step").read(_traced([])) is None


def test_microbatches_sum_under_their_step(recorded):
    """Two microbatches repeat augment, forward and backward under one
    step: their device ms add up within the step, then average over the
    steps."""
    mb = [("augment", 1.0), ("forward", 4.0), ("backward", 8.0)]
    recorded(_steps((0, 10, mb + mb + [("optimizer", 0.5)]),
                    (20, 30, mb + mb + [("optimizer", 0.75)])))
    t = _traced([_kernel(5, 40)])
    assert _reader("augment_ms_per_step").read(t) == pytest.approx(2.0)
    assert _reader("optimizer_ms_per_step").read(t) == pytest.approx(0.625)
    # One step too few for the traced window: nothing is read.
    recorded(_steps((0, 10, mb + [("optimizer", 0.5)])))
    assert all(_reader(n).read(t) is None for n in NAMES)


def test_device_ms_need_the_events(recorded):
    """Spans recorded off CUDA carry no device ms: the device readers read
    nothing, the host reader still does."""
    recorded(_steps((0, 10, [("augment", None), ("optimizer", None)]),
                    (20, 30, [("augment", None), ("optimizer", None)])))
    t = _traced([_kernel(5, 40)])
    assert _reader("augment_ms_per_step").read(t) is None
    assert _reader("optimizer_ms_per_step").read(t) is None
    assert _reader("host_enqueue_ms_per_step").read(t) == pytest.approx(10e-3)


@pytest.mark.parametrize("module", [None, types.ModuleType("profiling"), "empty"])
def test_nothing_is_read_without_a_recorder(monkeypatch, module):
    """A program without ``utils/profiling`` (import fails), without
    ``recorded`` in it (as before the recorder), or with nothing recorded:
    every reader gives None and none raises."""
    if module == "empty":
        module = types.ModuleType("profiling")
        module.recorded = lambda: []
    monkeypatch.setitem(sys.modules, "cross_scale_mae_torch.utils.profiling", module)
    assert spans.program_spans() is None
    t = _traced([_kernel(0, 10), _kernel(20, 30)])
    assert all(_reader(n).read(t) is None for n in NAMES)
