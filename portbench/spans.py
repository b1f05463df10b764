"""The program's own spans of the traced window
(``cross_scale_mae_torch.utils.profiling.span``), in microseconds on the
profiler's clock, as ``trace.Trace`` has its activities.

The program records its spans in the process that runs it, and a card's
per-layer readers run in that card's process, so a card's spans go with
its trace. A program without the recorder, or with nothing recorded, gives
None: a reader then reads nothing and never raises.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    parent: int | None        # the index of the span it was opened in; None at the top
    start: float              # host clock, us
    end: float
    device_ms: float | None   # its CUDA events' interval; None off CUDA


def program_spans() -> list[Span] | None:
    """The closed spans of the program's latest profiler window, in entry
    order; None without a recorder or with an empty one."""
    try:
        from cross_scale_mae_torch.utils.profiling import recorded

        spans = [Span(s.name, s.parent, s.start_ns / 1e3, s.end_ns / 1e3, s.device_ms)
                 for s in recorded() if s.end_ns is not None]
    except (ImportError, AttributeError):
        return None
    return spans or None


def steps(spans: list[Span]) -> list[Span]:
    """The top-level ``step`` spans."""
    return [s for s in spans if s.name == "step" and s.parent is None]


def of_window(t) -> list[Span] | None:
    """The spans of the traced window ``t`` (one card's), or None unless
    they hold one top-level ``step`` span per traced step."""
    spans = program_spans()
    if spans is None or len(t.traces) != 1 or len(steps(spans)) != t.steps:
        return None
    return spans


def device_ms_per_step(t, name: str) -> float | None:
    """The device ms of the spans named ``name``, summed over the traced
    steps, over the steps; None where there is none or one has no events."""
    spans = of_window(t)
    mine = [s.device_ms for s in spans or () if s.name == name]
    if not mine or any(ms is None for ms in mine):
        return None
    return sum(mine) / t.steps
