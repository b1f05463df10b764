"""The traced window: what ran on the device, taken from the benchmark's
own ``torch.profiler`` window, and the interval arithmetic the per-layer
readers share.

Times are microseconds on the profiler's clock. The window is the span
from the first device activity of the traced steps to the last; the
device is busy where any kernel, copy or fill runs on any stream, so work
that overlaps on two streams counts once.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Iterable

GEMM_NAMES = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
ATTENTION_NAMES = ("mha3_fwd", "mha3_bwd", "mha_fwd", "mha_bwd", "mha2_fwd", "mha2_bwd")
COMM_NAMES = ("nccl",)


@dataclasses.dataclass(frozen=True)
class Activity:
    """One kernel, copy or fill on the device."""

    name: str
    kind: str       # "kernel", "memcpy" or "memset"
    start: float
    end: float


@dataclasses.dataclass
class Trace:
    device: list[Activity]

    @property
    def window(self) -> tuple[float, float]:
        if not self.device:
            return (0.0, 0.0)
        return (min(a.start for a in self.device), max(a.end for a in self.device))

    @property
    def window_us(self) -> float:
        lo, hi = self.window
        return hi - lo


def from_profiler(prof) -> Trace:
    """The device activities of a finished ``torch.profiler.profile``, read
    from its in-memory events. Copies and fills are told from kernels by
    their names ("Memcpy ...", "Memset ...")."""
    device = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        name, start = e.name(), e.start_ns() / 1e3
        kind = name[:6].lower() if name.startswith(("Memcpy", "Memset")) else "kernel"
        device.append(Activity(name, kind, start, start + e.duration_ns() / 1e3))
    return Trace(device)


def merged(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of intervals as sorted, disjoint intervals."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def covered(intervals: Iterable[tuple[float, float]]) -> float:
    """Length of the union of intervals."""
    return sum(hi - lo for lo, hi in merged(intervals))


def exposed(comm: Iterable[tuple[float, float]], compute: Iterable[tuple[float, float]]) -> float:
    """Length of the union of ``comm`` not overlapped by any ``compute`` interval."""
    comp = merged(compute)
    starts = [lo for lo, _ in comp]
    total = 0.0
    for lo, hi in merged(comm):
        left = hi - lo
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(comp) and comp[i][0] < hi:
            left -= max(0.0, min(hi, comp[i][1]) - max(lo, comp[i][0]))
            i += 1
        total += left
    return total


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in GEMM_NAMES)


def is_attention(name: str) -> bool:
    return any(k in name for k in ATTENTION_NAMES)


def is_comm(name: str) -> bool:
    return any(k in name.lower() for k in COMM_NAMES)


def short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def device_ops(trace: Trace, top: int = 10) -> list[tuple[str, float]]:
    """The ``top`` device operations that took most time, in seconds."""
    by_op: dict[str, float] = {}
    for a in trace.device:
        key = short(a.name)
        by_op[key] = by_op.get(key, 0.0) + (a.end - a.start) / 1e6
    return sorted(by_op.items(), key=lambda kv: -kv[1])[:top]


@dataclasses.dataclass
class Traced:
    """What a per-layer reader is handed: the traced window of ``steps``
    steps on each of ``chips`` cards (one trace per card), and the cell's
    counts: images/s of the untraced part of the run, the model FLOPs of a
    training image and the step's attention calls by kernel family."""

    traces: list[Trace]
    steps: int
    chips: int
    images_per_s: float
    flops_per_image: float
    attention: dict[str, list[dict]]
