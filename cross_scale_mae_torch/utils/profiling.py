"""Profiling hooks (counterpart of ``cross_scale_mae_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` window of CPU and, where there is a
  card, CUDA activity, written at its end as a Chrome trace
  (``<host>_<pid>.<ns>.pt.trace.json``, the name
  ``torch.profiler.tensorboard_trace_handler`` gives it) into ``log_dir``.
  Perfetto, ``chrome://tracing`` and TensorBoard's profiler plugin read it;
  writing it needs no TensorBoard package. A no-op for ``None``.
* :class:`TraceWindow`: :func:`trace` over a window of steps of a training
  loop (``--profile_dir``: steps 10-30 of the first epoch), closed when the
  loop ends whatever step it reached.
* :func:`device_memory_stats`: MiB in use per visible CUDA device (the
  reference's ``max_memory_allocated`` line, util/misc.py:153-166); ``{}``
  on a host without one, as the JAX package gives ``{}`` for a device
  without statistics.
* :class:`StepTimer`: steady-state images/s with a warm-up discard.
"""

from __future__ import annotations

import contextlib
import glob
import os
import socket
import time
from typing import Iterator, Optional

import torch

TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """A torch.profiler window; its Chrome trace goes into ``log_dir`` when
    the window closes. Yields the profiler (None for no ``log_dir``)."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}{TRACE_SUFFIX}"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def trace_files(log_dir: str) -> list[str]:
    """The Chrome traces :func:`trace` wrote into ``log_dir``, oldest first."""
    return sorted(glob.glob(os.path.join(log_dir, f"*{TRACE_SUFFIX}")), key=os.path.getmtime)


class TraceWindow:
    """:func:`trace` over steps [``start``, ``stop``) of a loop's first
    epoch, counted from 0 (the JAX CLI's ``--profile_dir`` window,
    cli/pretrain.py:387-390). :meth:`before_step` opens it before step
    ``start`` of the first epoch and closes it before step ``stop``;
    leaving the ``with`` block closes it wherever the loop stopped (the JAX
    CLI leaves its trace open when the first epoch ends before step 30).
    With ``device`` a CUDA device, the card is synchronised at both ends so
    that ``window_s`` holds the traced steps' wall time and
    ``overhead_s`` the profiler's own start, stop and export."""

    def __init__(self, log_dir: Optional[str], start: int = 10, stop: int = 30,
                 device: Optional[torch.device] = None):
        self.log_dir, self.start, self.stop = log_dir, start, stop
        self.device = device if device is not None and device.type == "cuda" else None
        self.steps = 0
        self.window_s = self.overhead_s = 0.0
        self._stack: Optional[contextlib.ExitStack] = None
        self._opened_at = 0.0
        self._first = self._next = 0
        self._done = False

    def __enter__(self) -> "TraceWindow":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _sync(self) -> float:
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def before_step(self, step: int, first_epoch: bool) -> None:
        """Called before step ``step`` (0-based) runs."""
        self._next = step + 1
        if self._stack is None:
            if self.log_dir and not self._done and first_epoch and step == self.start:
                t0 = self._sync()
                self._stack = contextlib.ExitStack()
                self._stack.enter_context(trace(self.log_dir))
                self._opened_at = time.perf_counter()
                self.overhead_s += self._opened_at - t0
                self._first = step
        elif step == self.stop:
            self._close(step)

    def _close(self, step: int) -> None:
        t0 = self._sync()
        self.window_s += t0 - self._opened_at
        self.steps += step - self._first
        self._stack.close()
        self._stack, self._done = None, True
        self.overhead_s += time.perf_counter() - t0

    def close(self) -> None:
        """Close the window, if open, after the last step that ran."""
        if self._stack is not None:
            self._close(self._next)

    @property
    def files(self) -> list[str]:
        return trace_files(self.log_dir) if self.log_dir else []


def device_memory_stats() -> dict[str, float]:
    """MiB that PyTorch's allocator holds in use on each visible CUDA
    device, keyed by its index; ``{}`` without one."""
    if not torch.cuda.is_available():
        return {}
    return {str(i): round(torch.cuda.memory_allocated(i) / 2 ** 20, 1)
            for i in range(torch.cuda.device_count())}


class StepTimer:
    """Steady-state steps/s and images/s, the first ``warmup`` ticks left
    out (the JAX package's ``StepTimer``). The caller synchronises the
    device before a tick where it needs device time."""

    def __init__(self, batch_size: int, warmup: int = 2):
        self.batch_size = batch_size
        self.warmup = warmup
        self._count = 0
        self._t0: Optional[float] = None

    def tick(self) -> None:
        self._count += 1
        if self._count == self.warmup:
            self._t0 = time.perf_counter()

    @property
    def imgs_per_sec(self) -> float:
        if self._t0 is None or self._count <= self.warmup:
            return 0.0
        steady = self._count - self.warmup
        return steady * self.batch_size / (time.perf_counter() - self._t0)
