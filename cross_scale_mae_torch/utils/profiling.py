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
* :func:`span`: the port's one profiler range. Off (no ``torch.profiler``
  window open) it costs a flag read; on, it is a ``record_function``
  range on the trace's timeline, and :func:`recorded` keeps its name,
  parent, host interval and device ms for the latest window.
"""

from __future__ import annotations

import contextlib
import glob
import os
import socket
import time
from typing import ContextManager, Iterator, NamedTuple, Optional

import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import record_function

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


class Span(NamedTuple):
    """One span of the latest profiler window. ``parent``: the index in
    :func:`recorded` of the span it was opened in (None at the top).
    ``start_ns``, ``end_ns``: ``time.time_ns()``, the clock the profiler
    stamps its events with (``end_ns`` None while the span is open).
    ``device_ms``: the time between the span's two CUDA events on its
    stream (None off CUDA or while open)."""

    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: Optional[int]
    device_ms: Optional[float]


class _Open:
    __slots__ = ("name", "index", "parent", "start_ns", "end_ns", "stream", "events", "range")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.end_ns, self.stream, self.events = name, None, None, None
        if device is not None and device.type == "cuda":
            self.stream = torch.cuda.current_stream(device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> "_Open":
        global _stale
        if _stale:   # the first span of a new window
            _spans.clear()
            _open.clear()
            _stale = False
        self.index, self.parent = len(_spans), _open[-1].index if _open else None
        _spans.append(self)
        _open.append(self)
        self.start_ns = time.time_ns()
        self.range = record_function(self.name)
        self.range.__enter__()
        if self.events is not None:
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc) -> None:
        if self.events is not None:
            self.events[1].record(self.stream)
        self.range.__exit__(*exc)
        self.end_ns = time.time_ns()
        if _open and _open[-1] is self:
            _open.pop()


_OFF = contextlib.nullcontext()
_spans: list[_Open] = []   # the latest window's spans, in entry order
_open: list[_Open] = []    # the spans open now, innermost last
_stale = True              # a span ran outside a window since the last one recorded


def span(name: str, device: Optional[torch.device] = None) -> ContextManager:
    """A profiler range around one phase of a step (``with span("optimizer",
    x.device): ...``), opened at phase boundaries only, from one thread.

    Outside a ``torch.profiler`` window it is one shared no-op context: a
    flag read and a flag set, no allocation, no CUDA call. Inside one it enters
    ``record_function(name)`` (the Chrome trace of :func:`trace` shows it),
    takes the host clock at both ends and, on a CUDA ``device``, records a
    timing event on its current stream at both ends; :func:`recorded`
    returns it. The first span of a window (a span ran outside a window
    since the last one recorded) starts the record anew."""
    global _stale
    if not autograd_profiler._is_profiler_enabled:
        _stale = True
        return _OFF
    return _Open(name, device)


def recorded() -> list[Span]:
    """The spans of the latest profiler window, in entry order. Waits for
    each span's end event, so the device ms are read after its work."""
    out = []
    for s in _spans:
        ms = None
        if s.events is not None and s.end_ns is not None:
            s.events[1].synchronize()
            ms = s.events[0].elapsed_time(s.events[1])
        out.append(Span(s.name, s.parent, s.start_ns, s.end_ns, ms))
    return out
