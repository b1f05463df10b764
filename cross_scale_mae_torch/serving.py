"""Serving core: checkpoint -> callable forward + micro-batcher.

Counterpart of ``cross_scale_mae_tpu/serving.py`` for the MAE kind:

* :func:`prepare_serving` rebuilds a checkpoint (an npz of
  ``save_params_npz``, or one step of a checkpoint directory that the
  training CLIs write, rebuilt from its config sidecar) as
  ``forward(params, uint8_canvas)``: the eval preprocessing (normalize +
  center-crop resize), the unmasked encoder and the pooling, on one
  device. The checkpoint's ``attention_impl`` is honoured: one trained
  with ``pallas_v3`` serves through the Hopper attention kernel.
* :func:`build_serving_model` wraps it as a numpy-in, numpy-out
  :class:`ServingModel`.
* :class:`MicroBatcher` coalesces concurrent requests into batches padded to
  a few fixed sizes, with backpressure and per-request deadlines.

Not in this slice (``ROADMAP.md``): the classifier kind, int8 weights,
data-parallel serving and the exported artifact.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from cross_scale_mae_torch.configs import MAEConfig
from cross_scale_mae_torch.data.datasets import DATASET_STATS, normalize_on_device_for
from cross_scale_mae_torch.models.mae import compute_dtype, mae_encode
from cross_scale_mae_torch.ops.augment import make_eval_preprocess
from cross_scale_mae_torch.parallel.dist import resolve_device
from cross_scale_mae_torch.utils.checkpoint import (
    checkpoint_kind,
    checkpoint_meta,
    load_flat_npz,
    read_config_json,
    restore_arrays_host,
)
from cross_scale_mae_torch.utils.params import params_from_jax

POOLS = ("cls", "mean", "tokens")


@dataclasses.dataclass
class ServingModel:
    """A ready-to-call serving head with its input contract."""

    fn: Callable[[np.ndarray], np.ndarray]  # (B,canvas,canvas,C)u8 -> f32
    canvas: int
    channels: int
    batch_size: Optional[int]  # largest dispatch; None = any size
    kind: str                  # 'mae'
    meta: dict


def _cast_linears(tree: Any, dtype: torch.dtype) -> Any:
    """Linear kernels and biases cast once to the compute dtype: the same
    values ``layers.linear`` would cast them to on every call."""
    if isinstance(tree, list):
        return [_cast_linears(t, dtype) for t in tree]
    if isinstance(tree, dict):
        if "kernel" in tree:
            return {k: v.to(dtype) for k, v in tree.items()}
        return {k: _cast_linears(v, dtype) for k, v in tree.items()}
    return tree


def prepare_serving(
    ckpt: str,
    step: Optional[int] = None,
    pool: str = "cls",
    dataset_type: str = "fmow_rgb",
    canvas_scale: Optional[float] = None,
    device: torch.device | str = "cuda",
):
    """Checkpoint -> (forward(params, imgs), params, cfg, kind, canvas, C).

    ``ckpt`` is an npz of ``save_params_npz`` or a checkpoint directory,
    whose step ``step`` (the newest by default) is read through
    :func:`restore_arrays_host` and its sidecar config. ``forward`` takes a
    uint8 (B, canvas, canvas, C) tensor on ``device`` and returns float32
    pooled features: the cls token, the mean of the patch tokens, or all
    tokens (``pool``)."""
    dev = resolve_device(device)
    if pool not in POOLS:
        raise ValueError(f"unknown pool {pool!r}; known: {POOLS}")
    if os.path.isdir(ckpt):
        tree, step = restore_arrays_host(ckpt, step, subset=("params",))
        meta = checkpoint_meta(ckpt, step)
        if "config" not in meta:
            raise ValueError(f"{ckpt} has no config sidecar meta-{step}.json")
        config_json = json.dumps(meta["config"])
        tree = tree["params"]
    else:
        if step is not None:
            raise ValueError(
                f"{ckpt} is an npz, which holds one set of parameters: --step "
                "picks a step of a checkpoint directory")
        config_json = read_config_json(ckpt)
        if config_json is None:
            raise ValueError(
                f"{ckpt} has no __config__ entry: write it with "
                "save_params_npz(path, params, cfg.to_json())")
        tree = load_flat_npz(ckpt)
    if checkpoint_kind({"config": json.loads(config_json)}) == "classifier":
        raise NotImplementedError(
            "serving a finetune/linprobe classifier checkpoint is not ported "
            "yet; see ROADMAP.md (queue 1 items 12 and 15)")
    cfg = MAEConfig.from_json(config_json)
    params = params_from_jax(tree, cfg, dev)
    params = _cast_linears(params, compute_dtype(cfg))

    if dataset_type not in DATASET_STATS:
        raise ValueError(
            f"unknown dataset_type {dataset_type!r}; known: {sorted(DATASET_STATS)}")
    mean, std = DATASET_STATS[dataset_type]
    normalize = normalize_on_device_for(dataset_type)
    if normalize and len(mean) != cfg.input_channels:
        raise ValueError(
            f"dataset_type {dataset_type} has {len(mean)}-channel stats but "
            f"the checkpoint expects {cfg.input_channels} channels")
    scale = canvas_scale
    if scale is None:
        # The eval pipeline's Resize(input/0.875) + CenterCrop for inputs <= 224.
        scale = 1.0 / 0.875 if cfg.input_size <= 224 else 1.0
    canvas = int(round(cfg.input_size * scale))
    preprocess = make_eval_preprocess(
        mean, std, cfg.input_size, normalize=normalize, dtype=cfg.compute_dtype)

    def forward(p, imgs: torch.Tensor) -> torch.Tensor:
        feats = mae_encode(p, cfg, preprocess(imgs))
        if pool == "cls":
            out = feats[:, 0]
        elif pool == "mean":
            out = feats[:, 1:].mean(dim=1)
        else:
            out = feats
        return out.to(torch.float32)

    return forward, params, cfg, "mae", canvas, cfg.input_channels


def build_serving_model(
    ckpt: str,
    step: Optional[int] = None,
    pool: str = "cls",
    dataset_type: str = "fmow_rgb",
    canvas_scale: Optional[float] = None,
    batch_size: int = 64,
    quantize: Optional[str] = None,
    data_parallel: bool = False,
    device: torch.device | str = "cuda",
) -> ServingModel:
    """In-process serving head: numpy uint8 in, numpy float32 out, computed
    on ``device`` under ``torch.inference_mode``."""
    if quantize is not None:
        raise NotImplementedError(
            "quantized serving is not ported yet; see ROADMAP.md (queue 1 item 15)")
    if data_parallel:
        raise NotImplementedError(
            "data-parallel serving is not ported yet; see ROADMAP.md "
            "(queue 1 items 11 and 15)")
    dev = resolve_device(device)
    forward, params, cfg, kind, canvas, c = prepare_serving(
        ckpt, step, pool, dataset_type, canvas_scale, device=dev)

    def fn(imgs: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
            return forward(params, x).cpu().numpy()

    meta = {
        "source": "checkpoint", "ckpt": ckpt, "kind": kind, "pool": pool,
        "dataset_type": dataset_type,
        "input": [batch_size, canvas, canvas, c],
        "quantize": None, "data_parallel": None,
        "device": str(dev),
        "model_config": json.loads(cfg.to_json()),
    }
    return ServingModel(fn, canvas, c, batch_size, kind, meta)


class QueueFullError(RuntimeError):
    """Backpressure: the batcher queue is at ``max_queue_rows`` (HTTP 429)."""


class DeadlineExceededError(RuntimeError):
    """The request missed its end-to-end ``deadline_ms`` (HTTP 504)."""


class MicroBatcher:
    """Coalesce concurrent requests into one batched call.

    ``submit`` blocks the calling (HTTP handler) thread until its rows are
    computed. A single worker drains the queue: it waits up to
    ``max_delay_ms`` for more rows, takes up to ``max_batch`` rows, pads the
    batch to ``max_batch`` (or to the smallest of ``buckets`` that fits),
    runs ``fn`` once and scatters the slices back. With ``max_batch=None``
    batches are not padded. ``max_queue_rows`` rejects a submit that would
    queue more rows (:class:`QueueFullError`); ``deadline_ms`` bounds each
    request end to end (:class:`DeadlineExceededError`), and expired entries
    leave the queue before they cost a dispatch. Queue entries hold numpy
    arrays, so they are found and removed by identity, never by ``==``.
    """

    def __init__(self, fn, max_batch: Optional[int], canvas: int,
                 channels: int, max_delay_ms: float = 5.0,
                 buckets: Optional[list[int]] = None,
                 max_queue_rows: Optional[int] = None,
                 deadline_ms: Optional[float] = None):
        self._fn = fn
        self.max_batch = max_batch
        self.max_queue_rows = max_queue_rows
        self._deadline = None if deadline_ms is None else deadline_ms / 1e3
        if buckets is not None:
            buckets = sorted(set(int(b) for b in buckets))
            if not buckets or any(b < 1 for b in buckets):
                raise ValueError(f"bad batch buckets {buckets}")
            if max_batch is None:
                raise ValueError("buckets need a static max_batch")
            if buckets[-1] != max_batch:
                raise ValueError(
                    f"largest bucket {buckets[-1]} must equal the max batch "
                    f"{max_batch}")
        self.buckets = buckets
        self._shape = (canvas, canvas, channels)
        self._delay = max_delay_ms / 1e3
        self._cv = threading.Condition()
        self._queue: list[dict[str, Any]] = []
        self._closed = False
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_rows = 0
        self._n_dispatches = 0
        self._rows_dispatched = 0
        self._rows_padded = 0  # sum of dispatched (bucket) batch sizes
        self._rejected_full = 0
        self._deadline_expired = 0
        self._dispatch_ms: list[float] = []  # ring, newest last
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stats(self) -> dict:
        """Counters + latency percentiles over the recent-dispatch ring."""
        with self._cv:
            depth = len(self._queue)
        with self._stats_lock:
            lat = sorted(self._dispatch_ms)
            n = len(lat)
            pct = (lambda q: round(lat[min(n - 1, int(q * n))], 2)) if n \
                else (lambda q: None)
            fill = (self._rows_dispatched / self._rows_padded
                    if self._rows_padded and self.max_batch else None)
            return {
                "requests": self._n_requests,
                "rows": self._n_rows,
                "dispatches": self._n_dispatches,
                "mean_batch_fill": round(fill, 3) if fill is not None else None,
                "dispatch_ms_p50": pct(0.50),
                "dispatch_ms_p99": pct(0.99),
                "queue_depth": depth,
                "rejected_full": self._rejected_full,
                "deadline_expired": self._deadline_expired,
            }

    def submit(self, imgs: np.ndarray) -> np.ndarray:
        if imgs.ndim != 4 or imgs.shape[1:] != self._shape:
            raise ValueError(
                f"expected (n, {', '.join(map(str, self._shape))}) uint8, "
                f"got {imgs.shape}")
        if imgs.dtype != np.uint8:
            raise ValueError(f"expected uint8 input, got {imgs.dtype}")
        if len(imgs) == 0:
            raise ValueError("empty batch: need at least one row")
        chunk = self.max_batch or len(imgs)
        parts = [imgs[i:i + chunk] for i in range(0, len(imgs), chunk)]
        out: list[Any] = [None] * len(parts)
        done = threading.Event()
        deadline = (None if self._deadline is None
                    else time.monotonic() + self._deadline)
        left = [len(parts)]

        def make_cb(slot):
            def cb(result):
                out[slot] = result
                left[0] -= 1
                if left[0] == 0:
                    done.set()
            return cb

        entries = [{"rows": part, "cb": make_cb(i), "deadline": deadline}
                   for i, part in enumerate(parts)]
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self.max_queue_rows is not None:
                queued = sum(len(e["rows"]) for e in self._queue)
                if queued + len(imgs) > self.max_queue_rows:
                    with self._stats_lock:
                        self._rejected_full += 1
                    raise QueueFullError(
                        f"queue full: {queued} rows queued + {len(imgs)} "
                        f"requested > max_queue_rows={self.max_queue_rows}; "
                        f"retry later")
            with self._stats_lock:
                self._n_requests += 1
                self._n_rows += len(imgs)
            self._queue.extend(entries)
            self._cv.notify()
        if deadline is None:
            done.wait()
        elif not done.wait(timeout=max(deadline - time.monotonic(), 0.0)):
            # Pull our still-queued entries so the worker never spends a
            # dispatch on them; one already in flight completes into `out`,
            # which nobody reads.
            mine = {id(e) for e in entries}
            with self._cv:
                self._queue[:] = [e for e in self._queue if id(e) not in mine]
            with self._stats_lock:
                self._deadline_expired += 1
            raise DeadlineExceededError(
                f"request exceeded deadline_ms={self._deadline * 1e3:.0f} "
                "before completing")
        for part in out:
            if isinstance(part, Exception):
                raise part
        return np.concatenate(out, axis=0)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=5)

    def _take_batch(self) -> Optional[list[dict[str, Any]]]:
        """Under ``self._cv``: wait for work, purge expired entries, wait
        out the coalescing window, and pop the entries of one dispatch.
        Returns None once the batcher is closed and drained."""
        while True:
            while not self._queue and not self._closed:
                self._cv.wait()
            if self._closed and not self._queue:
                return None
            if self._deadline is not None:
                now = time.monotonic()
                expired = [e for e in self._queue
                           if e["deadline"] is not None and e["deadline"] <= now]
                if expired:
                    gone = {id(e) for e in expired}
                    self._queue[:] = [e for e in self._queue if id(e) not in gone]
                    with self._stats_lock:
                        self._deadline_expired += len(expired)
                    for e in expired:
                        e["cb"](DeadlineExceededError(
                            "request expired in queue (deadline_ms="
                            f"{self._deadline * 1e3:.0f})"))
                if not self._queue:
                    continue
            if self._delay > 0 and self.max_batch:
                until = time.monotonic() + self._delay
                while (sum(len(e["rows"]) for e in self._queue)
                       < self.max_batch and not self._closed):
                    wait = until - time.monotonic()
                    if wait <= 0:
                        break
                    self._cv.wait(timeout=wait)
                if not self._queue:  # every entry was pulled by its submitter
                    continue
            budget = self.max_batch or sum(len(e["rows"]) for e in self._queue)
            used = []
            # submit() chunks to max_batch, so the head always fits.
            while self._queue and budget >= len(self._queue[0]["rows"]):
                e = self._queue.pop(0)
                budget -= len(e["rows"])
                used.append(e)
            return used

    def _run(self):
        while True:
            with self._cv:
                used = self._take_batch()
            if used is None:
                return
            rows = np.concatenate([e["rows"] for e in used], axis=0)
            n = len(rows)
            target = self.max_batch
            if target and self.buckets:
                target = next(b for b in self.buckets if b >= n)
            if target and n < target:
                pad = np.zeros((target - n, *rows.shape[1:]), rows.dtype)
                rows = np.concatenate([rows, pad], axis=0)
            t0 = time.monotonic()
            try:
                result = self._fn(rows)[:n]
            except Exception as e:  # noqa: BLE001 — delivered to the waiters
                for entry in used:
                    entry["cb"](e)
                continue
            with self._stats_lock:
                self._n_dispatches += 1
                self._rows_dispatched += n
                self._rows_padded += target or n
                self._dispatch_ms.append((time.monotonic() - t0) * 1e3)
                if len(self._dispatch_ms) > 512:
                    del self._dispatch_ms[:-512]
            off = 0
            for entry in used:
                entry["cb"](result[off:off + len(entry["rows"])])
                off += len(entry["rows"])
