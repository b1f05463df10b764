"""Serving core: checkpoint or exported artifact -> callable forward +
micro-batcher (counterpart of ``cross_scale_mae_tpu/serving.py``).

* :func:`prepare_serving` rebuilds a checkpoint (an npz of
  ``save_params_npz``, or one step of a checkpoint directory that the
  training CLIs write, rebuilt from its config sidecar) as
  ``forward(params, uint8_canvas)``: the eval preprocessing (normalize +
  center-crop resize), then for a pretrain (MAE) run the unmasked encoder
  and the pooling, for a finetune or linprobe run the classifier's logits
  (the BN head's running statistics in eval mode). The checkpoint's
  ``attention_impl`` is honoured: ``pallas_v3`` serves through K1f
  (``csrc/mha3_fwd.cu``), ``pallas`` through K2f (``csrc/mha_fwd.cu``);
  ``portable=True`` (the export) takes the plain attention instead, and a
  variant attention (linformer, ...) serves as itself either way.
* :func:`build_serving_model` wraps it as a numpy-in, numpy-out
  :class:`ServingModel`, optionally from int8 weights (``quant.py``) and
  data parallel over a list of devices, one replica of the params each.
* :func:`load_artifact` serves a ``torch.export`` artifact of
  ``cli/export.py`` with its ``.json`` sidecar.
* :class:`MicroBatcher` coalesces concurrent requests into batches padded to
  a few fixed sizes, with backpressure and per-request deadlines.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import numpy as np
import torch

from cross_scale_mae_torch.configs import MAEConfig, ViTClassifierConfig
from cross_scale_mae_torch.data.datasets import DATASET_STATS, normalize_on_device_for
from cross_scale_mae_torch.models.layers import KERNEL_IMPLS
from cross_scale_mae_torch.models.mae import compute_dtype, mae_encode
from cross_scale_mae_torch.models.vit import vit_apply
from cross_scale_mae_torch.ops.augment import make_eval_preprocess
from cross_scale_mae_torch.parallel.dist import resolve_device
from cross_scale_mae_torch.quant import is_qnode, quantize_params_int8, quantized_bytes
from cross_scale_mae_torch.utils.checkpoint import (
    checkpoint_kind,
    classifier_from_host,
    load_flat_npz,
    read_host_checkpoint,
)
from cross_scale_mae_torch.utils.params import params_from_jax, vit_params_from_jax

POOLS = ("cls", "mean", "tokens")


@dataclasses.dataclass
class ServingModel:
    """A ready-to-call serving head with its input contract."""

    fn: Callable[[np.ndarray], np.ndarray]  # (B,canvas,canvas,C)u8 -> f32
    canvas: int
    channels: int
    batch_size: Optional[int]  # largest dispatch; None = any size
    kind: str                  # 'mae' | 'classifier'
    meta: dict


def cast_linears(tree: Any, dtype: torch.dtype) -> Any:
    """Linear kernels and biases cast once to the compute dtype: the same
    values ``layers.linear`` would cast them to on every call. An int8
    kernel stays int8 (``layers.linear`` dequantizes it per call)."""
    if isinstance(tree, list):
        return [cast_linears(t, dtype) for t in tree]
    if isinstance(tree, dict):
        if "kernel" in tree:
            return {k: v if is_qnode(v) else v.to(dtype) for k, v in tree.items()}
        return {k: cast_linears(v, dtype) for k, v in tree.items()}
    return tree


def to_device(tree: Any, device: torch.device) -> Any:
    """A params tree (dicts and lists of tensors) copied onto ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def params_from_host(config: dict, tree: dict, device: torch.device | str = "cpu") -> dict:
    """A serving tree in the JAX layout (an npz sidecar's, fp32 or int8)
    carried into the port's on ``device``: the classifier's whole tree, or
    the MAE encoder's subtrees, by the model config ``config``."""
    if checkpoint_kind({"config": config}) == "classifier":
        return vit_params_from_jax(tree, ViTClassifierConfig.from_json(json.dumps(config)), device)
    return params_from_jax(tree, MAEConfig.from_json(json.dumps(config)), device)


def pool_features(feats: torch.Tensor, pool: str) -> torch.Tensor:
    """Encoder tokens (N, 1+L, D) -> float32 ``pool``: the cls token, the
    mean of the patch tokens, or all tokens."""
    if pool == "cls":
        out = feats[:, 0]
    elif pool == "mean":
        out = feats[:, 1:].mean(dim=1)
    else:
        out = feats
    return out.to(torch.float32)


def make_forward(cfg, kind: str, pool: str, dataset_type: str, model_state=None):
    """``forward(params, imgs)``: uint8 (B, canvas, canvas, C) on a device ->
    float32 pooled features (MAE) or logits (classifier), eval semantics."""
    if pool not in POOLS:
        raise ValueError(f"unknown pool {pool!r}; known: {POOLS}")
    if dataset_type not in DATASET_STATS:
        raise ValueError(
            f"unknown dataset_type {dataset_type!r}; known: {sorted(DATASET_STATS)}")
    mean, std = DATASET_STATS[dataset_type]
    normalize = normalize_on_device_for(dataset_type)
    if normalize and len(mean) != cfg.input_channels:
        raise ValueError(
            f"dataset_type {dataset_type} has {len(mean)}-channel stats but "
            f"the checkpoint expects {cfg.input_channels} channels")
    preprocess = make_eval_preprocess(
        mean, std, cfg.input_size, normalize=normalize, dtype=cfg.compute_dtype)

    if kind == "classifier":
        state = model_state or {}

        def forward(p, imgs: torch.Tensor) -> torch.Tensor:
            # The BN head's running statistics ride along, eval semantics.
            st = {k: {n: t.to(imgs.device) for n, t in v.items()} for k, v in state.items()}
            logits, _ = vit_apply(p, st, cfg, preprocess(imgs), train=False)
            return logits.to(torch.float32)
        return forward

    def forward(p, imgs: torch.Tensor) -> torch.Tensor:
        return pool_features(mae_encode(p, cfg, preprocess(imgs)), pool)
    return forward


def canvas_of(cfg, canvas_scale: Optional[float]) -> int:
    # The eval pipeline's Resize(input/0.875) + CenterCrop for inputs <= 224.
    scale = canvas_scale
    if scale is None:
        scale = 1.0 / 0.875 if cfg.input_size <= 224 else 1.0
    return int(round(cfg.input_size * scale))


def prepare_serving(
    ckpt: str,
    step: Optional[int] = None,
    pool: str = "cls",
    dataset_type: str = "fmow_rgb",
    canvas_scale: Optional[float] = None,
    device: torch.device | str = "cuda",
    portable: bool = False,
):
    """Checkpoint -> (forward(params, imgs), params, cfg, kind, canvas, C).

    ``ckpt`` is an npz of ``save_params_npz`` or a checkpoint directory,
    whose step ``step`` (the newest by default) is read with its sidecar
    config. ``params`` are fp32 tensors on ``device`` in the port's layout:
    a classifier's whole tree, or the MAE encoder's subtrees alone (the
    decoder and predictors dropped). ``forward`` takes a uint8 (B, canvas,
    canvas, C) tensor and returns float32 logits (classifier) or pooled
    features: the cls token, the mean of the patch tokens, or all tokens
    (``pool``). ``portable`` takes the plain attention (``'xla'``) in place
    of a kernel impl, as ``cli/export.py`` needs; a variant attention stays
    what the checkpoint trained with."""
    dev = resolve_device(device)
    config, tree, state, step = read_host_checkpoint(ckpt, step)
    kind = checkpoint_kind({"config": config})
    model_state = None
    if kind == "classifier":
        params, model_state, cfg = classifier_from_host(config, tree, state, dev)
    else:
        cfg = MAEConfig.from_json(json.dumps(config))
        params = params_from_jax(tree, cfg, dev)
    if portable and cfg.attention_impl in KERNEL_IMPLS:
        # Only a kernel gives way to its plain version: a variant is another
        # model (JAX serving.py:98-99 exports every checkpoint as exact
        # attention, linformer's E and F unused).
        cfg = cfg.replace(attention_impl="xla")
    forward = make_forward(cfg, kind, pool, dataset_type, model_state)
    return forward, params, cfg, kind, canvas_of(cfg, canvas_scale), cfg.input_channels


def serving_devices(device: torch.device | str, data_parallel: bool,
                    devices: Optional[list] = None) -> list[torch.device]:
    """The devices that hold a replica: ``devices`` when given, else with
    ``data_parallel`` every visible CUDA device (``device`` itself on a CPU
    host), else ``device`` alone."""
    if devices:
        return [resolve_device(d) for d in devices]
    dev = resolve_device(device)
    if data_parallel and dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def replicated_fn(forward, replicas: list, devices: list[torch.device]):
    """numpy uint8 -> numpy float32 over one replica of the params per
    device: each call's rows split evenly (``np.array_split``), the replicas
    run concurrently, one thread each, and the outputs gathered in row
    order. One device runs in the calling thread."""
    def run(i: int, rows: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(rows)).to(devices[i])
            return forward(replicas[i], x).cpu().numpy()

    if len(devices) == 1:
        return lambda imgs: run(0, imgs)
    pool = ThreadPoolExecutor(max_workers=len(devices), thread_name_prefix="replica")

    def fn(imgs: np.ndarray) -> np.ndarray:
        parts = np.array_split(imgs, len(devices))
        futures = [pool.submit(run, i, part) for i, part in enumerate(parts)]
        return np.concatenate([f.result() for f in futures], axis=0)
    return fn


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
    devices: Optional[list] = None,
    portable: bool = False,
) -> ServingModel:
    """In-process serving head: numpy uint8 in, numpy float32 out, computed
    under ``torch.inference_mode``.

    ``quantize='int8'`` keeps every matmul kernel on the device as int8
    codes with per-channel scales (``quant.py``); each linear dequantizes
    its kernel just before its matmul. ``data_parallel`` keeps one replica
    of the params on each of ``devices`` (default: every visible CUDA
    device), splits each dispatch's rows evenly over them and gathers the
    outputs in row order; ``batch_size`` must divide by the device count.
    At one device it is the same program as without it. ``portable`` runs
    the plain attention, as the exported artifact does. ``meta`` records
    ``param_bytes``, the bytes of one replica's params on its device."""
    devs = serving_devices(device, data_parallel, devices)
    n_dev = len(devs) if data_parallel else None
    if data_parallel and batch_size % len(devs):
        raise SystemExit(
            f"--batch_size {batch_size} must be divisible by the device "
            f"count {len(devs)} for data-parallel serving")
    forward, params, cfg, kind, canvas, c = prepare_serving(
        ckpt, step, pool, dataset_type, canvas_scale, device="cpu", portable=portable)
    quant_info = None
    if quantize == "int8":
        params = quantize_params_int8(params)
        qb, fb = quantized_bytes(params)
        quant_info = {"scheme": "int8_weight_only", "bytes": qb, "fp32_bytes": fb}
    elif quantize is not None:
        raise SystemExit(f"unknown quantization scheme {quantize!r}")
    params = cast_linears(params, compute_dtype(cfg))
    replicas = [to_device(params, d) for d in devs]
    meta = {
        "source": "checkpoint", "ckpt": ckpt, "kind": kind,
        "pool": pool if kind == "mae" else "n/a (classifier head)",
        "dataset_type": dataset_type,
        "input": [batch_size, canvas, canvas, c],
        "quantize": quant_info, "data_parallel": n_dev,
        "device": ",".join(str(d) for d in devs),
        "param_bytes": quantized_bytes(params)[0],
        "model_config": json.loads(cfg.to_json()),
    }
    return ServingModel(replicated_fn(forward, replicas, devs), canvas, c, batch_size,
                        kind, meta)


def concrete_device(device: torch.device | str) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def load_artifact(path: str, device: torch.device | str = "cuda") -> ServingModel:
    """Exported artifact of ``cli/export.py`` (``torch.export.save`` of the
    serving forward, + its ``.json`` sidecar) -> ServingModel on ``device``.

    Serves all three export forms: baked weights, ``--no_bake_weights``
    (fp32 params in ``<path>.params.npz``) and ``--quantize int8`` (int8
    codes in ``<path>.q8.npz``; the dequantize is part of the program). A
    sidecar path that does not exist (exported on another host) falls back
    to the file of that name next to the artifact. A program exported for
    another device than ``device`` is moved onto it
    (``torch.export.passes.move_to_device_pass``); a torch without that
    pass refuses the mismatch."""
    dev = concrete_device(device)
    try:
        with open(path + ".json") as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise SystemExit(
            f"{path}.json sidecar not found next to the artifact; "
            "cli/export.py writes it: serve from the original export") from None
    program = torch.export.load(path)
    exported_on = torch.device(meta["device"])
    if exported_on != dev:
        try:
            from torch.export.passes import move_to_device_pass
        except ImportError:
            raise SystemExit(
                f"{path} was exported for {exported_on} and this torch cannot move "
                f"an exported program onto {dev}: export it for {dev.type}") from None
        program = move_to_device_pass(program, dev)
    module = program.module()
    weights = meta.get("weights", "baked")
    wtree = None
    if isinstance(weights, str) and weights != "baked":
        if not os.path.exists(weights):  # exported on another host?
            local = path + (".q8.npz" if weights.endswith(".q8.npz") else ".params.npz")
            if not os.path.exists(local):
                raise SystemExit(f"weights sidecar not found: {weights} (nor {local})")
            weights = local
        wtree = params_from_host(meta["model_config"], load_flat_npz(weights), dev)
    b, canvas, _, c = meta["input"]

    def fn(imgs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
            out = module(x) if wtree is None else module(wtree, x)
            return out.cpu().numpy()

    meta = dict(meta, source="artifact", artifact=path, device=str(dev))
    return ServingModel(fn, int(canvas), int(c), b if b is None else int(b),
                        meta["kind"], meta)


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
