"""Checkpoints of a training run, and the npz parameter file shared with the
JAX package (counterpart of ``cross_scale_mae_tpu/utils/checkpoint.py``).

Checkpoints keep the JAX package's layout: one directory per step under
``<ckpt_dir>/<step>/``, and beside it a ``meta-<step>.json`` sidecar
holding ``step``, the CLI's ``extra`` (``epoch``; ``max_acc`` for the
classifier CLIs) and the model ``config``, from which a checkpoint is
rebuilt without its run's flags. The step directory holds ``state.pt``: a
``torch.save`` of ``TrainState.state_dict()``, a flat dict keyed by the JAX
TrainState's '/'-joined paths (``params/...``, ``model_state/...``,
``opt_state/...``, ``step``), block leaves stacked on a leading layer axis,
loaded with ``weights_only=True``. The port reads no Orbax directory.

A save is atomic: rank 0 writes ``<step>.tmp/``, then the sidecar, then
renames the directory into place, and every rank waits for it
(``parallel/dist.barrier``). :func:`latest_step` trusts only complete step
directories, so a process killed during a write leaves nothing the next
attempt restores.

The npz file is the same on-disk format as ``save_params_npz`` /
``load_flat_npz`` of the JAX package: one npz whose keys are the
'/'-joined paths of the parameter tree (block leaves stacked on a leading
layer axis) and whose ``__config__`` entry is the model config's JSON as
uint8 bytes. numpy only.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Mapping, Optional

import numpy as np
import torch

from cross_scale_mae_torch.parallel.dist import barrier, is_main_process
from cross_scale_mae_torch.train.state import tree_leaves

CONFIG_KEY = "__config__"
STATE_FILE = "state.pt"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _write_json(path: str, obj: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, step: int, state, config_json: Optional[str] = None,
                    extra: Optional[dict[str, Any]] = None) -> None:
    """Write ``state`` (a ``train/state.TrainState``) as step ``step`` of
    ``ckpt_dir``, with the sidecar. Rank 0 writes; every rank of a process
    group must call it, and waits until the step is in place."""
    ckpt_dir = _abs(ckpt_dir)
    if is_main_process():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"{step}.tmp")
        final = os.path.join(ckpt_dir, str(step))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        flat = {k: v.cpu() for k, v in state.state_dict().items()}
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(flat, f)
            f.flush()
            os.fsync(f.fileno())
        meta = {"step": int(step), **(extra or {})}
        if config_json is not None:
            meta["config"] = json.loads(config_json)
        _write_json(os.path.join(ckpt_dir, f"meta-{step}.json"), meta)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    barrier()


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step in ``ckpt_dir``, or None (no directory, no
    checkpoint, or only an interrupted ``<step>.tmp`` write)."""
    ckpt_dir = _abs(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name) for name in os.listdir(ckpt_dir)
             if name.isdigit() and os.path.isfile(os.path.join(ckpt_dir, name, STATE_FILE))]
    return max(steps, default=None)


def _state_file(ckpt_dir: str, step: Optional[int]) -> tuple[str, int]:
    ckpt_dir = _abs(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(
            f"no checkpoints in {ckpt_dir} (the port reads the {STATE_FILE} step "
            "directories it writes, not the JAX package's Orbax directories)")
    return os.path.join(ckpt_dir, str(step), STATE_FILE), step


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Restore step ``step`` (the newest by default) into ``state`` in
    place, on the device of its params; returns (state, meta). A missing or
    unreadable file raises."""
    path, step = _state_file(ckpt_dir, step)
    device = tree_leaves(state.params)[0].device
    flat = torch.load(path, map_location=device, weights_only=True)
    state.load_state_dict(flat)
    return state, checkpoint_meta(ckpt_dir, step)


def restore_arrays_host(ckpt_dir: str, step: Optional[int] = None,
                        subset: Optional[tuple] = ("params", "model_state")):
    """A checkpoint's leaves as host numpy arrays in the JAX layout, with no
    TrainState to restore into (serving, a finetune's encoder): the nested
    dict of the top-level keys in ``subset`` (None for all, the optimizer
    state and ``step`` included; bf16 Adam moments as fp32, exactly, numpy
    having no bf16). Returns (tree, step)."""
    path, step = _state_file(ckpt_dir, step)
    flat = torch.load(path, map_location="cpu", weights_only=True)
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        if subset is not None and parts[0] not in subset:
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return tree, step


def checkpoint_meta(ckpt_dir: str, step: int) -> dict:
    """The sidecar ``meta-<step>.json`` of a checkpoint; {} when absent."""
    path = os.path.join(_abs(ckpt_dir), f"meta-{step}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def checkpoint_kind(meta: dict) -> str:
    """'classifier' (a finetune or linprobe run) or 'mae' (a pretrain run):
    classifier configs carry ``embed_dim``, MAE configs ``dim_model``."""
    return "classifier" if "embed_dim" in meta.get("config", {}) else "mae"


def _check_file(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: load_flat_npz reads one npz file of "
            "save_params_npz; a checkpoint directory of the port opens with "
            "restore_arrays_host")


def save_params_npz(path: str, params: Mapping[str, Any],
                    config_json: Optional[str] = None) -> None:
    """Write a nested dict of arrays (numpy, or CPU tensors) as one npz."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k], (*prefix, str(k)))
        else:
            if hasattr(node, "detach"):  # a torch tensor
                node = node.detach().cpu().numpy()
            flat["/".join(prefix)] = np.asarray(node)

    walk(params, ())
    if config_json is not None:
        flat[CONFIG_KEY] = np.frombuffer(config_json.encode(), np.uint8)
    np.savez(path, **flat)


def load_flat_npz(path: str) -> dict[str, Any]:
    """Rebuild the nested dict of numpy arrays from a ``save_params_npz``
    file ('/'-joined keys -> nesting), leaving out the config entry."""
    _check_file(path)
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key == CONFIG_KEY:
                continue
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def read_config_json(path: str) -> Optional[str]:
    """The config JSON stored in a ``save_params_npz`` file, or None."""
    _check_file(path)
    with np.load(path) as data:
        if CONFIG_KEY not in data.files:
            return None
        return bytes(data[CONFIG_KEY]).decode()
