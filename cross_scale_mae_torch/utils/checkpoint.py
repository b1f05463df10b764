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

:func:`read_host_checkpoint` reads either form (a step directory or an npz)
as host trees with its config, and :func:`restore_classifier_host` rebuilds
a finetune or linprobe run from one, with the BN head's statistics.

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
from cross_scale_mae_torch.parallel.mesh import spec_of
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
    ``ckpt_dir``, with the sidecar. Every rank of a process group must call
    it: the leaves a mesh layout splits are gathered whole (the same file
    for every layout); rank 0 writes, and every rank waits until the step
    is in place."""
    ckpt_dir = _abs(ckpt_dir)
    # Gathering a split leaf is a collective: then every rank builds the
    # dict, else only rank 0.
    if is_main_process() or any(spec_of(t) is not None for t in tree_leaves(state.params)):
        state_dict = state.state_dict()
    if is_main_process():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"{step}.tmp")
        final = os.path.join(ckpt_dir, str(step))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        flat = {k: v.cpu() for k, v in state_dict.items()}
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
    place, on the device of its params, each split leaf taking this rank's
    part (any layout reads any other's checkpoint); returns (state, meta).
    A missing or unreadable file raises."""
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


def read_host_checkpoint(ckpt: str, step: Optional[int] = None
                         ) -> tuple[dict, dict, dict, Optional[int]]:
    """(config, params, model_state, step) of a checkpoint as host numpy
    trees in the JAX layout: a directory's step ``step`` (the newest by
    default) with its sidecar config, or an npz of ``save_params_npz`` with
    its ``__config__`` entry (``step`` None). An npz holds the params tree,
    or ``params`` and ``model_state`` subtrees side by side."""
    if os.path.isdir(ckpt):
        tree, step = restore_arrays_host(ckpt, step)
        meta = checkpoint_meta(ckpt, step)
        if "config" not in meta:
            raise ValueError(f"{ckpt} has no config sidecar meta-{step}.json")
        return meta["config"], tree.get("params", {}), tree.get("model_state", {}), step
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
    if "params" in tree and set(tree) <= {"params", "model_state"}:
        return json.loads(config_json), tree["params"], tree.get("model_state", {}), None
    return json.loads(config_json), tree, {}, None


def classifier_from_host(config: dict, tree: Mapping, state: Mapping,
                         device: torch.device | str = "cpu"):
    """(params, model_state, cfg) of a classifier from its host trees (of
    :func:`read_host_checkpoint`): fp32 tensors on ``device`` in the port's
    layout (``utils/params.vit_params_from_jax``), the BN head's running
    statistics in ``model_state["head_bn"]`` when the config has the BN
    head."""
    from cross_scale_mae_torch.configs import ViTClassifierConfig
    from cross_scale_mae_torch.utils.params import vit_params_from_jax

    cfg = ViTClassifierConfig.from_json(json.dumps(config))
    params = vit_params_from_jax(tree, cfg, device)
    model_state = {}
    if cfg.use_bn_head:
        bn = state.get("head_bn")
        if bn is None:
            raise ValueError("the config has the BN head but the checkpoint holds no "
                             "model_state/head_bn running statistics")
        model_state["head_bn"] = {
            k: torch.from_numpy(np.asarray(bn[k], np.float32).reshape(cfg.embed_dim)).to(device)
            for k in ("mean", "var")}
    return params, model_state, cfg


def restore_classifier_host(ckpt: str, step: Optional[int] = None,
                            device: torch.device | str = "cpu"):
    """A finetune or linprobe run rebuilt from its config (the JAX
    package's ``restore_classifier_host``): the port's checkpoint directory
    (step ``step``, the newest by default) or a ``save_params_npz`` file of
    a classifier tree, the JAX package's included; a BN-head npz holds the
    statistics as a ``model_state`` subtree beside ``params``. Returns
    (params, model_state, cfg) as :func:`classifier_from_host`."""
    config, tree, state, _ = read_host_checkpoint(ckpt, step)
    if checkpoint_kind({"config": config}) != "classifier":
        raise ValueError(f"{ckpt} is a pretrain (MAE) checkpoint, not a classifier's")
    return classifier_from_host(config, tree, state, device)
