"""Checkpoints of a training run, and the npz parameter file shared with the
JAX package (counterpart of ``cross_scale_mae_tpu/utils/checkpoint.py``).

Checkpoints keep the JAX package's layout: one directory per step under
``<ckpt_dir>/<step>/``, and beside it a ``meta-<step>.json`` sidecar
holding ``step``, the CLI's ``extra`` (``epoch``; ``max_acc`` for the
classifier CLIs) and the model ``config``, from which a checkpoint is
rebuilt without its run's flags. A step directory holds one of two forms:

* the port's own, ``state.pt``: a ``torch.save`` of
  ``TrainState.state_dict()``, a flat dict keyed by the JAX TrainState's
  '/'-joined paths (``params/...``, ``model_state/...``, ``opt_state/...``,
  ``step``), block leaves stacked on a leading layer axis, loaded with
  ``weights_only=True``; the port's CLIs write it;
* the JAX package's, an Orbax step (``_CHECKPOINT_METADATA`` and
  ``default/``: OCDBT and zarr), read and written by ``utils/orbax.py``
  without JAX. Every function here that opens a step takes either, so a run
  trained by the JAX package is resumed, finetuned from, served, embedded,
  exported and visualized by the port; its optimizer state is placed by
  ``utils/params.train_state_flat_from_jax`` and then restored as a
  ``state.pt`` is. :func:`save_orbax_checkpoint` writes the JAX form from
  the port's state (``utils/params.jax_train_state``).

A save is atomic: rank 0 writes ``<step>.tmp/``, then the sidecar, then
renames the directory into place, and every rank waits for it
(``parallel/dist.barrier``). :func:`latest_step` trusts only complete step
directories (``state.pt`` in place, or a finished Orbax step), so a process
killed during a write leaves nothing the next attempt restores.

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
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from cross_scale_mae_torch.parallel.dist import barrier, is_main_process
from cross_scale_mae_torch.parallel.mesh import spec_of
from cross_scale_mae_torch.train.state import tree_leaves
from cross_scale_mae_torch.utils import orbax
from cross_scale_mae_torch.utils.params import jax_train_state, train_state_flat_from_jax

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
    ``ckpt_dir`` (``state.pt``), with the sidecar. Every rank of a process
    group must call it: the leaves a mesh layout splits are gathered whole
    (the same file for every layout); rank 0 writes, and every rank waits
    until the step is in place."""
    def write(step_dir: str, flat: dict[str, torch.Tensor]) -> None:
        with open(os.path.join(step_dir, STATE_FILE), "wb") as f:
            torch.save(flat, f)
            f.flush()
            os.fsync(f.fileno())

    _write_checkpoint(ckpt_dir, step, state, config_json, extra, write)


def save_orbax_checkpoint(ckpt_dir: str, step: int, state, config_json: Optional[str] = None,
                          extra: Optional[dict[str, Any]] = None) -> None:
    """Write ``state`` as step ``step`` of ``ckpt_dir`` in the JAX package's
    Orbax form (its ``save_checkpoint``): the JAX tree paths and the optax
    state of the options ``state.tx`` was built with
    (``utils/params.jax_train_state``; options whose optax structure is not
    known are refused), with the same sidecar and atomic write as
    :func:`save_checkpoint`. Every rank of a process group must call it."""
    def write(step_dir: str, flat: dict[str, torch.Tensor]) -> None:
        orbax.write_step(step_dir, jax_train_state(flat, state.tx))

    _write_checkpoint(ckpt_dir, step, state, config_json, extra, write)


def _write_checkpoint(ckpt_dir: str, step: int, state, config_json: Optional[str],
                     extra: Optional[dict[str, Any]],
                     write: Callable[[str, dict[str, torch.Tensor]], None]) -> None:
    """The atomic save both forms share: ``write(step_dir, flat)`` fills
    ``<step>.tmp/`` from the host copy of ``state.state_dict()``, then the
    sidecar is written and the directory renamed into place."""
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
        write(tmp, {k: v.cpu() for k, v in state_dict.items()})
        meta = {"step": int(step), **(extra or {})}
        if config_json is not None:
            meta["config"] = json.loads(config_json)
        _write_json(os.path.join(ckpt_dir, f"meta-{step}.json"), meta)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    barrier()


def _complete(step_dir: str) -> bool:
    return os.path.isfile(os.path.join(step_dir, STATE_FILE)) or orbax.is_step(step_dir)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step in ``ckpt_dir`` in either form, or None (no
    directory, no checkpoint, or only an interrupted ``<step>.tmp`` or
    Orbax ``<step>.orbax-checkpoint-tmp-*`` write)."""
    ckpt_dir = _abs(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name) for name in os.listdir(ckpt_dir)
             if name.isdigit() and _complete(os.path.join(ckpt_dir, name))]
    return max(steps, default=None)


def _step_dir(ckpt_dir: str, step: Optional[int]) -> tuple[str, int, bool]:
    """(step directory, step, whether it is an Orbax step)."""
    ckpt_dir = _abs(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(
            f"no checkpoints in {ckpt_dir} (a step directory holds the port's "
            f"{STATE_FILE} or the JAX package's finished Orbax step)")
    step_dir = os.path.join(ckpt_dir, str(step))
    is_orbax = not os.path.isfile(os.path.join(step_dir, STATE_FILE)) and orbax.is_step(step_dir)
    return step_dir, step, is_orbax


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Restore step ``step`` (the newest by default) into ``state`` in
    place, on the device of its params, each split leaf taking this rank's
    part (any layout reads any other's checkpoint); returns (state, meta).
    An Orbax step's optimizer state must have the structure of the options
    ``state.tx`` was built with (``utils/params.opt_state_from_jax``). A
    missing or unreadable file, or a state that does not fit, raises."""
    step_dir, step, is_orbax = _step_dir(ckpt_dir, step)
    if is_orbax:
        flat = train_state_flat_from_jax(orbax.read_step(step_dir, subset=None), state.tx)
    else:
        device = tree_leaves(state.params)[0].device
        flat = torch.load(os.path.join(step_dir, STATE_FILE), map_location=device,
                          weights_only=True)
    state.load_state_dict(flat)
    return state, checkpoint_meta(ckpt_dir, step)


def _host(tree: Any) -> Any:
    """An Orbax tree's leaves as numpy, bf16 ones (torch tensors) as fp32."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host(v) for v in tree]
    return tree.float().numpy() if isinstance(tree, torch.Tensor) else tree


def restore_orbax_host(ckpt_dir: str, step: Optional[int] = None,
                       subset: Optional[tuple] = ("params", "model_state")):
    """The JAX package's ``restore_arrays_host`` without JAX: an Orbax step
    (the newest complete step by default, which must be one) as
    ``utils/orbax.read_step`` gives it, bf16 leaves as torch bf16. Returns
    (tree, step)."""
    step_dir, step, is_orbax = _step_dir(ckpt_dir, step)
    if not is_orbax:
        raise orbax.OrbaxFormatError(f"{step_dir}: holds the port's {STATE_FILE}, not an "
                                     "Orbax step")
    return orbax.read_step(step_dir, subset), step


def restore_arrays_host(ckpt_dir: str, step: Optional[int] = None,
                        subset: Optional[tuple] = ("params", "model_state")):
    """A checkpoint's leaves as host numpy arrays in the JAX layout, with no
    TrainState to restore into (serving, a finetune's encoder): the nested
    dict of the top-level keys in ``subset`` (None for all, the optimizer
    state and ``step`` included; bf16 leaves as fp32, exactly, numpy having
    no bf16). An Orbax step's optimizer state keeps its optax structure
    (lists for chains); a ``state.pt``'s is the port's flat one. Returns
    (tree, step)."""
    step_dir, step, is_orbax = _step_dir(ckpt_dir, step)
    if is_orbax:
        return _host(orbax.read_step(step_dir, subset)), step
    flat = torch.load(os.path.join(step_dir, STATE_FILE), map_location="cpu",
                      weights_only=True)
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
            "save_params_npz; a checkpoint directory (the port's or the JAX "
            "package's Orbax one) opens with restore_arrays_host")


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
    default; the port's ``state.pt`` or a JAX run's Orbax step) with its
    sidecar config, or an npz of ``save_params_npz`` with
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
    package's ``restore_classifier_host``): a checkpoint directory, the
    port's or a JAX run's Orbax one (step ``step``, the newest by default),
    or a ``save_params_npz`` file of
    a classifier tree, the JAX package's included; a BN-head npz holds the
    statistics as a ``model_state`` subtree beside ``params``. Returns
    (params, model_state, cfg) as :func:`classifier_from_host`."""
    config, tree, state, _ = read_host_checkpoint(ckpt, step)
    if checkpoint_kind({"config": config}) != "classifier":
        raise ValueError(f"{ckpt} is a pretrain (MAE) checkpoint, not a classifier's")
    return classifier_from_host(config, tree, state, device)
