"""The npz parameter file shared with the JAX package.

The same on-disk format as ``save_params_npz`` / ``load_flat_npz`` in
``cross_scale_mae_tpu/utils/checkpoint.py``: one npz whose keys are the
'/'-joined paths of the parameter tree (block leaves stacked on a leading
layer axis, as the JAX package keeps them) and whose ``__config__`` entry is
the model config's JSON as uint8 bytes. numpy only.

This file is the port's checkpoint for now. Restoring the JAX package's
Orbax checkpoint directories is queued in ``ROADMAP.md`` (queue 1 item 9);
write the npz from a JAX run with
``cross_scale_mae_tpu.utils.checkpoint.save_params_npz(path, params,
cfg.to_json())``.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import numpy as np

CONFIG_KEY = "__config__"


def _check_file(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the port reads the single-file npz of "
            "save_params_npz, not an Orbax checkpoint directory (restoring "
            "those is queued in ROADMAP.md, queue 1 item 9). Write one from "
            "JAX with cross_scale_mae_tpu.utils.checkpoint.save_params_npz("
            "path, params, cfg.to_json()).")


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
