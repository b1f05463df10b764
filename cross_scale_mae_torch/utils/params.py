"""The weight carry: the JAX package's parameter tree -> the port's tensors.

The JAX package keeps parameters as a nested dict with linear kernels in
(in, out) layout and every encoder-block leaf stacked on a leading
(layers, ...) axis. The port keeps the (in, out) layout (``layers.linear``
computes ``x @ W + b``), so nothing is transposed; the carry unstacks the
block leaves into a list of per-layer dicts and keeps only what the encoder
runs, as the JAX package's serving does (``serving.py:94-97``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from cross_scale_mae_torch.configs import MAEConfig


def _linear_shapes(d_in: int, d_out: int, lead: tuple = ()) -> dict:
    return {"kernel": (*lead, d_in, d_out), "bias": (*lead, d_out)}


def _norm_shapes(dim: int, lead: tuple = ()) -> dict:
    return {"scale": (*lead, dim), "bias": (*lead, dim)}


def _block_shapes(dim: int, hidden: int, layers: int) -> dict:
    lead = (layers,)
    return {
        "norm1": _norm_shapes(dim, lead),
        "attn": {"qkv": _linear_shapes(dim, 3 * dim, lead),
                 "proj": _linear_shapes(dim, dim, lead)},
        "norm2": _norm_shapes(dim, lead),
        "mlp": {"fc1": _linear_shapes(dim, hidden, lead),
                "fc2": _linear_shapes(hidden, dim, lead)},
    }


def encoder_param_shapes(cfg: MAEConfig) -> dict:
    """Shapes of the encoder subtrees in the JAX layout (blocks stacked)."""
    d = cfg.dim_model
    shapes = {
        "patch_embed": _linear_shapes(cfg.patch_dim, d),
        "cls_token": (1, 1, d),
        "encoder_blocks": _block_shapes(d, d * cfg.ffn_ratio,
                                        cfg.encoder_num_layers),
    }
    if cfg.apply_encoder_norm:
        shapes["encoder_norm"] = _norm_shapes(d)
    return shapes


def _checked(node: Any, spec: Any, path: str) -> Any:
    if isinstance(spec, dict):
        if not isinstance(node, Mapping):
            raise ValueError(f"{path}: expected a subtree, got {type(node).__name__}")
        missing = sorted(set(spec) - set(node))
        extra = sorted(set(node) - set(spec))
        if missing:
            raise KeyError(f"parameter tree lacks {path}/{missing[0]}")
        if extra:
            raise KeyError(f"unexpected parameter {path}/{extra[0]}")
        return {k: _checked(node[k], spec[k], f"{path}/{k}") for k in spec}
    arr = np.asarray(node)
    if arr.shape != spec:
        raise ValueError(f"{path}: shape {arr.shape}, expected {spec}")
    return arr.astype(np.float32)


def _to_torch(tree: Any, device, index: int | None = None) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    arr = tree if index is None else tree[index]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def params_from_jax(tree: Mapping[str, Any], cfg: MAEConfig,
                    device: torch.device | str = "cpu") -> dict[str, Any]:
    """Map a JAX MAE parameter tree (nested dict of numpy arrays) to the
    port's encoder params: fp32 tensors on ``device``, with
    ``encoder_blocks`` a list of per-layer dicts. Subtrees the encoder does
    not run (decoder, mask token, predictors) are dropped; a missing key,
    an unexpected key inside a kept subtree or a wrong shape raises."""
    spec = encoder_param_shapes(cfg)
    checked = {}
    for key, sub in spec.items():
        if key not in tree:
            raise KeyError(f"parameter tree lacks {key}")
        checked[key] = _checked(tree[key], sub, key)
    out = {k: _to_torch(v, device) for k, v in checked.items()
           if k != "encoder_blocks"}
    out["encoder_blocks"] = [
        _to_torch(checked["encoder_blocks"], device, i)
        for i in range(cfg.encoder_num_layers)
    ]
    return out


def random_mae_tree(cfg: MAEConfig, seed: int) -> dict[str, Any]:
    """A seeded random MAE parameter tree in the JAX layout, with the JAX
    package's full set of subtrees (encoder, decoder, predictors) so that a
    file written from it exercises the carry's drop. Kernels are
    xavier-uniform as in ``mae_init``; biases, norm parameters and tokens are
    small random values, so that no parameter is a constant a wrong mapping
    could hide behind."""
    rng = np.random.default_rng(seed)

    def draw(shape, name):
        if name == "kernel":
            fan_in, fan_out = shape[-2], shape[-1]
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            return rng.uniform(-lim, lim, shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)

    def fill(spec, name=""):
        if isinstance(spec, dict):
            return {k: fill(v, k) for k, v in spec.items()}
        return draw(spec, name)

    d, dd = cfg.dim_model, cfg.decoder_embed_dim
    spec = encoder_param_shapes(cfg.replace(apply_encoder_norm=True))
    spec.update({
        "mask_token": (1, 1, dd),
        "decoder_embed": _linear_shapes(d, dd),
        "decoder_blocks": _block_shapes(dd, dd * cfg.ffn_ratio,
                                        cfg.decoder_num_layers),
        "decoder_norm": _norm_shapes(dd),
        "decoder_pred": _linear_shapes(dd, cfg.patch_dim),
    })
    hidden = cfg.predictor_hidden_size
    if cfg.use_cd_pred:
        spec["predictor_cd"] = {"fc1": _linear_shapes(dd, hidden),
                                "bn": _norm_shapes(cfg.num_patches),
                                "fc2": _linear_shapes(hidden, dd)}
    if cfg.use_ce_pred:
        spec["predictor_ce"] = {"fc1": _linear_shapes(d, hidden),
                                "bn": _norm_shapes(cfg.len_keep),
                                "fc2": _linear_shapes(hidden, d)}
    return fill(spec)
