"""The weight carry between the JAX package's parameter tree and the port's.

The JAX package keeps parameters as a nested dict with linear kernels in
(in, out) layout and every block leaf stacked on a leading (layers, ...)
axis. The port keeps the (in, out) layout (``layers.linear`` computes
``x @ W + b``), so nothing is transposed; the carry unstacks the block
leaves into a list of per-layer dicts. ``params_from_jax`` keeps only what
the encoder runs (serving, as the JAX package's ``serving.py:94-97``) or,
with ``full=True``, the whole tree the training step runs;
``state_from_jax`` carries the predictors' BatchNorm statistics;
``params_to_jax`` is the way back.
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


def mae_param_shapes(cfg: MAEConfig) -> dict:
    """Shapes of the whole tree of the JAX package's ``mae_init`` (blocks
    stacked): encoder, decoder, tokens and the configured predictors."""
    d, dd = cfg.dim_model, cfg.decoder_embed_dim
    spec = encoder_param_shapes(cfg.replace(apply_encoder_norm=True))
    spec.update({
        "mask_token": (1, 1, dd),
        "decoder_embed": _linear_shapes(d, dd),
        "decoder_blocks": _block_shapes(dd, dd * cfg.ffn_ratio, cfg.decoder_num_layers),
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
    return spec


def mae_state_shapes(cfg: MAEConfig) -> dict:
    """Shapes of the JAX ``mae_init`` state: predictor BatchNorm statistics."""
    spec = {}
    if cfg.use_cd_pred:
        spec["predictor_cd"] = {"bn": {"mean": (cfg.num_patches,),
                                       "var": (cfg.num_patches,)}}
    if cfg.use_ce_pred:
        spec["predictor_ce"] = {"bn": {"mean": (cfg.len_keep,), "var": (cfg.len_keep,)}}
    return spec


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
                    device: torch.device | str = "cpu", *,
                    full: bool = False) -> dict[str, Any]:
    """Map a JAX MAE parameter tree (nested dict of numpy arrays) to the
    port's params: fp32 tensors on ``device``, with each ``*_blocks`` stack
    a list of per-layer dicts.

    By default only the encoder's subtrees are kept and the others
    (decoder, mask token, predictors) dropped. ``full=True`` carries the
    whole ``mae_init`` tree and refuses any other top-level key. A missing
    key, an unexpected key inside a kept subtree or a wrong shape raises."""
    spec = mae_param_shapes(cfg) if full else encoder_param_shapes(cfg)
    if full:
        extra = sorted(set(tree) - set(spec))
        if extra:
            raise KeyError(f"unexpected parameter {extra[0]}")
    checked = {}
    for key, sub in spec.items():
        if key not in tree:
            raise KeyError(f"parameter tree lacks {key}")
        checked[key] = _checked(tree[key], sub, key)
    depth = {"encoder_blocks": cfg.encoder_num_layers,
             "decoder_blocks": cfg.decoder_num_layers}
    return {k: ([_to_torch(v, device, i) for i in range(depth[k])] if k in depth
                else _to_torch(v, device))
            for k, v in checked.items()}


def state_from_jax(state: Mapping[str, Any], cfg: MAEConfig,
                   device: torch.device | str = "cpu") -> dict[str, Any]:
    """The JAX ``mae_init`` state (predictor BatchNorm statistics) as fp32
    tensors on ``device``; the same checks as :func:`params_from_jax`."""
    return _to_torch(_checked(state, mae_state_shapes(cfg), "state"), device)


def params_to_jax(tree: Any) -> Any:
    """The inverse carry: the port's params or state (tensors, block stacks
    as lists) -> the JAX layout as numpy arrays (fp32), block leaves stacked
    on a leading layer axis."""
    if isinstance(tree, Mapping):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        layers = [params_to_jax(v) for v in tree]
        return _stack(layers)
    return tree.detach().to("cpu", torch.float32).numpy()


def _stack(layers: list) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers, axis=0)


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

    return fill(mae_param_shapes(cfg))
