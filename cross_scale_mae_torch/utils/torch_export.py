"""The port's params -> the reference's ``.pth`` schema (counterpart of
``cross_scale_mae_tpu/utils/torch_export.py``; the inverse of
``utils/torch_import.py``).

* The payload is ``{"model": state_dict, "args": argparse.Namespace,
  "epoch": N}``, the part of ``util/misc.py:358-379``'s that every
  reference load path reads.
* timm-layout names of ``MAE_ViT_Baseline`` (``use_xformers=False``):
  ``encoder.N.*`` and ``decoder.N.*`` blocks, the ``patch_embed.proj`` conv
  (OIHW), the fused ``attn.qkv``; torch Linear weights are (out, in), the
  port's kernels (in, out), so each is transposed. The port's blocks are
  already per layer, so nothing is unstacked.
* The fixed sin-cos tables are persistent parameters in the reference
  (``encoder_pos_embed``, ``decoder_pos_embed``) and are written from
  ``ops/pos_embed.py``.
* The predictor MLP is ``predictor.{0,1,3}.*``, its BatchNorm's running
  statistics from the model state when given.
* ``args.patch_size`` is a ``str``, as the reference parser declares it.
* Linformer's E and F (``e_proj``, ``f_proj``) have no key in that schema:
  a tree that holds them refuses, naming the keys, rather than lose them.
* A classifier exports in ``models_vit`` naming (``blocks.N.*``, trainable
  ``pos_embed``, ``head``, ``fc_norm`` or ``norm``); a linear probe's BN head
  as ``head.0`` (the running statistics) and ``head.1`` (the Linear).
"""

from __future__ import annotations

import argparse
from typing import Any, Mapping, Optional

import numpy as np

from cross_scale_mae_torch.configs import _VARIANTS, _VIT_SIZES, VIT_SIZES, MAEConfig
from cross_scale_mae_torch.ops.pos_embed import get_2d_sincos_pos_embed

Params = Mapping[str, Any]


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        import torch

        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _linear_out(sd: dict, prefix: str, p: Params) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(_np(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _np(p["bias"])


def _norm_out(sd: dict, prefix: str, p: Params) -> None:
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])


def _refuse_projections(stacks: dict[str, list]) -> None:
    """ValueError naming every linformer E and F key of the ``{prefix:
    blocks}`` stacks: the reference's timm blocks have no place for them,
    and the JAX package's ``_blocks_out`` drops them silently."""
    lost = [f"{prefix}.{i}.attn.{name}" for prefix, blocks in stacks.items()
            for i, b in enumerate(blocks) for name in ("e_proj", "f_proj")
            if name in b["attn"]]
    if lost:
        raise ValueError(
            "the reference .pth schema has no key for linformer's sequence projections; "
            f"writing it would drop {', '.join(lost)}")


def _blocks_out(sd: dict, prefix: str, blocks: list) -> None:
    for i, b in enumerate(blocks):
        _norm_out(sd, f"{prefix}.{i}.norm1", b["norm1"])
        _linear_out(sd, f"{prefix}.{i}.attn.qkv", b["attn"]["qkv"])
        _linear_out(sd, f"{prefix}.{i}.attn.proj", b["attn"]["proj"])
        _norm_out(sd, f"{prefix}.{i}.norm2", b["norm2"])
        _linear_out(sd, f"{prefix}.{i}.mlp.fc1", b["mlp"]["fc1"])
        _linear_out(sd, f"{prefix}.{i}.mlp.fc2", b["mlp"]["fc2"])


def _patch_embed_out(sd: dict, p: Params, patch: int, channels: int, dim: int) -> None:
    # The (p*p*c, d) matmul kernel as the conv's OIHW weight.
    k = _np(p["kernel"])
    sd["patch_embed.proj.weight"] = np.ascontiguousarray(
        k.reshape(patch, patch, channels, dim).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = _np(p["bias"])


def reference_model_name(cfg: MAEConfig) -> Optional[str]:
    """The ``models_mae`` factory name of this config
    (``models_mae/__init__.py:71-124``), or None off the registry."""
    size_name = next(
        (name for name, s in VIT_SIZES.items()
         if (s.dim_model, s.encoder_num_layers, s.encoder_num_heads,
             s.decoder_embed_dim, s.decoder_num_layers, s.decoder_num_heads)
         == (cfg.dim_model, cfg.encoder_num_layers, cfg.encoder_num_heads,
             cfg.decoder_embed_dim, cfg.decoder_num_layers, cfg.decoder_num_heads)),
        None)
    if size_name is None:
        return None
    flags = dict(multi_scale=cfg.multi_scale, use_le=cfg.use_le,
                 use_ce_pred=cfg.use_ce_pred, use_cd_pred=cfg.use_cd_pred,
                 use_ce_ntxent=cfg.use_ce_ntxent)
    for variant, vflags in _VARIANTS.items():
        if {k: vflags.get(k, False) for k in flags} == flags:
            return f"mae_vit_{size_name}" + (f"_{variant}" if variant else "")
    return None


def mae_state_dict(params: Params, cfg: MAEConfig,
                   model_state: Optional[Params] = None) -> dict[str, np.ndarray]:
    """The port's whole MAE params (``mae_init``'s tree, or
    ``params_from_jax(..., full=True)``) -> the reference state_dict (numpy
    fp32; ``num_batches_tracked`` int64)."""
    _refuse_projections({"encoder": params["encoder_blocks"],
                         "decoder": params["decoder_blocks"]})
    sd: dict[str, np.ndarray] = {}
    d, dd, g = cfg.dim_model, cfg.decoder_embed_dim, cfg.grid_size
    _patch_embed_out(sd, params["patch_embed"], cfg.patch_size, cfg.input_channels, d)
    sd["cls_token"] = _np(params["cls_token"])
    sd["mask_token"] = _np(params["mask_token"])
    sd["encoder_pos_embed"] = get_2d_sincos_pos_embed(d, g, cls_token=True)[None]
    sd["decoder_pos_embed"] = get_2d_sincos_pos_embed(dd, g, cls_token=True)[None]
    _blocks_out(sd, "encoder", params["encoder_blocks"])
    _norm_out(sd, "encoder_norm", params["encoder_norm"])
    _linear_out(sd, "decoder_embed", params["decoder_embed"])
    _blocks_out(sd, "decoder", params["decoder_blocks"])
    _norm_out(sd, "decoder_norm", params["decoder_norm"])
    _linear_out(sd, "decoder_pred", params["decoder_pred"])
    # The reference has at most one predictor per variant; cd wins over ce,
    # as the importer reads it back.
    key = ("predictor_cd" if cfg.use_cd_pred
           else "predictor_ce" if cfg.use_ce_pred else None)
    if key is not None and key in params:
        pred = params[key]
        _linear_out(sd, "predictor.0", pred["fc1"])
        sd["predictor.1.weight"] = _np(pred["bn"]["scale"])
        sd["predictor.1.bias"] = _np(pred["bn"]["bias"])
        bn_state = (model_state or {}).get(key, {}).get("bn")
        n_tok = pred["bn"]["scale"].shape[0]
        sd["predictor.1.running_mean"] = (
            _np(bn_state["mean"]) if bn_state else np.zeros(n_tok, np.float32))
        sd["predictor.1.running_var"] = (
            _np(bn_state["var"]) if bn_state else np.ones(n_tok, np.float32))
        sd["predictor.1.num_batches_tracked"] = np.asarray(0, np.int64)
        _linear_out(sd, "predictor.3", pred["fc2"])
    return sd


def classifier_state_dict(params: Params, cfg,
                          model_state: Optional[Params] = None) -> dict[str, np.ndarray]:
    """The port's classifier params -> the ``models_vit`` state_dict; a BN
    head needs ``model_state["head_bn"]`` (its running statistics are part
    of the reference's ``head.0``)."""
    _refuse_projections({"blocks": params["blocks"]})
    sd: dict[str, np.ndarray] = {}
    _patch_embed_out(sd, params["patch_embed"], cfg.patch_size, cfg.input_channels,
                     cfg.embed_dim)
    sd["cls_token"] = _np(params["cls_token"])
    sd["pos_embed"] = _np(params["pos_embed"])
    _blocks_out(sd, "blocks", params["blocks"])
    for name in ("norm", "fc_norm"):
        if name in params:
            _norm_out(sd, name, params[name])
    if cfg.use_bn_head:
        bn = (model_state or {}).get("head_bn")
        if bn is None:
            raise ValueError(
                "cfg.use_bn_head=True but model_state has no 'head_bn': the "
                "BN running stats are part of the reference's head.0 "
                "Sequential layout; pass the run's model_state")
        sd["head.0.running_mean"] = _np(bn["mean"])
        sd["head.0.running_var"] = _np(bn["var"])
        sd["head.0.num_batches_tracked"] = np.asarray(0, np.int64)
        _linear_out(sd, "head.1", params["head"])
    else:
        _linear_out(sd, "head", params["head"])
    return sd


def reference_args(cfg: MAEConfig, model_name: Optional[str] = None) -> dict:
    """The ``args`` payload the reference's ``util/viz.py:prepare_model``
    rebuilds a model from; the factory supplies the sizes."""
    name = model_name or reference_model_name(cfg)
    if name is None:
        raise ValueError(
            "config does not correspond to a reference registry model "
            "(custom size or loss-term combination); pass model_name= with "
            "a reference factory name to force one")
    args = {
        "model": name,
        "input_size": cfg.input_size,
        "input_channels": cfg.input_channels,
        "patch_size": str(cfg.patch_size),   # type=str in main_pretrain.py:78-86
        "mask_ratio": cfg.mask_ratio,
        "loss": cfg.loss,
        "norm_pix_loss": cfg.norm_pix_loss,
        "use_xformers": False,
    }
    if cfg.multi_scale:
        args["ms_range"] = tuple(cfg.ms_range)
        args["ms_decoder_loss_reduction"] = cfg.ms_decoder_loss_reduction
    if cfg.use_cd_pred or cfg.use_ce_pred:
        args["predictor_hidden_size"] = cfg.predictor_hidden_size
    return args


def classifier_reference_name(cfg) -> Optional[str]:
    """The ``models_vit`` factory name (models_vit.py:63-99) of this
    classifier's stack, or None for custom sizes."""
    for name, kw in _VIT_SIZES.items():
        if (kw["embed_dim"], kw["depth"], kw["num_heads"]) == (
                cfg.embed_dim, cfg.depth, cfg.num_heads):
            return name
    return None


def classifier_args(cfg, model_name: Optional[str] = None) -> dict:
    """``args`` payload of a classifier checkpoint."""
    name = model_name or classifier_reference_name(cfg)
    if name is None:
        raise ValueError(
            "classifier config does not match a models_vit factory "
            "(custom size); pass model_name= to force one")
    return {"model": name, "input_size": cfg.input_size, "nb_classes": cfg.num_classes,
            "global_pool": cfg.global_pool, "drop_path": cfg.drop_path_rate}


def save_torch_checkpoint(path: str, state_dict: Mapping[str, np.ndarray],
                          args: Optional[dict] = None, epoch: int = 0) -> None:
    """Write the reference-schema ``.pth`` (util/misc.py:358-379 subset)."""
    import torch

    payload = {"model": {k: torch.from_numpy(np.array(v, copy=True))
                         for k, v in state_dict.items()},
               "epoch": int(epoch)}
    if args is not None:
        payload["args"] = argparse.Namespace(**args)
    torch.save(payload, path)
