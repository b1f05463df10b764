"""The reference's ``.pth`` -> the port's params (counterpart of
``cross_scale_mae_tpu/utils/torch_import.py``).

Reads the reference's released MAE checkpoints and any checkpoint in its
schema:

* timm-layout MAE checkpoints (``encoder.N.*`` / ``decoder.N.*`` blocks,
  conv patch-embed) and xFormers-layout ones (``encoder.encoders.N.wrap_*``,
  separate q/k/v projections), remapped as ``main_finetune.py:556-586``
  does, and loaded into the model (the reference then loads the wrong dict,
  ``main_finetune.py:591``; the JAX package fixed that, and so does this);
* the conv (OIHW) patch embed as the (p*p*c, d) matmul kernel, torch
  Linear (out, in) weights as (in, out) kernels, per-layer blocks as the
  port keeps them;
* the classifier's trainable ``pos_embed`` resampled bicubically to the
  model's grid (``ops/pos_embed.interpolate_pos_embed``).

A classifier starts from an imported encoder through
``utils/params.mae_encoder_to_classifier`` and ``merge_pretrained``.
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Mapping

import numpy as np
import torch

from cross_scale_mae_torch.configs import MAEConfig, ViTClassifierConfig
from cross_scale_mae_torch.ops.pos_embed import interpolate_pos_embed

Params = dict[str, Any]

_XFORMER_MAPPINGS = {
    # main_finetune.py:556-566: xFormers block internals -> timm names.
    ".wrap_att.norm.": ".norm1.",
    ".wrap_att.sublayer.layer.in_proj_container.q_proj.": ".attn.q_proj.",
    ".wrap_att.sublayer.layer.in_proj_container.k_proj.": ".attn.k_proj.",
    ".wrap_att.sublayer.layer.in_proj_container.v_proj.": ".attn.v_proj.",
    ".wrap_att.sublayer.layer.proj.": ".attn.proj.",
    ".wrap_ff.norm.": ".norm2.",
    ".wrap_ff.sublayer.layer.mlp.0.": ".mlp.fc1.",
    ".wrap_ff.sublayer.layer.mlp.3.": ".mlp.fc2.",
}


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """A ``.pth`` checkpoint's state_dict as numpy (the ``{'model': ...}``
    wrapper of util/misc.py:358-379 unwrapped). Loaded with
    ``weights_only=True``; the ``args`` Namespace is the one class allowed."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


def normalize_torch_keys(sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """xFormers names -> timm names; split q/k/v projections fused."""
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        name = k
        if ".wrap_att." in name or ".wrap_ff." in name:
            for src, dst in _XFORMER_MAPPINGS.items():
                if src in name:
                    name = name.replace(src, dst)
            name = name.replace("encoder.encoders", "encoder")
            name = name.replace("decoder.encoders", "decoder")
        out[name] = v
    fused: dict[str, np.ndarray] = {}
    for name in list(out):
        m = re.match(r"(.*\.attn)\.q_proj\.(weight|bias)$", name)
        if m:
            base, kind = m.groups()
            q = out.pop(f"{base}.q_proj.{kind}")
            k = out.pop(f"{base}.k_proj.{kind}")
            v = out.pop(f"{base}.v_proj.{kind}")
            fused[f"{base}.qkv.{kind}"] = np.concatenate([q, k, v], axis=0)
    out.update(fused)
    return out


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


def _linear(sd, prefix, device) -> Params:
    return {"kernel": _tensor(sd[f"{prefix}.weight"].T, device),
            "bias": _tensor(sd[f"{prefix}.bias"], device)}


def _norm(sd, prefix, device) -> Params:
    return {"scale": _tensor(sd[f"{prefix}.weight"], device),
            "bias": _tensor(sd[f"{prefix}.bias"], device)}


def _patch_embed(sd, device, prefix: str = "patch_embed.proj") -> Params:
    w = sd[f"{prefix}.weight"]  # (D, C, p, p), conv OIHW
    d, c, p, _ = w.shape
    # The port's patch features are (ph, pw, c)-ordered (ops/patchify.py).
    return {"kernel": _tensor(w.transpose(2, 3, 1, 0).reshape(p * p * c, d), device),
            "bias": _tensor(sd[f"{prefix}.bias"], device)}


def _blocks(sd, prefix: str, n_layers: int, device) -> list[Params]:
    return [{
        "norm1": _norm(sd, f"{prefix}.{i}.norm1", device),
        "attn": {"qkv": _linear(sd, f"{prefix}.{i}.attn.qkv", device),
                 "proj": _linear(sd, f"{prefix}.{i}.attn.proj", device)},
        "norm2": _norm(sd, f"{prefix}.{i}.norm2", device),
        "mlp": {"fc1": _linear(sd, f"{prefix}.{i}.mlp.fc1", device),
                "fc2": _linear(sd, f"{prefix}.{i}.mlp.fc2", device)},
    } for i in range(n_layers)]


def import_mae_checkpoint(path: str, cfg: MAEConfig, device: torch.device | str = "cpu",
                          encoder_only: bool = False) -> Params:
    """Reference MAE ``.pth`` -> the port's MAE params (fp32 tensors on
    ``device``), the predictor MLP included where the checkpoint and the
    config both have one. ``encoder_only`` reads the patch embed, the cls
    token, the encoder blocks and norm alone (what a classifier starts
    from), whatever the checkpoint's decoder."""
    sd = normalize_torch_keys(load_torch_state_dict(path))
    params: Params = {
        "patch_embed": _patch_embed(sd, device),
        "cls_token": _tensor(sd["cls_token"], device),
        "encoder_blocks": _blocks(sd, "encoder", cfg.encoder_num_layers, device),
        "encoder_norm": _norm(sd, "encoder_norm", device),
    }
    if encoder_only:
        return params
    params.update({
        "mask_token": _tensor(sd["mask_token"], device),
        "decoder_embed": _linear(sd, "decoder_embed", device),
        "decoder_blocks": _blocks(sd, "decoder", cfg.decoder_num_layers, device),
        "decoder_norm": _norm(sd, "decoder_norm", device),
        "decoder_pred": _linear(sd, "decoder_pred", device),
    })
    if "predictor.0.weight" in sd and (cfg.use_cd_pred or cfg.use_ce_pred):
        key = "predictor_cd" if cfg.use_cd_pred else "predictor_ce"
        params[key] = {
            "fc1": _linear(sd, "predictor.0", device),
            "bn": {"scale": _tensor(sd["predictor.1.weight"], device),
                   "bias": _tensor(sd["predictor.1.bias"], device)},
            "fc2": _linear(sd, "predictor.3", device),
        }
    return params


def import_classifier_checkpoint(path: str, cfg: ViTClassifierConfig,
                                 device: torch.device | str = "cpu") -> Params:
    """timm-layout classifier ``.pth`` (models_vit.py) -> the port's
    classifier params, ``pos_embed`` resampled to the config's grid."""
    sd = normalize_torch_keys(load_torch_state_dict(path))
    params: Params = {
        "patch_embed": _patch_embed(sd, device),
        "cls_token": _tensor(sd["cls_token"], device),
        "pos_embed": _tensor(interpolate_pos_embed(
            np.asarray(sd["pos_embed"], np.float32), cfg.grid_size), device),
        "blocks": _blocks(sd, "blocks", cfg.depth, device),
        "head": _linear(sd, "head", device),
    }
    for name in ("fc_norm", "norm"):
        if f"{name}.weight" in sd:
            params[name] = _norm(sd, name, device)
    return params
