"""Cross-Scale MAE encoder (counterpart of the encoder half of
``cross_scale_mae_tpu/models/mae.py``).

This slice serves the unmasked encoder (``mae_encode``). The decoder,
predictors and loss terms are the training slice's work (``ROADMAP.md``).
Params are the dict that ``utils/params.py::params_from_jax`` returns.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from cross_scale_mae_torch.configs import MAEConfig
from cross_scale_mae_torch.models import layers
from cross_scale_mae_torch.ops.numerics import at_least_f32
from cross_scale_mae_torch.ops.patchify import patchify
from cross_scale_mae_torch.ops.pos_embed import get_2d_sincos_pos_embed

Params = dict[str, Any]


def compute_dtype(cfg: MAEConfig) -> torch.dtype:
    dtype = getattr(torch, cfg.compute_dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    return dtype


@functools.lru_cache(maxsize=16)
def _enc_pos(dim: int, grid_size: int, device: torch.device) -> torch.Tensor:
    """The encoder's fixed sincos table with its zero cls row, (1+L, D) fp32.
    Cached per device so a dispatch does not copy it to the card again;
    callers only read it."""
    table = get_2d_sincos_pos_embed(dim, grid_size, cls_token=True)
    return torch.from_numpy(table).to(device)


def _embed_patches(params: Params, cfg: MAEConfig, imgs: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """imgs NHWC -> (patch tokens + pos (N, L, D), enc_pos table)."""
    dtype = compute_dtype(cfg)
    enc_pos = _enc_pos(cfg.dim_model, cfg.grid_size, imgs.device)
    x = patchify(imgs, cfg.patch_size).to(dtype)
    x = layers.linear(params["patch_embed"], x)
    return x + enc_pos[None, 1:, :].to(dtype), enc_pos


def _encoder_trunk(params: Params, cfg: MAEConfig, x: torch.Tensor,
                   enc_pos: torch.Tensor) -> torch.Tensor:
    """cls-token cat -> encoder blocks -> (optional) encoder norm."""
    cls = (at_least_f32(params["cls_token"]) + enc_pos[None, :1, :]).to(x.dtype)
    x = torch.cat([cls.expand(x.shape[0], 1, x.shape[2]), x], dim=1)
    x = layers.run_blocks(
        params["encoder_blocks"], x, cfg.encoder_num_heads,
        cfg.attention_impl, cfg.residual_norm_style, cfg.gelu,
    )
    if cfg.apply_encoder_norm:
        # The reference computes and discards this norm (MAE_ViT_Baseline.py:264).
        x = layers.layer_norm(params["encoder_norm"], x)
    return x


def mae_encode(params: Params, cfg: MAEConfig, imgs: torch.Tensor) -> torch.Tensor:
    """Unmasked encoder features (N, 1+L, D) of NHWC images."""
    x, enc_pos = _embed_patches(params, cfg, imgs)
    return _encoder_trunk(params, cfg, x, enc_pos)
