"""Downstream ViT classifier for finetuning (counterpart of
``cross_scale_mae_tpu/models/vit.py``; reference ``models_vit.py``).

* The sin-cos position table is the init of a trainable ``pos_embed``
  (models_vit.py:24-29).
* Global-average-pool head: the mean over patch tokens, then ``fc_norm``;
  else the cls token after ``norm`` (models_vit.py:31-58).
* Optional affine-free BatchNorm in front of the head (the linear probe's,
  main_linprobe.py:517-520), with its statistics in the model state.
* Stochastic depth drops the whole block delta per sample,
  ``x + (block(x) - x) * mask / keep``, with keep rates
  ``1 - linspace(0, drop_path_rate, depth)`` (vit.py:70-101): the JAX
  package's rule, not timm's two separate sub-residual drops.

The drop-path masks are an input, (depth, N) bools, which
``train/classify.py::sample_finetune_draws`` makes (or a test takes from the
JAX package's keys).
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import numpy as np
import torch

from cross_scale_mae_torch.configs import ViTClassifierConfig
from cross_scale_mae_torch.models import layers
from cross_scale_mae_torch.models.mae import compute_dtype
from cross_scale_mae_torch.ops.numerics import at_least_f32
from cross_scale_mae_torch.ops.patchify import patchify
from cross_scale_mae_torch.ops.pos_embed import get_2d_sincos_pos_embed
from cross_scale_mae_torch.parallel.collectives import fsdp_gathered, gather_seq_full, split_seq

Params = dict[str, Any]


def trunc_normal(gen: torch.Generator, shape: tuple[int, ...], std: float) -> torch.Tensor:
    """std * a standard normal truncated to [-2, 2] (the JAX package's
    ``std * jax.random.truncated_normal(key, -2, 2, shape)``)."""
    t = torch.empty(shape, device=gen.device)
    return std * torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def vit_init(cfg: ViTClassifierConfig, gen: torch.Generator) -> tuple[Params, Params]:
    """(params, state) on ``gen``'s device, fp32 leaves: xavier-uniform
    linear kernels, normal(0.02) cls token, the sin-cos table as pos_embed,
    a trunc_normal(0.02) head (entry points re-init it with their own
    std), and the BatchNorm head's statistics when ``use_bn_head``."""
    d, dev = cfg.embed_dim, gen.device
    patch_dim = cfg.patch_size ** 2 * cfg.input_channels
    params: Params = {
        "patch_embed": layers.linear_init(gen, patch_dim, d),
        "cls_token": 0.02 * torch.randn((1, 1, d), generator=gen, device=dev),
        "pos_embed": torch.from_numpy(
            get_2d_sincos_pos_embed(d, cfg.grid_size, cls_token=True)[None]).to(dev),
        "blocks": layers.stacked_blocks_init(gen, cfg.depth, d, cfg.mlp_ratio,
                                             cfg.attention_impl, cfg.num_patches + 1),
        "head": {"kernel": trunc_normal(gen, (d, cfg.num_classes), 0.02),
                 "bias": torch.zeros(cfg.num_classes, device=dev)},
    }
    params["fc_norm" if cfg.global_pool else "norm"] = layers.layer_norm_init(d, dev)
    state: Params = {}
    if cfg.use_bn_head:
        state["head_bn"] = {"mean": torch.zeros(d, device=dev),
                            "var": torch.ones(d, device=dev)}
    return params, state


def drop_path_rates(cfg: ViTClassifierConfig) -> np.ndarray:
    """Per-block drop rates, fp32 (the timm linear ramp)."""
    return np.linspace(0.0, cfg.drop_path_rate, cfg.depth).astype(np.float32)


def vit_forward_features(params: Params, cfg: ViTClassifierConfig, imgs: torch.Tensor,
                         *, train: bool = False,
                         drop_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """imgs NHWC -> (N, D) pooled features. In training with
    ``drop_path_rate > 0``, ``drop_masks`` (depth, N) bool says which
    samples keep each block's delta. Under a mesh layout ``params`` are
    this rank's parts (``parallel/mesh.py``): FSDP's are gathered here and
    in each block, and with ``cfg.sequence_parallel`` the blocks run on
    this rank's token chunk."""
    dtype = compute_dtype(cfg)
    with fsdp_gathered(params, dtype) as params:
        return _features(params, cfg, imgs, train, drop_masks, dtype)


def _features(params, cfg, imgs, train, drop_masks, dtype) -> torch.Tensor:
    x = layers.linear(params["patch_embed"], patchify(imgs, cfg.patch_size).to(dtype))
    cls = params["cls_token"].to(dtype).expand(x.shape[0], 1, x.shape[2])
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dtype)
    if train and cfg.drop_path_rate > 0:
        if drop_masks is None or drop_masks.shape != (cfg.depth, x.shape[0]):
            raise ValueError(f"drop_path needs (depth, N) = {(cfg.depth, x.shape[0])} "
                             "keep masks in train mode")
        keeps = 1.0 - torch.from_numpy(drop_path_rates(cfg)).to(x.device)
        sp, seq_len = cfg.sequence_parallel, x.shape[1]
        if sp:
            x = split_seq(x)
        for p, mask, keep in zip(params["blocks"], drop_masks, keeps):
            out = layers.block(p, x, cfg.num_heads, cfg.attention_impl, gelu=cfg.gelu,
                               sp=sp, seq_len=seq_len)
            scale = (mask.to(torch.float32) / keep).to(dtype)
            x = x + (out - x) * scale[:, None, None]
        if sp:
            x = gather_seq_full(x, seq_len)
    else:
        x = layers.run_blocks(params["blocks"], x, cfg.num_heads, cfg.attention_impl,
                              gelu=cfg.gelu, sp=cfg.sequence_parallel)
    if cfg.global_pool:
        return layers.layer_norm(params["fc_norm"], x[:, 1:, :].mean(dim=1))
    return layers.layer_norm(params["norm"], x)[:, 0]


def vit_apply(params: Params, state: Params, cfg: ViTClassifierConfig, imgs: torch.Tensor,
              *, train: bool = False, drop_masks: Optional[torch.Tensor] = None,
              bn_momentum: float = 0.1, freeze_backbone: bool = False,
              global_stats: bool = False) -> tuple[torch.Tensor, Params]:
    """Returns (fp32 logits (N, num_classes), new_state).
    ``freeze_backbone`` runs the backbone without autograd (the linear
    probe's requires_grad=False; JAX's ``stop_gradient`` at the features,
    which lets XLA prune the backbone's backward): no block records a node
    or saves an activation, and the attention takes its forward-only
    kernel. The logits are the same bits either way. ``global_stats``
    takes the BN head's batch statistics over every rank's rows (the JAX
    package's jit over a batch-sharded array); behind a frozen backbone no
    gradient flows through them."""
    with torch.no_grad() if freeze_backbone else contextlib.nullcontext():
        feat = vit_forward_features(params, cfg, imgs, train=train, drop_masks=drop_masks)
    new_state = dict(state)
    if cfg.use_bn_head:
        f32 = at_least_f32(feat)
        if train:
            mean, var, nb = layers.batch_stats(f32, (0,), global_stats)
            mean, var = mean[0], var[0]
            with torch.no_grad():
                new_state["head_bn"] = {
                    "mean": (1 - bn_momentum) * state["head_bn"]["mean"] + bn_momentum * mean,
                    "var": (1 - bn_momentum) * state["head_bn"]["var"]
                    + bn_momentum * var * nb / max(nb - 1, 1),
                }
        else:
            mean, var = state["head_bn"]["mean"], state["head_bn"]["var"]
        # affine=False (main_linprobe.py:517-520): no scale or bias.
        feat = ((f32 - mean) * torch.rsqrt(var + 1e-6)).to(feat.dtype)
    with fsdp_gathered({"head": params["head"]}, feat.dtype) as top:
        return at_least_f32(layers.linear(top["head"], feat)), new_state
