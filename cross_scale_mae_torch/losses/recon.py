"""Masked reconstruction losses (counterpart of ``cross_scale_mae_tpu/losses/recon.py``).

Pure functions on ``(target, pred, mask)`` in patch space, computed in fp32
whatever the activation dtype. The masked mean is
``(per_patch * mask).sum() / mask.sum()`` with mask 1 = reconstructed
(MAE_ViT_Shared.py:119); with ``mask=None`` it is a plain mean, which is how
the latent and cross-predictor terms use these functions.

The SSIM family (``ssim``, ``ms_ssim``, ``mse_ssim``, ``mse_ms_ssim``) needs
``ops/ssim.py``, which is not ported yet (ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cross_scale_mae_torch.ops.numerics import at_least_f32
from cross_scale_mae_torch.ops.patchify import patchify

SSIM_LOSSES = ("ssim", "ms_ssim", "mse_ssim", "mse_ms_ssim")


def _masked_mean(per_patch: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return per_patch.mean()
    mask = mask.to(per_patch.dtype)
    return (per_patch * mask).sum() / mask.sum()


def scale_01(x: torch.Tensor) -> torch.Tensor:
    """Global min-max rescale (MAE_ViT_Shared.py:93-94)."""
    return (x - x.min()) / (x.max() - x.min() + 1.0e-6)


def process_target(imgs: torch.Tensor, patch_size: int, channels: int,
                   norm_pix_loss: bool) -> torch.Tensor:
    """Patchified NHWC target, optionally normalized per patch with the
    unbiased variance (MAE_ViT_Shared.py:97-111)."""
    target = patchify(at_least_f32(imgs), patch_size)
    if norm_pix_loss:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, correction=1)
        target = (target - mean) / torch.sqrt(var + 1.0e-6)
    return target


def loss_mse(target, pred, mask=None):
    target, pred = at_least_f32(target), at_least_f32(pred)
    return _masked_mean(((pred - target) ** 2).mean(dim=-1), mask)


def loss_l2(target, pred, mask=None):
    target, pred = at_least_f32(target), at_least_f32(pred)
    return _masked_mean(((pred - target) ** 2).sum(dim=-1), mask)


def loss_mae(target, pred, mask=None):
    target, pred = at_least_f32(target), at_least_f32(pred)
    return _masked_mean((pred - target).abs().mean(dim=-1), mask)


def loss_l1(target, pred, mask=None):
    target, pred = at_least_f32(target), at_least_f32(pred)
    return _masked_mean((pred - target).abs().sum(dim=-1), mask)


def loss_bce(target, pred, mask=None):
    """BCE with logits against a 0-1 rescaled target (MAE_ViT_Shared.py:160-177)."""
    target, pred = at_least_f32(target), at_least_f32(pred)
    target = scale_01(target)
    per_elem = (torch.clamp(pred, min=0) - pred * target
                + torch.log1p(torch.exp(-pred.abs())))
    return _masked_mean(per_elem.mean(dim=-1), mask)


RECON_LOSSES: dict[str, Callable] = {
    "mse": loss_mse, "l2": loss_l2, "mae": loss_mae, "l1": loss_l1, "bce": loss_bce,
}


def recon_loss(name: str, target: torch.Tensor, pred: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch by name (the registry at MAE_ViT_Shared.py:19)."""
    key = name.lower()
    if key in SSIM_LOSSES:
        raise NotImplementedError(
            f"loss {name!r} needs ops/ssim.py, which is not ported yet; see "
            "ROADMAP.md (queue 1 item 14)")
    if key not in RECON_LOSSES:
        raise ValueError(
            f"unknown loss {name!r}; known: {sorted(RECON_LOSSES) + list(SSIM_LOSSES)}")
    return RECON_LOSSES[key](target, pred, mask)
