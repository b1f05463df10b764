"""Masked reconstruction losses (counterpart of ``cross_scale_mae_tpu/losses/recon.py``).

Pure functions on ``(target, pred, mask)`` in patch space, computed in fp32
whatever the activation dtype. The masked mean is
``(per_patch * mask).sum() / mask.sum()`` with mask 1 = reconstructed
(MAE_ViT_Shared.py:119); with ``mask=None`` it is a plain mean, which is how
the latent and cross-predictor terms use these functions.

The SSIM family (``ssim``, ``ms_ssim``, ``mse_ssim``, ``mse_ms_ssim``)
compares images: it rescales target and prediction to [0, 1] over the whole
batch, unpatchifies them (so it needs ``patch_size`` and ``channels``) and
zeroes the visible patches (MAE_ViT_Shared.py:179-267). With
``global_batch`` (the gspmd semantics beyond one rank) the rescale's min
and max are the global batch's, reduced over the data group, with JAX's
gradient of ``min``/``max`` (split evenly among the ties of every rank).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cross_scale_mae_torch.ops.numerics import at_least_f32
from cross_scale_mae_torch.ops.patchify import patchify, unpatchify
from cross_scale_mae_torch.ops.ssim import ms_ssim, ssim
from cross_scale_mae_torch.parallel.collectives import global_max, global_min

SSIM_LOSSES = ("ssim", "ms_ssim", "mse_ssim", "mse_ms_ssim")


def _masked_mean(per_patch: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return per_patch.mean()
    mask = mask.to(per_patch.dtype)
    return (per_patch * mask).sum() / mask.sum()


def scale_01(x: torch.Tensor, global_batch: bool = False) -> torch.Tensor:
    """Global min-max rescale (MAE_ViT_Shared.py:93-94); over every data
    rank's rows with ``global_batch``."""
    lo, hi = (global_min(x), global_max(x)) if global_batch else (x.min(), x.max())
    return (x - lo) / (hi - lo + 1.0e-6)


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


def loss_mse(target, pred, mask=None, **kw):
    target, pred = at_least_f32(target), at_least_f32(pred)
    return _masked_mean(((pred - target) ** 2).mean(dim=-1), mask)


def loss_l2(target, pred, mask=None, **kw):
    target, pred = at_least_f32(target), at_least_f32(pred)
    return _masked_mean(((pred - target) ** 2).sum(dim=-1), mask)


def loss_mae(target, pred, mask=None, **kw):
    target, pred = at_least_f32(target), at_least_f32(pred)
    return _masked_mean((pred - target).abs().mean(dim=-1), mask)


def loss_l1(target, pred, mask=None, **kw):
    target, pred = at_least_f32(target), at_least_f32(pred)
    return _masked_mean((pred - target).abs().sum(dim=-1), mask)


def loss_bce(target, pred, mask=None, global_batch=False, **kw):
    """BCE with logits against a 0-1 rescaled target (MAE_ViT_Shared.py:160-177)."""
    target, pred = at_least_f32(target), at_least_f32(pred)
    target = scale_01(target, global_batch)
    per_elem = (torch.clamp(pred, min=0) - pred * target
                + torch.log1p(torch.exp(-pred.abs())))
    return _masked_mean(per_elem.mean(dim=-1), mask)


def _ssim_family(target, pred, mask, patch_size, channels, fn, global_batch=False, **fn_kw):
    """1 - fn of the [0, 1]-rescaled images, the visible patches zeroed in
    both (MAE_ViT_Shared.py:179-267)."""
    if patch_size is None or channels is None:
        raise ValueError("the ssim losses compare images: they need patch_size and "
                         "channels to unpatchify")
    target = scale_01(at_least_f32(target), global_batch)
    pred = scale_01(at_least_f32(pred), global_batch)
    timg = unpatchify(target, patch_size, channels)
    pimg = unpatchify(pred, patch_size, channels)
    if mask is not None:
        mimg = unpatchify(at_least_f32(mask)[:, :, None].expand(
            *mask.shape, patch_size * patch_size * channels), patch_size, channels)
        timg, pimg = timg * mimg, pimg * mimg
    return 1.0 - fn(pimg, timg, data_range=1.0, size_average=True, **fn_kw)


def loss_ssim(target, pred, mask=None, patch_size=None, channels=None, global_batch=False):
    return _ssim_family(target, pred, mask, patch_size, channels, ssim, global_batch,
                        nonnegative_ssim=True)


def loss_ms_ssim(target, pred, mask=None, patch_size=None, channels=None,
                 global_batch=False):
    return _ssim_family(target, pred, mask, patch_size, channels, ms_ssim, global_batch)


def loss_mse_ssim(target, pred, mask=None, weight=0.1, **kw):
    return loss_mse(target, pred, mask) + weight * loss_ssim(target, pred, mask, **kw)


def loss_mse_ms_ssim(target, pred, mask=None, weight=0.1, **kw):
    return loss_mse(target, pred, mask) + weight * loss_ms_ssim(target, pred, mask, **kw)


RECON_LOSSES: dict[str, Callable] = {
    "mse": loss_mse, "l2": loss_l2, "mae": loss_mae, "l1": loss_l1, "bce": loss_bce,
    "ssim": loss_ssim, "ms_ssim": loss_ms_ssim, "mse_ssim": loss_mse_ssim,
    "mse_ms_ssim": loss_mse_ms_ssim,
}


def recon_loss(name: str, target: torch.Tensor, pred: torch.Tensor,
               mask: Optional[torch.Tensor] = None, patch_size: Optional[int] = None,
               channels: Optional[int] = None, global_batch: bool = False) -> torch.Tensor:
    """Dispatch by name (the registry at MAE_ViT_Shared.py:19). The SSIM
    family needs ``patch_size`` and ``channels``; the others ignore them.
    ``global_batch``: the rescale's min and max over the data group."""
    try:
        fn = RECON_LOSSES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; known: {sorted(RECON_LOSSES)}") from None
    return fn(target, pred, mask, patch_size=patch_size, channels=channels,
              global_batch=global_batch)
