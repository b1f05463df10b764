"""Label smoothing and the soft-target loss (counterpart of
``cross_scale_mae_tpu/train/mixup.py:21-26, 195-198``).

Mixup and CutMix are not ported yet (ROADMAP.md, queue 1 item 12):
:func:`mixup_cutmix` refuses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cross_scale_mae_torch.ops.numerics import at_least_f32


def smooth_one_hot(labels: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    """fp32 targets with the timm convention: on = 1 - smoothing + off,
    off = smoothing / num_classes (each row sums to 1)."""
    off = smoothing / num_classes
    return F.one_hot(labels.long(), num_classes).to(torch.float32) * (1.0 - smoothing) + off


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """timm SoftTargetCrossEntropy: the batch mean of -sum(t * log_softmax)."""
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    return -(targets * logp).sum(dim=-1).mean()


def mixup_cutmix(*args, **kwargs):
    raise NotImplementedError(
        "mixup/cutmix is not ported yet; see ROADMAP.md (queue 1 item 12)")
