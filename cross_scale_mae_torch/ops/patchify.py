"""Image -> patch-sequence reshape (counterpart of ``cross_scale_mae_tpu/ops/patchify.py``).

NHWC in, per-patch features in (ph, pw, c) row-major order, so the patch
embedding kernel of a JAX checkpoint carries over as it is.
"""

from __future__ import annotations

import torch


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, L, p*p*C) with L = (H/p)*(W/p)."""
    n, h, w, c = imgs.shape
    p = patch_size
    if h != w or h % p:
        raise ValueError(f"bad shape {tuple(imgs.shape)} for patch {p}")
    gh, gw = h // p, w // p
    x = imgs.reshape(n, gh, p, gw, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (n, gh, gw, p, p, c)
    return x.reshape(n, gh * gw, p * p * c)
