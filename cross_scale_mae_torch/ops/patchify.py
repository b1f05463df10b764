"""Image <-> patch-sequence reshapes (counterpart of ``cross_scale_mae_tpu/ops/patchify.py``).

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


def unpatchify(x: torch.Tensor, patch_size: int, channels: int) -> torch.Tensor:
    """(N, L, p*p*C) -> (N, H, W, C); the inverse of :func:`patchify`."""
    n, l, d = x.shape
    p = patch_size
    g = int(round(l ** 0.5))
    if g * g != l:
        raise ValueError(f"L={l} is not a square grid")
    if d != p * p * channels:
        raise ValueError(f"patch dim {d} != {p}*{p}*{channels}")
    x = x.reshape(n, g, g, p, p, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (n, g, p, g, p, c)
    return x.reshape(n, g * p, g * p, channels)
