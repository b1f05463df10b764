"""Crop + resize as two matrix products (counterpart of part of
``cross_scale_mae_tpu/ops/image.py``).

A per-sample crop box becomes a pair of interpolation-weight matrices
``W_y (out, H)`` and ``W_x (out, W)``; the resampled image is
``W_y @ img @ W_xᵀ`` per channel. This slice ports the ``exact=True`` path
that eval preprocessing runs: the JAX package runs its einsums in fp32 at
``Precision.HIGHEST``, and the port runs them as IEEE fp32 matrix products.
PyTorch has no per-call precision argument, so on the GPU the product
refuses to run when the process has enabled TF32 for fp32 matmuls, rather
than round its operands to 10 bits of mantissa.
"""

from __future__ import annotations

from typing import Sequence

import torch


def normalize_images(imgs: torch.Tensor, mean: Sequence[float],
                     std: Sequence[float]) -> torch.Tensor:
    """(x - mean) / std per channel, NHWC, in the images' dtype."""
    mean_t = torch.tensor(mean, dtype=torch.float64).to(imgs.device, imgs.dtype)
    std_t = torch.tensor(std, dtype=torch.float64).to(imgs.device, imgs.dtype)
    return (imgs - mean_t) / std_t


def _cubic_kernel(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Keys cubic convolution kernel (the torch 'bicubic' convention, a=-0.75)."""
    at = torch.abs(t)
    at2, at3 = at * at, at * at * at
    f1 = (a + 2) * at3 - (a + 3) * at2 + 1
    f2 = a * at3 - 5 * a * at2 + 8 * a * at - 4 * a
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(at <= 1, f1, torch.where(at < 2, f2, zero))


def _resample_matrix(src_len: int, out_len: int, start: torch.Tensor,
                     length: torch.Tensor, method: str) -> torch.Tensor:
    """Interpolation-weight matrices (..., out_len, src_len), one per entry
    of the fp32 ``start``/``length`` tensors (shape (...)).

    Output pixel o maps to source coordinate
    ``start + (o + 0.5) * (length / out_len) - 0.5`` (align_corners=False);
    taps clamped at the border add onto the edge pixel's weight."""
    dev = start.device
    scale = length / out_len
    dst = torch.arange(out_len, dtype=torch.float32, device=dev)
    src = start[..., None] + (dst + 0.5) * scale[..., None] - 0.5  # (..., out)
    base = torch.floor(src)
    frac = src - base
    if method == "linear":
        offs = torch.tensor([0.0, 1.0], device=dev)
        weights = torch.stack([1.0 - frac, frac], dim=-1)  # (..., out, 2)
    elif method == "cubic":
        offs = torch.tensor([-1.0, 0.0, 1.0, 2.0], device=dev)
        weights = _cubic_kernel(frac[..., None] - offs)
        weights = weights / weights.sum(dim=-1, keepdim=True)
    else:
        raise ValueError(f"unknown resample method {method!r}")
    idx = (base[..., None] + offs).clamp(0, src_len - 1).long()
    mat = torch.zeros((*src.shape, src_len), dtype=torch.float32, device=dev)
    return mat.scatter_add_(-1, idx, weights.to(torch.float32))


def _require_ieee_fp32(device: torch.device) -> None:
    if device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "exact crop_resize needs IEEE fp32 matrix products, but this "
            "process enabled TF32 for fp32 matmuls "
            "(torch.backends.cuda.matmul.allow_tf32 / "
            "torch.set_float32_matmul_precision)")


def crop_resize(imgs: torch.Tensor, boxes: torch.Tensor, out_size: int,
                method: str = "linear", exact: bool = True) -> torch.Tensor:
    """Batched per-sample crop+resize via weight-matrix products.

    imgs: (N, H, W, C); boxes: (N, 4) fp32 rows of (top, left, height, width)
    in (possibly fractional) pixels. Returns (N, out_size, out_size, C) in the
    images' dtype; the products accumulate in fp32 (or wider)."""
    if not exact:
        raise NotImplementedError(
            "crop_resize(exact=False), the training augmentation's fast "
            "path, is not ported yet; see ROADMAP.md")
    n, h, w, c = imgs.shape
    boxes = boxes.to(imgs.device, torch.float32)
    row_mat = _resample_matrix(h, out_size, boxes[:, 0], boxes[:, 2], method)
    col_mat = _resample_matrix(w, out_size, boxes[:, 1], boxes[:, 3], method)
    acc = torch.promote_types(imgs.dtype, torch.float32)
    _require_ieee_fp32(imgs.device)
    tmp = torch.einsum("noh,nhwc->nowc", row_mat.to(acc), imgs.to(acc))
    out = torch.einsum("npw,nowc->nopc", col_mat.to(acc), tmp)
    return out.to(imgs.dtype)


def center_crop_resize(imgs: torch.Tensor, out_size: int,
                       crop_pct: float | None = None) -> torch.Tensor:
    """Eval transform: Resize(out/crop_pct) then CenterCrop(out), fused:
    a centred (crop_pct * side) box resized to out_size, bicubic."""
    n, h, w, _ = imgs.shape
    if crop_pct is None:
        crop_pct = 224.0 / 256.0 if out_size <= 224 else 1.0
    box_h, box_w = h * crop_pct, w * crop_pct
    top, left = (h - box_h) / 2.0, (w - box_w) / 2.0
    boxes = torch.tensor([[top, left, box_h, box_w]], dtype=torch.float32,
                         device=imgs.device).expand(n, 4)
    return crop_resize(imgs, boxes, out_size, "cubic")
