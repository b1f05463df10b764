"""Image augmentation on the device (counterpart of
``cross_scale_mae_tpu/ops/image.py``).

* Crop + resize as two matrix products: a per-sample crop box becomes a
  pair of interpolation-weight matrices ``W_y (out, H)`` and
  ``W_x (out, W)``; the resampled image is ``W_y @ img @ W_xᵀ`` per channel.
  ``exact=True`` (eval preprocessing) is the JAX package's fp32
  ``Precision.HIGHEST``: IEEE fp32 products, and on the GPU the product
  refuses to run when the process has enabled TF32 for fp32 matmuls.
  ``exact=False`` (training augmentation) is its ``Precision.DEFAULT``: on
  the GPU the operands are rounded to bf16 and the products accumulate in
  fp32, as the TPU's matrix unit does; on the CPU, where JAX's DEFAULT is
  fp32, it is the fp32 product.
* Flips and crop boxes take their random draws as inputs
  (``train/pretrain.py::sample_pretrain_draws`` makes them), so a test can
  hand both packages the same numbers.
"""

from __future__ import annotations

import math
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


def _bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """A matmul operand at the TPU's DEFAULT precision on the GPU: rounded
    to bf16 and held in fp32, so the fp32 product of two of them is exact
    and only the accumulation rounds (TF32, if enabled, keeps bf16 values
    exact too). On the CPU the operand is left in fp32."""
    if x.device.type == "cpu":
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def crop_resize(imgs: torch.Tensor, boxes: torch.Tensor, out_size: int,
                method: str = "linear", exact: bool = True) -> torch.Tensor:
    """Batched per-sample crop+resize via weight-matrix products.

    imgs: (N, H, W, C); boxes: (N, 4) fp32 rows of (top, left, height, width)
    in (possibly fractional) pixels. Returns (N, out_size, out_size, C) in the
    images' dtype; the products accumulate in fp32 (or wider). ``exact``
    picks the operand precision (module docstring)."""
    n, h, w, c = imgs.shape
    boxes = boxes.to(imgs.device, torch.float32)
    row_mat = _resample_matrix(h, out_size, boxes[:, 0], boxes[:, 2], method)
    col_mat = _resample_matrix(w, out_size, boxes[:, 1], boxes[:, 3], method)
    acc = torch.promote_types(imgs.dtype, torch.float32)
    if exact:
        _require_ieee_fp32(imgs.device)
        operand = (lambda x: x)
    else:
        operand = _bf16_operand
    tmp = torch.einsum("noh,nhwc->nowc", operand(row_mat.to(acc)),
                       operand(imgs.to(acc)))
    out = torch.einsum("npw,nowc->nopc", operand(col_mat.to(acc)), operand(tmp))
    return out.to(imgs.dtype)


def random_flips(imgs: torch.Tensor, hflip: torch.Tensor,
                 vflip: torch.Tensor) -> torch.Tensor:
    """Per-sample horizontal then vertical flips of NHWC images, where the
    (N,) bool flags say so (JAX: ``random_flips``' Bernoulli(0.5) draws)."""
    imgs = torch.where(hflip[:, None, None, None], imgs.flip(2), imgs)
    return torch.where(vflip[:, None, None, None], imgs.flip(1), imgs)


def sample_crop_boxes(u: torch.Tensor, height: int, width: int,
                      scale: tuple[float, float],
                      ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
                      ) -> torch.Tensor:
    """Loop-free RandomResizedCrop boxes from four uniform [0, 1) draws per
    sample, ``u`` of shape (4, N): area, log-aspect, top, left (the JAX
    formula, fed the same uniforms). Returns (N, 4) fp32 (top, left, h, w);
    sizes are clamped to the image, positions uniform over the valid range."""
    u = u.to(torch.float32)
    area = float(height * width)
    target_area = area * (u[0] * (scale[1] - scale[0]) + scale[0])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(u[1] * (hi - lo) + lo)
    w = torch.clamp(torch.sqrt(target_area * aspect), max=float(width))
    h = torch.clamp(torch.sqrt(target_area / aspect), max=float(height))
    i = u[2] * (height - h)
    j = u[3] * (width - w)
    return torch.stack([i, j, h, w], dim=1)


def random_resized_crop(imgs: torch.Tensor, boxes: torch.Tensor, out_size: int,
                        method: str = "linear") -> torch.Tensor:
    """Per-sample RandomResizedCrop on the training fast path
    (``exact=False``), for boxes from :func:`sample_crop_boxes`."""
    return crop_resize(imgs, boxes, out_size, method, exact=False)


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
