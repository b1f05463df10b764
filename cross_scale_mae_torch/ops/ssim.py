"""SSIM and MS-SSIM (counterpart of ``cross_scale_mae_tpu/ops/ssim.py``).

pytorch_msssim's defaults, as the JAX package has them: an 11-tap Gaussian
window (sigma 1.5), K = (0.01, 0.03), a separable depthwise blur with valid
padding, the MS-SSIM weights (0.0448, 0.2856, 0.3001, 0.2363, 0.1333) and a
2x average pool between levels. The API takes NHWC images, as the JAX one
does; the blur runs on NCHW as two ``F.conv2d(..., groups=C)``. Inputs
are computed in fp32, or wider if they are (float64 gives a reference).

The blur feeds ``sigma^2 = E[x^2] - mu^2``, a cancellation, so on the GPU
it runs in IEEE fp32 whatever the process allows for convolutions: its
forward and its backward switch cuDNN's TF32 off for their own convolutions
(:class:`_Blur`) and restore the setting after.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from cross_scale_mae_torch.ops.numerics import at_least_f32, device_constant

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(win_size: int, sigma: float) -> np.ndarray:
    """The normalized 1-D window, built in float64 and cast to float32."""
    coords = np.arange(win_size, dtype=np.float64) - win_size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@contextlib.contextmanager
def _ieee_fp32_convs():
    """cuDNN's TF32 off for the convolutions in the block, restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _kernels(window: torch.Tensor, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The depthwise (C, 1, k, 1) and (C, 1, 1, k) kernels of the window."""
    k = window.shape[0]
    return window.view(1, 1, k, 1).expand(c, 1, k, 1), window.view(1, 1, 1, k).expand(c, 1, 1, k)


class _Blur(torch.autograd.Function):
    """Separable depthwise Gaussian blur of NCHW ``x``, valid padding,
    with the IEEE fp32 convolutions in both directions."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(window)
        ctx.shape = x.shape
        kern_h, kern_w = _kernels(window, x.shape[1])
        with _ieee_fp32_convs():
            y = F.conv2d(x, kern_h, groups=x.shape[1])
            ctx.mid = y.shape
            return F.conv2d(y, kern_w, groups=x.shape[1])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (window,) = ctx.saved_tensors
        c = ctx.shape[1]
        kern_h, kern_w = _kernels(window, c)
        with _ieee_fp32_convs():
            grad = torch.nn.grad.conv2d_input(ctx.mid, kern_w, grad, groups=c)
            grad = torch.nn.grad.conv2d_input(ctx.shape, kern_h, grad, groups=c)
        return grad, None


def _ssim_maps(x, y, window, data_range, k1=0.01, k2=0.03):
    """The SSIM and contrast-structure maps of NCHW ``x`` and ``y``."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1, mu2 = _Blur.apply(x, window), _Blur.apply(y, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _Blur.apply(x * x, window) - mu1_sq
    sigma2_sq = _Blur.apply(y * y, window) - mu2_sq
    sigma12 = _Blur.apply(x * y, window) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map, cs_map


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return at_least_f32(x).permute(0, 3, 1, 2)


def _window(win_size: int, win_sigma: float, like: torch.Tensor) -> torch.Tensor:
    """The fp32 window, in ``like``'s dtype and on its device."""
    return device_constant(_gaussian_window(win_size, win_sigma).tolist(), like.device,
                           like.dtype, torch.float32)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0, win_size: int = 11,
         win_sigma: float = 1.5, size_average: bool = True,
         nonnegative_ssim: bool = False) -> torch.Tensor:
    """SSIM of NHWC images (pytorch_msssim.ssim): the scalar mean, or (N,)
    per image with ``size_average=False``."""
    x, y = _nchw(x), _nchw(y)
    ssim_map, _ = _ssim_maps(x, y, _window(win_size, win_sigma, x), data_range)
    # Per-channel means (N, C), the clamp per channel before the channel
    # mean: the order matters when channels straddle zero.
    per_channel = ssim_map.mean(dim=(2, 3))
    if nonnegative_ssim:
        per_channel = torch.relu(per_channel)
    return per_channel.mean() if size_average else per_channel.mean(dim=1)


def _avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """pytorch_msssim's downsample of NCHW ``x``: an odd dim gets one zero
    on both sides and every window is divided by 4."""
    h, w = x.shape[2:]
    return F.avg_pool2d(x, kernel_size=2, padding=(h % 2, w % 2), count_include_pad=True)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0, win_size: int = 11,
            win_sigma: float = 1.5, size_average: bool = True,
            weights: tuple = MS_SSIM_WEIGHTS) -> torch.Tensor:
    """MS-SSIM of NHWC images; min(H, W) must exceed (win_size - 1) *
    2**(levels - 1), 160 for 5 levels (util/metrics.py:39-40)."""
    levels = len(weights)
    smaller = min(x.shape[1], x.shape[2])
    if smaller <= (win_size - 1) * 2 ** (levels - 1):
        raise ValueError(f"image too small for {levels}-level ms-ssim: {tuple(x.shape)}")
    x, y = _nchw(x), _nchw(y)
    window = _window(win_size, win_sigma, x)
    # (N, C) granularity throughout, as pytorch_msssim: the relu clamps and
    # the cross-level product are per channel; only the end averages them.
    mcs = []
    for level in range(levels):
        ssim_map, cs_map = _ssim_maps(x, y, window, data_range)
        ssim_val = ssim_map.mean(dim=(2, 3))
        if level < levels - 1:
            mcs.append(torch.relu(cs_map.mean(dim=(2, 3))))
            x, y = _avg_pool_2x(x), _avg_pool_2x(y)
    stacked = torch.stack(mcs + [torch.relu(ssim_val)], dim=0)  # (levels, N, C)
    w = device_constant(weights, x.device, x.dtype, torch.float32)
    out = torch.prod(stacked ** w[:, None, None], dim=0)
    return out.mean() if size_average else out.mean(dim=1)
