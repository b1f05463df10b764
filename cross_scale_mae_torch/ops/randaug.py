"""RandAugment, ColorJitter and RandomErasing for finetuning, on the device
(counterpart of ``cross_scale_mae_tpu/ops/randaug.py``).

The semantics are the JAX package's (timm's ``rand`` policy with the
increasing-severity ops, torchvision-style ColorJitter in a fixed b -> c
-> s order, timm RandomErasing); the draws are explicit
(:class:`RandAugDraws`, :class:`EraseDraws`, jitter factors), made by the
``sample_*`` functions on a ``torch.Generator`` or, in a test, from the JAX
package's keys. Images are [0, 1] fp32 NHWC (erasing: normalized).

Where the JAX package runs every op on every sample and selects
(``rand_augment``), each op here runs once, on the samples that drew it and
whose apply flag is set, and writes them back: the same image per sample,
one pass over the batch per layer instead of about eleven. Which samples
drew which op is read on the host once per call (one device-to-host copy of
the (layers, N) plan). Equalize's histogram is a per-(sample, channel)
``scatter_add_`` and its LUT a ``gather`` (the JAX package's chunked
256-bin compare form is a scatter-free TPU idiom); the arithmetic is
integer, so the result is the same bits. The five geometric ops share one
per-sample affine, resampled bilinearly with mid-gray fill.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

_GRAY = (0.2989, 0.587, 0.114)
ERASE_AREA = (0.02, 1.0 / 3.0)
ERASE_ASPECT = (0.3, 10.0 / 3.0)
ERASE_MODES = ("pixel", "const")


# ------------------------------------------------------------- pixel ops
# Each takes [0, 1] fp32 NHWC images and per-sample (K,) magnitudes in
# [0, 1] (m / 10) and signs (+-1).


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def _gray(x: torch.Tensor) -> torch.Tensor:
    # Scalar products: a weight tensor made from Python data on the card would
    # be a blocking copy, a wait for the stream.
    if x.shape[-1] == 3:
        return x[..., 0] * _GRAY[0] + x[..., 1] * _GRAY[1] + x[..., 2] * _GRAY[2]
    return x.mean(dim=-1)


def _blend(a: torch.Tensor, b: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """a + factor * (b - a), clamped to [0, 1]."""
    return torch.clamp(a + _col(factor) * (b - a), 0.0, 1.0)


def _brightness(x, m, sign):
    return _blend(torch.zeros_like(x), x, 1.0 + 0.9 * m * sign)


def _contrast(x, m, sign):
    gm = _gray(x).mean(dim=(1, 2))
    return _blend(_col(gm).expand(x.shape), x, 1.0 + 0.9 * m * sign)


def _color(x, m, sign):
    return _blend(_gray(x)[..., None].expand(x.shape), x, 1.0 + 0.9 * m * sign)


def _sharpness(x, m, sign):
    """Blend with the 3x3 PIL SMOOTH image (centre 5, ring 1, over 13), the
    one-pixel border kept from x as PIL leaves it."""
    c = x.shape[-1]
    k = torch.ones((3, 3), dtype=x.dtype, device=x.device)   # made on the card, no copy
    k[1, 1] = 5.0
    k = k / 13.0
    smooth = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, 3, 3), padding=1,
                      groups=c).permute(0, 2, 3, 1)
    h, w = x.shape[1], x.shape[2]
    ys = torch.arange(h, device=x.device)[:, None]
    xs = torch.arange(w, device=x.device)[None, :]
    interior = (ys > 0) & (ys < h - 1) & (xs > 0) & (xs < w - 1)
    smooth = torch.where(interior[None, :, :, None], smooth, x)
    return _blend(smooth, x, 1.0 + 0.9 * m * sign)


def _posterize(x, m, sign):
    """timm PosterizeIncreasing: 4 - floor(4 m) bits kept (at least 1), as
    float arithmetic in the JAX order: floor(x * 255 / (256 / levels))."""
    bits = torch.clamp(4.0 - torch.floor(4.0 * m), 1, 8)
    step = _col(256.0 / 2.0 ** bits)
    q = torch.floor(x * 255.0 / step)
    return torch.clamp(q * step / 255.0, 0.0, 1.0)


def _solarize(x, m, sign):
    return torch.where(x >= _col(1.0 - m), 1.0 - x, x)


def _solarize_add(x, m, sign):
    add = _col(110.0 / 255.0 * m)
    return torch.where(x < 0.5, torch.clamp(x + add, 0.0, 1.0), x)


def _invert(x, m, sign):
    return 1.0 - x


def _autocontrast(x, m, sign):
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    return torch.where(hi > lo, (x - lo) / torch.clamp(hi - lo, min=1e-6), x)


def _equalize(x, m, sign):
    """PIL ImageOps.equalize per (sample, channel) on the 8-bit values:
    step = (npix - hist[255]) // 255, lut[i] = (cumsum(hist)[:i] + step // 2)
    // step, the identity where step is 0."""
    n, h, w, c = x.shape
    xu = torch.clamp(torch.round(x * 255.0), 0, 255).long()
    px = xu.permute(0, 3, 1, 2).reshape(n * c, h * w)          # (N*C, P)
    base = torch.arange(n * c, device=x.device)[:, None] * 256
    hist = torch.zeros(n * c * 256, dtype=torch.int64, device=x.device)
    hist.scatter_add_(0, (px + base).reshape(-1), torch.ones_like(px).reshape(-1))
    hist = hist.reshape(n * c, 256)
    step = torch.div(h * w - hist[:, 255], 255, rounding_mode="floor")
    cum = torch.cumsum(hist, dim=-1) - hist
    lut = torch.div(cum + torch.div(step, 2, rounding_mode="floor")[:, None],
                    torch.clamp(step, min=1)[:, None], rounding_mode="floor")
    lut = torch.clamp(lut, 0, 255)
    ident = torch.arange(256, device=x.device).expand_as(lut)
    lut = torch.where((step > 0)[:, None], lut, ident)
    y = torch.gather(lut, 1, px).to(x.dtype) / 255.0
    return y.reshape(n, c, h, w).permute(0, 2, 3, 1).contiguous()


PIXEL_OPS = (
    ("autocontrast", _autocontrast),
    ("equalize", _equalize),
    ("invert", _invert),
    ("posterize", _posterize),
    ("solarize", _solarize),
    ("solarize_add", _solarize_add),
    ("color", _color),
    ("contrast", _contrast),
    ("brightness", _brightness),
    ("sharpness", _sharpness),
)
GEOM_OPS = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")
NUM_OPS = len(PIXEL_OPS) + len(GEOM_OPS)


# ---------------------------------------------------------- geometric ops


def affine_params(op: torch.Tensor, m: torch.Tensor, sign: torch.Tensor, h: int, w: int):
    """Per-sample (a00, a01, a10, a11, ty, tx), output pixel -> source pixel
    around the centre, for the geometric ops (JAX randaug.py:185-206); the
    identity for a pixel op's index."""
    n_pix = len(PIXEL_OPS)
    zero = torch.zeros_like(m)
    theta = torch.where(op == n_pix, math.radians(30.0) * m * sign, zero)
    shear = 0.3 * m * sign
    shx = torch.where(op == n_pix + 1, shear, zero)
    shy = torch.where(op == n_pix + 2, shear, zero)
    tx = torch.where(op == n_pix + 3, 0.45 * m * sign * w, zero)
    ty = torch.where(op == n_pix + 4, 0.45 * m * sign * h, zero)
    cos, sin = torch.cos(theta), torch.sin(theta)
    return cos, -sin + shy, sin + shx, cos, ty, tx


def affine_sample(x: torch.Tensor, a00, a01, a10, a11, ty, tx, fill: float = 0.5) -> torch.Tensor:
    """Bilinear per-sample affine resample with constant ``fill`` outside
    (JAX ``map_coordinates(order=1, mode="constant", cval=fill)``, each tap
    out of bounds taking the fill): source [sy, sx] = A [ys, xs] + centre +
    [ty, tx]. Runs as ``grid_sample`` on x - fill with zero padding, then
    adds the fill back."""
    n, h, w, _ = x.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = (torch.arange(h, dtype=torch.float32, device=x.device) - cy)[None, :, None]
    xs = (torch.arange(w, dtype=torch.float32, device=x.device) - cx)[None, None, :]

    def c(v):
        return v[:, None, None]

    sy = c(a00) * ys + c(a01) * xs + cy + c(ty)
    sx = c(a10) * ys + c(a11) * xs + cx + c(tx)
    grid = torch.stack([sx / (w - 1) * 2.0 - 1.0, sy / (h - 1) * 2.0 - 1.0], dim=-1)
    src = (x.to(torch.float32) - fill).permute(0, 3, 1, 2)
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return (out.permute(0, 2, 3, 1) + fill).to(x.dtype)


# ------------------------------------------------------------- RandAugment


class RandAugmentConfig(NamedTuple):
    num_layers: int = 2
    magnitude: float = 9.0
    mag_std: float = 0.5


def parse_rand_augment(spec: Optional[str]) -> Optional[RandAugmentConfig]:
    """A timm policy string 'rand-m9-mstd0.5[-n2][-inc1]' (JAX randaug.py:
    245-272); ``inc`` is accepted, the ops being the increasing-severity
    ones already."""
    if not spec:
        return None
    if not spec.startswith("rand"):
        raise ValueError(f"only 'rand-*' auto-augment policies supported, got {spec!r}")
    cfg = RandAugmentConfig()
    for tok in spec.split("-")[1:]:
        if m := re.fullmatch(r"m(\d+)", tok):
            cfg = cfg._replace(magnitude=float(m.group(1)))
        elif m := re.fullmatch(r"mstd([\d.]+)", tok):
            cfg = cfg._replace(mag_std=float(m.group(1)))
        elif m := re.fullmatch(r"n(\d+)", tok):
            cfg = cfg._replace(num_layers=int(m.group(1)))
        elif re.fullmatch(r"inc\d*", tok):
            pass
        else:
            raise ValueError(f"unknown rand-augment token {tok!r} in {spec!r}")
    return cfg


@dataclasses.dataclass
class RandAugDraws:
    """RandAugment's draws for N samples, one row per layer."""

    op: torch.Tensor      # (layers, N) int64 in [0, NUM_OPS)
    mag: torch.Tensor     # (layers, N) fp32 standard normals (the magnitude's noise)
    sign: torch.Tensor    # (layers, N) bool: True is +1
    apply: torch.Tensor   # (layers, N) bool: the op applies (timm's prob 0.5)

    def take(self, rows) -> "RandAugDraws":
        return RandAugDraws(self.op[:, rows], self.mag[:, rows], self.sign[:, rows],
                            self.apply[:, rows])


def sample_randaug_draws(gen: torch.Generator, n: int, cfg: RandAugmentConfig) -> RandAugDraws:
    """Per layer: a uniform op, a normal magnitude noise, Bernoulli(0.5)
    sign and apply (JAX randaug.py:283-298)."""
    dev, layers = gen.device, cfg.num_layers
    op = torch.randint(0, NUM_OPS, (layers, n), generator=gen, device=dev)
    mag = torch.randn((layers, n), generator=gen, device=dev)
    sign = torch.rand((layers, n), generator=gen, device=dev) < 0.5
    apply = torch.rand((layers, n), generator=gen, device=dev) < 0.5
    return RandAugDraws(op, mag, sign, apply)


def rand_augment(imgs: torch.Tensor, draws: RandAugDraws, cfg: RandAugmentConfig) -> torch.Tensor:
    """``cfg.num_layers`` layers, each applying its drawn op to the samples
    whose apply flag is set: magnitude clip(m + std * noise, 0, 10) / 10,
    sign +-1. imgs: [0, 1] fp32 NHWC."""
    n, h, w, _ = imgs.shape
    if draws.op.shape != (cfg.num_layers, n):
        raise ValueError(f"RandAugment draws of shape {tuple(draws.op.shape)} for "
                         f"{cfg.num_layers} layers of {n} samples")
    x = imgs.clone()
    # One host read (a device sync) of which sample runs which op in each layer.
    plan = torch.where(draws.apply, draws.op, NUM_OPS).cpu()
    n_pix = len(PIXEL_OPS)
    for layer in range(cfg.num_layers):
        m = torch.clamp(cfg.magnitude + cfg.mag_std * draws.mag[layer], 0.0, 10.0) / 10.0
        sign = torch.where(draws.sign[layer], 1.0, -1.0)
        row = plan[layer]
        order = torch.argsort(row, stable=True)
        counts = torch.bincount(row, minlength=NUM_OPS + 1).tolist()
        order = order.to(x.device, non_blocking=True)
        start = 0
        groups = []
        for op, count in enumerate(counts[:n_pix] + [sum(counts[n_pix:NUM_OPS])]):
            groups.append((op, order[start:start + count]))
            start += count
        # Every op reads only its own samples, so the groups write x in place.
        for op, idx in groups:
            if idx.numel() == 0:
                continue
            xi, mi, si = x.index_select(0, idx), m[idx], sign[idx]
            if op < n_pix:
                out = PIXEL_OPS[op][1](xi, mi, si)
            else:
                out = affine_sample(xi, *affine_params(draws.op[layer][idx], mi, si, h, w))
            x.index_copy_(0, idx, out)
    return x


# ------------------------------------------------------------- ColorJitter


def sample_jitter_factors(gen: torch.Generator, n: int, factor: float) -> torch.Tensor:
    """(N, 3) brightness, contrast and saturation factors ~ U[max(0, 1 - f),
    1 + f] (JAX randaug.py:316-321)."""
    lo, hi = max(0.0, 1.0 - factor), 1.0 + factor
    return torch.rand((n, 3), generator=gen, device=gen.device) * (hi - lo) + lo


def color_jitter(imgs: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter(f, f, f) in the fixed brightness -> contrast
    -> saturation order (JAX randaug.py:306-325); factors (N, 3)."""
    x = _blend(torch.zeros_like(imgs), imgs, factors[:, 0])
    gm = _gray(x).mean(dim=(1, 2))
    x = _blend(_col(gm).expand(x.shape), x, factors[:, 1])
    return _blend(_gray(x)[..., None].expand(x.shape), x, factors[:, 2])


# ---------------------------------------------------------- RandomErasing


@dataclasses.dataclass
class EraseDraws:
    """RandomErasing's draws for N samples and ``count`` rectangles."""

    apply: torch.Tensor        # (N,) bool: erase this image (once per image)
    area: torch.Tensor         # (count, N) target area fraction in ERASE_AREA
    log_aspect: torch.Tensor   # (count, N) log aspect ratio in log(ERASE_ASPECT)
    y: torch.Tensor            # (count, N) U[0, 1): the top, over the free height
    x: torch.Tensor            # (count, N) U[0, 1): the left, over the free width
    noise: Optional[torch.Tensor] = None  # (count, N, H, W, C) fp32 N(0, 1), 'pixel' mode

    def take(self, rows) -> "EraseDraws":
        return EraseDraws(self.apply[rows], self.area[:, rows], self.log_aspect[:, rows],
                          self.y[:, rows], self.x[:, rows],
                          None if self.noise is None else self.noise[:, rows])


def sample_erase_draws(gen: torch.Generator, n: int, size: int, channels: int, prob: float,
                       mode: str = "pixel", count: int = 1) -> EraseDraws:
    """timm RandomErasing's draws (JAX randaug.py:347-370): one Bernoulli
    ``prob`` per image, then per rectangle a uniform area and log-aspect and
    a uniform position; 'pixel' mode's per-pixel N(0, 1) fill in fp32 on a
    (size, size, channels) image."""
    if mode not in ERASE_MODES:
        raise ValueError(f"erasing mode {mode!r} is not one of {ERASE_MODES}")
    dev = gen.device

    def uniform(lo=0.0, hi=1.0):
        return torch.rand((count, n), generator=gen, device=dev) * (hi - lo) + lo

    apply = torch.rand(n, generator=gen, device=dev) < prob
    area = uniform(*ERASE_AREA)
    log_aspect = uniform(math.log(ERASE_ASPECT[0]), math.log(ERASE_ASPECT[1]))
    y, x = uniform(), uniform()
    noise = (torch.randn((count, n, size, size, channels), generator=gen, device=dev)
             if mode == "pixel" else None)
    return EraseDraws(apply, area, log_aspect, y, x, noise)


def random_erasing(imgs: torch.Tensor, draws: EraseDraws, mode: str = "pixel") -> torch.Tensor:
    """Erase ``count`` rectangles of each image whose apply flag is set,
    each of area fraction / count of the image (timm divides the target
    area by the count), with the noise ('pixel') or 0 ('const'). imgs:
    normalized NHWC, before the cast (JAX randaug.py:331-379)."""
    if mode not in ERASE_MODES:
        raise ValueError(f"erasing mode {mode!r} is not one of {ERASE_MODES}")
    count = draws.area.shape[0]
    _, h, w, _ = imgs.shape
    ys = torch.arange(h, dtype=torch.float32, device=imgs.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=imgs.device)[None, None, :]
    x = imgs
    for r in range(count):
        area = draws.area[r] * (h * w / count)
        ar = torch.exp(draws.log_aspect[r])
        eh = torch.clamp(torch.sqrt(area * ar), max=float(h))
        ew = torch.clamp(torch.sqrt(area / ar), max=float(w))
        y0 = draws.y[r] * (h - eh)
        x0 = draws.x[r] * (w - ew)
        inside = ((ys >= y0[:, None, None]) & (ys < (y0 + eh)[:, None, None])
                  & (xs >= x0[:, None, None]) & (xs < (x0 + ew)[:, None, None]))
        mask = (inside & draws.apply[:, None, None])[..., None]
        fill = draws.noise[r].to(x.dtype) if mode == "pixel" else torch.zeros_like(x)
        x = torch.where(mask, fill, x)
    return x
