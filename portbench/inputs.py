"""Every input of a run, made on the device from ``--seed``: the image
pool, the labels, each step's rows of the pool, each step's random draws
(flips, crop boxes, mask noise, drop-path keeps, Mixup/CutMix) and the
weights. The same seed gives the same tensors, so the reference is handed
exactly what the program was, made anew once the window has closed.

Each stream has a generator of its own, seeded from (seed, stream, step),
so no input depends on how many were drawn before it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_STREAMS = {"pool": 1, "labels": 2, "order": 3, "draws": 4, "weights": 5}


def generator(seed: int, stream: str, index: int, device) -> torch.Generator:
    value = (seed * 1_000_003 + _STREAMS[stream]) * 1_000_033 + index
    return torch.Generator(device=device).manual_seed(value % 2 ** 63)


def image_pool(seed: int, count: int, size: int, channels: int, device) -> torch.Tensor:
    """(count, size, size, channels) uint8 images, uniform over 0..255."""
    gen = generator(seed, "pool", 0, device)
    return torch.randint(0, 256, (count, size, size, channels), generator=gen, device=device,
                         dtype=torch.uint8)


def labels(seed: int, count: int, classes: int, device) -> torch.Tensor:
    gen = generator(seed, "labels", 0, device)
    return torch.randint(0, classes, (count,), generator=gen, device=device)


def step_rows(seed: int, step: int, pool: int, batch: int, device) -> torch.Tensor:
    """The pool rows of ``step``: epoch e = step * batch // pool walks a
    permutation of its own, so the steps of an epoch never share a row."""
    per_epoch = pool // batch
    epoch, k = divmod(step, per_epoch)
    order = torch.randperm(pool, generator=generator(seed, "order", epoch, device),
                           device=device)
    return order[k * batch:(k + 1) * batch]


def crop_boxes(u: torch.Tensor, height: int, width: int, scale, ratio) -> torch.Tensor:
    """RandomResizedCrop boxes (top, left, h, w) from four uniforms a row,
    u (4, N): area fraction in ``scale``, log-uniform aspect in ``ratio``,
    sizes clamped to the image, position uniform over the valid range."""
    area = height * width * (u[0] * (scale[1] - scale[0]) + scale[0])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(u[1] * (hi - lo) + lo)
    w = torch.sqrt(area * aspect).clamp(max=float(width))
    h = torch.sqrt(area / aspect).clamp(max=float(height))
    return torch.stack([u[2] * (height - h), u[3] * (width - w), h, w], dim=1)


def pretrain_draws(seed: int, step: int, n: int, cfg: dict, mix: dict, device) -> dict:
    """Flips, the augment's crop boxes, the low-GSD view's per-sample boxes
    and independent mask noise for both views, (2n, L)."""
    gen = generator(seed, "draws", step, device)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    size = cfg["input_size"]
    num = (size // cfg["patch_size"]) ** 2
    return {"hflip": uniform(n) < 0.5, "vflip": uniform(n) < 0.5,
            "crop_boxes": crop_boxes(uniform(4, n), size, size, mix["crop_scale"],
                                     mix["crop_ratio"]),
            "ms_boxes": crop_boxes(uniform(4, n), size, size, cfg["ms_range"],
                                   cfg["ms_aspect_ratio"]),
            "noise": uniform(2 * n, num)}


def _beta(u: torch.Tensor, v: torch.Tensor, alpha: float) -> torch.Tensor:
    """Beta(alpha, alpha) by Johnk's method over 16 candidate pairs; 0.5
    where no candidate is accepted."""
    x, y = u ** (1.0 / alpha), v ** (1.0 / alpha)
    s = x + y
    ok = s <= 1.0
    first = ok.to(torch.uint8).argmax(dim=0, keepdim=True)
    lam = torch.gather(x, 0, first)[0] / torch.gather(s, 0, first)[0].clamp(min=1e-12)
    return torch.where(ok.any(dim=0), lam, torch.full_like(lam, 0.5))


def finetune_draws(seed: int, step: int, n: int, cfg: dict, mix: dict, device) -> dict:
    """Flips, crop boxes, drop-path keeps (depth, n) at keep rates 1 -
    linspace(0, drop_path_rate, depth), and one Mixup/CutMix draw for the
    batch (switch to CutMix with ``mixup_switch_prob``, Beta lambdas, a box
    centre), broadcast to every row."""
    gen = generator(seed, "draws", step, device)

    def uniform(*shape, lo=0.0):
        return torch.rand(shape, generator=gen, device=device) * (1.0 - lo) + lo

    size = cfg["input_size"]
    keep = 1.0 - torch.from_numpy(
        np.linspace(0.0, cfg["drop_path_rate"], cfg["depth"]).astype(np.float32)).to(device)
    out = {"hflip": uniform(n) < 0.5, "vflip": uniform(n) < 0.5,
           "crop_boxes": crop_boxes(uniform(4, n), size, size, mix["crop_scale"],
                                    mix["crop_ratio"]),
           "drop_masks": uniform(cfg["depth"], n) < keep[:, None]}
    use_cut = uniform(1) < mix["mixup_switch_prob"]
    lam_mix = _beta(uniform(16, 1, lo=1e-7), uniform(16, 1, lo=1e-7), mix["mixup"])
    lam_cut = _beta(uniform(16, 1, lo=1e-7), uniform(16, 1, lo=1e-7), mix["cutmix"])
    apply = uniform(1) < mix["mixup_prob"]
    box = uniform(1, 4)
    out["mixup"] = {"apply": apply.expand(n).contiguous(),
                    "use_cutmix": use_cut.expand(n).contiguous(),
                    "lam_mix": lam_mix.expand(n).contiguous(),
                    "lam_cut": lam_cut.expand(n).contiguous(),
                    "box": box.expand(n, 4).contiguous()}
    return out


def weights(specs: list, seed: int, device) -> dict[tuple, torch.Tensor]:
    """Every parameter from one uniform draw over [-1, 1): kernels Glorot
    uniform, biases within 0.02, norm scales 1 +- 0.1, tokens within 0.035,
    a trained position table within 1."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = generator(seed, "weights", 0, device)
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for path, shape, kind in specs:
        u = flat[at:at + math.prod(shape)].view(shape)
        at += u.numel()
        if kind == "kernel":
            out[path] = u * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif kind == "scale":
            out[path] = 1.0 + 0.1 * u
        else:
            out[path] = u * {"bias": 0.02, "token": 0.035, "pos": 1.0}[kind]
    return out
