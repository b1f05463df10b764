"""Preprocessing on the device, uint8 batch -> model input (counterpart of
``make_pretrain_augment``, ``make_finetune_augment`` and
``make_eval_preprocess`` in ``cross_scale_mae_tpu/ops/augment.py``).

The train chains take their random draws (flip flags, crop boxes, the
NAIP chain's rotations, the finetune chain's RandAugment, ColorJitter and
RandomErasing draws) as arguments: ``train/pretrain.py::sample_pretrain_draws`` and
``train/classify.py::sample_finetune_draws`` make them, and a test can hand
the JAX package's draws to both."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from cross_scale_mae_torch.ops.image import (
    center_crop_resize,
    normalize_images,
    random_flips,
    random_resized_crop,
    random_rot90,
)
from cross_scale_mae_torch.ops.randaug import (
    EraseDraws,
    RandAugDraws,
    RandAugmentConfig,
    parse_rand_augment,
    rand_augment,
    random_erasing,
    sample_erase_draws,
    sample_jitter_factors,
    sample_randaug_draws,
)
from cross_scale_mae_torch.ops.randaug import color_jitter as color_jitter_fn
from cross_scale_mae_torch.utils.profiling import span

# RandomResizedCrop area range of the train transform (util/datasets.py:130-136).
PRETRAIN_CROP_SCALE = (0.25, 1.0)


def make_pretrain_augment(
    mean: Sequence[float],
    std: Sequence[float],
    input_size: int,
    *,
    rot90: bool = False,
    normalize: bool = True,
    dtype: str = "float32",
) -> Callable[..., torch.Tensor]:
    """Train chain (util/datasets.py:123-138), op for op in ``dtype``:
    uint8 -> dtype, /255, normalize (unless the loader did, ``normalize``
    False: the SentinelNormalize families), per-sample horizontal and
    vertical flips, with ``rot90`` the NAIP chain's per-sample k * 90 degree
    rotation (util/naip_loader.py), then bicubic RandomResizedCrop on the
    fast product path. Returns ``augment(batch_u8, hflip, vflip, boxes,
    rot_k=None)`` with (N,) bool flip flags, (N, 4) crop boxes
    (``ops/image.sample_crop_boxes`` with ``PRETRAIN_CROP_SCALE``) and, with
    ``rot90``, (N,) rotation counts in {0, 1, 2, 3}."""
    tdtype = getattr(torch, dtype)

    def augment(batch_u8: torch.Tensor, hflip: torch.Tensor, vflip: torch.Tensor,
                boxes: torch.Tensor, rot_k: torch.Tensor | None = None) -> torch.Tensor:
        x = batch_u8.to(tdtype) / 255.0
        if normalize:
            x = normalize_images(x, mean, std)
        x = random_flips(x, hflip, vflip)
        if rot90:
            x = random_rot90(x, _rotations(rot_k))
        return random_resized_crop(x, boxes, input_size, "cubic")

    return augment


def _rotations(rot_k: torch.Tensor | None) -> torch.Tensor:
    if rot_k is None:
        raise ValueError("the rot90 chain needs its (N,) rotation draws")
    return rot_k


@dataclasses.dataclass(frozen=True)
class AugmentExtras:
    """The finetune chain's extras (main_finetune.py:188-232): RandAugment
    (``aa``, a parsed policy), ColorJitter (off under RandAugment, as in
    timm) and RandomErasing (``reprob``, ``remode``, ``recount``)."""

    aa: Optional[RandAugmentConfig] = None
    color_jitter: Optional[float] = None
    reprob: float = 0.0
    remode: str = "pixel"
    recount: int = 1

    @property
    def jitter(self) -> Optional[float]:
        return self.color_jitter if self.aa is None and self.color_jitter else None

    def sample(self, gen: torch.Generator, n: int, size: int, channels: int) -> dict:
        """The draws of ``n`` samples on ``size``-pixel crops, keyed as
        ``FinetuneDraws`` holds them (``randaug``, ``jitter``, ``erase``);
        drawn in that order after the crop's."""
        out = {}
        if self.aa is not None:
            out["randaug"] = sample_randaug_draws(gen, n, self.aa)
        if self.jitter is not None:
            out["jitter"] = sample_jitter_factors(gen, n, self.jitter)
        if self.reprob > 0:
            out["erase"] = sample_erase_draws(gen, n, size, channels, self.reprob,
                                              self.remode, self.recount)
        return out


def make_finetune_augment(
    mean: Sequence[float],
    std: Sequence[float],
    input_size: int,
    *,
    rot90: bool = False,
    color_jitter: float | None = None,
    aa: str | None = None,
    reprob: float = 0.0,
    remode: str = "pixel",
    recount: int = 1,
    normalize: bool = True,
    dtype: str = "float32",
) -> Callable[..., torch.Tensor]:
    """Finetune train chain (augment.py:57-114) with its whole flag surface,
    in the JAX order: uint8 -> fp32, /255, per-sample horizontal and
    vertical flips, with ``rot90`` the NAIP rotation, bicubic
    RandomResizedCrop on the fast product path, RandAugment (``aa``) or
    else ColorJitter (``color_jitter``) on the [0, 1] pixels, normalize
    (not where the loader did, ``normalize`` False), RandomErasing
    (``reprob``, ``remode``, ``recount``) on the normalized fp32 tensor, and
    the cast to ``dtype``. Returns ``augment(batch_u8, hflip, vflip, boxes,
    rot_k=None, randaug=None, jitter=None, erase=None)``, boxes drawn on the
    batch's canvas with ``PRETRAIN_CROP_SCALE``, the extras' draws from
    ``augment.extras.sample``; ``augment.extras`` is the
    :class:`AugmentExtras`. Each extra runs in a span of its name
    (``randaug``, ``color_jitter``, ``random_erasing``; ``utils/profiling.span``)."""
    extras = AugmentExtras(parse_rand_augment(aa), color_jitter, reprob, remode, recount)
    tdtype = getattr(torch, dtype)

    def augment(batch_u8: torch.Tensor, hflip: torch.Tensor, vflip: torch.Tensor,
                boxes: torch.Tensor, rot_k: torch.Tensor | None = None, *,
                randaug: RandAugDraws | None = None, jitter: torch.Tensor | None = None,
                erase: EraseDraws | None = None) -> torch.Tensor:
        x = random_flips(batch_u8.to(torch.float32) / 255.0, hflip, vflip)
        if rot90:
            x = random_rot90(x, _rotations(rot_k))
        x = random_resized_crop(x, boxes, input_size, "cubic")
        if extras.aa is not None:
            with span("randaug", x.device):
                x = rand_augment(x, _needed(randaug, "RandAugment"), extras.aa)
        elif extras.jitter is not None:
            with span("color_jitter", x.device):
                x = color_jitter_fn(x, _needed(jitter, "ColorJitter"))
        if normalize:
            x = normalize_images(x, mean, std)
        if extras.reprob > 0:
            with span("random_erasing", x.device):
                x = random_erasing(x, _needed(erase, "RandomErasing"), extras.remode)
        return x.to(tdtype)

    augment.extras = extras
    return augment


def _needed(draws, name: str):
    if draws is None:
        raise ValueError(f"the finetune chain runs {name} and needs its draws")
    return draws


def make_eval_preprocess(
    mean: Sequence[float],
    std: Sequence[float],
    input_size: int,
    *,
    normalize: bool = True,
    dtype: str = "float32",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Eval chain: Normalize -> Resize(1/0.875) -> CenterCrop
    (util/datasets.py:140-158), op for op in ``dtype``: uint8 -> dtype,
    /255, normalize, then the resize on an input_size/0.875 canvas."""
    tdtype = getattr(torch, dtype)

    def preprocess(batch_u8: torch.Tensor) -> torch.Tensor:
        x = batch_u8.to(tdtype) / 255.0
        if normalize:
            x = normalize_images(x, mean, std)
        if x.shape[1] != input_size:
            x = center_crop_resize(x, input_size)
        return x

    return preprocess
