"""Preprocessing on the device, uint8 batch -> model input (counterpart of
``make_pretrain_augment`` and ``make_eval_preprocess`` in
``cross_scale_mae_tpu/ops/augment.py``).

The pretrain chain takes its random draws (flip flags, crop boxes) as
arguments: ``train/pretrain.py::sample_pretrain_draws`` makes them, and a
test can hand the JAX package's draws to both."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from cross_scale_mae_torch.ops.image import (
    center_crop_resize,
    normalize_images,
    random_flips,
    random_resized_crop,
)

# RandomResizedCrop area range of the train transform (util/datasets.py:130-136).
PRETRAIN_CROP_SCALE = (0.25, 1.0)


def make_pretrain_augment(
    mean: Sequence[float],
    std: Sequence[float],
    input_size: int,
    *,
    dtype: str = "float32",
) -> Callable[..., torch.Tensor]:
    """Train chain (util/datasets.py:123-138), op for op in ``dtype``:
    uint8 -> dtype, /255, normalize, per-sample horizontal and vertical
    flips, bicubic RandomResizedCrop on the fast product path. Returns
    ``augment(batch_u8, hflip, vflip, boxes)`` with (N,) bool flip flags and
    (N, 4) crop boxes (``ops/image.sample_crop_boxes`` with
    ``PRETRAIN_CROP_SCALE``). The NAIP rot90 variant is not ported yet
    (ROADMAP.md, queue 1 item 10)."""
    tdtype = getattr(torch, dtype)

    def augment(batch_u8: torch.Tensor, hflip: torch.Tensor,
                vflip: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        x = normalize_images(batch_u8.to(tdtype) / 255.0, mean, std)
        x = random_flips(x, hflip, vflip)
        return random_resized_crop(x, boxes, input_size, "cubic")

    return augment


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
