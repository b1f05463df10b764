"""Preprocessing on the device, uint8 batch -> model input (counterpart of
``make_pretrain_augment``, ``make_finetune_augment`` and
``make_eval_preprocess`` in ``cross_scale_mae_tpu/ops/augment.py``).

The train chains take their random draws (flip flags, crop boxes, the
NAIP chain's rotations) as arguments: ``train/pretrain.py::sample_pretrain_draws`` and
``train/classify.py::sample_finetune_draws`` make them, and a test can hand
the JAX package's draws to both."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from cross_scale_mae_torch.ops.image import (
    center_crop_resize,
    normalize_images,
    random_flips,
    random_resized_crop,
    random_rot90,
)

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


def make_finetune_augment(
    mean: Sequence[float],
    std: Sequence[float],
    input_size: int,
    *,
    rot90: bool = False,
    color_jitter: float | None = None,
    aa: str | None = None,
    reprob: float = 0.0,
    normalize: bool = True,
    dtype: str = "float32",
) -> Callable[..., torch.Tensor]:
    """Finetune train chain (augment.py:57-114) without its extras: uint8 ->
    fp32, /255, per-sample horizontal and vertical flips, with ``rot90`` the
    NAIP rotation, bicubic RandomResizedCrop on the fast product path, then
    normalize (after the crop, unlike the pretrain chain; not where the
    loader did, ``normalize`` False) and cast to ``dtype``. Returns
    ``augment(batch_u8, hflip, vflip, boxes, rot_k=None)``, boxes drawn on the batch's canvas with
    ``PRETRAIN_CROP_SCALE``. RandAugment, color jitter and random erasing
    are not ported yet and refuse."""
    unported = {"color_jitter": color_jitter, "aa": aa, "reprob": reprob > 0}
    for name, value in unported.items():
        if value:
            raise NotImplementedError(
                f"finetune augmentation {name} is not ported yet; see ROADMAP.md "
                "(queue 1 item 12)")
    tdtype = getattr(torch, dtype)

    def augment(batch_u8: torch.Tensor, hflip: torch.Tensor, vflip: torch.Tensor,
                boxes: torch.Tensor, rot_k: torch.Tensor | None = None) -> torch.Tensor:
        x = random_flips(batch_u8.to(torch.float32) / 255.0, hflip, vflip)
        if rot90:
            x = random_rot90(x, _rotations(rot_k))
        x = random_resized_crop(x, boxes, input_size, "cubic")
        if normalize:
            x = normalize_images(x, mean, std)
        return x.to(tdtype)

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
