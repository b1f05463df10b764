"""Eval preprocessing, uint8 batch -> model input (counterpart of
``make_eval_preprocess`` in ``cross_scale_mae_tpu/ops/augment.py``)."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from cross_scale_mae_torch.ops.image import center_crop_resize, normalize_images


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
