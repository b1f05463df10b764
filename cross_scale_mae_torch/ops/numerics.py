"""Accumulation-dtype helpers (counterpart of ``cross_scale_mae_tpu/ops/numerics.py``).

The stability-sensitive spots (LN statistics, attention logits) upcast bf16
activations to fp32, and never downcast a wider input: fp64 stays fp64.
"""

from __future__ import annotations

import torch


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: at least fp32, wider if the input is."""
    return torch.promote_types(dtype, torch.float32)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast to fp32 unless the input is already wider."""
    return x.to(accum_dtype(x.dtype))
