"""Accumulation-dtype helpers (counterpart of ``cross_scale_mae_tpu/ops/numerics.py``).

The stability-sensitive spots (LN statistics, attention logits) upcast bf16
activations to fp32, and never downcast a wider input: fp64 stays fp64.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: at least fp32, wider if the input is."""
    return torch.promote_types(dtype, torch.float32)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast to fp32 unless the input is already wider."""
    return x.to(accum_dtype(x.dtype))


def _make_constant(values: tuple, device: torch.device, dtype: torch.dtype,
                   source_dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=source_dtype).to(device, dtype)


_cached_constant = functools.lru_cache(maxsize=64)(_make_constant)


def device_constant(values: Sequence[float], device: torch.device, dtype: torch.dtype,
                    source_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``values`` (made in ``source_dtype``, then cast to ``dtype``) as a
    tensor on ``device``, copied from the host once per (values, device,
    dtype): a copy from the host on every call would make the caller wait
    for the device. Callers only read it. Under ``torch.compile`` or
    ``torch.export`` it is made anew, so no traced tensor enters the cache."""
    key = tuple(float(v) for v in values)
    if torch.compiler.is_compiling():
        return _make_constant(key, device, dtype, source_dtype)
    return _cached_constant(key, torch.device(device), dtype, source_dtype)


def require_ieee_fp32(device: torch.device, what: str) -> None:
    """RuntimeError where the process lets fp32 matmuls on the card run in
    TF32 (PyTorch's default is IEEE fp32): ``what``'s fp32 products would
    silently lose 13 mantissa bits."""
    if device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{what} needs IEEE fp32 matrix products, but this process enabled TF32 for "
            "fp32 matmuls (torch.backends.cuda.matmul.allow_tf32 / "
            "torch.set_float32_matmul_precision)")
