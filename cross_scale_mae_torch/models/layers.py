"""Transformer building blocks on plain dicts of tensors.

Counterpart of ``cross_scale_mae_tpu/models/layers.py`` (forward only).
Parameters keep the JAX package's layout, so a JAX tree carries over without
transposes: linear kernels are (in, out) and ``linear`` computes
``x @ W + b`` in the activation dtype. LayerNorm statistics and the attention
softmax run in (at least) fp32. A block stack is a list of per-layer dicts
(``utils/params.py`` unstacks the JAX package's stacked leaves).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from cross_scale_mae_torch.configs import GELU_MODES
from cross_scale_mae_torch.ops.attention import mha_v3, mha_v3_reference
from cross_scale_mae_torch.ops.numerics import accum_dtype

Params = dict[str, Any]

# attention_impl values this slice runs. The JAX package's others (the v1
# kernel 'pallas'/'pallas_t' and the variant attentions) are queued in
# ROADMAP.md.
ATTENTION_IMPLS = ("xla", "pallas_v3")


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ W(in, out) + b, weights cast to the activation dtype. The bias is
    added to the rounded product, as in the JAX package, not fused into the
    product's fp32 epilogue: in bf16 the two differ by an ulp on a quarter
    of the outputs."""
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with (at least) fp32 statistics, output in x's dtype."""
    ct = accum_dtype(x.dtype)
    y = F.layer_norm(x.to(ct), (x.shape[-1],), p["scale"].to(ct),
                     p["bias"].to(ct), eps)
    return y.to(x.dtype)


def attention(p: Params, x: torch.Tensor, num_heads: int,
              impl: str = "xla") -> torch.Tensor:
    """Multi-head self-attention with fused qkv (timm Attention layout).

    'pallas_v3' runs the Hopper kernel on a CUDA tensor (``ops/attention.py``
    ``mha_v3``); 'xla' runs its plain PyTorch version, which computes the
    JAX package's einsum attention in the same op order."""
    if impl not in ATTENTION_IMPLS:
        raise NotImplementedError(
            f"attention_impl {impl!r} is not ported yet (this package runs "
            f"{ATTENTION_IMPLS}); see ROADMAP.md for the queue")
    mha = mha_v3 if impl == "pallas_v3" else mha_v3_reference
    return linear(p["proj"], mha(linear(p["qkv"], x), num_heads))


def mlp(p: Params, x: torch.Tensor, gelu: str = "tanh") -> torch.Tensor:
    """fc1 -> GELU -> fc2. 'exact_tanhbwd' differs from 'exact' only in its
    backward, so its forward is the exact GELU."""
    if gelu not in GELU_MODES:
        raise ValueError(f"unknown gelu flavor {gelu!r}")
    h = linear(p["fc1"], x)
    a = F.gelu(h, approximate="tanh" if gelu == "tanh" else "none")
    return linear(p["fc2"], a)


def block(p: Params, x: torch.Tensor, num_heads: int, impl: str = "xla",
          norm_style: str = "pre", gelu: str = "tanh") -> torch.Tensor:
    """'pre' = timm Block (x + f(ln(x))); 'post' = ln(x + f(x))."""
    if norm_style == "pre":
        x = x + attention(p["attn"], layer_norm(p["norm1"], x), num_heads, impl)
        return x + mlp(p["mlp"], layer_norm(p["norm2"], x), gelu)
    if norm_style == "post":
        x = layer_norm(p["norm1"], x + attention(p["attn"], x, num_heads, impl))
        return layer_norm(p["norm2"], x + mlp(p["mlp"], x, gelu))
    raise ValueError(f"unknown residual_norm_style {norm_style!r}")


def run_blocks(blocks: list[Params], x: torch.Tensor, num_heads: int,
               impl: str = "xla", norm_style: str = "pre",
               gelu: str = "tanh") -> torch.Tensor:
    """Apply a stack of blocks in order. The JAX package's scan, unrolled,
    flat-carry and remat variants lay out this same loop."""
    for p in blocks:
        x = block(p, x, num_heads, impl, norm_style, gelu)
    return x
