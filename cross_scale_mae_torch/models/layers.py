"""Transformer building blocks on plain dicts of tensors.

Counterpart of ``cross_scale_mae_tpu/models/layers.py``. Parameters keep the
JAX package's layout, so a JAX tree carries over without transposes: linear
kernels are (in, out) and ``linear`` computes ``x @ W + b`` in the
activation dtype. LayerNorm statistics, the attention softmax and the
predictor's BatchNorm statistics run in (at least) fp32. A block stack is a
list of per-layer dicts (``utils/params.py`` unstacks the JAX package's
stacked leaves). Gradients come from autograd, with two hand-written
backwards: the attention kernels' (``ops/attention.py``) and
:class:`GeluExactFastBwd`'s.

The init functions draw from an explicit ``torch.Generator`` on the target
device: the same distributions as the JAX package's, not the same bits.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from cross_scale_mae_torch.configs import GELU_MODES
from cross_scale_mae_torch.ops.attention import mha, mha_folded, mha_v3, mha_v3_reference
from cross_scale_mae_torch.ops.numerics import accum_dtype, at_least_f32
from cross_scale_mae_torch.parallel.collectives import all_reduce_sum
from cross_scale_mae_torch.parallel.dist import world_size

Params = dict[str, Any]

# attention_impl values the port runs. The JAX package's variant attentions
# are queued in ROADMAP.md.
ATTENTION_IMPLS = ("xla", "pallas_v3", "pallas", "pallas_t")


def xavier_uniform(gen: torch.Generator, shape: tuple[int, ...], fan_in: int,
                   fan_out: int) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return u * (2 * limit) - limit


def linear_init(gen: torch.Generator, d_in: int, d_out: int) -> Params:
    """Xavier-uniform kernel (in, out), zero bias (MAE_ViT_Baseline.py:233-241)."""
    return {"kernel": xavier_uniform(gen, (d_in, d_out), d_in, d_out),
            "bias": torch.zeros(d_out, device=gen.device)}


def layer_norm_init(dim: int, device: torch.device | str) -> Params:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def block_init(gen: torch.Generator, dim: int, mlp_ratio: int = 4) -> Params:
    """One pre-LN transformer block (timm Block layout, qkv fused and
    initialised as one Linear(dim, 3*dim))."""
    hidden = dim * mlp_ratio
    return {
        "norm1": layer_norm_init(dim, gen.device),
        "attn": {"qkv": linear_init(gen, dim, 3 * dim),
                 "proj": linear_init(gen, dim, dim)},
        "norm2": layer_norm_init(dim, gen.device),
        "mlp": {"fc1": linear_init(gen, dim, hidden),
                "fc2": linear_init(gen, hidden, dim)},
    }


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


def _attention_pallas_t(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The K2 kernels with the head transpose in the projections
    (layers.py:115-143): the qkv einsum emits head-major (N, 3, H, L, hd)
    output, the bias added in the compute dtype, and the proj einsum
    consumes (N, H, L, hd) back."""
    n, l, d = x.shape
    hd = d // num_heads
    wq = p["qkv"]["kernel"].to(x.dtype).reshape(d, 3, num_heads, hd)
    bq = p["qkv"]["bias"].to(x.dtype).reshape(3, num_heads, hd)
    qkv = torch.einsum("nld,dshk->nshlk", x, wq) + bq[None, :, :, None, :]
    q, k, v = (qkv[:, i].reshape(n * num_heads, l, hd) for i in range(3))
    out = mha_folded(q, k, v).reshape(n, num_heads, l, hd)
    wp = p["proj"]["kernel"].to(x.dtype).reshape(num_heads, hd, d)
    return torch.einsum("nhlk,hkd->nld", out, wp) + p["proj"]["bias"].to(x.dtype)


def attention(p: Params, x: torch.Tensor, num_heads: int,
              impl: str = "xla") -> torch.Tensor:
    """Multi-head self-attention with fused qkv (timm Attention layout).

    'pallas_v3' runs the K1 kernels on the raw qkv layout and 'pallas' and
    'pallas_t' the K2 kernels on head-folded q, k, v (``ops/attention.py``);
    on a CPU tensor each runs its kernels' plain versions. 'xla' runs the
    plain v3 version, which computes the JAX package's einsum attention in
    the same op order."""
    if impl not in ATTENTION_IMPLS:
        raise NotImplementedError(
            f"attention_impl {impl!r} is not ported yet (this package runs "
            f"{ATTENTION_IMPLS}); see ROADMAP.md for the queue")
    if impl == "pallas_t":
        return _attention_pallas_t(p, x, num_heads)
    qkv = linear(p["qkv"], x)
    if impl == "pallas":
        n, l, d = x.shape
        # JAX slices qkv[:, :, i]; unbind is the same views, and its
        # backward stacks the three gradients in one copy.
        q, k, v = qkv.reshape(n, l, 3, num_heads, d // num_heads).unbind(2)
        return linear(p["proj"], mha(q, k, v).reshape(n, l, d))
    attend = mha_v3 if impl == "pallas_v3" else mha_v3_reference
    return linear(p["proj"], attend(qkv, num_heads))


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


class GeluExactFastBwd(torch.autograd.Function):
    """Exact (erf) GELU whose backward is the tanh-GELU derivative
    (``gelu='exact_tanhbwd'``; JAX ``gelu_exact_fastbwd``, layers.py:235-279):
    the backward skips differentiating through erf."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return F.gelu(x, approximate="none")

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        xf = at_least_f32(x)
        c = _SQRT_2_OVER_PI
        t = torch.tanh(c * (xf + 0.044715 * (xf * xf * xf)))
        d = 0.5 * (1.0 + t) + 0.5 * xf * (1.0 - t * t) * c * (
            1.0 + 3.0 * 0.044715 * xf * xf)
        return (at_least_f32(g) * d).to(x.dtype)


gelu_exact_fastbwd = GeluExactFastBwd.apply


def mlp(p: Params, x: torch.Tensor, gelu: str = "tanh") -> torch.Tensor:
    """fc1 -> GELU -> fc2. 'exact_tanhbwd' has the exact GELU's forward and
    the tanh GELU's derivative as its backward."""
    if gelu not in GELU_MODES:
        raise ValueError(f"unknown gelu flavor {gelu!r}")
    h = linear(p["fc1"], x)
    if gelu == "exact_tanhbwd":
        a = gelu_exact_fastbwd(h)
    else:
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


def predictor_init(gen: torch.Generator, dim: int, num_tokens: int, hidden: int) -> Params:
    """The predictor MLP (models_mae/MLP.py): Linear -> BatchNorm1d over the
    token axis (channel = token position) -> ReLU -> Linear."""
    return {"fc1": linear_init(gen, dim, hidden),
            "bn": {"scale": torch.ones(num_tokens, device=gen.device),
                   "bias": torch.zeros(num_tokens, device=gen.device)},
            "fc2": linear_init(gen, hidden, dim)}


def predictor_state_init(num_tokens: int, device: torch.device | str) -> Params:
    return {"bn": {"mean": torch.zeros(num_tokens, device=device),
                   "var": torch.ones(num_tokens, device=device)}}


def batch_stats(x32: torch.Tensor, dims: tuple[int, ...], global_stats: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """BatchNorm's batch statistics of fp32 ``x32`` over ``dims``: (mean,
    biased variance, count), the first two kept as broadcastable dims. Two
    passes, as ``jnp.var`` computes them: the sum over the count, then the
    sum of squared deviations from that mean over the count. With
    ``global_stats`` each sum runs over every rank's rows (the gspmd
    semantics, where the JAX package's ``jnp.mean`` on a batch-sharded
    array is the global mean), its gradient summed back over the ranks."""
    count = math.prod(x32.shape[d] for d in dims)
    reduce = all_reduce_sum if global_stats else (lambda t: t)
    if global_stats:
        count *= world_size()
    mean = reduce(x32.sum(dim=dims, keepdim=True)) / count
    var = reduce(torch.square(x32 - mean).sum(dim=dims, keepdim=True)) / count
    return mean, var, count


def predictor_apply(p: Params, state: Params, x: torch.Tensor, train: bool = True,
                    momentum: float = 0.1, eps: float = 1e-5, global_stats: bool = False
                    ) -> tuple[torch.Tensor, Params]:
    """x: (N, T, D) -> ((N, T, D), new_state). BatchNorm normalizes over
    (N, hidden) per token position T (torch BatchNorm1d(T) on an (N, T, L)
    input) with fp32 statistics (:func:`batch_stats`; over every rank's
    rows with ``global_stats``) and the biased batch variance; the running
    variance is the unbiased one of the statistics' count, updated without
    grad."""
    h = linear(p["fc1"], x)
    h32 = at_least_f32(h)
    if train:
        mean, var, n = batch_stats(h32, (0, 2), global_stats)
        with torch.no_grad():
            unbiased = var.reshape(-1) * n / max(n - 1, 1)
            new_state = {"bn": {
                "mean": (1 - momentum) * state["bn"]["mean"] + momentum * mean.reshape(-1),
                "var": (1 - momentum) * state["bn"]["var"] + momentum * unbiased,
            }}
    else:
        mean = state["bn"]["mean"][None, :, None]
        var = state["bn"]["var"][None, :, None]
        new_state = state
    h32 = (h32 - mean) * torch.rsqrt(var + eps)
    h32 = h32 * p["bn"]["scale"][None, :, None] + p["bn"]["bias"][None, :, None]
    return linear(p["fc2"], torch.relu(h32).to(h.dtype)), new_state
