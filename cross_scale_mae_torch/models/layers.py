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

Under a mesh layout (``parallel/mesh.py``) a block runs on this rank's
parts. Tensor parallelism: a block whose qkv holds H/tp heads' columns
runs them (the kernels and the variants unchanged, on its heads; Fourier
mixing on every rank's q, gathered) and its fc1 columns, with
Megatron's f before qkv and fc1 and g after proj and fc2, whose biases are
added once, after the sum; the predictor's fc1/fc2 split the same way and
its BatchNorm sums its statistics over the model group too. Sequence
parallelism (``sp``): the residual stream holds this rank's chunk of the
tokens, LayerNorm and the residual adds run on it, an all-gather comes
before qkv and fc1 and a reduce-scatter after proj and fc2; the norms'
and those biases' gradients are summed over the model group. FSDP: a
block's sharded leaves are gathered just before it runs
(``parallel/collectives.fsdp_gathered``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cross_scale_mae_torch.configs import GELU_MODES
from cross_scale_mae_torch.ops.attention import (
    fourier_mix,
    linformer_mha,
    local_mha,
    mha,
    mha_folded,
    mha_v3,
    mha_v3_reference,
    nystrom_mha,
    orthoformer_mha,
)
from cross_scale_mae_torch.ops.numerics import accum_dtype, at_least_f32
from cross_scale_mae_torch.parallel.collectives import (
    all_reduce_sum,
    copy_to_model,
    fsdp_gathered,
    gather_heads,
    gather_seq,
    gather_seq_full,
    group_rank,
    group_size,
    reduce_from_model,
    reduce_scatter_seq,
    split_seq,
)
from cross_scale_mae_torch.parallel.dist import data_group, model_group
from cross_scale_mae_torch.quant import QKEY, dequantize, is_qnode

Params = dict[str, Any]

# attention_impl values: the exact attention (the plain version, or the K1
# or K2 kernels), then the reference's variant attentions, which change the
# model (ops/attention.py; linformer adds parameters).
KERNEL_IMPLS = ("pallas_v3", "pallas", "pallas_t")
VARIANTS = ("linformer", "nystrom", "orthoformer", "local", "fourier_mix")
ATTENTION_IMPLS = ("xla", *KERNEL_IMPLS, *VARIANTS)


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


def block_init(gen: torch.Generator, dim: int, mlp_ratio: int = 4,
               attn_variant: str | None = None, seq_len: int | None = None) -> Params:
    """One pre-LN transformer block (timm Block layout, qkv fused and
    initialised as one Linear(dim, 3*dim)). ``attn_variant='linformer'``
    adds the sequence projections E and F, (seq_len, max(seq_len // 4, 1))
    xavier-uniform each, ``seq_len`` the declared num_patches + 1
    (MAE_ViT_Baseline.py:110)."""
    hidden = dim * mlp_ratio
    block = {
        "norm1": layer_norm_init(dim, gen.device),
        "attn": {"qkv": linear_init(gen, dim, 3 * dim),
                 "proj": linear_init(gen, dim, dim)},
        "norm2": layer_norm_init(dim, gen.device),
        "mlp": {"fc1": linear_init(gen, dim, hidden),
                "fc2": linear_init(gen, hidden, dim)},
    }
    if attn_variant == "linformer":
        if seq_len is None:
            raise ValueError("linformer needs seq_len at init")
        proj_k = max(seq_len // 4, 1)
        for name in ("e_proj", "f_proj"):
            block["attn"][name] = xavier_uniform(gen, (seq_len, proj_k), seq_len, proj_k)
    return block


def stacked_blocks_init(gen: torch.Generator, num_layers: int, dim: int, mlp_ratio: int = 4,
                        attn_variant: str | None = None,
                        seq_len: int | None = None) -> list[Params]:
    """``num_layers`` blocks of :func:`block_init`, drawn in order."""
    return [block_init(gen, dim, mlp_ratio, attn_variant, seq_len) for _ in range(num_layers)]


def kernel(p: Params, dtype: torch.dtype) -> torch.Tensor:
    """A linear's kernel in ``dtype``: cast, or, for an int8 node of
    ``quant.py``, dequantized here, just before its one use."""
    w = p["kernel"]
    return dequantize(w, dtype) if is_qnode(w) else w.to(dtype)


def _out_features(p: Params) -> int:
    w = p["kernel"]
    return (w[QKEY] if is_qnode(w) else w).shape[-1]


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ W(in, out) + b, weights cast to the activation dtype (int8
    weights dequantized to it). The bias is added to the rounded product, as
    in the JAX package, not fused into the product's fp32 epilogue: in bf16
    the two differ by an ulp on a quarter of the outputs."""
    return x @ kernel(p, x.dtype) + p["bias"].to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with (at least) fp32 statistics, output in x's dtype."""
    ct = accum_dtype(x.dtype)
    y = F.layer_norm(x.to(ct), (x.shape[-1],), p["scale"].to(ct),
                     p["bias"].to(ct), eps)
    return y.to(x.dtype)


def _attention_pallas_t(p: Params, x: torch.Tensor, num_heads: int, hd: int
                        ) -> torch.Tensor:
    """The K2 kernels with the head transpose in the projections
    (layers.py:115-143): the qkv einsum emits head-major (N, 3, H, L, hd)
    output, the bias added in the compute dtype, and the proj einsum
    consumes (N, H, L, hd) back; without proj's bias."""
    n, l, d = x.shape
    wq = kernel(p["qkv"], x.dtype).reshape(d, 3, num_heads, hd)
    bq = p["qkv"]["bias"].to(x.dtype).reshape(3, num_heads, hd)
    qkv = torch.einsum("nld,dshk->nshlk", x, wq) + bq[None, :, :, None, :]
    q, k, v = (qkv[:, i].reshape(n * num_heads, l, hd) for i in range(3))
    out = mha_folded(q, k, v).reshape(n, num_heads, l, hd)
    wp = kernel(p["proj"], x.dtype).reshape(num_heads, hd, -1)
    return torch.einsum("nhlk,hkd->nld", out, wp)


def _into_split(x: torch.Tensor, split: bool, sp: bool, seq_len: int) -> torch.Tensor:
    """Before a column-parallel product: SP's all-gather, or TP's f."""
    if sp:
        return gather_seq(x, seq_len)
    return copy_to_model(x) if split else x


def _fourier_mix_heads(q: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Under tensor parallelism: :func:`fourier_mix` of the whole q
    gathered from the model group, this rank's heads of the result."""
    heads = q.shape[2]
    out = fourier_mix(gather_heads(q, num_heads))
    return out.narrow(2, group_rank(model_group()) * heads, heads)


def _out_of_split(y: torch.Tensor, bias: torch.Tensor, split: bool, sp: bool) -> torch.Tensor:
    """After a row-parallel product: SP's reduce-scatter or TP's g, then
    the bias, once (under SP on this rank's tokens, its gradient summed
    over the model group)."""
    if sp:
        y, bias = reduce_scatter_seq(y), copy_to_model(bias)
    elif split:
        y = reduce_from_model(y)
    return y + bias.to(y.dtype)


def attention(p: Params, x: torch.Tensor, num_heads: int, impl: str = "xla",
              sp: bool = False, seq_len: int | None = None) -> torch.Tensor:
    """Multi-head self-attention with fused qkv (timm Attention layout).

    'pallas_v3' runs the K1 kernels on the raw qkv layout and 'pallas' and
    'pallas_t' the K2 kernels on head-folded q, k, v (``ops/attention.py``);
    on a CPU tensor each runs its kernels' plain versions. 'xla' runs the
    plain v3 version, which computes the JAX package's einsum attention in
    the same op order. The :data:`VARIANTS` run their stock PyTorch ops on
    q, k and v (linformer with the block's ``e_proj`` and ``f_proj``).

    A qkv of fewer than 3D columns holds a head group (tensor parallelism,
    ``parallel/mesh.py``): the heads it holds run, and proj's partial
    products are summed over the model group. Every impl but 'fourier_mix'
    computes each head from that head's q, k and v alone (Nystrom's
    pseudo-inverse scale and segment means and orthoformer's landmark rows
    are taken per head), so a rank's heads are its rows of the whole
    result. Fourier mixing's FFT runs over the whole h*hd feature axis: it
    takes every rank's q (:func:`gather_heads`) and keeps this rank's
    heads' columns (:func:`_fourier_mix_heads`). With ``sp``, ``x`` is this
    rank's chunk of the ``seq_len`` tokens, gathered whole (unpadded)
    before qkv: the FFT over tokens, the segments and the landmark rows see
    exactly the ``seq_len`` tokens."""
    if impl not in ATTENTION_IMPLS:
        raise NotImplementedError(
            f"attention_impl {impl!r} is unknown: this package runs {ATTENTION_IMPLS} "
            "('shunted' maps to modules missing from the reference and is not carried)")
    d = x.shape[-1]
    hd = d // num_heads
    w = kernel(p["qkv"], x.dtype)
    heads = w.shape[1] // (3 * hd)
    split = heads != num_heads
    x = _into_split(x, split, sp, seq_len)
    if impl == "pallas_t":
        y = _attention_pallas_t(p, x, heads, hd)
        return _out_of_split(y, p["proj"]["bias"], split, sp)
    qkv = x @ w + p["qkv"]["bias"].to(x.dtype)
    n, l = x.shape[:2]
    if impl in ("pallas_v3", "xla"):
        attend = mha_v3 if impl == "pallas_v3" else mha_v3_reference
        out = attend(qkv, heads)
    else:
        # JAX slices qkv[:, :, i]; unbind is the same views, and its backward
        # stacks the three gradients in one copy.
        q, k, v = qkv.reshape(n, l, 3, heads, hd).unbind(2)
        if impl == "pallas":
            out = mha(q, k, v)
        elif impl == "linformer":
            # E and F serve every head: a head group's gradient is a part of theirs.
            e, f = ((copy_to_model(p[n]) if split else p[n]) for n in ("e_proj", "f_proj"))
            out = linformer_mha(q, k, v, e, f)
        elif impl == "nystrom":
            out = nystrom_mha(q, k, v)
        elif impl == "orthoformer":
            out = orthoformer_mha(q, k, v)
        elif impl == "local":
            out = local_mha(q, k, v)
        else:
            out = _fourier_mix_heads(q, num_heads) if split else fourier_mix(q)
        out = out.reshape(n, l, heads * hd)
    y = out @ kernel(p["proj"], out.dtype)
    return _out_of_split(y, p["proj"]["bias"], split, sp)


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


def mlp(p: Params, x: torch.Tensor, gelu: str = "tanh", split: bool = False,
        sp: bool = False, seq_len: int | None = None) -> torch.Tensor:
    """fc1 -> GELU -> fc2. 'exact_tanhbwd' has the exact GELU's forward and
    the tanh GELU's derivative as its backward. ``split``: fc1 holds this
    rank's hidden columns and fc2 their rows (tensor parallelism); ``sp``:
    ``x`` is this rank's token chunk."""
    if gelu not in GELU_MODES:
        raise ValueError(f"unknown gelu flavor {gelu!r}")
    h = linear(p["fc1"], _into_split(x, split, sp, seq_len))
    if gelu == "exact_tanhbwd":
        a = gelu_exact_fastbwd(h)
    else:
        a = F.gelu(h, approximate="tanh" if gelu == "tanh" else "none")
    return _out_of_split(a @ kernel(p["fc2"], a.dtype), p["fc2"]["bias"], split, sp)


def block(p: Params, x: torch.Tensor, num_heads: int, impl: str = "xla",
          norm_style: str = "pre", gelu: str = "tanh", sp: bool = False,
          seq_len: int | None = None) -> torch.Tensor:
    """'pre' = timm Block (x + f(ln(x))); 'post' = ln(x + f(x)). With
    ``sp``, ``x`` is this rank's chunk of the ``seq_len`` tokens."""
    with fsdp_gathered(p, x.dtype) as p:
        split = _out_features(p["attn"]["qkv"]) != 3 * x.shape[-1]
        norm1, norm2 = p["norm1"], p["norm2"]
        if sp:
            # Each rank normalizes its tokens: the affine's gradient is a sum
            # over the model group.
            norm1, norm2 = ({k: copy_to_model(v) for k, v in n.items()} for n in (norm1, norm2))
        if norm_style == "pre":
            x = x + attention(p["attn"], layer_norm(norm1, x), num_heads, impl, sp, seq_len)
            return x + mlp(p["mlp"], layer_norm(norm2, x), gelu, split, sp, seq_len)
        if norm_style == "post":
            x = layer_norm(norm1, x + attention(p["attn"], x, num_heads, impl, sp, seq_len))
            return layer_norm(norm2, x + mlp(p["mlp"], x, gelu, split, sp, seq_len))
    raise ValueError(f"unknown residual_norm_style {norm_style!r}")


def run_blocks(blocks: list[Params], x: torch.Tensor, num_heads: int,
               impl: str = "xla", norm_style: str = "pre",
               gelu: str = "tanh", sp: bool = False) -> torch.Tensor:
    """Apply a stack of blocks in order. The JAX package's scan, unrolled,
    flat-carry and remat variants lay out this same loop. ``sp``: the
    stream is split into token chunks over the model group before the
    first block and gathered after the last (the JAX package's
    ``sp_constrain`` layout)."""
    seq_len = x.shape[1]
    if sp:
        x = split_seq(x)
    for p in blocks:
        x = block(p, x, num_heads, impl, norm_style, gelu, sp, seq_len)
    return gather_seq_full(x, seq_len) if sp else x


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


def batch_stats(x32: torch.Tensor, dims: tuple[int, ...], global_stats: bool = False,
                group: Any = "data") -> tuple[torch.Tensor, torch.Tensor, int]:
    """BatchNorm's batch statistics of fp32 ``x32`` over ``dims``: (mean,
    biased variance, count), the first two kept as broadcastable dims. Two
    passes, as ``jnp.var`` computes them: the sum over the count, then the
    sum of squared deviations from that mean over the count. With
    ``global_stats`` each sum runs over ``group`` (the data group: every
    rank's rows, the gspmd semantics, where the JAX package's ``jnp.mean``
    on a batch-sharded array is the global mean; the world when the
    reduced axes are split over the model group too), its gradient summed
    back over it."""
    count = math.prod(x32.shape[d] for d in dims)
    reduce = (lambda t: all_reduce_sum(t, group)) if global_stats else (lambda t: t)
    if global_stats:
        count *= group_size(data_group() if group == "data" else group)
    mean = reduce(x32.sum(dim=dims, keepdim=True)) / count
    var = reduce(torch.square(x32 - mean).sum(dim=dims, keepdim=True)) / count
    return mean, var, count


def predictor_apply(p: Params, state: Params, x: torch.Tensor, train: bool = True,
                    momentum: float = 0.1, eps: float = 1e-5, global_stats: bool = False,
                    split: bool = False) -> tuple[torch.Tensor, Params]:
    """x: (N, T, D) -> ((N, T, D), new_state). BatchNorm normalizes over
    (N, hidden) per token position T (torch BatchNorm1d(T) on an (N, T, L)
    input) with fp32 statistics (:func:`batch_stats`; over every rank's
    rows with ``global_stats``) and the biased batch variance; the running
    variance is the unbiased one of the statistics' count, updated without
    grad. ``split`` (tensor parallelism): fc1 holds this rank's hidden
    columns, so the statistics sum over the model group too."""
    bn = p["bn"]
    if split:
        x = copy_to_model(x)
        bn = {k: copy_to_model(v) for k, v in bn.items()}
    h = linear(p["fc1"], x)
    h32 = at_least_f32(h)
    if train:
        group = "data"
        if split:
            group = dist.group.WORLD if global_stats else model_group()
        elif not global_stats:
            group = None
        mean, var, n = batch_stats(h32, (0, 2), group is not None, group)
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
    h32 = h32 * bn["scale"][None, :, None] + bn["bias"][None, :, None]
    a = torch.relu(h32).to(h.dtype)
    return _out_of_split(a @ kernel(p["fc2"], a.dtype), p["fc2"]["bias"], split, False), new_state
