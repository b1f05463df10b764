"""Multi-head attention kernels and their plain PyTorch versions.

Counterpart of the Pallas paths of ``cross_scale_mae_tpu/ops/attention.py``:

* v3 (K1): ``mha_v3(qkv, num_heads)`` takes the qkv projection's own
  (N, L, 3D) output and returns (N, L, D), with head h's q, k and v in the
  columns [h*hd, (h+1)*hd) of each D-wide third. A ``torch.autograd.Function``
  that saves only qkv and recomputes the probabilities in its backward, as
  the JAX custom VJP ``pallas_mha_v3`` does. On a CUDA tensor the forward
  launches ``csrc/mha3_fwd.cu`` (the port of ``_mha3_kernel``) and the
  backward ``csrc/mha3_bwd.cu`` (``_mha3_bwd_kernel``), for bf16 each on a
  tensor-core body of ``csrc/mha_tc.cuh`` with P (and dS) rounded once to
  bf16, counted by ``mha_v3.launches`` and ``mha_v3.bwd_launches``; on a
  CPU tensor the plain versions ``mha_v3_reference`` (fp32 logits and
  softmax, P rounded to the input dtype, fp32 PV sum) and
  ``mha3_bwd_reference``.
* v1 (K2): ``mha(q, k, v)`` (also ``pallas_mha``) on (N, L, H, hd) folds the
  heads into (N*H, L, hd) copies (``_fold``), runs ``_MhaFolded``, which
  saves q, k and v as ``_mha_folded_fwd`` does, and unfolds the output. On a
  CUDA tensor ``csrc/mha_fwd.cu`` (``_mha_kernel``) and ``csrc/mha_bwd.cu``
  (``_mha_bwd_kernel``), counted by ``mha.launches`` and
  ``mha.bwd_launches``: each runs its tensor-core body for bf16
  (``csrc/mha_tc.cuh``, P and dS split into bf16 terms) and the scalar
  body of ``csrc/mha_common.cuh`` for fp32; on a CPU tensor
  ``mha_folded_reference`` and ``mha_folded_bwd_reference``, with every
  operand in fp32 and nothing rounded before the output.
* v2 (K3): ``mha_qkv(qkv, num_heads)`` (also ``pallas_mha_qkv``) on the
  (N, L, 3H, hd) layout, q heads at [0, H), k at [H, 2H), v at [2H, 3H),
  returns (N, L, H, hd) with K2's numerics. ``_MhaQkv`` saves only qkv, as
  ``_mha2_cvjp_fwd`` does, and its backward returns dqkv in the qkv layout.
  On a CUDA tensor ``csrc/mha2_fwd.cu`` (``_mha2_kernel``) and
  ``csrc/mha2_bwd.cu`` (``_mha2_bwd_kernel``), for bf16 each on K2's
  tensor-core body (``csrc/mha_tc.cuh``) on K1's rows, counted by
  ``mha_qkv.launches`` and ``mha_qkv.bwd_launches``; on a CPU tensor ``mha_qkv_reference`` and
  ``mha_qkv_bwd_reference``. No path of the model dispatches it, as in the
  JAX package.
* The attention variants of the reference's ``--attn_name``
  (``linformer_mha``, ``nystrom_mha``, ``orthoformer_mha``, ``local_mha``,
  ``fourier_mix``): plain XLA in the JAX package, so stock PyTorch ops
  here (cuBLAS and cuFFT on the card), with no kernel behind them.

A CUDA tensor goes to a kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.utils.checkpoint

from cross_scale_mae_torch.ops.numerics import (
    accum_dtype,
    device_constant,
    require_ieee_fp32,
)

# Head widths the kernels are instantiated for (csrc/mha_common.cuh `dispatch`):
# those of every ViT size in configs.VIT_SIZES, encoder and decoder.
KERNEL_HEAD_DIMS = (16, 32, 64, 80)
# Dynamic shared memory one block may use on an H100 (sm_90).
MAX_SMEM_BYTES = 232_448
_THREADS = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _softmax_fp32(logits: torch.Tensor) -> torch.Tensor:
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    return p / p.sum(dim=-1, keepdim=True)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Head-major (..., L, hd) attention in the kernel's op order."""
    acc = accum_dtype(q.dtype)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    p = _softmax_fp32(logits).to(q.dtype)
    return torch.matmul(p.to(acc), v.to(acc)).to(q.dtype)


def xla_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention on (N, L, H, hd) q, k, v -> (N, L, H, hd)."""
    out = _attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)


def _split_dims(qkv: torch.Tensor, num_heads: int) -> tuple[int, int, int, int]:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (N, L, 3D), got shape {tuple(qkv.shape)}")
    n, l, three_d = qkv.shape
    if three_d % (3 * num_heads):
        raise ValueError(
            f"qkv width {three_d} is not divisible by 3 * num_heads "
            f"({3 * num_heads})")
    d = three_d // 3
    return n, l, d, d // num_heads


def mha_v3_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N, L, 3D) -> (N, L, D)."""
    n, l, d, hd = _split_dims(qkv, num_heads)
    r = qkv.reshape(n, l, 3, num_heads, hd)
    return xla_mha(r[:, :, 0], r[:, :, 1], r[:, :, 2]).reshape(n, l, d)


def mha3_smem_bytes(seq_len: int, head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one forward block of the scalar body, K1f's,
    K2f's and K3f's in fp32 (csrc/mha_common.cuh `fwd_smem_bytes`): k
    and v in the input dtype, rows padded by 16 bytes, and one fp32 query
    row and score row per warp."""
    item = torch.empty((), dtype=dtype).element_size()
    pitch = head_dim + 16 // item
    warps = _THREADS // 32
    return 2 * seq_len * pitch * item + warps * head_dim * 4 + warps * seq_len * 4


def _check_kernel_input(qkv: torch.Tensor, num_heads: int, smem_bytes,
                        name: str = "mha_v3") -> tuple[int, int, int, int]:
    """Raise on what the kernels on the (N, L, 3D) layout (K1, and K3 on its
    view) do not take; returns (N, L, D, hd)."""
    n, l, d, hd = _split_dims(qkv, num_heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes bfloat16 or float32, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous qkv tensor")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{name} kernel is built for head_dim in {KERNEL_HEAD_DIMS}, got {hd}")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs a 16-byte aligned qkv tensor")
    smem = smem_bytes(l, hd, qkv.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"sequence length {l} needs {smem} bytes of shared memory per "
            f"block, above the {MAX_SMEM_BYTES} an H100 block may use")
    if n * num_heads >= 2 ** 31:
        raise ValueError(f"grid of {n * num_heads} blocks is too large")
    return n, l, d, hd


def _mha3_fwd_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K1f: ``csrc/mha3_fwd.cu``, the tensor-core body for bf16 and the
    scalar body for fp32 (:func:`mha_smem_bytes`)."""
    n, l, d, hd = _check_kernel_input(qkv, num_heads, mha_smem_bytes)
    from cross_scale_mae_torch.ops.cuda_build import load_library

    lib = load_library("mha3_fwd")
    fn = lib.csmae_mha3_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n, l, d), dtype=qkv.dtype, device=qkv.device)
    if n == 0 or l == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), n, l, num_heads, hd,
                 _DTYPE_CODES[qkv.dtype], hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"mha3_fwd kernel launch failed: cudaError_t {err}")
    mha_v3.launches += 1
    return out


def mha3_bwd_reference(qkv: torch.Tensor, do: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: qkv (N, L, 3D) and
    dO (N, L, D) -> dqkv (N, L, 3D), in ``_mha3_bwd_kernel``'s op order.

    P is recomputed in fp32 from the input-dtype operands, scaled after the
    dot; dV = P_b^T dO with P_b = P rounded to the input dtype; dP = dO V^T
    in fp32; row = sum(dP * P) with the fp32 P; dS = P (dP - row) scale,
    rounded to the input dtype; dQ = dS K and dK = dS^T Q in fp32."""
    n, l, d, hd = _split_dims(qkv, num_heads)
    acc = accum_dtype(qkv.dtype)
    scale = hd ** -0.5
    r = qkv.reshape(n, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4).to(acc)
    q, k, v = r[0], r[1], r[2]                      # (N, H, L, hd)
    g = do.reshape(n, l, num_heads, hd).transpose(1, 2).to(acc)
    p = _softmax_fp32(torch.matmul(q, k.transpose(-1, -2)) * scale)
    dv = torch.matmul(p.to(qkv.dtype).to(acc).transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    row = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - row) * scale).to(qkv.dtype).to(acc)
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    out = torch.stack([dq, dk, dv], dim=2)         # (N, H, 3, L, hd)
    return out.permute(0, 3, 2, 1, 4).reshape(n, l, 3 * d).to(qkv.dtype)


def mha3_bwd_smem_bytes(seq_len: int, head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one backward block of the scalar body, K1b's,
    K2b's and K3b's in fp32 (csrc/mha_common.cuh `bwd_smem_bytes`): two
    (L, hd) tiles in the input dtype, rows padded by 16 bytes; max, sum and
    row per query row; per warp two fp32 head rows and two fp32 rows of
    length L."""
    item = torch.empty((), dtype=dtype).element_size()
    pitch = head_dim + 16 // item
    warps = _THREADS // 32
    return (2 * seq_len * pitch * item + 3 * seq_len * 4
            + warps * (2 * head_dim + 2 * seq_len) * 4)


def _mha3_bwd_cuda(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K1b: ``csrc/mha3_bwd.cu``, the tensor-core body for bf16 and the
    scalar body for fp32 (:func:`mha_bwd_smem_bytes`).
    ``out_dtype=torch.float32`` writes the kernel's fp32 sums before their
    rounding to the input dtype (``csmae_mha3_bwd_f32``), for accuracy
    checks."""
    n, l, d, hd = _check_kernel_input(qkv, num_heads, mha_bwd_smem_bytes)
    if do.shape != (n, l, d) or do.dtype != qkv.dtype or do.device != qkv.device:
        raise ValueError(
            f"dO must be a {qkv.dtype} tensor of shape {(n, l, d)} on "
            f"{qkv.device}, got {do.dtype} {tuple(do.shape)} on {do.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("mha_v3 backward kernel needs a contiguous, 16-byte aligned dO")
    out_dtype = out_dtype or qkv.dtype
    if out_dtype not in (qkv.dtype, torch.float32):
        raise TypeError(f"mha_v3 backward kernel writes {qkv.dtype} or float32, not {out_dtype}")
    from cross_scale_mae_torch.ops.cuda_build import load_library

    lib = load_library("mha3_bwd")
    fn = lib.csmae_mha3_bwd if out_dtype == qkv.dtype else lib.csmae_mha3_bwd_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(qkv, dtype=out_dtype)
    if n == 0 or l == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), do.data_ptr(), out.data_ptr(), n, l, num_heads, hd,
                 _DTYPE_CODES[qkv.dtype], hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"mha3_bwd kernel launch failed: cudaError_t {err}")
    mha_v3.bwd_launches += 1
    return out


def _mha3_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return mha_v3_reference(qkv, num_heads)
    return _mha3_fwd_cuda(qkv, num_heads)


class _MhaV3(torch.autograd.Function):
    """The kernels (CUDA) or their plain versions (CPU) behind one autograd
    node that saves only qkv."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return _mha3_fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        if qkv.device.type == "cpu":
            return mha3_bwd_reference(qkv, do, ctx.num_heads), None
        return _mha3_bwd_cuda(qkv, do.contiguous(), ctx.num_heads), None


def mha_v3(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(N, L, 3D) -> (N, L, D) attention on the raw qkv layout, differentiable.

    A CUDA tensor goes to the Hopper kernels (``mha_v3.launches`` and
    ``mha_v3.bwd_launches`` count their launches); a CPU tensor to
    :func:`mha_v3_reference` and :func:`mha3_bwd_reference`."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mha_v3 runs on cuda or cpu tensors, got {qkv.device}")
    if not (qkv.requires_grad and torch.is_grad_enabled()):
        return _mha3_fwd(qkv, num_heads)  # no autograd node when serving
    if qkv.device.type == "cuda":
        # Refuse before the forward what the backward kernel cannot take.
        _check_kernel_input(qkv, num_heads, mha_bwd_smem_bytes)
    return _MhaV3.apply(qkv, num_heads)


mha_v3.launches = 0
mha_v3.bwd_launches = 0


# ---------------------------------------------------------------------------
# v1 (K2): head-folded q, k, v, the layout of ``attention_impl='pallas'`` and
# ``'pallas_t'``. Every operand is read as fp32 and only the outputs are
# rounded, once, to the input dtype (attention.py:33-86).


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(N, L, H, hd) -> (N*H, L, hd), a contiguous copy."""
    n, l, h, hd = x.shape
    return x.transpose(1, 2).reshape(n * h, l, hd)


def _unfold(x: torch.Tensor, n: int, h: int) -> torch.Tensor:
    """(N*H, L, hd) -> (N, L, H, hd), a view."""
    _, l, hd = x.shape
    return x.reshape(n, h, l, hd).transpose(1, 2)


def _folded_probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 softmax of the fp32 logits, scaled after the dot."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    return _softmax_fp32(logits)


def mha_folded_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``_mha_kernel``: (BH, L, hd) q, k, v ->
    (BH, L, hd); fp32 operands, logits, softmax and PV sum, P not rounded."""
    p = _folded_probs(q.float(), k.float())
    return torch.matmul(p, v.float()).to(q.dtype)


def mha_folded_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``_mha_bwd_kernel``: q, k, v, dO (BH, L, hd)
    -> (dq, dk, dv), in its op order with every operand in fp32: P
    recomputed; dV = P^T dO; dP = dO V^T; row = sum(dP * P); dS = P (dP -
    row) scale, not rounded; dQ = dS K; dK = dS^T Q."""
    q32, k32, v32, g = q.float(), k.float(), v.float(), do.float()
    p = _folded_probs(q32, k32)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v32.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * (q.shape[-1] ** -0.5)
    dq = torch.matmul(ds, k32)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def mha_smem_bytes(seq_len: int, head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one K1f, K2f or K3f block. bf16: the
    tensor-core body (csrc/mha_tc.cuh `tc_fwd_smem_bytes`), q, k and v as
    (L padded to 16, hd + 8) bf16 tiles; fp32: the scalar body
    (:func:`mha3_smem_bytes`)."""
    if dtype != torch.bfloat16:
        return mha3_smem_bytes(seq_len, head_dim, dtype)
    rows = -(-seq_len // 16) * 16
    return 3 * rows * (head_dim + 8) * 2


def _check_folded(tensors: tuple[torch.Tensor, ...], smem_bytes) -> tuple[int, int, int]:
    """Raise on what the K2 kernels do not take; returns (BH, L, hd)."""
    first = tensors[0]
    if first.dim() != 3:
        raise ValueError(f"q, k and v must be (N*H, L, hd), got shape {tuple(first.shape)}")
    for t in tensors:
        if t.shape != first.shape or t.dtype != first.dtype or t.device != first.device:
            raise ValueError(
                f"q, k, v and dO must share shape, dtype and device, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} beside {first.dtype} "
                f"{tuple(first.shape)} on {first.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("mha kernels need contiguous, 16-byte aligned inputs")
    bh, l, hd = first.shape
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"mha kernel takes bfloat16 or float32, got {first.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"mha kernel is built for head_dim in {KERNEL_HEAD_DIMS}, got {hd}")
    smem = smem_bytes(l, hd, first.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"sequence length {l} needs {smem} bytes of shared memory per "
            f"block, above the {MAX_SMEM_BYTES} an H100 block may use")
    if bh >= 2 ** 31:
        raise ValueError(f"grid of {bh} blocks is too large")
    return bh, l, hd


def _mha_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K2f: ``csrc/mha_fwd.cu``, the tensor-core body for bf16 and the
    scalar body it shares with K1f for fp32 (:func:`mha_smem_bytes`)."""
    bh, l, hd = _check_folded((q, k, v), mha_smem_bytes)
    from cross_scale_mae_torch.ops.cuda_build import load_library

    fn = load_library("mha_fwd").csmae_mha_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    if bh == 0 or l == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, l, hd,
                 _DTYPE_CODES[q.dtype], hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"mha_fwd kernel launch failed: cudaError_t {err}")
    mha.launches += 1
    return out


def mha_bwd_smem_bytes(seq_len: int, head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one K1b, K2b or K3b block. bf16: the tensor-core body
    (csrc/mha_tc.cuh `tc_bwd_smem_bytes`), q, k, v and dO as (L padded to
    16, hd + 8) bf16 tiles and three fp32 rows of the padded length; fp32:
    the scalar body (:func:`mha3_bwd_smem_bytes`)."""
    if dtype != torch.bfloat16:
        return mha3_bwd_smem_bytes(seq_len, head_dim, dtype)
    rows = -(-seq_len // 16) * 16
    return 4 * rows * (head_dim + 8) * 2 + 3 * rows * 4


def _mha_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                  out_dtype: torch.dtype | None = None) -> tuple[torch.Tensor, ...]:
    """K2b: ``csrc/mha_bwd.cu``, the tensor-core body it shares with K1b
    for bf16 and the scalar body for fp32 (:func:`mha_bwd_smem_bytes`).
    ``out_dtype=torch.float32`` writes the kernel's fp32 sums before their
    rounding to the input dtype (``csmae_mha_bwd_f32``), for accuracy
    checks."""
    bh, l, hd = _check_folded((q, k, v, do), mha_bwd_smem_bytes)
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"mha backward kernel writes {q.dtype} or float32, not {out_dtype}")
    from cross_scale_mae_torch.ops.cuda_build import load_library

    lib = load_library("mha_bwd")
    fn = lib.csmae_mha_bwd if out_dtype == q.dtype else lib.csmae_mha_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq, dk, dv = (torch.empty_like(q, dtype=out_dtype) for _ in range(3))
    if bh == 0 or l == 0:
        return dq, dk, dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), bh, l, hd, _DTYPE_CODES[q.dtype],
                 hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"mha_bwd kernel launch failed: cudaError_t {err}")
    mha.bwd_launches += 1
    return dq, dk, dv


def _mha_folded_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return mha_folded_reference(q, k, v)
    return _mha_fwd_cuda(q, k, v)


class _MhaFolded(torch.autograd.Function):
    """K2f and K2b (CUDA) or their plain versions (CPU) behind one autograd
    node that saves q, k and v (``_mha_folded_fwd``'s residuals)."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        return _mha_folded_fwd(q, k, v)

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v = ctx.saved_tensors
        if q.device.type == "cpu":
            return mha_folded_bwd_reference(q, k, v, do)
        return _mha_bwd_cuda(q, k, v, do.contiguous())


def mha_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(BH, L, hd) q, k, v -> (BH, L, hd), differentiable: the JAX package's
    ``_mha_folded``. No autograd node when no gradient is needed."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mha runs on cuda or cpu tensors, got {q.device}")
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return _mha_folded_fwd(q, k, v)
    if q.device.type == "cuda":
        # Refuse before the forward what the backward kernel cannot take.
        _check_folded((q, k, v), mha_bwd_smem_bytes)
    return _MhaFolded.apply(q, k, v)


def pallas_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v (N, L, H, hd) -> (N, L, H, hd): softmax(QK^T/sqrt(hd))V per
    head through the folded layout, differentiable. A CUDA tensor goes to
    the Hopper kernels (``mha.launches`` and ``mha.bwd_launches`` count
    their launches); a CPU tensor to the plain versions."""
    n, _, h, _ = q.shape
    return _unfold(mha_folded(_fold(q), _fold(k), _fold(v)), n, h)


# The JAX package's ``mha`` picks interpret mode off the TPU; here the tensor's
# device picks the kernel or the plain version, so the two names are one.
mha = pallas_mha
mha.launches = 0
mha.bwd_launches = 0


# ---------------------------------------------------------------------------
# v2 (K3): the (N, L, 3H, hd) layout of ``pallas_mha_qkv``. Its bytes are
# K1's (N, L, 3D): q head g starts at column g*hd of a row 3D long, k head g
# at D + g*hd. Its numerics are K2's: fp32 operands, P and dS never rounded,
# each output rounded once (attention.py:192-238).

# K3f runs K1f's and K2f's forward bodies, K3b K1b's and K2b's backward
# bodies: the tensor-core ones for bf16, the scalar ones for fp32.
mha2_smem_bytes = mha_smem_bytes
mha2_bwd_smem_bytes = mha_bwd_smem_bytes


def _qkv_heads(qkv: torch.Tensor, num_heads: int) -> tuple[torch.Tensor, ...]:
    """(N, L, 3H, hd) -> q, k, v as (N, H, L, hd) views."""
    if qkv.dim() != 4 or qkv.shape[2] != 3 * num_heads:
        raise ValueError(
            f"qkv must be (N, L, 3H, hd) with 3H = {3 * num_heads}, got shape "
            f"{tuple(qkv.shape)}")
    return tuple(t.transpose(1, 2) for t in qkv.split(num_heads, dim=2))


def mha_qkv_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of ``_mha2_kernel``: (N, L, 3H, hd) ->
    (N, L, H, hd), every operand in fp32, P not rounded."""
    return mha_folded_reference(*_qkv_heads(qkv, num_heads)).transpose(1, 2)


def mha_qkv_bwd_reference(qkv: torch.Tensor, do: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of ``_mha2_bwd_kernel``: qkv (N, L, 3H, hd) and
    dO (N, L, H, hd) -> dqkv (N, L, 3H, hd), K2's op order per head
    (:func:`mha_folded_bwd_reference`)."""
    grads = mha_folded_bwd_reference(*_qkv_heads(qkv, num_heads), do.transpose(1, 2))
    return torch.cat([g.transpose(1, 2) for g in grads], dim=2)


def _check_qkv4(qkv: torch.Tensor, num_heads: int, smem_bytes) -> tuple[int, int, int, int]:
    """Raise on what the K3 kernels do not take; returns (N, L, D, hd)."""
    _qkv_heads(qkv, num_heads)
    if not qkv.is_contiguous():
        raise ValueError("mha_qkv kernel needs a contiguous qkv tensor")
    n, l, three_h, hd = qkv.shape
    return _check_kernel_input(qkv.view(n, l, three_h * hd), num_heads, smem_bytes,
                               name="mha_qkv")


def _mha2_fwd_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K3f: ``csrc/mha2_fwd.cu``, K2f's tensor-core body for bf16 and the
    scalar forward body for fp32, without K1's rounding of P."""
    n, l, d, hd = _check_qkv4(qkv, num_heads, mha2_smem_bytes)
    from cross_scale_mae_torch.ops.cuda_build import load_library

    fn = load_library("mha2_fwd").csmae_mha2_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n, l, num_heads, hd), dtype=qkv.dtype, device=qkv.device)
    if n == 0 or l == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), n, l, num_heads, hd,
                 _DTYPE_CODES[qkv.dtype], hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"mha2_fwd kernel launch failed: cudaError_t {err}")
    mha_qkv.launches += 1
    return out


def _mha2_bwd_cuda(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K3b: ``csrc/mha2_bwd.cu``, K2b's tensor-core body on K1's rows for
    bf16 and the scalar body without K1's rounding for fp32
    (:func:`mha_bwd_smem_bytes`), dqkv written in the qkv layout.
    ``out_dtype=torch.float32`` writes the kernel's fp32 sums before their
    rounding to the input dtype (``csmae_mha2_bwd_f32``), for accuracy
    checks."""
    n, l, d, hd = _check_qkv4(qkv, num_heads, mha2_bwd_smem_bytes)
    if do.shape != (n, l, num_heads, hd) or do.dtype != qkv.dtype or do.device != qkv.device:
        raise ValueError(
            f"dO must be a {qkv.dtype} tensor of shape {(n, l, num_heads, hd)} on "
            f"{qkv.device}, got {do.dtype} {tuple(do.shape)} on {do.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("mha_qkv backward kernel needs a contiguous, 16-byte aligned dO")
    out_dtype = out_dtype or qkv.dtype
    if out_dtype not in (qkv.dtype, torch.float32):
        raise TypeError(f"mha_qkv backward kernel writes {qkv.dtype} or float32, not {out_dtype}")
    from cross_scale_mae_torch.ops.cuda_build import load_library

    lib = load_library("mha2_bwd")
    fn = lib.csmae_mha2_bwd if out_dtype == qkv.dtype else lib.csmae_mha2_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(qkv, dtype=out_dtype)
    if n == 0 or l == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), do.data_ptr(), out.data_ptr(), n, l, num_heads, hd,
                 _DTYPE_CODES[qkv.dtype], hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"mha2_bwd kernel launch failed: cudaError_t {err}")
    mha_qkv.bwd_launches += 1
    return out


def _mha2_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return mha_qkv_reference(qkv, num_heads)
    return _mha2_fwd_cuda(qkv, num_heads)


class _MhaQkv(torch.autograd.Function):
    """K3f and K3b (CUDA) or their plain versions (CPU) behind one autograd
    node that saves only qkv (``_mha2_cvjp_fwd``'s residuals)."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return _mha2_fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        if qkv.device.type == "cpu":
            return mha_qkv_bwd_reference(qkv, do, ctx.num_heads), None
        return _mha2_bwd_cuda(qkv, do.contiguous(), ctx.num_heads), None


def pallas_mha_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(N, L, 3H, hd) -> (N, L, H, hd) attention with no layout change,
    differentiable. A CUDA tensor goes to the Hopper kernels
    (``mha_qkv.launches`` and ``mha_qkv.bwd_launches`` count their
    launches); a CPU tensor to :func:`mha_qkv_reference` and
    :func:`mha_qkv_bwd_reference`."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mha_qkv runs on cuda or cpu tensors, got {qkv.device}")
    if not (qkv.requires_grad and torch.is_grad_enabled()):
        return _mha2_fwd(qkv, num_heads)
    if qkv.device.type == "cuda":
        # Refuse before the forward what the backward kernel cannot take.
        _check_qkv4(qkv, num_heads, mha2_bwd_smem_bytes)
    return _MhaQkv.apply(qkv, num_heads)


# As with ``mha``: the tensor's device picks the kernel or the plain version.
mha_qkv = pallas_mha_qkv
mha_qkv.launches = 0
mha_qkv.bwd_launches = 0


# --------------------------------------------------------------------------
# The attention variants behind the reference's --attn_name
# (main_pretrain.py:101-119): linformer, nystrom, orthoformer, local and
# fourier_mix. The JAX package computes them in plain XLA, outside any
# Pallas kernel (ops/attention.py:587-728 there), so here they are stock
# PyTorch ops with the JAX op order and dtypes. Each takes (N, L, H, hd)
# q, k, v and returns (N, L, H, hd) in q's dtype; what JAX computes in fp32
# runs in ``accum_dtype`` (fp32, or fp64 for a float64 input).
# --------------------------------------------------------------------------

NYSTROM_LANDMARKS = 64
ORTHOFORMER_LANDMARKS = 32
LOCAL_WINDOW = 5


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)   # (N, L, H, hd) -> (N, H, L, hd)


def _softmax_logits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """softmax(a bᵀ / √hd) over the last axis for head-major (N, H, ., hd)
    operands: logits and softmax in ``accum_dtype``."""
    acc = accum_dtype(a.dtype)
    logits = torch.matmul(a.to(acc), b.to(acc).transpose(-1, -2)) * (a.shape[-1] ** -0.5)
    return torch.softmax(logits, dim=-1)


def linformer_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  e_proj: torch.Tensor, f_proj: torch.Tensor) -> torch.Tensor:
    """Linformer (xFormers 'linformer'): K and V projected along the
    sequence by the learned (seq_len, m) E and F, their first L rows (the
    masked encoder is shorter than the declared seq_len), cast to q's dtype;
    the projections in that dtype, the logits and softmax in fp32, P cast
    to q's dtype before P V."""
    l = q.shape[1]
    e, f = e_proj[:l].to(q.dtype), f_proj[:l].to(q.dtype)
    k_p = torch.einsum("nlhd,lm->nhmd", k, e)
    v_p = torch.einsum("nlhd,lm->nhmd", v, f)
    probs = _softmax_logits(_heads_first(q), k_p).to(q.dtype)
    return torch.matmul(probs, v_p).transpose(1, 2)


def iterative_pinv(s: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Newton-Schulz Moore-Penrose pseudo-inverse of a row-stochastic
    (..., m, m) matrix (the Nystromformer recipe), in ``s``'s dtype:
    z0 = sᵀ / (max row sum * max column sum), then
    z <- 0.25 z (13 I - s z (15 I - s z (7 I - s z))). Under autograd the
    backward recomputes the iterations from ``s`` (``torch.utils.checkpoint``)
    instead of keeping them: saved, their some 40 (m, m) products a head take
    8 GB a decoder layer at the flagship's batch of 384."""
    if torch.is_grad_enabled() and s.requires_grad:
        return torch.utils.checkpoint.checkpoint(_newton_schulz, s, iters,
                                                 use_reentrant=False)
    return _newton_schulz(s, iters)


def _newton_schulz(s: torch.Tensor, iters: int) -> torch.Tensor:
    eye = torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)
    a = s.abs()
    denom = (a.sum(dim=-1).amax(dim=-1, keepdim=True)
             * a.sum(dim=-2).amax(dim=-1, keepdim=True))[..., None]
    z = s.transpose(-1, -2) / denom
    for _ in range(iters):
        sz = s @ z
        z = (0.25 * z) @ (13 * eye - sz @ (15 * eye - sz @ (7 * eye - sz)))
    return z


def segment_ids(l: int, m: int, device: torch.device) -> torch.Tensor:
    """The landmark segment of each of ``l`` rows: ``m`` contiguous
    segments, the first ``l % m`` of them one row longer."""
    base, rem = divmod(l, m)
    row = torch.arange(l, device=device)
    cut = rem * (base + 1)
    rest = rem + (row - cut) // max(base, 1) if base > 0 else torch.zeros_like(row)
    return torch.where(row < cut, row // (base + 1), rest)


def segment_means(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, L, H, hd) -> (N, m, H, hd) means of the :func:`segment_ids`
    segments. The counts and sums are scatter-adds (``index_add_``) in x's
    dtype, as JAX's ``.at[].add`` sums; an empty segment divides by 1."""
    n, l, h, hd = x.shape
    seg = segment_ids(l, m, x.device)
    counts = x.new_zeros(m).index_add_(0, seg, x.new_ones(l))
    sums = x.new_zeros((n, m, h, hd)).index_add_(1, seg, x)
    return sums / counts.clamp(min=1.0)[None, :, None, None]


def nystrom_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                num_landmarks: int = NYSTROM_LANDMARKS) -> torch.Tensor:
    """Nystromformer (xFormers 'nystrom'):
    softmax(Q K̃ᵀ) pinv(softmax(Q̃ K̃ᵀ)) softmax(Q̃ Kᵀ) V, the landmarks Q̃, K̃
    the segment means, the pseudo-inverse iterative; the three products
    after the softmaxes in fp32, which on the card must be IEEE fp32
    (:func:`require_ieee_fp32`). Exact attention when L <= the landmarks."""
    if q.shape[1] <= num_landmarks:
        return xla_mha(q, k, v)
    require_ieee_fp32(q.device, "nystrom attention")
    return nystrom_products(q, k, v, num_landmarks)


def nystrom_products(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_landmarks: int) -> torch.Tensor:
    """:func:`nystrom_mha` for L > the landmarks, in whatever matmul
    precision the process sets."""
    q_l, k_l = segment_means(q, num_landmarks), segment_means(k, num_landmarks)
    qh, kh, ql, kl = (_heads_first(t) for t in (q, k, q_l, k_l))
    f1, f2, f3 = _softmax_logits(qh, kl), _softmax_logits(ql, kl), _softmax_logits(ql, kh)
    out = f1 @ iterative_pinv(f2) @ (f3 @ _heads_first(v).to(f3.dtype))
    return out.transpose(1, 2).to(q.dtype)


def landmark_rows(l: int, m: int) -> list[int]:
    """Orthoformer's m strided landmark rows of 0..l-1: floor(i (l-1) /
    (m-1)), the JAX package's ``linspace(0, l-1, m).astype(int32)``."""
    return [i * (l - 1) // (m - 1) for i in range(m)]


def orthoformer_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_landmarks: int = ORTHOFORMER_LANDMARKS) -> torch.Tensor:
    """Orthoformer-style landmark attention (xFormers 'orthoformer', its
    OMP selection replaced by strided query rows, as the JAX package does):
    queries attend to the landmarks, the landmarks to all of K and V; both
    products in fp32 (IEEE on the card). Exact attention when L <= the
    landmarks."""
    if q.shape[1] <= num_landmarks:
        return xla_mha(q, k, v)
    require_ieee_fp32(q.device, "orthoformer attention")
    return orthoformer_products(q, k, v, num_landmarks)


def orthoformer_products(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_landmarks: int) -> torch.Tensor:
    """:func:`orthoformer_mha` for L > the landmarks, in whatever matmul
    precision the process sets."""
    idx = device_constant(landmark_rows(q.shape[1], num_landmarks), q.device, torch.long)
    qh = _heads_first(q)
    q_l = qh.index_select(2, idx)
    attn1, attn2 = _softmax_logits(qh, q_l), _softmax_logits(q_l, _heads_first(k))
    out = attn1 @ (attn2 @ _heads_first(v).to(attn2.dtype))
    return out.transpose(1, 2).to(q.dtype)


def local_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int = LOCAL_WINDOW) -> torch.Tensor:
    """Sliding-window attention: token i attends to the tokens j with
    |i - j| <= window // 2; the logits outside the band are -1e30, the
    softmax in fp32, P cast to q's dtype before P V."""
    l = q.shape[1]
    acc = accum_dtype(q.dtype)
    qh, kh = _heads_first(q).to(acc), _heads_first(k).to(acc)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    pos = torch.arange(l, device=q.device)
    band = (pos[:, None] - pos[None, :]).abs() <= window // 2
    probs = torch.softmax(logits.masked_fill(~band, -1e30), dim=-1).to(q.dtype)
    return torch.matmul(probs, _heads_first(v)).transpose(1, 2)


def fourier_mix(q: torch.Tensor) -> torch.Tensor:
    """FNet-style token mixing (xFormers FourierMix): the real part of an
    FFT over the features, then over the sequence, in fp32; k and v are
    unused, as in the xFormers block."""
    n, l, h, hd = q.shape
    x = q.reshape(n, l, h * hd).to(accum_dtype(q.dtype))
    out = torch.fft.fft(torch.fft.fft(x, dim=-1), dim=-2).real
    return out.reshape(n, l, h, hd).to(q.dtype)
