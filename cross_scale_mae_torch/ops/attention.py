"""Multi-head attention on the raw qkv projection layout.

Counterpart of the v3 path of ``cross_scale_mae_tpu/ops/attention.py``:
``mha_v3(qkv, num_heads)`` takes the qkv projection's own (N, L, 3D) output
and returns (N, L, D), with head h's q, k and v in the columns
[h*hd, (h+1)*hd) of each D-wide third. It is a ``torch.autograd.Function``
that saves only qkv and recomputes the probabilities in its backward, as the
JAX custom VJP ``pallas_mha_v3`` does.

* On a CUDA tensor the forward launches the hand-written Hopper kernel
  ``csrc/mha3_fwd.cu`` (the port of the Pallas ``_mha3_kernel``) and the
  backward ``csrc/mha3_bwd.cu`` (the port of ``_mha3_bwd_kernel``), or
  raise. ``mha_v3.launches`` and ``mha_v3.bwd_launches`` count the launches.
* On a CPU tensor they run the plain PyTorch versions with the kernels' op
  order: ``mha_v3_reference`` (fp32 logits, fp32 softmax, probabilities
  rounded to the input dtype, fp32 PV sum) and ``mha3_bwd_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from cross_scale_mae_torch.ops.numerics import accum_dtype

# Head widths the kernel is instantiated for (csrc/mha3_fwd.cu `dispatch`):
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
    """Dynamic shared memory of one kernel block (csrc `smem_bytes`): k_h and
    v_h in the input dtype, rows padded by 16 bytes, and one fp32 query row
    and score row per warp."""
    item = torch.empty((), dtype=dtype).element_size()
    pitch = head_dim + 16 // item
    warps = _THREADS // 32
    return 2 * seq_len * pitch * item + warps * head_dim * 4 + warps * seq_len * 4


def _check_kernel_input(qkv: torch.Tensor, num_heads: int, smem_bytes
                        ) -> tuple[int, int, int, int]:
    """Raise on what the kernels do not take; returns (N, L, D, hd)."""
    n, l, d, hd = _split_dims(qkv, num_heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"mha_v3 kernel takes bfloat16 or float32, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("mha_v3 kernel needs a contiguous qkv tensor")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"mha_v3 kernel is built for head_dim in {KERNEL_HEAD_DIMS}, got {hd}")
    if qkv.data_ptr() % 16:
        raise ValueError("mha_v3 kernel needs a 16-byte aligned qkv tensor")
    smem = smem_bytes(l, hd, qkv.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"sequence length {l} needs {smem} bytes of shared memory per "
            f"block, above the {MAX_SMEM_BYTES} an H100 block may use")
    if n * num_heads >= 2 ** 31:
        raise ValueError(f"grid of {n * num_heads} blocks is too large")
    return n, l, d, hd


def _mha3_fwd_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    n, l, d, hd = _check_kernel_input(qkv, num_heads, mha3_smem_bytes)
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
    """Dynamic shared memory of one backward block (csrc/mha3_bwd.cu
    `smem_bytes`): two (L, hd) tiles in the input dtype, rows padded by 16
    bytes; max, sum and row per query row; per warp two fp32 head rows and
    two fp32 rows of length L."""
    item = torch.empty((), dtype=dtype).element_size()
    pitch = head_dim + 16 // item
    warps = _THREADS // 32
    return (2 * seq_len * pitch * item + 3 * seq_len * 4
            + warps * (2 * head_dim + 2 * seq_len) * 4)


def _mha3_bwd_cuda(qkv: torch.Tensor, do: torch.Tensor, num_heads: int) -> torch.Tensor:
    n, l, d, hd = _check_kernel_input(qkv, num_heads, mha3_bwd_smem_bytes)
    if do.shape != (n, l, d) or do.dtype != qkv.dtype or do.device != qkv.device:
        raise ValueError(
            f"dO must be a {qkv.dtype} tensor of shape {(n, l, d)} on "
            f"{qkv.device}, got {do.dtype} {tuple(do.shape)} on {do.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("mha_v3 backward kernel needs a contiguous, 16-byte aligned dO")
    from cross_scale_mae_torch.ops.cuda_build import load_library

    fn = load_library("mha3_bwd").csmae_mha3_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(qkv)
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
        _check_kernel_input(qkv, num_heads, mha3_bwd_smem_bytes)
    return _MhaV3.apply(qkv, num_heads)


mha_v3.launches = 0
mha_v3.bwd_launches = 0
