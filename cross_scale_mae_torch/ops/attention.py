"""Multi-head attention on the raw qkv projection layout.

Counterpart of the v3 path of ``cross_scale_mae_tpu/ops/attention.py``:
``mha_v3(qkv, num_heads)`` takes the qkv projection's own (N, L, 3D) output
and returns (N, L, D), with head h's q, k and v in the columns
[h*hd, (h+1)*hd) of each D-wide third.

* On a CUDA tensor ``mha_v3`` launches the hand-written Hopper kernel
  ``csrc/mha3_fwd.cu`` (the port of the Pallas ``_mha3_kernel``) or raises.
* On a CPU tensor it runs ``mha_v3_reference``, the plain PyTorch version
  with the kernel's op order: fp32 logits, fp32 softmax, probabilities
  rounded to the input dtype, fp32 PV sum.

The kernel is forward-only: its backward (the Pallas ``_mha3_bwd_kernel``)
is the training slice's work (``ROADMAP.md``), so ``mha_v3`` refuses a CUDA
input that requires grad rather than differentiate the plain version.
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


def _mha3_fwd_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
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
    smem = mha3_smem_bytes(l, hd, qkv.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"sequence length {l} needs {smem} bytes of shared memory per "
            f"block, above the {MAX_SMEM_BYTES} an H100 block may use")
    if n * num_heads >= 2 ** 31:
        raise ValueError(f"grid of {n * num_heads} blocks is too large")
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


def mha_v3(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(N, L, 3D) -> (N, L, D) attention on the raw qkv layout.

    A CUDA tensor goes to the Hopper kernel (``mha_v3.launches`` counts its
    launches); a CPU tensor to :func:`mha_v3_reference`."""
    if qkv.device.type == "cpu":
        return mha_v3_reference(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"mha_v3 runs on cuda or cpu tensors, got {qkv.device}")
    if qkv.requires_grad:
        raise NotImplementedError(
            "mha_v3's CUDA kernel is forward-only: its backward (the port of "
            "_mha3_bwd_kernel) is the training slice, see ROADMAP.md; run "
            "under torch.no_grad() or torch.inference_mode()")
    return _mha3_fwd_cuda(qkv, num_heads)


mha_v3.launches = 0
