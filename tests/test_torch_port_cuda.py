"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU and nvcc and skips without
them: a CUDA kernel has no CPU mode. This file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: fp32 1e-5; bf16 one bf16 ulp at the output's largest magnitude,
2**-7 * max(1, max|ref|) (both sides round P, dS and the output to bf16 from
fp32 sums taken in another order).
"""

import pytest
import torch

from cross_scale_mae_torch.ops import attention as port_attn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,h,hd", [(64, 65, 12, 64), (768, 17, 12, 64),
                                      (768, 65, 16, 32), (8, 257, 12, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernel_matches_plain_version(cuda_device, n, l, h, hd, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(n, l, 3 * h * hd, device=cuda_device, generator=gen).to(dtype)
    before = port_attn.mha_v3.launches
    got = port_attn.mha_v3(qkv, h)
    torch.cuda.synchronize()
    assert port_attn.mha_v3.launches == before + 1
    ref = port_attn.mha_v3_reference(qkv, h).float()
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * max(1.0, ref.abs().max().item())
    assert (got.float() - ref).abs().max().item() <= atol


SHAPES = [(768, 17, 12, 64), (768, 65, 16, 32), (8, 257, 12, 64)]


def _tol(ref: torch.Tensor, dtype: torch.dtype) -> float:
    """fp32: 1e-5 of the largest magnitude (dK and dV sum up to 257 rows in
    another order); bf16: one bf16 ulp there."""
    scale = max(1.0, ref.abs().max().item())
    return 1e-5 * scale if dtype == torch.float32 else 2.0 ** -7 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,h,hd", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_bwd_kernel_matches_plain_version(cuda_device, n, l, h, hd, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(n, l, 3 * h * hd, device=cuda_device, generator=gen).to(dtype)
    do = torch.randn(n, l, h * hd, device=cuda_device, generator=gen).to(dtype)
    before = port_attn.mha_v3.bwd_launches
    got = port_attn._mha3_bwd_cuda(qkv, do, h)
    torch.cuda.synchronize()
    assert port_attn.mha_v3.bwd_launches == before + 1
    ref = port_attn.mha3_bwd_reference(qkv, do, h).float()
    assert (got.float() - ref).abs().max().item() <= _tol(ref, dtype)
    # No atomics: a second launch gives the same bits.
    assert torch.equal(port_attn._mha3_bwd_cuda(qkv, do, h), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_attention_trains_through_both_kernels(cuda_device, dtype):
    """One autograd step of layers.attention, 'pallas_v3' (the kernels)
    against 'xla' (the plain attention), at the decoder's shape."""
    from cross_scale_mae_torch.models import layers

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    n, l, d, h = 64, 65, 512, 16
    p = {"qkv": {"kernel": torch.randn(d, 3 * d, device=cuda_device, generator=gen) / d ** 0.5,
                 "bias": torch.zeros(3 * d, device=cuda_device)},
         "proj": {"kernel": torch.randn(d, d, device=cuda_device, generator=gen) / d ** 0.5,
                  "bias": torch.zeros(d, device=cuda_device)}}
    x = torch.randn(n, l, d, device=cuda_device, generator=gen).to(dtype)
    grads = {}
    for impl in ("xla", "pallas_v3"):
        leaf = x.clone().requires_grad_(True)
        fwd, bwd = port_attn.mha_v3.launches, port_attn.mha_v3.bwd_launches
        out = layers.attention(p, leaf, h, impl)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        launched = (port_attn.mha_v3.launches - fwd, port_attn.mha_v3.bwd_launches - bwd)
        assert launched == ((1, 1) if impl == "pallas_v3" else (0, 0))
        grads[impl] = (out.detach().float(), leaf.grad.float())
    for ref, got in zip(grads["xla"], grads["pallas_v3"]):
        # fp32: sums in another order, relative 1e-5 of the largest value.
        # bf16: the plain path's autograd also rounds dP to bf16 before the
        # softmax backward, which the kernel keeps in fp32; eight bf16 ulps
        # at the largest magnitude.
        scale = max(1.0, ref.abs().max().item())
        tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** -4 * scale
        assert (got - ref).abs().max().item() <= tol
