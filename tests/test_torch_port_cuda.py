"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU and nvcc and skips without
them: a CUDA kernel has no CPU mode. This file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: fp32 1e-5; bf16 one bf16 ulp at the output's largest magnitude,
2**-7 * max(1, max|ref|) (both sides round P and the output to bf16 from
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


@pytest.mark.cuda
def test_cuda_kernel_refuses_grad(cuda_device):
    qkv = torch.zeros(1, 4, 3 * 64, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        port_attn.mha_v3(qkv, 1)
