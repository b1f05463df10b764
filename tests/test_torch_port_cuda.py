"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU and nvcc and skips without
them: a CUDA kernel has no CPU mode. This file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: fp32 1e-5; bf16 one bf16 ulp at the output's largest magnitude,
2**-7 * max(1, max|ref|) (both sides round the output to bf16 from fp32 sums
taken in another order), and for K2 each output's mean error as well.
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


# K2 (the v1 head-folded kernels): the ViT-L finetune shape, the ViT-B shape
# and the longest sequence, as (N, L, H, hd), folded to (N*H, L, hd).
K2_SHAPES = [(512, 65, 16, 64), (64, 65, 12, 64), (8, 257, 16, 80)]


# bf16 only: mean |kernel - plain| / mean |plain| of each K2 output, set
# between the kernels' reading and that of K1's order on the same inputs
# (P rounded before PV and dV, dS before dQ and dK), which flips the bf16
# rounding of a large share of the outputs (chip_smoke.py K2_MEAN_TOL).
K2_MEAN_TOL = 2.0 ** -15


def _k1_order(q, k, v, do, h):
    """K1's plain versions on the same folded inputs: out and (dq, dk, dv)."""
    bh, l, hd = q.shape
    n = bh // h
    qkv = torch.stack([port_attn._unfold(t, n, h) for t in (q, k, v)], dim=2)
    qkv = qkv.reshape(n, l, 3 * h * hd)
    out = port_attn._fold(port_attn.mha_v3_reference(qkv, h).view(n, l, h, hd))
    do_v3 = port_attn._unfold(do, n, h).reshape(n, l, h * hd)
    dqkv = port_attn.mha3_bwd_reference(qkv, do_v3, h).view(n, l, 3, h, hd)
    return (out, *(port_attn._fold(t) for t in dqkv.unbind(2)))


def _rel_mean(a: torch.Tensor, ref: torch.Tensor) -> float:
    return (a.float() - ref).abs().mean().item() / ref.abs().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,h,hd", K2_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_mha_kernels_match_plain_versions(cuda_device, n, l, h, hd, dtype):
    """K2f and K2b against mha_folded_reference and mha_folded_bwd_reference:
    both compute in fp32 and round each output once, so they differ by the
    order of fp32 sums (fp32: 1e-5 of the largest magnitude; bf16: one bf16
    ulp there, and each output's mean error within K2_MEAN_TOL, which K1's
    rounding order exceeds)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, do = (torch.randn(n * h, l, hd, device=cuda_device, generator=gen).to(dtype)
                   for _ in range(4))
    fwd, bwd = port_attn.mha.launches, port_attn.mha.bwd_launches
    got = port_attn._mha_fwd_cuda(q, k, v)
    grads = port_attn._mha_bwd_cuda(q, k, v, do)
    torch.cuda.synchronize()
    assert (port_attn.mha.launches, port_attn.mha.bwd_launches) == (fwd + 1, bwd + 1)
    refs = [port_attn.mha_folded_reference(q, k, v).float()]
    refs += [r.float() for r in port_attn.mha_folded_bwd_reference(q, k, v, do)]
    controls = _k1_order(q, k, v, do, h)
    for name, a, r, c in zip(("out", "dq", "dk", "dv"), (got, *grads), refs, controls):
        assert (a.float() - r).abs().max().item() <= _tol(r, dtype), name
        if dtype == torch.bfloat16:
            assert _rel_mean(a, r) <= K2_MEAN_TOL < _rel_mean(c, r), name
    # No atomics: a second launch gives the same bits.
    assert all(torch.equal(a, b) for a, b in zip(port_attn._mha_bwd_cuda(q, k, v, do), grads))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "pallas_t"])
def test_cuda_k2_attention_trains_through_both_kernels(cuda_device, impl):
    """One autograd step of layers.attention through K2f and K2b against
    'xla' (the plain attention) at ViT-L's width, fp32: sums in another
    order, 1e-5 of the largest value."""
    from cross_scale_mae_torch.models import layers

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    n, l, d, h = 16, 65, 1024, 16
    p = {"qkv": {"kernel": torch.randn(d, 3 * d, device=cuda_device, generator=gen) / d ** 0.5,
                 "bias": torch.zeros(3 * d, device=cuda_device)},
         "proj": {"kernel": torch.randn(d, d, device=cuda_device, generator=gen) / d ** 0.5,
                  "bias": torch.zeros(d, device=cuda_device)}}
    x = torch.randn(n, l, d, device=cuda_device, generator=gen)
    grads = {}
    for name in ("xla", impl):
        leaf = x.clone().requires_grad_(True)
        fwd, bwd = port_attn.mha.launches, port_attn.mha.bwd_launches
        out = layers.attention(p, leaf, h, name)
        out.square().sum().backward()
        torch.cuda.synchronize()
        launched = (port_attn.mha.launches - fwd, port_attn.mha.bwd_launches - bwd)
        assert launched == ((1, 1) if name == impl else (0, 0))
        grads[name] = (out.detach(), leaf.grad)
    for ref, got in zip(grads["xla"], grads[impl]):
        assert (got - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


# K3 (the v2 (N, L, 3H, hd) kernels): ViT-B, the decoder and the longest
# sequence, chip_smoke.py's [kernel] shapes.
K3_SHAPES = [(64, 65, 12, 64), (768, 65, 16, 32), (8, 257, 16, 80)]


def _k1_order_qkv(qkv, do, h):
    """K1's plain versions on the same bytes, seen as (N, L, 3D): out and
    (dq, dk, dv) in the (N, L, H, hd) layout."""
    n, l, _, hd = qkv.shape
    out = port_attn.mha_v3_reference(qkv.view(n, l, 3 * h * hd), h).view(n, l, h, hd)
    dqkv = port_attn.mha3_bwd_reference(qkv.view(n, l, 3 * h * hd), do.reshape(n, l, h * hd), h)
    return (out, *dqkv.view(n, l, 3 * h, hd).split(h, dim=2))


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,h,hd", K3_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_mha_qkv_kernels_match_plain_versions(cuda_device, n, l, h, hd, dtype):
    """K3f and K3b against mha_qkv_reference and mha_qkv_bwd_reference: K2's
    numerics on K1's bytes, so K2's tolerances (fp32: 1e-5 of the largest
    magnitude; bf16: one bf16 ulp there, and each output's mean error
    within K2_MEAN_TOL, which K1's rounding order exceeds)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn(n, l, 3 * h, hd, device=cuda_device, generator=gen).to(dtype)
    do = torch.randn(n, l, h, hd, device=cuda_device, generator=gen).to(dtype)
    fwd, bwd = port_attn.mha_qkv.launches, port_attn.mha_qkv.bwd_launches
    got = port_attn._mha2_fwd_cuda(qkv, h)
    dqkv = port_attn._mha2_bwd_cuda(qkv, do, h)
    torch.cuda.synchronize()
    assert (port_attn.mha_qkv.launches, port_attn.mha_qkv.bwd_launches) == (fwd + 1, bwd + 1)
    assert got.shape == (n, l, h, hd) and dqkv.shape == qkv.shape
    refs = [port_attn.mha_qkv_reference(qkv, h).float()]
    refs += [r.float() for r in port_attn.mha_qkv_bwd_reference(qkv, do, h).split(h, dim=2)]
    controls = _k1_order_qkv(qkv, do, h)
    for name, a, r, c in zip(("out", "dq", "dk", "dv"), (got, *dqkv.split(h, dim=2)),
                             refs, controls):
        assert (a.float() - r).abs().max().item() <= _tol(r, dtype), name
        if dtype == torch.bfloat16:
            assert _rel_mean(a, r) <= K2_MEAN_TOL < _rel_mean(c, r), name
    # No atomics: a second launch gives the same bits.
    assert torch.equal(port_attn._mha2_bwd_cuda(qkv, do, h), dqkv)


@pytest.mark.cuda
def test_cuda_mha_qkv_trains_through_both_kernels(cuda_device):
    """One autograd step of mha_qkv through K3f and K3b against autograd of
    the plain version, fp32 at the decoder's shape: 1e-5 of the largest
    value."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(64, 65, 3 * 16, 32, device=cuda_device, generator=gen)
    grads = {}
    for name, fn in (("plain", port_attn.mha_qkv_reference), ("kernel", port_attn.mha_qkv)):
        leaf = x.clone().requires_grad_(True)
        fwd, bwd = port_attn.mha_qkv.launches, port_attn.mha_qkv.bwd_launches
        out = fn(leaf, 16)
        out.square().sum().backward()
        torch.cuda.synchronize()
        launched = (port_attn.mha_qkv.launches - fwd, port_attn.mha_qkv.bwd_launches - bwd)
        assert launched == ((1, 1) if name == "kernel" else (0, 0))
        grads[name] = (out.detach(), leaf.grad)
    for ref, got in zip(grads["plain"], grads["kernel"]):
        assert (got - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
def test_cuda_device_prefetch_delivers_the_host_bytes(cuda_device):
    """Batches through pinned memory and the side stream arrive unchanged,
    each checked on the device after later batches were already in flight."""
    import numpy as np

    from cross_scale_mae_torch.data.loader import device_prefetch

    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 256, (64, 146, 146, 3), np.uint8),
             rng.integers(0, 10, 64).astype(np.int32)) for _ in range(6)]
    seen = []
    for imgs, labels in device_prefetch(iter(host), cuda_device):
        imgs.add_(0)  # work on the consumer's stream
        seen.append((imgs, labels))
    for (imgs, labels), (h_imgs, h_labels) in zip(seen, host, strict=True):
        assert torch.equal(imgs, torch.from_numpy(h_imgs).to(cuda_device))
        assert torch.equal(labels, torch.from_numpy(h_labels).to(cuda_device))
