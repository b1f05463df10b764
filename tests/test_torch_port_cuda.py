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


# Where the tensor-core bodies' 16-row tiles and 80-key sweep are ragged:
# the encoder's 17 tokens, ViT-B's 65, exactly one sweep (80), one past it
# (81), and the longest sequence (257); every head width the kernels take.
RAGGED_L = [17, 65, 80, 81, 257]
HEAD_DIMS = [16, 32, 64, 80]


@pytest.mark.cuda
@pytest.mark.parametrize("l", RAGGED_L)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_k1f_tc_kernel_at_ragged_edges(cuda_device, l, hd):
    """The bf16 K1f (csrc/mha_tc.cuh, P rounded once to bf16) on the qkv
    layout with an odd head count, against mha_v3_reference: one bf16 ulp
    at the largest output, and a second launch gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    qkv = torch.randn(5, l, 3 * 3 * hd, device=cuda_device, generator=gen).bfloat16()
    got = port_attn._mha3_fwd_cuda(qkv, 3)
    torch.cuda.synchronize()
    ref = port_attn.mha_v3_reference(qkv, 3).float()
    assert (got.float() - ref).abs().max().item() <= _tol(ref, torch.bfloat16)
    assert torch.equal(port_attn._mha3_fwd_cuda(qkv, 3), got)


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
@pytest.mark.parametrize("l", [1, 16, 33, 65, 257])
@pytest.mark.parametrize("hd", [16, 32, 64, 80])
def test_cuda_mha_bf16_kernels_at_ragged_edges(cuda_device, l, hd):
    """The bf16 tensor-core K2 bodies where their 16-row tiles are ragged:
    L from one token to one past a tile (33, 65, 257) and exactly a tile
    (16), every head width, an odd head count (37). Each output within one
    bf16 ulp of its plain version and its mean error within K2_MEAN_TOL of
    mean |plain| (at L = 1, dq and dk are exactly 0)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, do = (torch.randn(37, l, hd, device=cuda_device, generator=gen).bfloat16()
                   for _ in range(4))
    got = port_attn._mha_fwd_cuda(q, k, v)
    grads = port_attn._mha_bwd_cuda(q, k, v, do)
    torch.cuda.synchronize()
    refs = [port_attn.mha_folded_reference(q, k, v).float()]
    refs += [r.float() for r in port_attn.mha_folded_bwd_reference(q, k, v, do)]
    for name, a, r in zip(("out", "dq", "dk", "dv"), (got, *grads), refs):
        err = (a.float() - r).abs()
        assert err.max().item() <= _tol(r, torch.bfloat16), name
        assert err.mean().item() <= K2_MEAN_TOL * r.abs().mean().item(), name
    assert all(torch.equal(a, b) for a, b in zip(port_attn._mha_bwd_cuda(q, k, v, do), grads))


# The [finetune_grads_fp64] limit (chip_smoke.py FP64_LEAF_TOL), here on
# each fp32 output of K2b: relative L2 gap to the same arithmetic in
# float64.
FP64_TOL = 2.0 ** -17


def _bwd64(q, k, v, do):
    """mha_folded_bwd_reference's arithmetic in float64, unrounded."""
    q, k, v, g = (t.double() for t in (q, k, v, do))
    p = port_attn._folded_probs(q, k)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * (q.shape[-1] ** -0.5)
    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), torch.matmul(
        p.transpose(-1, -2), g)


@pytest.mark.cuda
@pytest.mark.parametrize("l", RAGGED_L)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_k2b_bf16_kernel_at_ragged_edges(cuda_device, l, hd):
    """The bf16 K2b against mha_folded_bwd_reference at ragged L and every
    head width (37 heads): one bf16 ulp and K2_MEAN_TOL per output, with
    K1's order above K2_MEAN_TOL; its fp32 outputs within FP64_TOL of
    float64; its bf16 outputs those fp32 outputs rounded, bit for bit; and
    a second launch gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, do = (torch.randn(37, l, hd, device=cuda_device, generator=gen).bfloat16()
                   for _ in range(4))
    grads = port_attn._mha_bwd_cuda(q, k, v, do)
    f32 = port_attn._mha_bwd_cuda(q, k, v, do, out_dtype=torch.float32)
    torch.cuda.synchronize()
    refs = [r.float() for r in port_attn.mha_folded_bwd_reference(q, k, v, do)]
    controls = _k1_order(q, k, v, do, 37)[1:]
    for name, a, r, c, f, e in zip(("dq", "dk", "dv"), grads, refs, controls, f32,
                                   _bwd64(q, k, v, do)):
        assert (a.float() - r).abs().max().item() <= _tol(r, torch.bfloat16), name
        assert _rel_mean(a, r) <= K2_MEAN_TOL < _rel_mean(c, r), name
        assert f.dtype == torch.float32 and torch.equal(a, f.bfloat16()), name
        gap = (torch.linalg.vector_norm(f.double() - e) / torch.linalg.vector_norm(e)).item()
        assert gap <= FP64_TOL, (name, gap)
    assert all(torch.equal(a, b) for a, b in zip(port_attn._mha_bwd_cuda(q, k, v, do), grads))
    assert all(torch.equal(a, b) for a, b in zip(
        port_attn._mha_bwd_cuda(q, k, v, do, out_dtype=torch.float32), f32))


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


def _k2_order_k1_bytes(qkv, do, h):
    """K2's order (P and dS left in fp32) on K1's (N, L, 3D) bytes: K3's
    plain backward, dqkv (N, L, 3D)."""
    n, l, three_d = qkv.shape
    hd = three_d // (3 * h)
    return port_attn.mha_qkv_bwd_reference(
        qkv.view(n, l, 3 * h, hd), do.view(n, l, h, hd), h).reshape(n, l, three_d)


@pytest.mark.cuda
@pytest.mark.parametrize("l", RAGGED_L)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_k1b_bf16_kernel_at_ragged_edges(cuda_device, l, hd):
    """The bf16 K1b (csrc/mha_tc.cuh attend_bwd_tc with K1's roundings) on
    the qkv layout, 5 samples of 7 heads, against mha3_bwd_reference: each
    of dq, dk and dv within one bf16 ulp and within K2_MEAN_TOL in mean,
    with K2's order above K2_MEAN_TOL; its bf16 outputs its fp32 outputs
    rounded, bit for bit; and a second launch gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    h = 7
    qkv = torch.randn(5, l, 3 * h * hd, device=cuda_device, generator=gen).bfloat16()
    do = torch.randn(5, l, h * hd, device=cuda_device, generator=gen).bfloat16()
    got = port_attn._mha3_bwd_cuda(qkv, do, h)
    f32 = port_attn._mha3_bwd_cuda(qkv, do, h, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert f32.dtype == torch.float32 and torch.equal(got, f32.bfloat16())
    ref = port_attn.mha3_bwd_reference(qkv, do, h).float()
    control = _k2_order_k1_bytes(qkv, do, h)
    for name, a, r, c in zip(("dq", "dk", "dv"), got.chunk(3, dim=-1), ref.chunk(3, dim=-1),
                             control.chunk(3, dim=-1)):
        assert (a.float() - r).abs().max().item() <= _tol(r, torch.bfloat16), name
        assert _rel_mean(a, r) <= K2_MEAN_TOL < _rel_mean(c, r), name
    assert torch.equal(port_attn._mha3_bwd_cuda(qkv, do, h), got)


@pytest.mark.cuda
@pytest.mark.parametrize("l", RAGGED_L)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_k3f_bf16_kernel_at_ragged_edges(cuda_device, l, hd):
    """The bf16 K3f (K2f's tensor-core body on rows 3D apart in, D apart
    out), 5 samples of 7 heads, against mha_qkv_reference: one bf16 ulp and
    K2_MEAN_TOL in mean, with K1's order above it; a second launch gives
    the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    h = 7
    qkv = torch.randn(5, l, 3 * h, hd, device=cuda_device, generator=gen).bfloat16()
    got = port_attn._mha2_fwd_cuda(qkv, h)
    torch.cuda.synchronize()
    ref = port_attn.mha_qkv_reference(qkv, h).float()
    control = port_attn.mha_v3_reference(qkv.view(5, l, 3 * h * hd), h).view(5, l, h, hd)
    assert (got.float() - ref).abs().max().item() <= _tol(ref, torch.bfloat16)
    assert _rel_mean(got, ref) <= K2_MEAN_TOL < _rel_mean(control, ref)
    assert torch.equal(port_attn._mha2_fwd_cuda(qkv, h), got)


@pytest.mark.cuda
@pytest.mark.parametrize("l", RAGGED_L)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_k3b_bf16_kernel_at_ragged_edges(cuda_device, l, hd):
    """The bf16 K3b (K2b's tensor-core backward body on rows 3D apart in
    qkv and dqkv, D apart in dO), 5 samples of 7 heads, against
    mha_qkv_bwd_reference: each of dq, dk and dv within one bf16 ulp and
    within K2_MEAN_TOL in mean, with K1's order above K2_MEAN_TOL; its bf16
    outputs its fp32 outputs rounded, bit for bit; and a second launch
    gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    h = 7
    qkv = torch.randn(5, l, 3 * h, hd, device=cuda_device, generator=gen).bfloat16()
    do = torch.randn(5, l, h, hd, device=cuda_device, generator=gen).bfloat16()
    got = port_attn._mha2_bwd_cuda(qkv, do, h)
    f32 = port_attn._mha2_bwd_cuda(qkv, do, h, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert f32.dtype == torch.float32 and torch.equal(got, f32.bfloat16())
    ref = port_attn.mha_qkv_bwd_reference(qkv, do, h).float()
    control = port_attn.mha3_bwd_reference(qkv.view(5, l, 3 * h * hd), do.view(5, l, h * hd),
                                           h).view(5, l, 3 * h, hd)
    for name, a, r, c in zip(("dq", "dk", "dv"), got.split(h, dim=2), ref.split(h, dim=2),
                             control.split(h, dim=2)):
        assert (a.float() - r).abs().max().item() <= _tol(r, torch.bfloat16), name
        assert _rel_mean(a, r) <= K2_MEAN_TOL < _rel_mean(c, r), name
    assert torch.equal(port_attn._mha2_bwd_cuda(qkv, do, h), got)


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


# The fused AdamW kernel (csrc/adamw.cu) against the foreach chain it
# replaces on the card, both in train/optim.AdamW. Each update starts both
# sides from the same state (the chain's), so a rounding that differs in
# one update is not carried into the next: a moment stored in bf16 that
# rounded the other way would move the next update by a bf16 ulp. Limits,
# each in units of the last place of the largest magnitude in the
# element's arithmetic (the terms of m, v and p, and lr s |u| for p): the
# fp32 params and moments within ADAMW_FP32_ULPS (the kernel contracts
# where the chain's own kernels may not: a few roundings of u differ), a
# moment stored in bf16 within one bf16 ulp (a rounding to nearest that
# went the other way).
ADAMW_FP32_ULPS = 8
ADAMW_BF16_ULPS = 1
ADAMW_RULES = {"fp32": (None, None), "bf16_mu": (torch.bfloat16, None),
               "bf16_nu": (None, torch.bfloat16), "bf16_both": (torch.bfloat16, torch.bfloat16)}


def _ulps(got: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> float:
    """The largest |got - ref| in units of the last place of ``scale``, in
    got's dtype (fp32: 23 fraction bits, bf16: 7)."""
    bits = 7 if got.dtype == torch.bfloat16 else 23
    scale = scale.double().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - bits)
    return ((got.double() - ref.double()).abs() / ulp).max().item()


def _adamw_leaves(device, gen):
    """Params and gradients: odd lengths, a leaf of several chunks with a
    ragged tail, a ZeRO-1 chunk on the leading axis (a view at an offset
    that is not 16-byte aligned), a chunk cut across the rows (not
    contiguous: the foreach chain), a gradient that is a view at an odd
    offset (as FlatGrads' after an odd length), a frozen leaf and a
    trainable leaf without a gradient."""
    from cross_scale_mae_torch.ops.adamw import CHUNK

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen)

    params = [randn(64, 96), randn(62), randn(3, 5, 7), randn(2 * CHUNK + 3),
              randn(9, 37).chunk(2, 0)[1], randn(6, 10).chunk(2, 1)[1], randn(16), randn(4, 4)]

    def grads(step_scale):
        out = [randn(*p.shape) * s for p, s in zip(params, (1.0, 0.3, 2.0, 1e-3, 0.5, 1.0, 1.0))]
        flat = torch.empty(out[2].numel() + 1, device=device)
        out[2] = flat[1:].view(3, 5, 7).copy_(out[2])
        return [g * step_scale for g in out] + [None]

    return params, grads


@pytest.mark.cuda
@pytest.mark.parametrize("rule", sorted(ADAMW_RULES))
@pytest.mark.parametrize("full", [False, True])
def test_cuda_adamw_kernel_matches_the_foreach_chain(cuda_device, rule, full):
    """Three updates through the kernel against the foreach chain on the
    card, for each moment-dtype rule; ``full`` adds layer decay, a clip
    factor below 1 and a frozen leaf (the weight-decay mask is on in both).
    One launch an update, and the fused share the kernel's elements over
    the trainable ones (all but the chunk cut across the rows)."""
    from unittest import mock

    from cross_scale_mae_torch.ops import adamw as fused
    from cross_scale_mae_torch.train import optim

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    params, grads = _adamw_leaves(cuda_device, gen)
    mu_dtype, nu_dtype = ADAMW_RULES[rule]
    trainable = [True] * 8
    if full:
        trainable[6] = False

    def make():
        return optim.AdamW(lambda s: 1e-3 * (1 + s), [True, False, True, True, True, False,
                                                     True, True],
                           b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.05,
                           clip_grad=1.0 if full else None,
                           scales=[0.75 ** k for k in range(8)] if full else None,
                           trainable=trainable, mu_dtype=mu_dtype, nu_dtype=nu_dtype)

    tx, ref = make(), make()
    ref_params = [p.clone() for p in params]
    state, ref_state = tx.init(params), ref.init(ref_params)
    idx = tx.idx
    fused_numel = sum(params[i].numel() for i in idx if i != 5)
    for step in range(3):
        gs = grads(1.0 + step)
        for a, b in zip(params + state.mu + state.nu, ref_params + ref_state.mu + ref_state.nu):
            a.copy_(b)
        state.count = ref_state.count
        old = [t.clone() for t in ref_params + ref_state.mu + ref_state.nu]
        before = fused.fused_adamw.launches
        tx.update(params, gs, state)
        with mock.patch.object(fused, "kernel_takes", lambda *leaf: False):
            ref.update(ref_params, gs, ref_state)
        torch.cuda.synchronize()
        assert fused.fused_adamw.launches == before + 1 and ref.fused_share == 0.0
        assert tx.fused_share == pytest.approx(
            fused_numel / sum(params[i].numel() for i in idx), rel=1e-12)
        t = step + 1
        lr = 1e-3 * (1 + step)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(gs[i] if gs[i] is not None else params[i] * 0)
             for i in idx]))
        c = min(1.0, 1.0 / norm.item()) if full else 1.0
        n = len(params)
        for j, i in enumerate(idx):
            g = (gs[i] if gs[i] is not None else torch.zeros_like(params[i])).double() * c
            p0, m0, v0 = old[i].double(), old[n + j].double(), old[n + len(idx) + j].double()
            m1, v1 = ref_state.mu[j].double(), ref_state.nu[j].double()
            u = (m1 / (1 - 0.9 ** t)) / ((v1 / (1 - 0.95 ** t)).sqrt() + 1e-8)
            s = 0.75 ** i if full else 1.0
            wd = 0.05 if tx.decay[j] else 0.0
            scale_p = torch.maximum(torch.maximum(p0.abs(), ref_params[i].double().abs()),
                                    lr * s * (u.abs() + wd * p0.abs()))
            scale_m = torch.maximum(torch.maximum(m1.abs(), 0.9 * m0.abs()), 0.1 * g.abs())
            scale_v = torch.maximum(torch.maximum(v1, 0.95 * v0), 0.05 * g * g)
            for got, want, scale in ((params[i], ref_params[i], scale_p),
                                     (state.mu[j], ref_state.mu[j], scale_m),
                                     (state.nu[j], ref_state.nu[j], scale_v)):
                limit = ADAMW_BF16_ULPS if got.dtype == torch.bfloat16 else ADAMW_FP32_ULPS
                assert got.dtype == want.dtype
                assert _ulps(got, want, scale) <= limit, (rule, step, i)
        if full:
            assert torch.equal(params[6], ref_params[6]) and torch.equal(params[6], old[6])


@pytest.mark.cuda
def test_cuda_adamw_kernel_returns_what_it_does_not_take(cuda_device):
    """The wrapper leaves a leaf kernel_takes refuses as it was and returns
    its index, launching nothing for it, and refuses leaves whose moments
    differ in dtype."""
    from cross_scale_mae_torch.ops import adamw as fused

    p = torch.ones(6, 4, device=cuda_device)
    leaf = (p, torch.ones_like(p), torch.zeros_like(p), torch.zeros_like(p))
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.05, count=1,
              upcast_first=False)
    before = fused.fused_adamw.launches
    transposed = [t.t() for t in leaf]
    assert fused.fused_adamw(*([t] for t in transposed), [True], None, None, **kw) == [0]
    assert fused.fused_adamw.launches == before and (p == 1).all()
    other = torch.ones(5, device=cuda_device)
    with pytest.raises(ValueError, match="one dtype for each moment"):
        fused.fused_adamw([p, other], [leaf[1], torch.ones_like(other)],
                          [leaf[2], torch.zeros_like(other, dtype=torch.bfloat16)],
                          [leaf[3], torch.zeros_like(other)], [True, True], None, None, **kw)
    assert fused.fused_adamw(*([t] for t in leaf), [True], None, None, **kw) == []
    torch.cuda.synchronize()
    assert fused.fused_adamw.launches == before + 1 and (p < 1).all()
