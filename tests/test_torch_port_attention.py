"""The PyTorch port's attention (cross_scale_mae_torch/ops/attention.py)
held against the JAX package's v3 Pallas kernels, forward and backward.

On the CPU the port's ``mha_v3`` runs its plain versions,
``mha_v3_reference`` and ``mha3_bwd_reference``; the JAX side runs
``pallas_mha_v3`` (and its custom VJP, ``_mha3_bwd_kernel``) in interpret
mode, as tests/test_models.py does. The CUDA kernels themselves are
compared with the plain versions on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).

Tolerances:
* fp32: atol 1e-5 (the bound tests/test_models.py holds the v3 kernel to);
  the two sides differ only in the order of fp32 sums.
* bf16: one bf16 ulp at the output's largest magnitude,
  2**-7 * max(1, max|ref|). Both sides round P (and in the backward dS) and
  the output to bf16 from fp32 values that differ in their last fp32 bits,
  so a value sitting on a rounding boundary may land one bf16 ulp apart.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cross_scale_mae_torch.ops import attention as port_attn

SHAPES = [(2, 16, 4, 8), (2, 65, 12, 64), (3, 17, 12, 64), (2, 65, 16, 32)]


def _bf16_bound(ref: np.ndarray) -> float:
    return 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("n,l,h,hd", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_v3_matches_jax_pallas_v3(n, l, h, hd, dtype):
    from cross_scale_mae_tpu.ops.attention import pallas_mha_v3

    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, l, 3 * h * hd)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = np.asarray(pallas_mha_v3(jnp.asarray(x, jdt), h, True).astype(jnp.float32))
    got = port_attn.mha_v3(torch.from_numpy(x).to(getattr(torch, dtype)), h)
    assert got.shape == (n, l, h * hd) and got.dtype == getattr(torch, dtype)
    atol = 1e-5 if dtype == "float32" else _bf16_bound(ref)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("n,l,h,hd", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_v3_grad_matches_jax_pallas_v3_vjp(n, l, h, hd, dtype):
    """The port's backward (mha3_bwd_reference directly, and through
    autograd of mha_v3) against jax.vjp of pallas_mha_v3, which runs
    _mha3_bwd_kernel."""
    import jax

    from cross_scale_mae_tpu.ops.attention import pallas_mha_v3

    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, l, 3 * h * hd)).astype(np.float32)
    g = rng.normal(size=(n, l, h * hd)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a: pallas_mha_v3(a, h, True), jnp.asarray(x, jdt))
    ref = np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))
    atol = 1e-5 if dtype == "float32" else _bf16_bound(ref)

    direct = port_attn.mha3_bwd_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), h)
    assert direct.shape == x.shape and direct.dtype == tdt
    np.testing.assert_allclose(direct.float().numpy(), ref, rtol=0, atol=atol)

    leaf = torch.from_numpy(x).to(tdt).requires_grad_(True)
    port_attn.mha_v3(leaf, h).backward(torch.from_numpy(g).to(tdt))
    assert leaf.grad.dtype == tdt
    np.testing.assert_allclose(leaf.grad.float().numpy(), ref, rtol=0, atol=atol)


def test_mha_v3_saves_only_qkv():
    """The autograd node keeps qkv and nothing else (the JAX custom VJP's
    residuals are (qkv,)): the backward recomputes the probabilities."""
    qkv = torch.randn(2, 5, 3 * 32, requires_grad=True)
    out = port_attn.mha_v3(qkv, 2)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is qkv


def test_xla_mha_matches_jax_xla_mha():
    from cross_scale_mae_tpu.ops.attention import xla_mha

    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 17, 4, 16)).astype(np.float32) for _ in range(3))
    ref = np.asarray(xla_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = port_attn.xla_mha(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_cpu_wrapper_never_counts_a_launch():
    before = port_attn.mha_v3.launches, port_attn.mha_v3.bwd_launches
    qkv = torch.zeros(1, 4, 3 * 32, requires_grad=True)
    port_attn.mha_v3(qkv, 2).sum().backward()
    assert (port_attn.mha_v3.launches, port_attn.mha_v3.bwd_launches) == before


def test_mha_v3_rejects_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_attn.mha_v3(torch.zeros(1, 4, 96, device="meta"), 2)


@pytest.mark.parametrize("make,err,match", [
    (lambda: torch.zeros(1, 4, 96, dtype=torch.float16), TypeError, "bfloat16 or float32"),
    (lambda: torch.zeros(1, 96, 4).transpose(1, 2), ValueError, "contiguous"),
    (lambda: torch.zeros(1, 4, 3 * 2 * 24), ValueError, "head_dim"),
    (lambda: torch.zeros(1, 4, 95), ValueError, "divisible"),
    (lambda: torch.zeros(1, 900, 3 * 2 * 64), ValueError, "shared memory"),
])
def test_kernel_wrapper_validates_before_launch(make, err, match):
    with pytest.raises(err, match=match):
        port_attn._mha3_fwd_cuda(make(), 2)


@pytest.mark.parametrize("make,match", [
    (lambda: torch.zeros(1, 5, 64), "shape"),
    (lambda: torch.zeros(1, 4, 64, dtype=torch.float64), "float32"),
    (lambda: torch.zeros(1, 64, 4).transpose(1, 2), "contiguous"),
])
def test_bwd_kernel_wrapper_validates_do_before_launch(make, match):
    with pytest.raises(ValueError, match=match):
        port_attn._mha3_bwd_cuda(torch.zeros(1, 4, 3 * 2 * 32), make(), 2)


def test_bwd_kernel_wrapper_validates_qkv_before_launch():
    with pytest.raises(ValueError, match="head_dim"):
        port_attn._mha3_bwd_cuda(torch.zeros(1, 4, 3 * 2 * 24), torch.zeros(1, 4, 48), 2)


def test_bwd_smem_layout_matches_kernel_source():
    # Two (L, hd+8) bf16 tiles, 3 fp32 row stats per query row, per warp
    # 2*hd + 2*L fp32 (csrc/mha_common.cuh bwd_smem_bytes): 28*L + 16*hd bytes
    # above the forward.
    assert port_attn.mha3_bwd_smem_bytes(65, 32, torch.bfloat16) == (
        2 * 65 * 40 * 2 + 3 * 65 * 4 + 4 * (2 * 32 + 2 * 65) * 4)
    for l, hd, dt in [(17, 64, torch.bfloat16), (257, 80, torch.float32)]:
        extra = (port_attn.mha3_bwd_smem_bytes(l, hd, dt)
                 - port_attn.mha3_smem_bytes(l, hd, dt))
        assert extra == 28 * l + 16 * hd


def test_bwd_kernel_fits_every_config_the_forward_runs():
    """Every ViT size of the configs, at inputs up to 256 px with patch 16
    (up to 257 tokens), in fp32 and bf16: the backward block (the scalar
    layout, and the tensor-core layout K1b's wrapper checks for bf16) fits
    an H100 block wherever the training forward runs."""
    from cross_scale_mae_torch.configs import VIT_SIZES

    for size in VIT_SIZES.values():
        for d, h in ((size.dim_model, size.encoder_num_heads),
                     (size.decoder_embed_dim, size.decoder_num_heads)):
            for l in (17, 65, 257):
                for dt in (torch.float32, torch.bfloat16):
                    for smem in (port_attn.mha3_bwd_smem_bytes, port_attn.mha_bwd_smem_bytes):
                        assert smem(l, d // h, dt) <= port_attn.MAX_SMEM_BYTES


def test_smem_layout_matches_kernel_source():
    # 2 * L * (hd + 8) bf16 for k/v, 4 warps * hd fp32 query rows, 4 warps *
    # L fp32 score rows (csrc/mha_common.cuh fwd_smem_bytes).
    assert port_attn.mha3_smem_bytes(65, 64, torch.bfloat16) == (
        2 * 65 * 72 * 2 + 4 * 64 * 4 + 4 * 65 * 4)
    # The L=257 serving limit needs the opt-in above 48 KB but fits a block.
    big = port_attn.mha3_smem_bytes(257, 64, torch.bfloat16)
    assert 48 * 1024 < big <= port_attn.MAX_SMEM_BYTES


def test_kernel_head_dims_cover_every_vit_size():
    from cross_scale_mae_torch.configs import VIT_SIZES

    dims = {v.dim_model // v.encoder_num_heads for v in VIT_SIZES.values()}
    dims |= {v.decoder_embed_dim // v.decoder_num_heads for v in VIT_SIZES.values()}
    assert sorted(dims) == list(port_attn.KERNEL_HEAD_DIMS)


# ---------------------------------------------------------------- K2 (v1)
#
# The port's pallas_mha (its plain versions on the CPU) against the JAX
# package's pallas_mha in interpret mode, which runs _mha_kernel and, through
# its custom VJP, _mha_bwd_kernel. fp32: atol 1e-5, as tests/test_models.py
# holds pallas_mha (sums in another order). bf16: one bf16 ulp at the
# largest magnitude, 2**-7 * max(1, max|ref|): both sides compute in fp32
# and round each output once, from fp32 sums taken in another order.

K2_CASES = [((2, 16, 4, 8), "float32"), ((2, 65, 4, 64), "bfloat16"),
            ((2, 65, 4, 64), "float32"), ((2, 17, 3, 16), "bfloat16")]


def _qkv_do(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape,dtype", K2_CASES)
def test_pallas_mha_matches_jax_pallas_mha(shape, dtype):
    from cross_scale_mae_tpu.ops.attention import pallas_mha as jmha

    q, k, v, _ = _qkv_do(shape, 11)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(jmha(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                          interpret=True).astype(jnp.float32))
    got = port_attn.pallas_mha(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert got.shape == shape and got.dtype == tdt
    atol = 1e-5 if dtype == "float32" else _bf16_bound(ref)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("shape,dtype", K2_CASES)
def test_pallas_mha_grad_matches_jax_vjp(shape, dtype):
    """dq, dk, dv through autograd of the port's mha against jax.vjp of
    pallas_mha (interpret mode, _mha_bwd_kernel)."""
    import jax

    from cross_scale_mae_tpu.ops.attention import pallas_mha as jmha

    q, k, v, g = _qkv_do(shape, 12)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a, b, c: jmha(a, b, c, interpret=True),
                     *(jnp.asarray(x, jdt) for x in (q, k, v)))
    refs = [np.asarray(r.astype(jnp.float32)) for r in vjp(jnp.asarray(g, jdt))]
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    port_attn.mha(*leaves).backward(torch.from_numpy(g).to(tdt))
    for leaf, ref in zip(leaves, refs):
        assert leaf.grad.dtype == tdt
        atol = 1e-5 if dtype == "float32" else _bf16_bound(ref)
        np.testing.assert_allclose(leaf.grad.float().numpy(), ref, rtol=0, atol=atol)


def test_mha_folded_bwd_reference_keeps_ds_in_fp32():
    """The K2 order leaves P and dS in fp32 (attention.py:41-62): in bf16 its
    dq differs from the K1 order, which rounds dS to bf16 first."""
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in _qkv_do((4, 33, 64), 13))
    dq, _, _ = port_attn.mha_folded_bwd_reference(q, k, v, g)
    qkv = torch.stack([q, k, v], dim=1).transpose(1, 2).reshape(4, 33, 3 * 64)
    k1 = port_attn.mha3_bwd_reference(qkv, g, 1)[..., :64]
    assert not torch.equal(dq, k1)


def test_mha_saves_folded_q_k_v():
    """The autograd node keeps the three folded inputs, as _mha_folded_fwd
    returns (qf, kf, vf) as its residuals."""
    q, k, v = (torch.randn(6, 5, 16, requires_grad=True) for _ in range(3))
    saved = port_attn.mha_folded(q, k, v).grad_fn.saved_tensors
    assert len(saved) == 3 and all(s is t for s, t in zip(saved, (q, k, v)))


def test_fold_unfold_match_jax():
    from cross_scale_mae_tpu.ops.attention import _fold as jfold
    from cross_scale_mae_tpu.ops.attention import _unfold as junfold

    x = np.random.default_rng(14).normal(size=(2, 5, 3, 4)).astype(np.float32)
    folded = port_attn._fold(torch.from_numpy(x))
    assert folded.is_contiguous()
    np.testing.assert_array_equal(folded.numpy(), np.asarray(jfold(jnp.asarray(x))))
    np.testing.assert_array_equal(port_attn._unfold(folded, 2, 3).numpy(),
                                  np.asarray(junfold(jfold(jnp.asarray(x)), 2, 3)))


def test_cpu_mha_never_counts_a_launch():
    before = port_attn.mha.launches, port_attn.mha.bwd_launches
    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    port_attn.mha(q, q, q).sum().backward()
    assert (port_attn.mha.launches, port_attn.mha.bwd_launches) == before
    assert port_attn.pallas_mha is port_attn.mha


@pytest.mark.parametrize("make,err,match", [
    (lambda: [torch.zeros(2, 4, 16, dtype=torch.float16)] * 3, TypeError, "bfloat16 or float32"),
    (lambda: [torch.zeros(2, 16, 4).transpose(1, 2)] * 3, ValueError, "contiguous"),
    (lambda: [torch.zeros(2, 4, 24)] * 3, ValueError, "head_dim"),
    (lambda: [torch.zeros(2, 4, 16), torch.zeros(2, 5, 16), torch.zeros(2, 4, 16)],
     ValueError, "share shape"),
    (lambda: [torch.zeros(2, 900, 64)] * 3, ValueError, "shared memory"),
    (lambda: [torch.zeros(4, 16)] * 3, ValueError, "N\\*H, L, hd"),
])
def test_mha_kernel_wrappers_validate_before_launch(make, err, match):
    with pytest.raises(err, match=match):
        port_attn._mha_fwd_cuda(*make())
    with pytest.raises(err, match=match):
        port_attn._mha_bwd_cuda(*make(), make()[0])


def test_mha_rejects_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_attn.mha_folded(*[torch.zeros(1, 4, 16, device="meta")] * 3)


def test_mha_kernels_fit_every_shape_the_configs_give():
    """K2's shared-memory layouts (the tensor-core bodies in bf16, K1's
    scalar bodies otherwise): every head width of the ViT sizes at up to 257
    tokens fits an H100 block, forward and backward."""
    for hd in port_attn.KERNEL_HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            for smem in (port_attn.mha_smem_bytes, port_attn.mha_bwd_smem_bytes):
                assert smem(257, hd, dt) <= port_attn.MAX_SMEM_BYTES
                port_attn._check_folded((torch.zeros(2, 257, hd, dtype=dt),) * 4, smem)


TC_HEADER = (Path(port_attn.__file__).resolve().parent.parent / "csrc" / "mha_tc.cuh").read_text()


def test_mha_smem_layout_matches_tc_kernel_source():
    """K2f in bf16 (csrc/mha_tc.cuh tc_fwd_smem_bytes): q, k and v as tiles
    of L rounded up to 16 rows of hd + 8 bf16; in fp32 the scalar body's
    K1f layout."""
    assert "kPitch = HD + 8" in TC_HEADER
    assert ("return 3 * size_t(padded_rows(L)) * TcGeometry<HD>::kPitch * sizeof(bf16);"
            in TC_HEADER)
    assert port_attn.mha_smem_bytes(65, 64, torch.bfloat16) == 3 * 80 * 72 * 2
    assert port_attn.mha_smem_bytes(17, 16, torch.bfloat16) == 3 * 32 * 24 * 2
    assert port_attn.mha_smem_bytes(257, 80, torch.bfloat16) == 3 * 272 * 88 * 2
    for l, hd in [(65, 64), (257, 80)]:
        assert (port_attn.mha_smem_bytes(l, hd, torch.float32)
                == port_attn.mha3_smem_bytes(l, hd, torch.float32))


# The tensor-core K2f (csrc/mha_tc.cuh) splits each fp32 P value into
# kSplitTerms bf16 terms before its P V product; the same split of P and dS
# was the design held for K2b (PERF.md section 6). An fp32 emulation of
# that arithmetic against the plain versions: mean |emulated - plain| /
# mean |plain| of each bf16 output. The chosen count must read at most
# K2_MEAN_TOL / 8; one term (K1's rounding, the control of chip_smoke.py's
# gate) must read above K2_MEAN_TOL.
K2_MEAN_TOL = 2.0 ** -15
SPLIT_TERMS = int(re.search(r"constexpr int kSplitTerms = (\d+);", TC_HEADER).group(1))
K1_SPLIT_TERMS = int(re.search(r"constexpr int kK1SplitTerms = (\d+);", TC_HEADER).group(1))


def _split_terms(x: torch.Tensor, terms: int) -> torch.Tensor:
    """The sum of x's first `terms` bf16 terms: bf16(x), bf16 of the rest,
    ... (exact in fp32)."""
    total, rest = torch.zeros_like(x), x
    for _ in range(terms):
        term = rest.bfloat16().float()
        total, rest = total + term, rest - term
    return total


def _split_emulation(q, k, v, do, terms):
    """out, dq, dk, dv in K2's op order with P and dS replaced by the sum of
    their bf16 terms before the products (bf16 operands are exact in fp32,
    the sums are fp32)."""
    q32, k32, v32, g = q.float(), k.float(), v.float(), do.float()
    p = port_attn._folded_probs(q32, k32)
    ps = _split_terms(p, terms)
    dp = torch.matmul(g, v32.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * (q.shape[-1] ** -0.5)
    dss = _split_terms(ds, terms)
    outs = (torch.matmul(ps, v32), torch.matmul(dss, k32),
            torch.matmul(dss.transpose(-1, -2), q32), torch.matmul(ps.transpose(-1, -2), g))
    return [t.to(q.dtype) for t in outs]


@pytest.mark.parametrize("shape", [(4, 65, 64), (4, 17, 16), (2, 257, 80)])
@pytest.mark.parametrize("terms", [1, SPLIT_TERMS])
def test_split_bf16_arithmetic_against_plain_versions(shape, terms):
    assert SPLIT_TERMS in (2, 3)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _qkv_do(shape, 15))
    refs = [port_attn.mha_folded_reference(q, k, v),
            *port_attn.mha_folded_bwd_reference(q, k, v, do)]
    emulated = _split_emulation(q, k, v, do, terms)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), emulated, refs):
        ref = ref.float()
        rel = ((got.float() - ref).abs().mean() / ref.abs().mean()).item()
        if terms == 1:
            assert rel > K2_MEAN_TOL, name
        else:
            assert rel <= K2_MEAN_TOL / 8, name


def _k1f_split_emulation(qkv: torch.Tensor, num_heads: int, terms: int) -> torch.Tensor:
    """mha_v3_reference with P's rounding to the input dtype replaced by the
    sum of its first `terms` bf16 terms: the tensor-core K1f's arithmetic
    (csrc/mha3_fwd.cu on csrc/mha_tc.cuh, kK1SplitTerms) in fp32."""
    n, l, d, hd = port_attn._split_dims(qkv, num_heads)
    r = qkv.reshape(n, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4).float()
    p = port_attn._softmax_fp32(torch.matmul(r[0], r[1].transpose(-1, -2)) * hd ** -0.5)
    out = torch.matmul(_split_terms(p, terms), r[2]).to(qkv.dtype)
    return out.transpose(1, 2).reshape(n, l, d)


@pytest.mark.parametrize("shape", [(3, 65, 4, 64), (4, 17, 6, 16), (2, 257, 2, 80)])
def test_k1f_split_term_count_reproduces_its_plain_version(shape):
    """One bf16 term of P is K1's own `.astype(bf16)`: the emulated
    tensor-core K1f equals mha_v3_reference bit for bit, which K2's three
    terms (P kept whole) do not."""
    assert K1_SPLIT_TERMS == 1
    n, l, h, hd = shape
    qkv = torch.from_numpy(np.random.default_rng(21).normal(
        size=(n, l, 3 * h * hd)).astype(np.float32)).bfloat16()
    ref = port_attn.mha_v3_reference(qkv, h)
    assert torch.equal(_k1f_split_emulation(qkv, h, K1_SPLIT_TERMS), ref)
    assert not torch.equal(_k1f_split_emulation(qkv, h, SPLIT_TERMS), ref)


def test_k2b_smem_layout_matches_tc_kernel_source():
    """K2b in bf16 (csrc/mha_tc.cuh tc_bwd_smem_bytes, launched by
    csrc/mha_bwd.cu): q, k, v and dO as tiles of L rounded up to 16 rows of
    hd + 8 bf16, and the row max, sum and sum_j dP P as three fp32 rows of
    that length; in fp32 the scalar body's layout. Every head width fits an
    H100 block at the longest sequence, 257 tokens."""
    assert ("return 4 * size_t(padded_rows(L)) * TcGeometry<HD>::kPitch * sizeof(bf16)\n"
            "         + 3 * size_t(padded_rows(L)) * sizeof(float);") in TC_HEADER
    k2b = (Path(port_attn.__file__).resolve().parent.parent / "csrc" / "mha_bwd.cu").read_text()
    assert "tc::tc_bwd_smem_bytes<HD>(L)" in k2b
    assert port_attn.mha_bwd_smem_bytes(65, 64, torch.bfloat16) == 4 * 80 * 72 * 2 + 3 * 80 * 4
    assert port_attn.mha_bwd_smem_bytes(17, 16, torch.bfloat16) == 4 * 32 * 24 * 2 + 3 * 32 * 4
    for hd in port_attn.KERNEL_HEAD_DIMS:
        assert port_attn.mha_bwd_smem_bytes(257, hd, torch.bfloat16) <= port_attn.MAX_SMEM_BYTES
        assert (port_attn.mha_bwd_smem_bytes(257, hd, torch.float32)
                == port_attn.mha3_bwd_smem_bytes(257, hd, torch.float32))


def test_k1f_smem_layout_is_the_tc_body_for_bf16():
    """K1f runs mha_tc.cuh's forward body for bf16 (three (L padded to 16,
    hd + 8) tiles) and the scalar body for fp32; its wrapper checks each
    against the block's limit before launch."""
    k1f = (Path(port_attn.__file__).resolve().parent.parent / "csrc" / "mha3_fwd.cu").read_text()
    assert "tc::tc_fwd_smem_bytes<HD>(L)" in k1f and "attend_fwd_tc<HD, kSingle, /*kK1=*/true>" in k1f
    for l, hd in [(17, 64), (65, 32), (257, 80)]:
        rows = -(-l // 16) * 16
        assert port_attn.mha_smem_bytes(l, hd, torch.bfloat16) == 3 * rows * (hd + 8) * 2
        for dt in (torch.bfloat16, torch.float32):
            port_attn._check_kernel_input(torch.zeros(2, l, 3 * 2 * hd, dtype=dt), 2,
                                          port_attn.mha_smem_bytes)


CSRC = Path(port_attn.__file__).resolve().parent.parent / "csrc"


def test_k1b_runs_the_tc_backward_body_with_k1s_roundings_for_bf16():
    """K1b launches mha_tc.cuh's backward body for bf16 with K1's numerics
    (kK1: one bf16 term of P and dS) on rows 3D apart in qkv and dqkv and D
    apart in dO, sized by tc_bwd_smem_bytes, with an fp32-output entry; K2b
    the same body with K2's. Both wrappers, and mha_v3's refusal before the
    forward, check that layout for bf16 and the scalar one for fp32."""
    import inspect

    k1b = (CSRC / "mha3_bwd.cu").read_text()
    assert "tc::tc_bwd_smem_bytes<HD>(L)" in k1b
    assert "attend_bwd_tc<HD, kSingle, /*kK1=*/true, TO>" in k1b
    assert "3 * D, dout + size_t(n) * L * D + size_t(h) * HD, D, dq" in k1b
    assert 'extern "C" int csmae_mha3_bwd_f32(' in k1b
    assert "attend_bwd_tc<HD, kSingle, /*kK1=*/false, TO>" in (CSRC / "mha_bwd.cu").read_text()
    assert "constexpr int kTerms = kK1 ? kK1SplitTerms : kSplitTerms;" in TC_HEADER
    for fn in (port_attn._mha3_bwd_cuda, port_attn.mha_v3):
        assert "_check_kernel_input(qkv, num_heads, mha_bwd_smem_bytes)" in inspect.getsource(fn)
    rows = -(-65 // 16) * 16
    assert port_attn.mha_bwd_smem_bytes(65, 32, torch.bfloat16) == 4 * rows * 40 * 2 + 3 * rows * 4
    # 400 tokens of width 80: the scalar bf16 layout would fit a block, the
    # tensor-core one does not, and the wrapper refuses before launch.
    assert port_attn.mha3_bwd_smem_bytes(400, 80, torch.bfloat16) <= port_attn.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        port_attn._mha3_bwd_cuda(torch.zeros(1, 400, 3 * 2 * 80, dtype=torch.bfloat16),
                                 torch.zeros(1, 400, 2 * 80, dtype=torch.bfloat16), 2)
    port_attn._check_kernel_input(torch.zeros(1, 257, 3 * 2 * 80, dtype=torch.bfloat16), 2,
                                  port_attn.mha_bwd_smem_bytes)


def test_k3f_runs_k2fs_tc_body_on_k1s_rows_for_bf16():
    """K3f launches K2f's tensor-core forward body (no kK1) for bf16, with
    q, k and v rows 3D apart and output rows D apart, sized by
    tc_fwd_smem_bytes; its wrapper checks that layout for bf16."""
    k3f = (CSRC / "mha2_fwd.cu").read_text()
    assert "tc::tc_fwd_smem_bytes<HD>(L)" in k3f
    assert ("attend_fwd_tc<HD, kSingle, /*kK1=*/false>(\n"
            "      q, q + D, q + 2 * D, 3 * D, out + size_t(n) * L * D + size_t(h) * HD, D, L,"
            in k3f)
    # 500 tokens of width 80: the scalar bf16 layout would fit, the
    # tensor-core one does not.
    assert port_attn.mha3_smem_bytes(500, 80, torch.bfloat16) <= port_attn.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        port_attn._mha2_fwd_cuda(torch.zeros(1, 500, 6, 80, dtype=torch.bfloat16), 2)


def test_k3b_runs_the_tc_backward_body_on_k1s_rows_for_bf16():
    """K3b launches mha_tc.cuh's backward body for bf16 with K2's numerics
    (no kK1: three bf16 terms of P and dS) on K1's rows, 3D apart in qkv
    and dqkv and D apart in dO, sized by tc_bwd_smem_bytes, with an
    fp32-output entry; fp32 keeps the scalar body. Its wrapper, and
    mha_qkv's refusal before the forward, check the tensor-core layout for
    bf16 and the scalar one for fp32."""
    import inspect

    k3b = (CSRC / "mha2_bwd.cu").read_text()
    assert "tc::tc_bwd_smem_bytes<HD>(L)" in k3b
    assert ("attend_bwd_tc<HD, kSingle, /*kK1=*/false, TO, /*kOneAcc=*/" in k3b
            and "q, q + D, q + 2 * D, 3 * D, dout + size_t(n) * L * D + size_t(h) * HD, D, "
                "dq, dq + D,\n      dq + 2 * D, 3 * D, L, scale);" in k3b)
    assert 'extern "C" int csmae_mha2_bwd_f32(' in k3b
    assert "launch(mha2_bwd_kernel<T, HD>, bwd_smem_bytes<T, HD>(L)" in k3b
    for fn in (port_attn._mha2_bwd_cuda, port_attn.pallas_mha_qkv):
        assert "_check_qkv4(qkv, num_heads, mha2_bwd_smem_bytes)" in inspect.getsource(fn)
    assert port_attn.mha2_bwd_smem_bytes is port_attn.mha_bwd_smem_bytes
    # 400 tokens of width 80: the scalar bf16 layout would fit a block, the
    # tensor-core one does not, and the wrapper refuses before launch.
    assert port_attn.mha3_bwd_smem_bytes(400, 80, torch.bfloat16) <= port_attn.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        port_attn._mha2_bwd_cuda(torch.zeros(1, 400, 6, 80, dtype=torch.bfloat16),
                                 torch.zeros(1, 400, 2, 80, dtype=torch.bfloat16), 2)
    with pytest.raises(TypeError, match="float32, not torch.float16"):
        port_attn._mha2_bwd_cuda(torch.zeros(1, 4, 6, 32, dtype=torch.bfloat16),
                                 torch.zeros(1, 4, 2, 32, dtype=torch.bfloat16), 2,
                                 out_dtype=torch.float16)


# ---------------------------------------------------------------- K3 (v2)
#
# The port's mha_qkv (its plain versions on the CPU) against the JAX
# package's pallas_mha_qkv in interpret mode, which runs _mha2_kernel and,
# through its custom VJP, _mha2_bwd_kernel, at tests/test_models.py:352's
# shape and the ViT shapes. fp32: atol 1e-5, as that test holds it. bf16:
# one bf16 ulp at the largest magnitude: both sides compute in fp32 and
# round each output once, from fp32 sums taken in another order.

K3_CASES = [((2, 16, 4, 8), "float32"), ((2, 16, 4, 8), "bfloat16"),
            ((2, 65, 4, 64), "float32"), ((2, 65, 4, 64), "bfloat16"),
            ((2, 17, 3, 16), "bfloat16")]


def _qkv4_do(shape, seed):
    n, l, h, hd = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, l, 3 * h, hd)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("shape,dtype", K3_CASES)
def test_mha_qkv_matches_jax_pallas_mha_qkv(shape, dtype):
    from cross_scale_mae_tpu.ops.attention import pallas_mha_qkv as jqkv

    x, _ = _qkv4_do(shape, 21)
    h = shape[2]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(jqkv(jnp.asarray(x, jdt), h, True).astype(jnp.float32))
    got = port_attn.mha_qkv(torch.from_numpy(x).to(tdt), h)
    assert got.shape == shape and got.dtype == tdt
    atol = 1e-5 if dtype == "float32" else _bf16_bound(ref)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("shape,dtype", K3_CASES)
def test_mha_qkv_grad_matches_jax_vjp(shape, dtype):
    """dqkv in the qkv layout, through mha_qkv_bwd_reference directly and
    through autograd of mha_qkv, against jax.vjp of pallas_mha_qkv."""
    import jax

    from cross_scale_mae_tpu.ops.attention import pallas_mha_qkv as jqkv

    x, g = _qkv4_do(shape, 22)
    h = shape[2]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a: jqkv(a, h, True), jnp.asarray(x, jdt))
    ref = np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))
    atol = 1e-5 if dtype == "float32" else _bf16_bound(ref)
    direct = port_attn.mha_qkv_bwd_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), h)
    assert direct.shape == x.shape and direct.dtype == tdt
    np.testing.assert_allclose(direct.float().numpy(), ref, rtol=0, atol=atol)
    leaf = torch.from_numpy(x).to(tdt).requires_grad_(True)
    port_attn.mha_qkv(leaf, h).backward(torch.from_numpy(g).to(tdt))
    np.testing.assert_allclose(leaf.grad.float().numpy(), ref, rtol=0, atol=atol)


def test_mha_qkv_saves_only_qkv():
    """The autograd node keeps qkv alone (``_mha2_cvjp_fwd``'s residuals)."""
    qkv = torch.randn(2, 5, 3 * 2, 16, requires_grad=True)
    saved = port_attn.mha_qkv(qkv, 2).grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is qkv
    assert port_attn.pallas_mha_qkv is port_attn.mha_qkv


def test_mha_qkv_keeps_p_and_ds_in_fp32():
    """K3 has K2's numerics: in bf16 its output and dq differ from K1's
    order on the same bytes, which rounds P and dS to bf16."""
    x, g = (torch.from_numpy(a).bfloat16() for a in _qkv4_do((3, 33, 2, 64), 23))
    out = port_attn.mha_qkv_reference(x, 2)
    dq = port_attn.mha_qkv_bwd_reference(x, g, 2)[:, :, :2]
    k1 = port_attn.mha_v3_reference(x.reshape(3, 33, 3 * 128), 2)
    k1_dq = port_attn.mha3_bwd_reference(x.reshape(3, 33, 3 * 128), g.reshape(3, 33, 128), 2)
    assert not torch.equal(out.reshape(3, 33, 128), k1)
    assert not torch.equal(dq.reshape(3, 33, 128), k1_dq[..., :128])


def test_cpu_mha_qkv_never_counts_a_launch():
    before = port_attn.mha_qkv.launches, port_attn.mha_qkv.bwd_launches
    qkv = torch.zeros(1, 4, 3 * 2, 16, requires_grad=True)
    port_attn.mha_qkv(qkv, 2).sum().backward()
    assert (port_attn.mha_qkv.launches, port_attn.mha_qkv.bwd_launches) == before


def test_mha_qkv_rejects_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_attn.mha_qkv(torch.zeros(1, 4, 6, 16, device="meta"), 2)


@pytest.mark.parametrize("make,err,match", [
    (lambda: torch.zeros(1, 4, 6, 32, dtype=torch.float16), TypeError, "bfloat16 or float32"),
    (lambda: torch.zeros(1, 6, 4, 32).transpose(1, 2), ValueError, "contiguous"),
    (lambda: torch.zeros(1, 4, 6, 24), ValueError, "head_dim"),
    (lambda: torch.zeros(1, 4, 5, 32), ValueError, "3H"),
    (lambda: torch.zeros(4, 6, 32), ValueError, "3H"),
    (lambda: torch.zeros(1, 900, 6, 64), ValueError, "shared memory"),
])
def test_mha_qkv_kernel_wrappers_validate_before_launch(make, err, match):
    with pytest.raises(err, match=match):
        port_attn._mha2_fwd_cuda(make(), 2)
    with pytest.raises(err, match=match):
        port_attn._mha2_bwd_cuda(make(), torch.zeros(1, 4, 2, 32), 2)


@pytest.mark.parametrize("make,match", [
    (lambda: torch.zeros(1, 5, 2, 32), "shape"),
    (lambda: torch.zeros(1, 4, 2, 32, dtype=torch.float64), "float32"),
    (lambda: torch.zeros(1, 4, 32, 2).transpose(2, 3), "contiguous"),
])
def test_mha_qkv_bwd_wrapper_validates_do_before_launch(make, match):
    with pytest.raises(ValueError, match=match):
        port_attn._mha2_bwd_cuda(torch.zeros(1, 4, 6, 32), make(), 2)


def test_mha_qkv_shared_memory_is_k1s():
    """K3 runs K1's bodies on K1's rows (the tensor-core ones for bf16,
    the scalar ones for fp32), so K3f's blocks need K1f's shared memory and
    K3b's K1b's and K2b's: the tensor-core layout for bf16, the scalar one
    for fp32. Every head width fits at up to 257 tokens."""
    for l, hd, dt in [(65, 64, torch.bfloat16), (257, 80, torch.float32),
                      (17, 16, torch.bfloat16), (65, 32, torch.float32)]:
        assert port_attn.mha2_smem_bytes(l, hd, dt) == port_attn.mha_smem_bytes(l, hd, dt)
        assert (port_attn.mha2_bwd_smem_bytes(l, hd, dt)
                == port_attn.mha_bwd_smem_bytes(l, hd, dt))
        if dt == torch.float32:
            assert (port_attn.mha2_bwd_smem_bytes(l, hd, dt)
                    == port_attn.mha3_bwd_smem_bytes(l, hd, dt))
    rows = -(-65 // 16) * 16
    assert port_attn.mha2_smem_bytes(65, 64, torch.bfloat16) == 3 * rows * 72 * 2
    assert (port_attn.mha2_bwd_smem_bytes(65, 64, torch.bfloat16)
            == 4 * rows * 72 * 2 + 3 * rows * 4)
    for hd in port_attn.KERNEL_HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            port_attn._check_qkv4(torch.zeros(2, 257, 6, hd, dtype=dt), 2,
                                  port_attn.mha2_bwd_smem_bytes)


def _chip_smoke():
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_reads_spills_from_ptxas_output():
    """chip_smoke.py's [build] gate: each spill line belongs to the function
    named above it, each tensor-core kernel is told apart by its mangled
    name, and the bf16 rows name the header's term count for each kernel."""
    chip_smoke = _chip_smoke()

    text = "\n".join([
        "ptxas info    : Compiling entry function '_Z17mha_fwd_tc_kernelILi64ELb1EE' for 'sm_90a'",
        "ptxas info    : Function properties for _Z17mha_fwd_tc_kernelILi64ELb1EE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Function properties for _Z17mha_fwd_tc_kernelILi80ELb1EE",
        "    24 bytes stack frame, 32 bytes spill stores, 36 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 24 bytes cumulative stack size",
    ])
    assert chip_smoke.ptxas_spills(text) == {"_Z17mha_fwd_tc_kernelILi64ELb1EE": (0, 0, 128),
                                             "_Z17mha_fwd_tc_kernelILi80ELb1EE": (32, 36, 128)}
    assert chip_smoke.tc_design("mha_fwd") == f"mma.sync split-bf16 x{SPLIT_TERMS}"
    assert chip_smoke.tc_design("mha3_fwd") == (
        f"plain-order fp32 FMA logits, mma.sync P V x{K1_SPLIT_TERMS}")
    assert chip_smoke.tc_design("mha_bwd") == (
        f"mma.sync split-bf16 x{SPLIT_TERMS}, rounded slice adds")
    assert chip_smoke.tc_design("mha3_bwd") == (
        f"mma.sync, P and dS in bf16 x{K1_SPLIT_TERMS}, rounded slice adds")
    assert chip_smoke.tc_design("mha2_fwd") == f"mma.sync split-bf16 x{SPLIT_TERMS}"
    assert chip_smoke.tc_design("mha2_bwd") == (
        f"mma.sync split-bf16 x{SPLIT_TERMS}, rounded slice adds")
    # 4 head widths x one sweep or several, x bf16 or fp32 outputs for the
    # three backward kernels: 3 x 8 + 3 x 16 = 72 instantiations.
    assert sum(chip_smoke.TC_KERNELS.values()) == 72
    for symbol, name in [
            ("_ZN12_GLOBAL__N_117mha_fwd_tc_kernelILi64ELb1EEEvPK13__nv_bfloat16S3_S3_PS1_if",
             "mha_fwd_tc_kernel"),
            ("_ZN12_GLOBAL__N_118mha3_fwd_tc_kernelILi32ELb0EEEvPK13__nv_bfloat16PS1_iif",
             "mha3_fwd_tc_kernel"),
            ("_ZN44_GLOBAL__N__5cc1bdea_11_mha3_bwd_cu_b8b0eda518mha3_bwd_tc_kernelILi32ELb1E"
             "13__nv_bfloat16EEvPKS1_S3_PT1_iif", "mha3_bwd_tc_kernel"),
            ("_ZN44_GLOBAL__N__5cc1bdea_11_mha2_fwd_cu_b8b0eda518mha2_fwd_tc_kernelILi64ELb0EEEv"
             "PK13__nv_bfloat16PS1_iif", "mha2_fwd_tc_kernel"),
            ("_ZN44_GLOBAL__N__7d2e1f3a_11_mha2_bwd_cu_0c1d2e3f18mha2_bwd_tc_kernelILi80ELb1EfEEv"
             "PK13__nv_bfloat16S3_PT1_iif", "mha2_bwd_tc_kernel"),
            ("_ZN12_GLOBAL__N_115mha2_bwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_PS2_iif", None),
            ("_ZN12_GLOBAL__N_115mha2_fwd_kernelI13__nv_bfloat16Li64EEEvPKT_PS2_iif", None),
            ("_ZN12_GLOBAL__N_115mha3_fwd_kernelI13__nv_bfloat16Li64EEEvPKT_PS2_iif", None)]:
        assert chip_smoke.tc_instance(symbol) == name
    assert chip_smoke.tc_label(
        "_ZN44_GLOBAL__N__5cc1bdea_11_mha3_bwd_cu_b8b0eda518mha3_bwd_tc_kernelILi32ELb1E"
        "13__nv_bfloat16EEvPKS1_S3_PT1_iif") == "mha3_bwd_tc_kernel<32,1,bf16>"
    assert chip_smoke.tc_label(
        "_ZN43_GLOBAL__N__5a6d6646_10_mha_bwd_cu_880686c317mha_bwd_tc_kernelILi80ELb0EfEEvPK13"
        "__nv_bfloat16S3_S3_S3_PT1_S5_S5_if") == "mha_bwd_tc_kernel<80,0,f32>"
    assert chip_smoke.tc_label("_ZN12_GLOBAL__N_117mha_fwd_tc_kernelILi64ELb1EEEvPK13__nv_bfloat16"
                               "S3_S3_PS1_if") == "mha_fwd_tc_kernel<64,1>"
    assert chip_smoke.tc_label(
        "_ZN44_GLOBAL__N__7d2e1f3a_11_mha2_bwd_cu_0c1d2e3f18mha2_bwd_tc_kernelILi80ELb1EfEEv"
        "PK13__nv_bfloat16S3_PT1_iif") == "mha2_bwd_tc_kernel<80,1,f32>"


def test_chip_smoke_fp64_direct_leaf_separates_plain_from_k1_order(tmp_path):
    """chip_smoke.py's [finetune_grads_fp64] yardstick on the CPU, through the
    port's plain versions: a tiny ViT finetune step (bf16, 'pallas', drop
    path) gives the last block's K2b inputs and its qkv-projection input X;
    the direct leaf X^T (dq | dk | dv) from the plain arithmetic in fp32
    stays within the gate's limit of the same arithmetic in float64, on the
    whole and on each column block, and K1's rounding order (P and dS in
    bf16) reads above it on the whole leaf."""
    from cross_scale_mae_torch.cli.finetune import build_run, get_args_parser

    chip_smoke = _chip_smoke()
    run = build_run(get_args_parser().parse_args([
        "--model", "vit_base_patch16", "--embed_dim", "64", "--depth", "2",
        "--num_heads", "4", "--input_size", "32", "--patch_size", "8",
        "--batch_size", "8", "--synthetic_len", "8", "--nb_classes", "5",
        "--compute_dtype", "bfloat16", "--attention_impl", "pallas",
        "--drop_path", "0.1", "--seed", "0", "--device", "cpu",
        "--output_dir", str(tmp_path)]))
    x, inputs = chip_smoke.k2b_step_inputs(run, run.draws(0)[0],
                                           bwd_name="mha_folded_bwd_reference")
    assert x.shape == (8, 17, 64) and inputs[0].shape == (8 * 4, 17, 16)
    assert all(t.dtype == torch.bfloat16 for t in (x, *inputs))
    assert port_attn.mha_folded_bwd_reference.__name__ == "mha_folded_bwd_reference"
    readings = chip_smoke.fp64_gaps(x, inputs, 4, chip_smoke.FP64_VERSIONS)
    tol = chip_smoke.FP64_LEAF_TOL
    assert tol == 2.0 ** -17
    assert all(readings["plain"][c] <= tol for c in ("leaf", "q", "k", "v")), readings["plain"]
    assert readings["control_k1_order"]["leaf"] > tol, readings["control_k1_order"]
    # dS alone rounded moves only the q and k columns.
    assert readings["control_ds_bf16"]["v"] == readings["plain"]["v"]
    assert readings["control_ds_bf16"]["q"] > tol


def _tiny_pretrain_run(tmp_path):
    """A tiny flagship-style pretrain run on the CPU (bf16, 'pallas_v3'):
    the decoder's 65 tokens in 8 heads of 32, batch 8 (16 rows)."""
    from cross_scale_mae_torch.cli.pretrain import build_run, get_args_parser

    return build_run(get_args_parser().parse_args([
        "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "64", "--patch_size", "8",
        "--batch_size", "8", "--synthetic_len", "8", "--compute_dtype", "bfloat16",
        "--attention_impl", "pallas_v3", "--seed", "0", "--device", "cpu",
        "--output_dir", str(tmp_path)]))


def test_chip_smoke_k1_fp64_direct_leaf_separates_plain_from_controls(tmp_path):
    """chip_smoke.py's [train_grads_fp64] yardstick on the CPU, through the
    port's plain versions: a tiny pretrain step gives the last decoder
    block's K1b inputs (qkv, dO) and its qkv-projection input X; the direct
    leaf X^T dqkv of each version is held against K1's arithmetic in
    float64. Here the plain version stands in the kernel's place, so the
    gate passes on its sound side, and each control reads above
    K1_C_CONTROL x plain on the columns it breaks and equals plain on the
    others; the gate refuses a control put in the kernel's place."""
    chip_smoke = _chip_smoke()
    run = _tiny_pretrain_run(tmp_path)
    x, inputs = chip_smoke.k1b_step_inputs(run, run.draws(0)[0], bwd_name="mha3_bwd_reference")
    assert x.shape == (16, 65, 256)
    assert inputs[0].shape == (16, 65, 768) and inputs[1].shape == (16, 65, 256)
    assert all(t.dtype == torch.bfloat16 for t in (x, *inputs))
    assert port_attn.mha3_bwd_reference.__name__ == "mha3_bwd_reference"
    versions = chip_smoke.K1_FP64_VERSIONS
    readings = chip_smoke.k1_fp64_gaps(x, inputs, 8, {"kernel": versions["plain"], **versions})
    assert (chip_smoke.K1_C_SOUND, chip_smoke.K1_C_CONTROL) == (4.0, 16.0)
    chip_smoke.k1_fp64_gate(readings)
    plain = readings["plain"]
    assert readings["kernel"] == plain
    for name, cols, others in (("control_ds_fp32", "qk", "v"), ("control_p_fp32", "v", "qk")):
        assert all(readings[name][c] > chip_smoke.K1_C_CONTROL * plain[c] for c in cols), name
        assert all(readings[name][c] == plain[c] for c in others), name
        with pytest.raises(AssertionError, match="K1b's direct leaf"):
            chip_smoke.k1_fp64_gate({**readings, "kernel": readings[name]})


@pytest.mark.parametrize("shape", [(3, 65, 4, 32), (4, 17, 6, 64), (2, 257, 2, 80)])
def test_chip_smoke_k1_bwd_math_rounded_is_its_plain_version(shape):
    """chip_smoke.py's k1_bwd_math in fp32 with K1's two roundings, its dqkv
    rounded to bf16, is mha3_bwd_reference bit for bit; with neither
    rounding it is K3's plain backward (K2's order) on the same bytes."""
    chip_smoke = _chip_smoke()
    n, l, h, hd = shape
    rng = np.random.default_rng(31)
    qkv = torch.from_numpy(rng.normal(size=(n, l, 3 * h * hd)).astype(np.float32)).bfloat16()
    do = torch.from_numpy(rng.normal(size=(n, l, h * hd)).astype(np.float32)).bfloat16()
    got = chip_smoke.k1_bwd_math(qkv, do, h)
    assert got.dtype == torch.float32 and got.shape == qkv.shape
    assert torch.equal(got.bfloat16(), port_attn.mha3_bwd_reference(qkv, do, h))
    k2 = chip_smoke.k1_bwd_math(qkv, do, h, round_p=False, round_ds=False).bfloat16()
    k3 = port_attn.mha_qkv_bwd_reference(qkv.view(n, l, 3 * h, hd), do.view(n, l, h, hd), h)
    assert torch.equal(k2, k3.reshape(n, l, 3 * h * hd))


@pytest.mark.parametrize("shape", [(2, 17, 3, 16), (2, 65, 4, 32)])
def test_chip_smoke_k3b_fp64_reading_separates_plain_from_k1_order(shape):
    """chip_smoke.py's float64 reading of K3b's outputs on the CPU, at small
    K3 shapes: dq, dk and dv of K2's arithmetic in fp32 (the plain version,
    here in the kernel's place) each within FP64_LEAF_TOL of the same
    arithmetic in float64 on the same bytes, K1's rounding order above it
    on each; the gate passes on the sound side and refuses K1's order put
    in the kernel's place. The fp32 plain version rounded is
    mha_qkv_bwd_reference bit for bit."""
    chip_smoke = _chip_smoke()
    n, l, h, hd = shape
    rng = np.random.default_rng(37)
    qkv = torch.from_numpy(rng.normal(size=(n, l, 3 * h, hd)).astype(np.float32)).bfloat16()
    do = torch.from_numpy(rng.normal(size=(n, l, h, hd)).astype(np.float32)).bfloat16()
    versions = chip_smoke.K3_FP64_VERSIONS
    plain = versions["plain"](qkv, do, h)
    assert all(t.dtype == torch.float32 and t.shape == (n, h, l, hd) for t in plain)
    assert torch.equal(torch.cat([t.transpose(1, 2).bfloat16() for t in plain], dim=2),
                       port_attn.mha_qkv_bwd_reference(qkv, do, h))
    readings = chip_smoke.k3b_fp64_gaps(qkv, do, h, {"kernel": versions["plain"], **versions})
    tol = chip_smoke.FP64_LEAF_TOL
    assert tol == 2.0 ** -17
    chip_smoke.k3b_fp64_gate("cpu", readings)
    for o in ("dq", "dk", "dv"):
        assert readings["plain"][o] <= tol < readings["control_k1_order"][o], (o, readings)
    with pytest.raises(AssertionError, match="against float64"):
        chip_smoke.k3b_fp64_gate("cpu", {**readings, "kernel": readings["control_k1_order"]})


def _k3b_stand_in(math):
    """A CPU stand-in for ``_mha2_bwd_cuda`` from one of chip_smoke's K3b
    versions: its fp32 (dq, dk, dv) written in the qkv layout, rounded to
    the input dtype unless ``out_dtype`` asks for fp32."""
    def bwd(qkv, do, num_heads, out_dtype=None):
        grads = math(qkv, do, num_heads)
        return torch.cat([g.transpose(1, 2) for g in grads], dim=2).to(out_dtype or qkv.dtype)
    return bwd


def test_chip_smoke_k3b_gates_pass_plain_and_refuse_k1_order(monkeypatch):
    """chip_smoke.py's K3b [kernel] gates (k3b_gates) rehearsed on the CPU,
    with the card's wrapper replaced by a stand-in: K2's arithmetic in fp32,
    its bf16 outputs rounded from its fp32 ones, passes every gate (one
    ulp, mean, second launch, rounded tie, float64); K1's order in its
    place is refused."""
    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(41)
    qkv = torch.from_numpy(rng.normal(size=(2, 17, 9, 16)).astype(np.float32)).bfloat16()
    do = torch.from_numpy(rng.normal(size=(2, 17, 3, 16)).astype(np.float32)).bfloat16()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    versions = chip_smoke.K3_FP64_VERSIONS
    monkeypatch.setattr(port_attn, "_mha2_bwd_cuda", _k3b_stand_in(versions["plain"]))
    dqkv, outputs, fp64 = chip_smoke.k3b_gates("cpu", qkv, do, 3)
    assert torch.equal(dqkv, port_attn.mha_qkv_bwd_reference(qkv, do, 3))
    assert all(r["rel_mean_err"] == 0.0 for r in outputs.values())
    assert set(fp64) == {"kernel", *versions}
    monkeypatch.setattr(port_attn, "_mha2_bwd_cuda",
                        _k3b_stand_in(versions["control_k1_order"]))
    with pytest.raises(AssertionError, match="mean abs err"):
        chip_smoke.k3b_gates("cpu", qkv, do, 3)
