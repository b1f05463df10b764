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
    (up to 257 tokens), in fp32 and bf16: the backward block fits an H100
    block wherever the training forward runs."""
    from cross_scale_mae_torch.configs import VIT_SIZES

    for size in VIT_SIZES.values():
        for d, h in ((size.dim_model, size.encoder_num_heads),
                     (size.decoder_embed_dim, size.decoder_num_heads)):
            for l in (17, 65, 257):
                for dt in (torch.float32, torch.bfloat16):
                    assert port_attn.mha3_bwd_smem_bytes(l, d // h, dt) <= port_attn.MAX_SMEM_BYTES


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
    """K2 shares K1's shared-memory layouts: every head width of the ViT
    sizes at up to 257 tokens fits an H100 block, forward and backward."""
    for hd in port_attn.KERNEL_HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            assert port_attn.mha3_bwd_smem_bytes(257, hd, dt) <= port_attn.MAX_SMEM_BYTES
            port_attn._check_folded((torch.zeros(2, 257, hd, dtype=dt),) * 4,
                                    port_attn.mha3_bwd_smem_bytes)


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
    """K3 runs the shared bodies on K1's rows, so its blocks need K1's
    shared memory, and every head width fits at up to 257 tokens."""
    for l, hd, dt in [(65, 64, torch.bfloat16), (257, 80, torch.float32)]:
        assert port_attn.mha2_smem_bytes(l, hd, dt) == port_attn.mha3_smem_bytes(l, hd, dt)
        assert (port_attn.mha2_bwd_smem_bytes(l, hd, dt)
                == port_attn.mha3_bwd_smem_bytes(l, hd, dt))
    for hd in port_attn.KERNEL_HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            port_attn._check_qkv4(torch.zeros(2, 257, 6, hd, dtype=dt), 2,
                                  port_attn.mha2_bwd_smem_bytes)
