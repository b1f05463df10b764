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
    # 2*hd + 2*L fp32 (csrc/mha3_bwd.cu smem_bytes): 28*L + 16*hd bytes
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
    # L fp32 score rows (csrc/mha3_fwd.cu smem_bytes).
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
