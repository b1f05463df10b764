"""The PyTorch port's RandAugment, ColorJitter and RandomErasing
(cross_scale_mae_torch/ops/randaug.py) and the finetune chain that runs
them (ops/augment.make_finetune_augment) held against the JAX package's
ops/randaug.py and ops/augment.py on the CPU, on seeded numpy images.

JAX's key splits cannot be reproduced in torch, so each test rebuilds the
JAX draws from the JAX keys in the JAX order and hands them to the port.

Tolerances: the integer-valued ops (autocontrast, equalize, invert,
posterize, solarize, solarize_add, brightness) bit-equal in fp32; the ops
with a gray mean or a 3x3 sum 2.4e-7 (two fp32 ulps at 1: the sums run in
another order); the affine 2e-6 (grid_sample's normalized coordinates
round the source position); whole chains 2e-6 in fp32.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu.ops import randaug as J
from cross_scale_mae_torch.ops import randaug as P

EXACT = {"autocontrast", "equalize", "invert", "posterize", "solarize", "solarize_add",
         "brightness"}
SUM_TOL = 2.4e-7
AFFINE_TOL = 2e-6
CHAIN_TOL = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, n=6, h=12, w=10, c=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, h, w, c)).astype(np.float32)
    x[0, ..., 1] = 0.3                                   # a constant channel
    x[1] = np.round(x[1] * 255) / 255                    # exact 8-bit values
    x[2, :, :, 0] = np.where(x[2, :, :, 0] > 0.5, 1.0, 0.0)   # two levels
    return x


def _mag_sign(seed, n=6):
    rng = np.random.default_rng(seed)
    m = rng.uniform(0, 1, n).astype(np.float32)
    m[:2] = (0.0, 1.0)
    return m, np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("name", [name for name, _ in J._PIXEL_OPS])
@pytest.mark.parametrize("channels", [3, 4])
def test_pixel_op_matches_jax(name, channels):
    """Each of the ten pixel ops on the same images, magnitudes and signs,
    with 3 channels (the gray weights) and 4 (the channel mean)."""
    x = _images(1, c=channels)
    m, sign = _mag_sign(2)
    jfn = dict(J._PIXEL_OPS)[name]
    pfn = dict(P.PIXEL_OPS)[name]
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(m), jnp.asarray(sign)))
    got = pfn(_t(x), _t(m), _t(sign))
    assert got.dtype == torch.float32 and got.shape == x.shape
    if name in EXACT:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=SUM_TOL)


def test_equalize_and_posterize_are_bit_equal_on_every_level():
    """Equalize on images holding every 8-bit value, a flat one (PIL's step
    of 0, the identity LUT) and a two-level one; posterize at every bit
    count: bit-equal to JAX."""
    levels = np.arange(256, dtype=np.float32) / 255.0
    x = np.stack([np.resize(levels, (16, 16, 3)), np.full((16, 16, 3), 0.2, np.float32),
                  np.resize(np.array([0.0, 1.0], np.float32), (16, 16, 3)),
                  np.resize(levels[::7], (16, 16, 3))])
    m = np.array([0.0, 0.3, 0.6, 0.99], np.float32)
    sign = np.ones(4, np.float32)
    for name in ("equalize", "posterize"):
        ref = np.asarray(dict(J._PIXEL_OPS)[name](jnp.asarray(x), jnp.asarray(m),
                                                  jnp.asarray(sign)))
        got = dict(P.PIXEL_OPS)[name](_t(x), _t(m), _t(sign)).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_affine_params_match_jax():
    m, sign = _mag_sign(3, n=7)
    op = np.array([10, 11, 12, 13, 14, 3, 10])
    ref = J._affine_params(jnp.asarray(op), jnp.asarray(m), jnp.asarray(sign), 12, 10)
    got = P.affine_params(_t(op), _t(m), _t(sign), 12, 10)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=6e-8)
    # A pixel op's index gets the identity.
    assert [float(v[5]) for v in got] == [1.0, 0.0, 0.0, 1.0, 0.0, 0.0]


@pytest.mark.parametrize("case", ["rotate", "translate_out", "shear", "border"])
def test_affine_sample_matches_map_coordinates_at_the_borders(case):
    """The bilinear resample with mid-gray fill against JAX map_coordinates
    (order 1, constant 0.5): a rotation, translations that move the image
    partly and wholly out of the frame (taps out of bounds take the fill), a
    shear, and sources landing exactly on the first and last row and column."""
    x = _images(4, n=4, h=9, w=11)
    n = 4
    one, zero = np.ones(n, np.float32), np.zeros(n, np.float32)
    if case == "rotate":
        th = np.array([0.3, -0.5, 0.52, 1.0], np.float32)
        a = (np.cos(th), -np.sin(th), np.sin(th), np.cos(th), zero, zero)
    elif case == "translate_out":
        a = (one, zero, zero, one, np.array([0.0, 4.5, -9.0, 20.0], np.float32),
             np.array([5.5, -2.25, 11.0, 0.0], np.float32))
    elif case == "shear":
        a = (one, np.array([0.3, -0.3, 0.1, 0.0], np.float32),
             np.array([0.0, 0.2, -0.27, 0.3], np.float32), one, zero, zero)
    else:
        # Sources on whole pixels: the first/last row and column and one past them.
        a = (one, zero, zero, one, np.array([-4.0, 4.0, -5.0, 1.0], np.float32),
             np.array([5.0, -5.0, 0.0, -6.0], np.float32))
    ref = np.asarray(J._affine_sample(jnp.asarray(x), *(jnp.asarray(v) for v in a)))
    got = P.affine_sample(_t(x), *(_t(v) for v in a)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=AFFINE_TOL)
    if case == "translate_out":
        # Sample 3 is moved wholly out of the frame: every pixel is the fill.
        np.testing.assert_allclose(got[3], 0.5, atol=1e-6)


def _jax_randaug_draws(key, n, cfg):
    """rand_augment's per-layer draws (randaug.py:283-298)."""
    ops, mags, signs, applies = [], [], [], []
    for layer in range(cfg.num_layers):
        k_op, k_mag, k_sign, k_apply = jax.random.split(jax.random.fold_in(key, layer), 4)
        ops.append(np.asarray(jax.random.randint(k_op, (n,), 0, J.NUM_OPS)))
        mags.append(np.asarray(jax.random.normal(k_mag, (n,))))
        signs.append(np.asarray(jax.random.bernoulli(k_sign, 0.5, (n,))))
        applies.append(np.asarray(jax.random.bernoulli(k_apply, 0.5, (n,))))
    return P.RandAugDraws(_t(np.stack(ops)).long(), _t(np.stack(mags)),
                          _t(np.stack(signs)), _t(np.stack(applies)))


@pytest.mark.parametrize("spec,seed", [("rand-m9-mstd0.5-inc1", 5), ("rand-m9-mstd0.5", 6),
                                       ("rand-n3-m7-mstd1.0", 7), ("rand-m10-mstd0", 8)])
def test_rand_augment_matches_jax_on_injected_draws(spec, seed):
    """rand_augment over a batch of 24 with the JAX draws injected; each
    op runs once on its own samples here, every op on every sample there."""
    cfg, pcfg = J.parse_rand_augment(spec), P.parse_rand_augment(spec)
    assert tuple(pcfg) == tuple(cfg)
    x = np.random.default_rng(seed).uniform(0, 1, (24, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(seed)
    draws = _jax_randaug_draws(key, 24, cfg)
    ref = np.asarray(J.rand_augment(key, jnp.asarray(x), cfg))
    got = P.rand_augment(_t(x), draws, pcfg)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=CHAIN_TOL)
    assert not np.array_equal(got.numpy(), x)   # some op applied
    # The input is not written.
    np.testing.assert_array_equal(_t(x).numpy(), x)


def test_parse_rand_augment_matches_jax_and_refuses_the_same():
    for spec in (None, "", "rand-m9-mstd0.5-inc1", "rand-n1-m3", "rand-mstd0.2-inc0"):
        assert P.parse_rand_augment(spec) == (None if J.parse_rand_augment(spec) is None
                                              else P.RandAugmentConfig(
                                                  *J.parse_rand_augment(spec)))
    for spec in ("v0", "rand-x3"):
        with pytest.raises(ValueError):
            J.parse_rand_augment(spec)
        with pytest.raises(ValueError):
            P.parse_rand_augment(spec)


@pytest.mark.parametrize("factor", [0.4, 1.3])
def test_color_jitter_matches_jax(factor):
    x = np.random.default_rng(9).uniform(0, 1, (8, 12, 12, 3)).astype(np.float32)
    key = jax.random.key(10)
    lo, hi = max(0.0, 1.0 - factor), 1.0 + factor
    ks = jax.random.split(key, 3)
    factors = np.stack([np.asarray(jax.random.uniform(k, (8,), minval=lo, maxval=hi))
                        for k in ks], axis=1)
    ref = np.asarray(J.color_jitter(key, jnp.asarray(x), factor))
    got = P.color_jitter(_t(x), _t(factors)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SUM_TOL * 2)


def _jax_erase_draws(key, n, shape, prob, mode, count):
    """random_erasing's draws (randaug.py:347-370)."""
    apply = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, count), prob, (n,)))
    area, log_ar, ys, xs, noise = [], [], [], [], []
    for r in range(count):
        _, k_area, k_aspect, k_y, k_x, k_noise = jax.random.split(jax.random.fold_in(key, r), 6)
        area.append(np.asarray(jax.random.uniform(k_area, (n,), minval=0.02, maxval=1 / 3)))
        log_ar.append(np.asarray(jax.random.uniform(
            k_aspect, (n,), minval=jnp.log(0.3), maxval=jnp.log(10 / 3))))
        ys.append(np.asarray(jax.random.uniform(k_y, (n,))))
        xs.append(np.asarray(jax.random.uniform(k_x, (n,))))
        noise.append(np.asarray(jax.random.normal(k_noise, shape, jnp.float32)))
    return P.EraseDraws(_t(apply), _t(np.stack(area)), _t(np.stack(log_ar)), _t(np.stack(ys)),
                        _t(np.stack(xs)), _t(np.stack(noise)) if mode == "pixel" else None)


@pytest.mark.parametrize("mode,count", [("pixel", 1), ("const", 1), ("pixel", 3), ("const", 2)])
def test_random_erasing_matches_jax(mode, count):
    """Both modes, one and several rectangles: bit-equal (the fill is the
    JAX noise, or 0; the rectangles are the same comparisons)."""
    x = np.random.default_rng(11).normal(size=(10, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(12 + count)
    draws = _jax_erase_draws(key, 10, x.shape, 0.6, mode, count)
    ref = np.asarray(J.random_erasing(key, jnp.asarray(x), 0.6, mode=mode, count=count))
    got = P.random_erasing(_t(x), draws, mode).numpy()
    np.testing.assert_array_equal(got, ref)
    erased = (got != x).any(axis=(1, 2, 3))
    assert erased.any() and not erased[~draws.apply.numpy()].any()


def test_sampled_draws_have_the_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    cfg = P.parse_rand_augment("rand-n2-m9-mstd0.5")
    ra = P.sample_randaug_draws(gen, 400, cfg)
    assert ra.op.shape == (2, 400) and ra.op.min() >= 0 and ra.op.max() < P.NUM_OPS
    assert 0.4 < ra.apply.float().mean() < 0.6 and 0.4 < ra.sign.float().mean() < 0.6
    f = P.sample_jitter_factors(gen, 400, 0.4)
    assert f.shape == (400, 3) and f.min() >= 0.6 and f.max() <= 1.4
    e = P.sample_erase_draws(gen, 400, 8, 3, 0.25, "pixel", 2)
    assert e.noise.shape == (2, 400, 8, 8, 3) and e.noise.dtype == torch.float32
    assert 0.15 < e.apply.float().mean() < 0.35
    assert e.area.min() >= 0.02 and e.area.max() <= 1 / 3
    assert e.log_aspect.min() >= math.log(0.3) and e.log_aspect.max() <= math.log(10 / 3)
    assert P.sample_erase_draws(gen, 4, 8, 3, 0.25, "const").noise is None
    with pytest.raises(ValueError, match="mode"):
        P.sample_erase_draws(gen, 4, 8, 3, 0.25, "zeros")


# ---------------------------------------------------------------- the chain


def _jax_chain_draws(key, n, canvas, size, channels, *, aa=None, jitter=None, reprob=0.0,
                     remode="pixel", recount=1, rot90=False):
    """make_finetune_augment's draws from ``key`` (augment.py:98-113)."""
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes as jboxes

    k_flip, k_rot, k_crop, k_aa, k_erase = jax.random.split(key, 5)
    kh, kv = jax.random.split(k_flip)
    flips = [_t(jax.random.bernoulli(k, 0.5, (n,))) for k in (kh, kv)]
    boxes = _t(jboxes(k_crop, n, canvas, canvas, (0.25, 1.0)))
    rot = _t(jax.random.randint(k_rot, (n,), 0, 4)) if rot90 else None
    extra = {}
    if aa:
        extra["randaug"] = _jax_randaug_draws(k_aa, n, J.parse_rand_augment(aa))
    elif jitter:
        lo, hi = max(0.0, 1.0 - jitter), 1.0 + jitter
        extra["jitter"] = _t(np.stack([np.asarray(jax.random.uniform(k, (n,), minval=lo,
                                                                     maxval=hi))
                                       for k in jax.random.split(k_aa, 3)], axis=1))
    if reprob > 0:
        extra["erase"] = _jax_erase_draws(k_erase, n, (n, size, size, channels), reprob,
                                          remode, recount)
    return (*flips, boxes, rot), extra


@pytest.mark.parametrize("kw", [
    dict(aa="rand-m9-mstd0.5-inc1", reprob=0.25),
    dict(aa="rand-m9-mstd0.5", color_jitter=0.4, reprob=0.5, remode="const", recount=2),
    dict(color_jitter=0.4),
    dict(color_jitter=0.4, reprob=0.25, rot90=True),
    dict(aa="rand-m7-mstd0.5", rot90=True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finetune_chain_with_extras_matches_jax(kw, dtype):
    """flips -> rot90 -> bicubic RRC -> RandAugment, or else ColorJitter
    (RandAugment disables jitter) -> normalize -> RandomErasing -> cast,
    against the JAX chain with its draws injected. bf16: the one cast at
    the end, 2**-7 relative of the largest value (with the erasing noise in
    fp32 before it)."""
    from cross_scale_mae_tpu.ops.augment import make_finetune_augment as jaug
    from cross_scale_mae_torch.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_torch.ops.augment import make_finetune_augment

    n, canvas, size = 12, 20, 16
    batch = np.random.default_rng(13).integers(0, 256, (n, canvas, canvas, 3), np.uint8)
    key = jax.random.key(14)
    ref = jaug(FMOW_RGB_MEAN, FMOW_RGB_STD, size, dtype=dtype, **kw)(key, jnp.asarray(batch))
    ref = np.asarray(ref.astype(jnp.float32))
    base, extra = _jax_chain_draws(key, n, canvas, size, 3, aa=kw.get("aa"),
                                   jitter=kw.get("color_jitter"), reprob=kw.get("reprob", 0.0),
                                   remode=kw.get("remode", "pixel"),
                                   recount=kw.get("recount", 1), rot90=kw.get("rot90", False))
    aug = make_finetune_augment(FMOW_RGB_MEAN, FMOW_RGB_STD, size, dtype=dtype, **kw)
    got = aug(torch.from_numpy(batch), *base, **extra)
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, size, size, 3)
    atol = CHAIN_TOL * 4 if dtype == "float32" else 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)
    # The extras the chain samples for are those it runs.
    assert set(aug.extras.sample(torch.Generator().manual_seed(0), n, size, 3)) == set(extra)


def test_finetune_chain_needs_the_draws_of_its_extras():
    from cross_scale_mae_torch.ops.augment import make_finetune_augment

    aug = make_finetune_augment((0.5,) * 3, (0.5,) * 3, 8, aa="rand-m9-mstd0.5", reprob=0.25)
    batch = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    flips = torch.zeros(2, dtype=torch.bool)
    boxes = torch.tensor([[0.0, 0.0, 8.0, 8.0]] * 2)
    with pytest.raises(ValueError, match="RandAugment"):
        aug(batch, flips, flips, boxes)
    with pytest.raises(ValueError, match="rand"):
        make_finetune_augment((0.5,) * 3, (0.5,) * 3, 8, aa="v0")
