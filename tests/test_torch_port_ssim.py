"""The port's SSIM, MS-SSIM, the SSIM family of reconstruction losses and
the reconstruction metrics, held against the JAX package on the CPU
(``cross_scale_mae_tpu/ops/ssim.py``, ``losses/recon.py``,
``utils/metrics.py``) and against ``tests/torch_msssim_ref.py``'s
transcription of pytorch_msssim as a third witness.

Inputs come from numpy seeds and reach both packages as numpy.

Tolerances, each with its reason:
* SSIM and MS-SSIM values, fp32: abs 2e-6. The two sides differ in the
  order of fp32 sums (the blur's taps, the spatial means); values are ~1.
  MS-SSIM against the witness: abs 5e-6. Its product of five levels'
  means raised to the weights carries each fp32 side's error from the
  exact value (2.6e-6 for these inputs against float64), and the witness
  sums in another order than the two packages.
* The gradient of 1 - SSIM: abs 1e-5 * max|g|. Each element sums the
  derivatives of the five blurred maps over the two 11-tap passes, a few
  hundred terms larger than their sum, in another fp32 order.
* The SSIM losses: abs 2e-6 on values of magnitude ~1, as above.
* The metrics: rel 1e-5 (mse, mae, l1, l2 sum a few thousand fp32 terms in
  another order), abs 2e-6 for ssim and ms_ssim.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu.ops import ssim as jssim
from cross_scale_mae_torch.ops import ssim as pssim
from tests import torch_msssim_ref as ref_msssim


def _pair(rng, shape, straddle=False):
    """Two NHWC images in [0, 1]; with ``straddle`` channel 0 of y is the
    negative of x's (a negative per-channel SSIM) and the others x plus a
    little noise (a positive one)."""
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    if straddle:
        y[..., 0] = 1.0 - x[..., 0]
    return x, y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


CASES = [  # (shape, straddle, size_average, nonnegative)
    ((2, 24, 24, 3), False, True, False),
    ((2, 23, 29, 3), True, True, False),
    ((2, 23, 29, 3), True, True, True),
    ((3, 21, 17, 2), True, False, False),
    ((3, 21, 17, 2), True, False, True),
]


@pytest.mark.parametrize("shape,straddle,size_average,nonneg", CASES)
def test_ssim_matches_jax_and_pytorch_msssim(shape, straddle, size_average, nonneg):
    x, y = _pair(np.random.default_rng(sum(shape)), shape, straddle)
    kw = dict(data_range=1.0, size_average=size_average, nonnegative_ssim=nonneg)
    want = np.asarray(jssim.ssim(jnp.asarray(x), jnp.asarray(y), **kw))
    got = pssim.ssim(_t(x), _t(y), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    witness = ref_msssim.ssim(_t(x).permute(0, 3, 1, 2), _t(y).permute(0, 3, 1, 2), **kw)
    np.testing.assert_allclose(got, witness.numpy(), rtol=0, atol=2e-6)
    if straddle and not nonneg:
        # The channels straddle zero, so the clamp's place matters.
        per_channel = pssim.ssim(_t(x), _t(y), size_average=False)
        assert float(pssim.ssim(_t(x), _t(y), nonnegative_ssim=True)) != float(
            per_channel.mean())


@pytest.mark.parametrize("shape,size_average", [((2, 167, 171, 3), True),
                                                ((1, 176, 161, 2), False)])
def test_ms_ssim_matches_jax_and_pytorch_msssim_at_odd_sizes(shape, size_average):
    x, y = _pair(np.random.default_rng(3), shape, straddle=True)
    want = np.asarray(jssim.ms_ssim(jnp.asarray(x), jnp.asarray(y),
                                    size_average=size_average))
    got = pssim.ms_ssim(_t(x), _t(y), size_average=size_average).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    witness = ref_msssim.ms_ssim(_t(x).permute(0, 3, 1, 2), _t(y).permute(0, 3, 1, 2),
                                 size_average=size_average)
    np.testing.assert_allclose(got, witness.numpy(), rtol=0, atol=5e-6)


def test_avg_pool_pads_odd_dims_as_jax():
    x = np.random.default_rng(4).normal(size=(2, 7, 10, 3)).astype(np.float32)
    want = np.asarray(jssim._avg_pool_2x(jnp.asarray(x)))
    got = pssim._avg_pool_2x(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_ms_ssim_refuses_160_px_as_jax():
    x = np.zeros((1, 160, 200, 3), np.float32)
    with pytest.raises(AssertionError):
        jssim.ms_ssim(jnp.asarray(x), jnp.asarray(x))
    with pytest.raises(ValueError, match="too small"):
        pssim.ms_ssim(_t(x), _t(x))
    x = np.full((1, 161, 161, 3), 0.5, np.float32)
    assert float(pssim.ms_ssim(_t(x), _t(x))) == pytest.approx(1.0, abs=1e-6)


def test_gaussian_window_matches_jax():
    np.testing.assert_array_equal(pssim._gaussian_window(11, 1.5),
                                  jssim._gaussian_window(11, 1.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_window_and_weights_are_made_once_per_device_and_dtype(dtype):
    """The window and the MS-SSIM weights are copied to the device once:
    a second call returns the same tensor, with the JAX window's values
    and the weights cast from fp32 as before."""
    like = torch.zeros((), dtype=dtype)
    first = pssim._window(11, 1.5, like)
    assert pssim._window(11, 1.5, like) is first
    assert first.dtype == dtype
    np.testing.assert_array_equal(first.numpy(),
                                  jssim._gaussian_window(11, 1.5).astype(first.numpy().dtype))
    weights = pssim.device_constant(pssim.MS_SSIM_WEIGHTS, like.device, dtype, torch.float32)
    assert pssim.device_constant(pssim.MS_SSIM_WEIGHTS, like.device, dtype,
                                 torch.float32) is weights
    assert torch.equal(weights, torch.tensor(pssim.MS_SSIM_WEIGHTS,
                                             dtype=torch.float32).to(dtype))


def test_ssim_gradient_matches_jax_grad():
    x, y = _pair(np.random.default_rng(5), (2, 19, 22, 3), straddle=True)
    want = np.asarray(jax.grad(lambda a: 1.0 - jssim.ssim(a, jnp.asarray(y)))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    (1.0 - pssim.ssim(xt, _t(y))).backward()
    got = xt.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", ["ssim", "ms_ssim", "mse_ssim", "mse_ms_ssim"])
@pytest.mark.parametrize("masked,norm_pix", [(True, False), (False, False), (True, True)])
def test_ssim_family_losses_match_jax(name, masked, norm_pix):
    from cross_scale_mae_tpu.losses.recon import process_target as jtarget
    from cross_scale_mae_tpu.losses.recon import recon_loss as jloss
    from cross_scale_mae_torch.losses.recon import process_target, recon_loss

    rng = np.random.default_rng(6)
    size, p = (176, 16) if "ms_ssim" in name else (32, 8)
    imgs = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    pred = rng.normal(size=(2, (size // p) ** 2, p * p * 3)).astype(np.float32)
    mask = (rng.uniform(size=pred.shape[:2]) < 0.75).astype(np.float32) if masked else None
    jt = jtarget(jnp.asarray(imgs), p, 3, norm_pix)
    want = float(jloss(name, jt, jnp.asarray(pred), None if mask is None else jnp.asarray(mask),
                       patch_size=p, channels=3))
    pt = process_target(_t(imgs), p, 3, norm_pix)
    got = float(recon_loss(name, pt, _t(pred), None if mask is None else _t(mask),
                           patch_size=p, channels=3))
    assert got == pytest.approx(want, abs=2e-6)


@pytest.mark.parametrize("name", ["mse", "mae", "l1", "l2", "ssim", "ms_ssim", "ssd", "sad",
                                  "SSIM"])
def test_calc_metric_matches_jax(name):
    from cross_scale_mae_tpu.utils.metrics import METRICS_DICT as JDICT
    from cross_scale_mae_tpu.utils.metrics import calc_metric as jmetric
    from cross_scale_mae_torch.utils.metrics import METRICS_DICT, calc_metric

    size = 168 if name == "ms_ssim" else 24
    x, y = _pair(np.random.default_rng(7), (2, size, size, 3))
    want, got = jmetric(x, y, name), calc_metric(x, y, name)
    if name.lower() in ("ssim", "ms_ssim"):
        assert got == pytest.approx(want, abs=2e-6)
    else:
        assert got == pytest.approx(want, rel=1e-5)
    assert {k: (v["full_name"], v["is_lower_better"]) for k, v in METRICS_DICT.items()} == {
        k: (v["full_name"], v["is_lower_better"]) for k, v in JDICT.items()}
