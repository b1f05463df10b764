"""The PyTorch port's model path held against the JAX package on the CPU:
configs, dataset stats, patchify, pos tables, eval preprocessing, the
transformer block and the unmasked encoder.

Sizes are small (input 32, patch 8, 2 layers, width 64, 4 heads); inputs and
weights come from a numpy seed and go through both packages as numpy.

Tolerances:
* fp32: 1e-5 absolute on outputs of magnitude ~1 (block, encoder); the two
  sides differ in the order of fp32 sums (matmuls, LayerNorm statistics)
  and in the last bits of exp/erf/tanh.
* bf16: the port computes GELU with PyTorch's fused op (fp32 inside, one
  rounding), LayerNorm with fp32 statistics and matmuls with fp32
  accumulation. JAX on the CPU rounds each op of its GELU to bf16, and
  PyTorch's and JAX's bf16 GELU differ by up to several ulps on some inputs
  (ROADMAP.md, queue 3). So bf16 is held to a stated error budget instead of
  bit equality: a block's output to 2**-5 * max(1, max|ref|) (four bf16
  ulps at the largest magnitude), the 2-layer encoder to 2**-4 * max(1,
  max|ref|), and in both the mean absolute error to one bf16 ulp at the
  mean magnitude, 2**-7 * max(1, mean|ref|). Linear layers, LayerNorm and
  attention match JAX bit for bit in bf16 on the CPU; GELU alone differs.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_tpu.models import layers as jlayers
from cross_scale_mae_torch import configs as pcfg
from cross_scale_mae_torch.models import layers as players

GELUS = ("tanh", "exact", "exact_tanhbwd")
IMPLS = ("pallas_v3", "xla")
DTYPES = ("float32", "bfloat16")


def _tiny(**kw):
    base = dict(input_size=32, patch_size=8, dim_model=64, encoder_num_layers=2,
                encoder_num_heads=4, decoder_embed_dim=32, decoder_num_layers=1,
                decoder_num_heads=4, predictor_hidden_size=32)
    base.update(kw)
    return base


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _block_params(rng, d, hidden):
    def lin(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(o,))).astype(np.float32)}

    def norm():
        return {"scale": (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(d,))).astype(np.float32)}

    return {"norm1": norm(), "attn": {"qkv": lin(d, 3 * d), "proj": lin(d, d)},
            "norm2": norm(), "mlp": {"fc1": lin(d, hidden), "fc2": lin(hidden, d)}}


def _assert_close(got: torch.Tensor, ref: np.ndarray, dtype: str, budget: float):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    if dtype == "float32":
        assert err.max() <= 1e-5, err.max()
    else:
        assert err.max() <= budget * max(1.0, np.abs(ref).max()), err.max()
        assert err.mean() <= 2.0 ** -7 * max(1.0, np.abs(ref).mean()), err.mean()


# ------------------------------------------------------------ configs, data


def test_config_fields_and_json_round_trip():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.MAEConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pcfg.MAEConfig)}
    assert jf == pf
    assert pcfg.GELU_MODES == jcfg.GELU_MODES
    assert {k: dataclasses.astuple(v) for k, v in pcfg.VIT_SIZES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jcfg.VIT_SIZES.items()}
    for name in jcfg.mae_model_names():
        j = jcfg.get_mae_config(name, attention_impl="pallas_v3")
        p = pcfg.MAEConfig.from_json(j.to_json())
        assert p == pcfg.get_mae_config(name, attention_impl="pallas_v3")
        assert jcfg.MAEConfig.from_json(p.to_json()) == j


def test_config_from_json_shims():
    d = json.loads(jcfg.MAEConfig(sequence_parallel=True).to_json())
    del d["gelu"]
    p = pcfg.MAEConfig.from_json(json.dumps(d))
    assert p.gelu == "exact" and p.sequence_parallel is False
    d["gelu"] = "nope"
    with pytest.raises(ValueError, match="gelu"):
        pcfg.MAEConfig.from_json(json.dumps(d))


def test_dataset_stats_match():
    from cross_scale_mae_tpu.data import datasets as jd
    from cross_scale_mae_torch.data import datasets as pd

    assert pd.DATASET_STATS == jd.DATASET_STATS
    for name in jd.DATASET_STATS:
        assert pd.normalize_on_device_for(name) == jd.normalize_on_device_for(name)
    with pytest.raises(ValueError):
        pd.normalize_on_device_for("nope")


# ---------------------------------------------------------------- ops


def test_patchify_and_pos_embed_match():
    from cross_scale_mae_tpu.ops.patchify import patchify as jpatchify
    from cross_scale_mae_tpu.ops.pos_embed import get_2d_sincos_pos_embed as jpos
    from cross_scale_mae_torch.ops.patchify import patchify
    from cross_scale_mae_torch.ops.pos_embed import get_2d_sincos_pos_embed

    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        patchify(torch.from_numpy(x), 8).numpy(), np.asarray(jpatchify(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(get_2d_sincos_pos_embed(64, 4, cls_token=True),
                                  np.asarray(jpos(64, 4, cls_token=True)))


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_resample_matrix_matches(method):
    from cross_scale_mae_tpu.ops.image import _resample_matrix as jmat
    from cross_scale_mae_torch.ops.image import _resample_matrix

    start, length = np.float32(3.25), np.float32(31.5)
    ref = np.asarray(jmat(37, 32, jnp.asarray(start), jnp.asarray(length), method))
    got = _resample_matrix(37, 32, torch.tensor(start), torch.tensor(length), method)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_crop_resize_per_sample_boxes_match():
    from cross_scale_mae_tpu.ops.image import crop_resize as jcrop
    from cross_scale_mae_torch.ops.image import crop_resize

    rng = np.random.default_rng(1)
    imgs = rng.uniform(size=(3, 20, 20, 3)).astype(np.float32)
    boxes = np.array([[0, 0, 20, 20], [2.5, 1.0, 12.0, 15.5], [5, 7, 9, 9]], np.float32)
    for method in ("linear", "cubic"):
        ref = np.asarray(jcrop(jnp.asarray(imgs), jnp.asarray(boxes), 16, method))
        got = crop_resize(torch.from_numpy(imgs), torch.from_numpy(boxes), 16, method)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # The training fast path: JAX's DEFAULT precision is fp32 on the CPU.
    ref = np.asarray(jcrop(jnp.asarray(imgs), jnp.asarray(boxes), 16, exact=False))
    got = crop_resize(torch.from_numpy(imgs), torch.from_numpy(boxes), 16, exact=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_preprocess_matches(dtype):
    from cross_scale_mae_tpu.ops.augment import make_eval_preprocess as jprep
    from cross_scale_mae_torch.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_torch.ops.augment import make_eval_preprocess

    u8 = np.random.default_rng(2).integers(0, 256, (2, 37, 37, 3), np.uint8)
    ref = jprep(FMOW_RGB_MEAN, FMOW_RGB_STD, 32, dtype=dtype)(jnp.asarray(u8))
    got = make_eval_preprocess(FMOW_RGB_MEAN, FMOW_RGB_STD, 32, dtype=dtype)(
        torch.from_numpy(u8))
    assert str(got.dtype) == f"torch.{dtype}"
    ref = np.asarray(ref.astype(jnp.float32))
    # Normalized pixels reach |x| ~ 3; fp32 sums of four bicubic taps differ
    # in order; bf16 results may then round one ulp apart (2**-6 at |x| < 4).
    atol = 1e-5 if dtype == "float32" else 2.0 ** -6
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


# ---------------------------------------------------------------- layers


def test_linear_and_layer_norm_match():
    rng = np.random.default_rng(5)
    p = _block_params(rng, 64, 256)
    x = rng.normal(size=(2, 17, 64)).astype(np.float32)
    np.testing.assert_allclose(
        players.linear(_to_torch(p["mlp"]["fc1"]), torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.linear(_to_jax(p["mlp"]["fc1"]), jnp.asarray(x))),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        players.layer_norm(_to_torch(p["norm1"]), torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.layer_norm(_to_jax(p["norm1"]), jnp.asarray(x))),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gelu", GELUS)
@pytest.mark.parametrize("impl", IMPLS)
def test_block_matches_jax(impl, gelu, dtype):
    rng = np.random.default_rng(6)
    p = _block_params(rng, 64, 256)
    x = rng.normal(size=(2, 17, 64)).astype(np.float32)
    ref = jlayers.block(_to_jax(p), jnp.asarray(x, jnp.dtype(dtype)), 4, impl,
                        "pre", gelu)
    got = players.block(_to_torch(p), torch.from_numpy(x).to(getattr(torch, dtype)),
                        4, impl, "pre", gelu)
    _assert_close(got, np.asarray(ref.astype(jnp.float32)), dtype, 2.0 ** -5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_post_norm_block_matches_jax(dtype):
    rng = np.random.default_rng(7)
    p = _block_params(rng, 64, 256)
    x = rng.normal(size=(2, 17, 64)).astype(np.float32)
    ref = jlayers.block(_to_jax(p), jnp.asarray(x, jnp.dtype(dtype)), 4,
                        "pallas_v3", "post", "exact")
    got = players.block(_to_torch(p), torch.from_numpy(x).to(getattr(torch, dtype)),
                        4, "pallas_v3", "post", "exact")
    _assert_close(got, np.asarray(ref.astype(jnp.float32)), dtype, 2.0 ** -5)


def test_unported_attention_impl_raises():
    p = _to_torch(_block_params(np.random.default_rng(0), 64, 256))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        players.attention(p["attn"], torch.zeros(1, 4, 64), 4, "linformer")


# ---------------------------------------------------------------- encoder


def _perturbed_init(cfg, seed=0):
    """JAX mae_init, with every leaf moved off its init constant (zero
    biases, unit norm scales) so a mis-mapped parameter shows."""
    from cross_scale_mae_tpu.models.mae import mae_init

    params, _ = mae_init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gelu", GELUS)
@pytest.mark.parametrize("impl", IMPLS)
def test_mae_encode_matches_jax(impl, gelu, dtype):
    from cross_scale_mae_tpu.models.mae import mae_encode as jencode
    from cross_scale_mae_torch.models.mae import mae_encode
    from cross_scale_mae_torch.utils.params import params_from_jax

    jc = jcfg.get_mae_config("mae_vit_base_MsLdCeCd", **_tiny(
        attention_impl=impl, gelu=gelu, compute_dtype=dtype))
    tree = _perturbed_init(jc)
    imgs = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = jencode(_to_jax(tree), jc, jnp.asarray(imgs))
    pc = pcfg.MAEConfig.from_json(jc.to_json())
    got = mae_encode(params_from_jax(tree, pc), pc, torch.from_numpy(imgs))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 17, 64)
    _assert_close(got, np.asarray(ref.astype(jnp.float32)), dtype, 2.0 ** -4)


def test_mae_encode_applies_encoder_norm_when_asked():
    from cross_scale_mae_tpu.models.mae import mae_encode as jencode
    from cross_scale_mae_torch.models.mae import mae_encode
    from cross_scale_mae_torch.utils.params import params_from_jax

    jc = jcfg.MAEConfig(**_tiny(apply_encoder_norm=True, compute_dtype="float32"))
    tree = _perturbed_init(jc, seed=1)
    imgs = np.random.default_rng(9).normal(size=(1, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jencode(_to_jax(tree), jc, jnp.asarray(imgs)))
    pc = pcfg.MAEConfig.from_json(jc.to_json())
    got = mae_encode(params_from_jax(tree, pc), pc, torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
