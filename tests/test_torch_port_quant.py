"""The port's int8 weights (``cross_scale_mae_torch/quant.py``) held against
the JAX package's ``quant.py`` on the CPU.

* Codes and scales: bit-equal to JAX ``quantize_params_int8`` on the same
  fp32 tree, whether the port quantizes the JAX layout (stacked blocks) or
  its own per-layer layout (carried back with ``params_to_jax``), for a tiny
  MAE tree and a tiny classifier tree; ``quantized_bytes`` equal.
* The dequantize: bit-equal to JAX ``dequantize_params`` in fp32 and bf16.
* The carry: a JAX-quantized tree and a ``.q8.npz`` carry into the port's
  per-layer layout with their codes int8.
* The int8 forward served in process against JAX's
  ``forward(dequantize_params(qp, dtype), imgs)`` on the same codes: 1e-5
  in fp32; in bf16 the budget of tests/test_torch_port_serving.py (max
  2**-4 x max(1, max|ref|), mean 2**-7 x max(1, mean|ref|)).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_tpu import quant as jquant
from cross_scale_mae_torch import quant as pquant
from cross_scale_mae_torch import serving as psrv
from cross_scale_mae_torch.configs import MAEConfig, ViTClassifierConfig
from cross_scale_mae_torch.utils import checkpoint as pckpt
from cross_scale_mae_torch.utils.params import (
    params_from_jax,
    params_to_jax,
    vit_params_from_jax,
)

torch.set_num_threads(1)

MAE_TINY = dict(input_size=16, patch_size=8, dim_model=32, encoder_num_layers=2,
                encoder_num_heads=4, decoder_embed_dim=16, decoder_num_layers=1,
                decoder_num_heads=4, predictor_hidden_size=16, attention_impl="pallas_v3")
VIT_TINY = dict(input_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4,
                num_classes=5, attention_impl="pallas")


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(np.float32), tree)


def _mae_tree(dtype="float32"):
    from cross_scale_mae_tpu.models.mae import mae_init

    cfg = jcfg.get_mae_config("mae_vit_base_MsLdCeCd", **MAE_TINY, compute_dtype=dtype)
    params, _ = mae_init(jax.random.key(0), cfg)
    tree = _perturbed(params, 0)
    # One all-zero output channel: its scale takes the 1e-12 floor.
    tree["encoder_blocks"]["mlp"]["fc2"]["kernel"][1, :, 3] = 0.0
    return cfg, tree


def _vit_tree(dtype="float32", bn=False):
    from cross_scale_mae_tpu.models.vit import vit_init

    cfg = jcfg.ViTClassifierConfig(**VIT_TINY, use_bn_head=bn, global_pool=not bn,
                                   compute_dtype=dtype)
    params, state = vit_init(jax.random.key(1), cfg)
    state = jax.tree.map(np.asarray, state)
    if bn:
        rng = np.random.default_rng(2)
        state = {"head_bn": {"mean": rng.normal(0, 0.3, 32).astype(np.float32),
                             "var": rng.uniform(0.5, 2.0, 32).astype(np.float32)}}
    return cfg, _perturbed(params, 1), state


def _leaves_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["mae", "classifier"])
def test_codes_and_scales_bit_equal_to_jax(kind):
    if kind == "mae":
        cfg, tree = _mae_tree()
        port = params_from_jax(tree, MAEConfig.from_json(cfg.to_json()), full=True)
    else:
        cfg, tree, _ = _vit_tree()
        port = vit_params_from_jax(tree, ViTClassifierConfig.from_json(cfg.to_json()))
    want = jax.tree.map(np.asarray, jquant.quantize_params_int8(tree))
    # The JAX layout, quantized by the port on the host.
    _leaves_equal(pquant.quantize_params_int8(tree), want)
    # The port's per-layer layout: per-layer scales are the stacked ones.
    q_port = pquant.quantize_params_int8(port)
    _leaves_equal(params_to_jax(q_port), want)
    assert pquant.quantized_bytes(q_port) == jquant.quantized_bytes(want)
    assert pquant.quantized_bytes(tree) == jquant.quantized_bytes(tree)
    node = want["patch_embed"]["kernel"]
    assert node["__int8__"].dtype == np.int8 and np.abs(node["__int8__"]).max() == 127
    if kind == "mae":
        assert want["encoder_blocks"]["mlp"]["fc2"]["kernel"]["scale"][1, 0, 3] == np.float32(1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_bit_equal_to_jax(dtype):
    _, tree = _mae_tree()
    q = jquant.quantize_params_int8(tree)
    want = jquant.dequantize_params(q, getattr(jnp, dtype))
    got = pquant.dequantize_params(
        jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), q), getattr(torch, dtype))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(w.astype(jnp.float32)), g.float().numpy())


def test_jax_quantized_tree_and_q8_npz_carry(tmp_path):
    cfg, tree, _ = _vit_tree()
    pc = ViTClassifierConfig.from_json(cfg.to_json())
    q = jax.tree.map(np.asarray, jquant.quantize_params_int8(tree))
    carried = vit_params_from_jax(q, pc)
    qkv = carried["blocks"][1]["attn"]["qkv"]["kernel"]
    assert qkv["__int8__"].dtype == torch.int8 and tuple(qkv["scale"].shape) == (1, 96)
    np.testing.assert_array_equal(qkv["__int8__"].numpy(),
                                  q["blocks"]["attn"]["qkv"]["kernel"]["__int8__"][1])
    _leaves_equal(params_to_jax(carried), q)
    # The same tree as a .q8.npz (flattened by '/'-joined paths).
    path = str(tmp_path / "w.q8.npz")
    pckpt.save_params_npz(path, q)
    _leaves_equal(params_to_jax(vit_params_from_jax(pckpt.load_flat_npz(path), pc)), q)
    bad = jax.tree.map(lambda a: a, q)
    bad["head"]["kernel"]["scale"] = np.ones((32, 5), np.float32)
    with pytest.raises(ValueError, match="scale"):
        vit_params_from_jax(bad, pc)


def _jax_forward_quantized(kind, cfg, tree, state, u8):
    """The JAX serving forward (serving.py:128-149) on dequantized codes."""
    from cross_scale_mae_tpu.data.datasets import DATASET_STATS
    from cross_scale_mae_tpu.ops.augment import make_eval_preprocess

    mean, std = DATASET_STATS["fmow_rgb"]
    pre = make_eval_preprocess(mean, std, cfg.input_size, normalize=True,
                               dtype=cfg.compute_dtype)
    q = jquant.quantize_params_int8(tree)
    p = jquant.dequantize_params(jax.tree.map(jnp.asarray, q), getattr(jnp, cfg.compute_dtype))
    jcfg_x = cfg.replace(attention_impl="xla")
    if kind == "classifier":
        from cross_scale_mae_tpu.models.vit import vit_apply

        out, _ = vit_apply(p, jax.tree.map(jnp.asarray, state), jcfg_x, pre(jnp.asarray(u8)),
                           train=False)
    else:
        from cross_scale_mae_tpu.models.mae import mae_encode

        out = jnp.mean(mae_encode(p, jcfg_x, pre(jnp.asarray(u8)))[:, 1:], axis=1)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mae", "classifier"])
def test_int8_serving_matches_jax_dequantized_forward(tmp_path, kind, dtype):
    if kind == "mae":
        cfg, tree = _mae_tree(dtype)
        keep = {"patch_embed", "cls_token", "encoder_blocks"}
        tree, state = {k: v for k, v in tree.items() if k in keep}, None
        npz_tree = tree
    else:
        cfg, tree, state = _vit_tree(dtype, bn=True)
        npz_tree = {"params": tree, "model_state": state}
    path = str(tmp_path / "ckpt.npz")
    pckpt.save_params_npz(path, npz_tree, cfg.to_json())
    model = psrv.build_serving_model(path, pool="mean", batch_size=3, quantize="int8",
                                     device="cpu")
    assert model.meta["quantize"]["scheme"] == "int8_weight_only"
    assert model.meta["quantize"]["bytes"] < model.meta["quantize"]["fp32_bytes"]
    u8 = np.random.default_rng(4).integers(0, 256, (3, model.canvas, model.canvas, 3), np.uint8)
    got = model.fn(u8)
    ref = _jax_forward_quantized(kind, cfg, tree, state, u8)
    err = np.abs(got - ref)
    if dtype == "float32":
        assert err.max() <= 1e-5, err.max()
    else:
        assert err.max() <= 2.0 ** -4 * max(1.0, np.abs(ref).max()), err.max()
        assert err.mean() <= 2.0 ** -7 * max(1.0, np.abs(ref).mean()), err.mean()
    # The int8 model reads back its own config.
    assert json.loads(json.dumps(model.meta["model_config"]))["compute_dtype"] == dtype
