"""The PyTorch port's pretrain path held against the JAX package on the CPU:
masking, crop boxes, the fast crop+resize, the pretrain augmentation, the
losses, the predictor, the GELU fast backward, the schedule, the optimizer
mask, the weight carry, the FLOP count, ``mae_loss_fn`` with its gradients,
a 10-step lockstep of the whole step, and the pretrain CLI.

Inputs and weights come from numpy or JAX seeds and go through both
packages as numpy; the JAX package's random draws (flip flags, crop boxes,
mask noise) are computed from its own keys and injected into the port.
Sizes are tiny (input 32, patch 8, width 64, 2 encoder layers).

Tolerances, each with its reason:
* fp32 unit functions: 1e-6 relative or 1e-5 absolute on values of
  magnitude ~1; the two sides differ only in the order of fp32 sums and in
  the last bits of exp/log/tanh.
* bf16 augmentation: one bf16 ulp at the largest magnitude, 2**-7 * max.
* mae_loss_fn, fp32: loss rtol 1e-5, gradients atol 1e-5 * max(1, max|g|)
  per leaf (sums of a few hundred products in another order).
* 10-step lockstep: the bounds of tests/test_train_equivalence.py (losses
  rtol 3e-4, params atol 5e-4, BatchNorm running mean atol 1e-5).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_torch import configs as pcfg
from cross_scale_mae_torch.utils import params as pparams

TINY = dict(input_size=32, patch_size=8, dim_model=64, encoder_num_layers=2,
            encoder_num_heads=4, decoder_embed_dim=32, decoder_num_layers=1,
            decoder_num_heads=4, predictor_hidden_size=32)


def _cfgs(name="mae_vit_tiny_MsLdCeCd", **kw):
    kw = {**TINY, "compute_dtype": "float32", "attention_impl": "pallas_v3", **kw}
    return jcfg.get_mae_config(name, **kw), pcfg.get_mae_config(name, **kw)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _assert_tree_close(got, ref, atol, rel=False):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_g) == len(flat_r)
    for path, g in flat_g:
        r = np.asarray(flat_r[path])
        tol = atol * max(1.0, float(np.abs(r).max())) if rel else atol
        np.testing.assert_allclose(np.asarray(g), r, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------- configs


def test_train_config_fields_and_json_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.TrainConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pcfg.TrainConfig)}
    assert jf == pf
    t = jcfg.TrainConfig(lr=None, blr=1e-4, batch_size=384)
    back = pcfg.TrainConfig.from_json(t.to_json())
    assert back.resolved_lr(384) == t.resolved_lr(384) == 1e-4 * 384 / 256
    assert jcfg.TrainConfig.from_json(back.to_json()) == t


@pytest.mark.parametrize("term", ["e", "ce", "cd"])
def test_loss_name_matches_jax(term):
    kw = {"loss": "MSE", f"loss_{term}": "L1"}
    assert (pcfg.MAEConfig(**kw).loss_name(term) == jcfg.MAEConfig(**kw).loss_name(term)
            == "l1")
    assert pcfg.MAEConfig(loss="MSE").loss_name(term) == "mse"


# ---------------------------------------------------------------- ops


def test_random_masking_and_restore_match_jax(rng_np):
    from cross_scale_mae_tpu.ops import masking as jm
    from cross_scale_mae_torch.ops import masking as pm

    x = rng_np.normal(size=(3, 16, 8)).astype(np.float32)
    noise = rng_np.uniform(size=(3, 16)).astype(np.float32)
    noise[0, 3] = noise[0, 7]  # a tie: the stable sort keeps index order
    jx, jmask, jids = jm.random_masking(jnp.asarray(x), 4, noise=jnp.asarray(noise))
    px, pmask, pids = pm.random_masking(_t(x), 4, _t(noise))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    tok = rng_np.normal(size=(8,)).astype(np.float32)
    vis = rng_np.normal(size=(3, 4, 8)).astype(np.float32)
    ref = jm.restore_tokens(jnp.asarray(vis), jnp.asarray(tok), jids)
    got = pm.restore_tokens(_t(vis), _t(tok), pids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("scale,ratio", [((0.25, 1.0), (3 / 4, 4 / 3)),
                                         ((0.25, 0.75), (3 / 4, 4 / 3))])
def test_sample_crop_boxes_matches_jax_on_the_same_uniforms(scale, ratio):
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes as jboxes
    from cross_scale_mae_torch.ops.image import sample_crop_boxes

    key = jax.random.key(4)
    ref = np.asarray(jboxes(key, 64, 40, 48, scale, ratio))
    u = np.stack([np.asarray(jax.random.uniform(k, (64,)))
                  for k in jax.random.split(key, 4)])
    got = sample_crop_boxes(_t(u), 40, 48, scale, ratio).numpy()
    # The log-aspect bounds are fp32 in JAX and float64 here.
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_crop_resize_fast_path_matches_jax_on_cpu(rng_np, method):
    from cross_scale_mae_tpu.ops.image import crop_resize as jcrop
    from cross_scale_mae_torch.ops.image import crop_resize

    imgs = rng_np.normal(size=(3, 20, 20, 3)).astype(np.float32)
    boxes = np.array([[0, 0, 20, 20], [2.5, 3.25, 11.0, 9.5], [7, 1, 12.75, 18]],
                     np.float32)
    ref = np.asarray(jcrop(jnp.asarray(imgs), jnp.asarray(boxes), 16, method, exact=False))
    got = crop_resize(_t(imgs), _t(boxes), 16, method, exact=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_crop_resize_fast_path_rounds_operands_to_bf16_on_the_gpu():
    """On a CUDA tensor the fast path multiplies bf16-rounded operands (the
    TPU's DEFAULT precision); on the CPU it leaves them in fp32 (JAX's
    DEFAULT there). The rounding itself is a plain cast, checked here."""
    from cross_scale_mae_torch.ops.image import _bf16_operand

    x = torch.tensor([1.0 + 2.0 ** -10, 3.0])
    assert torch.equal(_bf16_operand(x), x)
    meta = torch.empty(2, device="meta")
    assert _bf16_operand(meta).dtype == torch.float32


def test_random_flips_match_jax(rng_np):
    from cross_scale_mae_tpu.ops.image import random_flips as jflips
    from cross_scale_mae_torch.ops.image import random_flips

    imgs = rng_np.normal(size=(8, 6, 5, 3)).astype(np.float32)
    key = jax.random.key(3)
    ref = np.asarray(jflips(key, jnp.asarray(imgs)))
    kh, kv = jax.random.split(key)
    h = torch.from_numpy(np.array(jax.random.bernoulli(kh, 0.5, (8,))))
    v = torch.from_numpy(np.array(jax.random.bernoulli(kv, 0.5, (8,))))
    np.testing.assert_array_equal(random_flips(_t(imgs), h, v).numpy(), ref)


def _jax_augment_draws(key, n, h, w):
    """The flip flags and crop boxes ``make_pretrain_augment``'s augment
    draws from ``key`` (ops/augment.py:44, ops/image.py:47-53, 165-178)."""
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes as jboxes

    k_flip, _, k_crop = jax.random.split(key, 3)
    kh, kv = jax.random.split(k_flip)
    flips = [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (n,))))
             for k in (kh, kv)]
    return (*flips, _t(jboxes(k_crop, n, h, w, (0.25, 1.0))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pretrain_augment_matches_jax_on_injected_draws(rng_np, dtype):
    from cross_scale_mae_tpu.ops.augment import make_pretrain_augment as jaug
    from cross_scale_mae_torch.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_torch.ops.augment import make_pretrain_augment

    batch = rng_np.integers(0, 256, (6, 24, 24, 3), np.uint8)
    key = jax.random.key(8)
    ref = jaug(FMOW_RGB_MEAN, FMOW_RGB_STD, 16, dtype=dtype)(key, jnp.asarray(batch))
    ref = np.asarray(ref.astype(jnp.float32))
    got = make_pretrain_augment(FMOW_RGB_MEAN, FMOW_RGB_STD, 16, dtype=dtype)(
        torch.from_numpy(batch), *_jax_augment_draws(key, 6, 24, 24))
    assert got.dtype == getattr(torch, dtype) and got.shape == (6, 16, 16, 3)
    atol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("name", ["mse", "l2", "mae", "l1", "bce"])
@pytest.mark.parametrize("masked", [True, False])
def test_recon_loss_matches_jax(rng_np, name, masked):
    from cross_scale_mae_tpu.losses.recon import recon_loss as jloss
    from cross_scale_mae_torch.losses.recon import recon_loss

    t = rng_np.normal(size=(4, 16, 12)).astype(np.float32)
    p = rng_np.normal(size=(4, 16, 12)).astype(np.float32)
    m = (rng_np.uniform(size=(4, 16)) < 0.75).astype(np.float32) if masked else None
    ref = float(jloss(name, jnp.asarray(t), jnp.asarray(p),
                      None if m is None else jnp.asarray(m)))
    got = float(recon_loss(name.upper(), _t(t), _t(p), None if m is None else _t(m)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_recon_loss_refuses_the_unported_ssim_family():
    from cross_scale_mae_torch.losses.recon import recon_loss

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        recon_loss("ms_ssim", torch.zeros(1, 4, 3), torch.zeros(1, 4, 3))
    with pytest.raises(ValueError, match="unknown loss"):
        recon_loss("huber", torch.zeros(1, 4, 3), torch.zeros(1, 4, 3))


@pytest.mark.parametrize("norm_pix", [False, True])
def test_process_target_matches_jax(rng_np, norm_pix):
    from cross_scale_mae_tpu.losses.recon import process_target as jpt
    from cross_scale_mae_torch.losses.recon import process_target

    imgs = rng_np.normal(size=(2, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jpt(jnp.asarray(imgs), 8, 3, norm_pix))
    got = process_target(_t(imgs), 8, 3, norm_pix).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tau", [0.5, 0.1])
def test_ntxent_loss_matches_jax(rng_np, tau):
    from cross_scale_mae_tpu.losses.ntxent import ntxent_loss as jnt
    from cross_scale_mae_torch.losses.ntxent import ntxent_loss

    zi = rng_np.normal(size=(6, 10)).astype(np.float32)
    zj = rng_np.normal(size=(6, 10)).astype(np.float32)
    ref = float(jnt(jnp.asarray(zi), jnp.asarray(zj), tau=tau))
    np.testing.assert_allclose(float(ntxent_loss(_t(zi), _t(zj), tau=tau)), ref, rtol=1e-6)


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("train", [True, False])
def test_predictor_apply_matches_jax(rng_np, train):
    from cross_scale_mae_tpu.models import layers as jl
    from cross_scale_mae_torch.models import layers as pl

    p = _tree_np(jl.predictor_init(jax.random.key(2), 12, 5, 16))
    p["bn"]["scale"] = (1 + 0.1 * rng_np.normal(size=5)).astype(np.float32)
    st = {"bn": {"mean": rng_np.normal(size=5).astype(np.float32),
                 "var": rng_np.uniform(0.5, 2, size=5).astype(np.float32)}}
    x = rng_np.normal(size=(3, 5, 12)).astype(np.float32)
    ref, ref_st = jl.predictor_apply(jax.tree.map(jnp.asarray, p),
                                     jax.tree.map(jnp.asarray, st), jnp.asarray(x), train)
    got, got_st = pl.predictor_apply(jax.tree.map(_t, p), jax.tree.map(_t, st), _t(x), train)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    _assert_tree_close(jax.tree.map(lambda a: a.numpy(), got_st), _tree_np(ref_st), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_fast_backward_matches_jax(dtype):
    """gelu_exact_fastbwd's backward against the JAX custom VJP's
    (_gelu_fb_bwd), over a dense grid. The tanh of PyTorch and XLA differ in
    their last fp32 bits (near saturation XLA's returns exactly +-1, so the
    derivative there is 0 against PyTorch's ~5e-7): fp32 to 2e-6 absolute
    on derivatives of magnitude at most 1.13; bf16 to one bf16 ulp relative
    plus the same 2e-6 absolute."""
    from cross_scale_mae_tpu.models.layers import gelu_exact_fastbwd as jgelu
    from cross_scale_mae_torch.models.layers import gelu_exact_fastbwd

    x = np.linspace(-8, 8, 4001).astype(np.float32)
    g = np.cos(x).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(jgelu, jnp.asarray(x, jdt))
    ref = np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))
    leaf = _t(x, tdt).requires_grad_(True)
    gelu_exact_fastbwd(leaf).backward(_t(g, tdt))
    got = leaf.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=2e-6)


# ---------------------------------------------------------------- train pieces


def test_warmup_half_cosine_matches_jax():
    from cross_scale_mae_tpu.train.schedule import warmup_half_cosine as jsched
    from cross_scale_mae_torch.train.schedule import warmup_half_cosine

    for args in [(1e-3, 1e-5, 2, 10, 7), (3e-4, 0.0, 0, 5, 3)]:
        ref, got = jsched(*args), warmup_half_cosine(*args)
        for step in range(0, 80):
            # JAX evaluates the curve in fp32, the port in float64: 1e-6 of
            # the peak lr (the cosine's tail is a difference of near-equal
            # values).
            np.testing.assert_allclose(got(step), float(ref(jnp.asarray(step))),
                                       rtol=0, atol=1e-6 * args[0])


def test_wd_mask_matches_jax_name_rule():
    from cross_scale_mae_tpu.models import mae_init as jinit
    from cross_scale_mae_tpu.train.optim import wd_mask as jmask
    from cross_scale_mae_torch.train.optim import wd_mask
    from cross_scale_mae_torch.train.state import tree_items

    jc, pc = _cfgs()
    params, _ = jinit(jax.random.key(0), jc)
    ref = jmask(params)
    port = pparams.params_from_jax(_tree_np(params), pc, full=True)
    for (path, _), decay in zip(tree_items(port), wd_mask(port)):
        node = ref
        for k in path:
            node = node[k] if isinstance(k, str) else node
        assert bool(node) == decay, path
    # The rule is by name: cls/mask tokens decay though not matrices, and no
    # bias, norm or BatchNorm leaf decays.
    names = {path[-1] if isinstance(path[-1], str) else path[0]: d
             for (path, _), d in zip(tree_items(port), wd_mask(port))}
    assert names["cls_token"] and names["mask_token"] and not names["bias"]


def test_weight_carry_round_trips_the_whole_tree():
    from cross_scale_mae_tpu.models import mae_init as jinit

    jc, pc = _cfgs()
    params, state = jinit(jax.random.key(1), jc)
    params, state = _tree_np(params), _tree_np(state)
    port = pparams.params_from_jax(params, pc, full=True)
    assert len(port["decoder_blocks"]) == pc.decoder_num_layers
    _assert_tree_close(pparams.params_to_jax(port), params, 0.0)
    _assert_tree_close(pparams.params_to_jax(pparams.state_from_jax(state, pc)), state, 0.0)
    with pytest.raises(KeyError, match="unexpected parameter"):
        pparams.params_from_jax({**params, "extra": np.zeros(1)}, pc, full=True)
    # The encoder-only carry (serving) still drops the rest.
    assert set(pparams.params_from_jax(params, pc)) == {
        "patch_embed", "cls_token", "encoder_blocks"}


def test_port_init_has_the_jax_tree_and_distributions():
    from cross_scale_mae_tpu.models import mae_init as jinit
    from cross_scale_mae_torch.models.mae import mae_init

    jc, pc = _cfgs()
    ref = _tree_np(jinit(jax.random.key(0), jc)[0])
    params, state = mae_init(pc, torch.Generator().manual_seed(0))
    got = pparams.params_to_jax(params)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, ref)
    assert set(state) == {"predictor_cd"}
    k = got["decoder_blocks"]["mlp"]["fc1"]["kernel"]
    lim = np.sqrt(6.0 / (32 + 128))
    assert np.abs(k).max() <= lim and np.abs(k).max() > 0.9 * lim
    assert abs(float(np.std(got["cls_token"])) - 0.02) < 0.01


@pytest.mark.parametrize("name", ["mae_vit_base_MsLdCeCd", "mae_vit_large_MsLdCe",
                                  "mae_vit_tiny"])
def test_train_flops_match_jax(name):
    from cross_scale_mae_tpu.utils.flops import mae_train_flops_per_image as jflops
    from cross_scale_mae_torch.utils.flops import mae_train_flops_per_image

    assert mae_train_flops_per_image(pcfg.get_mae_config(name)) == jflops(
        jcfg.get_mae_config(name))


# ---------------------------------------------------------------- model


def _jax_loss_draws(rng, n, cfg):
    """The MsLd crop boxes and the mask noise ``mae_loss_fn`` draws from
    ``rng`` (models/mae.py:288-316)."""
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes as jboxes

    k_crop, k1, k2 = jax.random.split(rng, 3)
    boxes = jboxes(k_crop, n, cfg.input_size, cfg.input_size, cfg.ms_range,
                   cfg.ms_aspect_ratio)
    noise = jnp.concatenate([jax.random.uniform(k, (n, cfg.num_patches))
                             for k in (k1, k2)])
    return _t(boxes), _t(noise)


# The flagship variant runs the v3 attention (its JAX side in interpret
# mode); the other variants check their loss terms through the plain one.
@pytest.mark.parametrize("name,impl", [("mae_vit_tiny_MsLdCeCd", "pallas_v3"),
                                       ("mae_vit_tiny_MsLdLe", "xla"),
                                       ("mae_vit_tiny_MsLdCe", "xla"),
                                       ("mae_vit_tiny", "xla")])
def test_mae_loss_fn_value_and_grads_match_jax(rng_np, name, impl):
    from cross_scale_mae_tpu.models import mae_init as jinit
    from cross_scale_mae_tpu.models.mae import mae_loss_fn as jloss
    from cross_scale_mae_torch.models.mae import mae_loss_fn
    from cross_scale_mae_torch.train.state import tree_leaves

    jc, pc = _cfgs(name, attention_impl=impl)
    params, state = jinit(jax.random.key(0), jc)
    imgs = rng_np.normal(size=(4, 32, 32, 3)).astype(np.float32)
    rng = jax.random.key(7)

    def jfn(p):
        out = jloss(p, state, jc, jnp.asarray(imgs), rng)
        return out.loss, (out.losses, out.state)

    (jl, (jterms, jstate)), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)

    port = pparams.params_from_jax(_tree_np(params), pc, full=True)
    for leaf in tree_leaves(port):
        leaf.requires_grad_(True)
    pstate = pparams.state_from_jax(_tree_np(state), pc)
    if jc.multi_scale:
        boxes, noise = _jax_loss_draws(rng, 4, jc)
    else:
        boxes, noise = None, _t(jax.random.uniform(rng, (4, jc.num_patches)))
    out = mae_loss_fn(port, pstate, pc, _t(imgs), noise=noise, ms_boxes=boxes)
    out.loss.backward()

    np.testing.assert_allclose(float(out.loss), float(jl), rtol=1e-5)
    assert set(out.losses) == set(jterms)
    for k in jterms:
        np.testing.assert_allclose(float(out.losses[k]), float(jterms[k]), rtol=1e-5)
    grads = jax.tree.map(lambda t: np.zeros(t.shape, np.float32) if t.grad is None
                         else t.grad.numpy(), port)
    _assert_tree_close(pparams.params_to_jax(
        jax.tree.map(torch.from_numpy, grads)), _tree_np(jgrads), 1e-5, rel=True)
    _assert_tree_close(pparams.params_to_jax(out.state), _tree_np(jstate), 1e-6)


def test_mae_loss_fn_refuses_unported_inputs():
    from cross_scale_mae_torch.models.mae import mae_init, mae_loss_fn

    _, pc = _cfgs()
    params, state = mae_init(pc, torch.Generator().manual_seed(0))
    # Temporal pairs run on a multi-scale config
    # (tests/test_torch_port_temporal.py); a single-view one refuses them.
    _, single = _cfgs("mae_vit_tiny")
    single_params, single_state = mae_init(single, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="temporal"):
        mae_loss_fn(single_params, single_state, single, torch.zeros(2, 2, 32, 32, 3),
                    noise=None)
    with pytest.raises(NotImplementedError, match="perceptual"):
        mae_loss_fn(params, state, pc.replace(use_perceptual=True),
                    torch.zeros(2, 32, 32, 3), noise=None)


# ---------------------------------------------------------------- the step


def test_pretrain_step_10_step_lockstep_with_jax():
    """The port's make_pretrain_step against the JAX one for 10 steps on the
    tiny MsLdCeCd config (fp32, pallas_v3, uint8 input through the pretrain
    augmentation), from the same weights, with the JAX draws of every step
    injected: the key splits of train/pretrain.py:41,111-112,
    ops/augment.py:44 and models/mae.py:288-315."""
    from cross_scale_mae_tpu.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_tpu.models import mae_init as jinit
    from cross_scale_mae_tpu.ops.augment import make_pretrain_augment as jaug
    from cross_scale_mae_tpu.train import TrainState as JState
    from cross_scale_mae_tpu.train import build_optimizer as jopt
    from cross_scale_mae_tpu.train import warmup_half_cosine as jsched
    from cross_scale_mae_tpu.train.pretrain import make_pretrain_step as jstep_fn
    from cross_scale_mae_torch.ops.augment import make_pretrain_augment
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.pretrain import PretrainDraws, make_pretrain_step
    from cross_scale_mae_torch.train.schedule import warmup_half_cosine
    from cross_scale_mae_torch.train.state import TrainState

    jc, pc = _cfgs()
    n, steps = 8, 10
    sched_args = (1e-3, 0.0, 1, 2, 5)
    jtcfg = jcfg.TrainConfig(batch_size=n, weight_decay=0.05)
    ptcfg = pcfg.TrainConfig(batch_size=n, weight_decay=0.05)
    params, mstate = jinit(jax.random.key(0), jc)
    jtx = jopt(params, jsched(*sched_args), weight_decay=0.05)
    jstate = JState.create(params, mstate, jtx)
    jstep = jstep_fn(jc, jtcfg, jsched(*sched_args), donate=False,
                     augment=jaug(FMOW_RGB_MEAN, FMOW_RGB_STD, 32, dtype="float32"))

    sched = warmup_half_cosine(*sched_args)
    pp = pparams.params_from_jax(_tree_np(params), pc, full=True)
    pstate = TrainState.create(pp, pparams.state_from_jax(_tree_np(mstate), pc),
                               build_optimizer(pp, sched, weight_decay=0.05))
    pstep = make_pretrain_step(pc, ptcfg, sched, augment=make_pretrain_augment(
        FMOW_RGB_MEAN, FMOW_RGB_STD, 32, dtype="float32"))

    batch = np.random.default_rng(0).integers(0, 256, (n, 32, 32, 3), np.uint8)
    rng = jax.random.key(1)
    jl, pl, gn = [], [], []
    for step in range(steps):
        k_aug, k_loss = jax.random.split(jax.random.fold_in(rng, step))
        hflip, vflip, boxes = _jax_augment_draws(k_aug, n, 32, 32)
        ms_boxes, noise = _jax_loss_draws(k_loss, n, jc)
        jstate, jm = jstep(jstate, jnp.asarray(batch), rng)
        pstate, pm = pstep(pstate, torch.from_numpy(batch),
                           PretrainDraws(hflip, vflip, boxes, ms_boxes, noise))
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
        gn.append((float(pm["grad_norm"]), float(jm["grad_norm"])))
        assert pm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)

    np.testing.assert_allclose(pl, jl, rtol=3e-4)
    np.testing.assert_allclose(*zip(*gn), rtol=1e-3)
    assert pstate.step == int(jstate.step) == steps
    _assert_tree_close(pparams.params_to_jax(pstate.params), _tree_np(jstate.params), 5e-4)
    _assert_tree_close(pparams.params_to_jax(pstate.model_state),
                       _tree_np(jstate.model_state), 1e-5)
    assert pl[-1] < pl[0]


def test_pretrain_step_accumulates_microbatches():
    """accum_iter=2 on one batch split in two equals the mean of the two
    microbatches' gradients (checked through the first AdamW update, which
    moves every parameter by lr * sign-like m/sqrt(v)), and its loss the
    mean of theirs."""
    from cross_scale_mae_torch.models.mae import mae_init
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.pretrain import make_pretrain_step, sample_pretrain_draws
    from cross_scale_mae_torch.train.state import TrainState, tree_leaves

    _, pc = _cfgs()
    imgs = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 32, 32, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    tc = pcfg.TrainConfig(batch_size=2, accum_iter=2)
    draws = [sample_pretrain_draws(gen, 2, pc, tc) for _ in range(2)]
    losses, grads = [], []
    for part, d in zip((imgs[:2], imgs[2:]), draws):
        params, state = mae_init(pc, torch.Generator().manual_seed(0))
        st = TrainState.create(params, state, build_optimizer(params, lambda s: 0.0))
        step = make_pretrain_step(pc, tc.replace(accum_iter=1), lambda s: 0.0)
        _, m = step(st, part, d)
        losses.append(float(m["loss"]))
        grads.append(float(m["grad_norm"]))
    params, state = mae_init(pc, torch.Generator().manual_seed(0))
    st = TrainState.create(params, state, build_optimizer(params, lambda s: 0.0))
    _, m = make_pretrain_step(pc, tc, lambda s: 0.0)(st, imgs, draws)
    assert float(m["loss"]) == pytest.approx(np.mean(losses), rel=1e-5)
    assert float(m["grad_norm"]) <= max(grads) * (1 + 1e-5)
    assert st.step == 1 and all(p.grad is None for p in tree_leaves(st.params))
    with pytest.raises(ValueError, match="accum_iter"):
        make_pretrain_step(pc, tc, lambda s: 0.0)(st, imgs, draws[:1])


def test_sample_pretrain_draws_shapes_and_consistent_mask():
    from cross_scale_mae_torch.train.pretrain import _step_rng, sample_pretrain_draws

    _, pc = _cfgs()
    tc = pcfg.TrainConfig()
    d = sample_pretrain_draws(_step_rng(tc, 1, 3, "cpu"), 5, pc, tc)
    assert d.hflip.dtype == torch.bool and d.hflip.shape == (5,)
    assert d.crop_boxes.shape == d.ms_boxes.shape == (5, 4)
    assert float(d.crop_boxes[:, 2:].max()) <= 32 and float(d.ms_boxes[:, 2:].max()) <= 32
    assert d.noise.shape == (10, pc.num_patches)
    assert not torch.equal(d.noise[:5], d.noise[5:])
    again = sample_pretrain_draws(_step_rng(tc, 1, 3, "cpu"), 5, pc, tc)
    assert torch.equal(again.noise, d.noise)
    pinned = tc.replace(mask_seed=4)
    c = sample_pretrain_draws(_step_rng(pinned, 1, 9, "cpu"), 5, pc.replace(
        ms_per_sample_crop=False), pinned)
    assert torch.equal(c.noise[:5], c.noise[5:])
    assert torch.equal(c.ms_boxes, c.ms_boxes[:1].expand(5, 4))


def test_optimizer_refuses_unported_options():
    """Nothing the JAX build_optimizer builds is refused any more (every
    optimizer, clipping, layer decay, a frozen mask and the moment dtypes
    build); what is refused is what the JAX one refuses too: an unknown
    optimizer (ValueError on both sides), and a moment dtype that is no
    float type."""
    from cross_scale_mae_tpu.train.optim import build_optimizer as jopt
    from cross_scale_mae_torch.train.optim import build_optimizer

    p = {"w": {"kernel": torch.zeros(2, 2)}, "head": {"bias": torch.zeros(2)}}
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    mask = {"w": {"kernel": False}, "head": {"bias": True}}
    for kw in ({"optimizer": "lars", "clip_grad": 1.0}, {"optimizer": "sgd"},
               {"nu_dtype": "bfloat16"}, {"mu_dtype": "bfloat16", "clip_grad": 1.0},
               {"optimizer": "lars", "mu_dtype": "bfloat16"}, {"frozen_mask": mask},
               {"optimizer": "sgd", "frozen_mask": mask, "clip_grad": 0.5}):
        jopt(jp, lambda s: 0.0, **kw)
        tx = build_optimizer(p, lambda s: 0.0, **kw)
        tx.update([p["head"]["bias"], p["w"]["kernel"]], [torch.ones(2), None]
                  if "frozen_mask" in kw else [torch.ones(2), torch.ones(2, 2)], tx.init(p))
    with pytest.raises(ValueError, match="unknown optimizer"):
        jopt(jp, lambda s: 0.0, optimizer="adam")
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer(p, lambda s: 0.0, optimizer="adam")
    with pytest.raises(ValueError, match="floating-point"):
        build_optimizer(p, lambda s: 0.0, mu_dtype="int8")


def test_adamw_matches_optax_with_clipping():
    """Three updates of the port's AdamW against optax's chain
    (clip_by_global_norm + adamw with the name mask), on fp32 leaves."""
    from cross_scale_mae_tpu.train.optim import build_optimizer as jopt
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import tree_leaves

    rng = np.random.default_rng(3)
    tree = {"a": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                  "bias": rng.normal(size=(3,)).astype(np.float32)},
            "cls_token": rng.normal(size=(1, 1, 3)).astype(np.float32)}
    sched = lambda s: 1e-2 * (s + 1)  # noqa: E731
    jtx = jopt(jax.tree.map(jnp.asarray, tree), sched, weight_decay=0.1, clip_grad=0.5)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jtx.init(jp)
    pp = jax.tree.map(_t, tree)
    tx = build_optimizer(pp, sched, weight_decay=0.1, clip_grad=0.5)
    ps = tx.init(pp)
    for k in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (k + 1)).astype(np.float32), tree)
        import optax

        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update(tree_leaves(pp), tree_leaves(jax.tree.map(_t, g)), ps)
    _assert_tree_close(jax.tree.map(lambda t: t.numpy(), pp), _tree_np(jp), 1e-6)


# ---------------------------------------------------------------- the CLI


def _cli_args(tmp_path, *extra):
    from cross_scale_mae_torch.cli.pretrain import get_args_parser

    return get_args_parser().parse_args([
        "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
        "--batch_size", "4", "--synthetic_len", "8", "--epochs", "2",
        "--warmup_epochs", "1", "--device", "cpu", "--log_interval", "1",
        "--output_dir", str(tmp_path), *extra])


def test_pretrain_cli_trains_and_writes_a_servable_npz(tmp_path):
    from cross_scale_mae_torch.cli.pretrain import main
    from cross_scale_mae_torch.serving import build_serving_model

    result = main(_cli_args(tmp_path, "--max_steps", "2"))
    assert result["steps"] == 2 and len(result["losses"]) == 2
    assert all(np.isfinite(result["losses"]))
    served = build_serving_model(result["npz"], pool="mean", batch_size=2, device="cpu")
    assert served.meta["model_config"]["attention_impl"] == "pallas_v3"
    feats = served.fn(np.zeros((2, served.canvas, served.canvas, 3), np.uint8))
    assert feats.shape == (2, 128) and np.isfinite(feats).all()


def test_pretrain_cli_synthetic_images_match_jax_dataset():
    from cross_scale_mae_tpu.data.datasets import SyntheticDataset
    from cross_scale_mae_torch.data.datasets import synthetic_images

    got = synthetic_images(3, 16, 3, 7, torch.device("cpu")).numpy()
    ds = SyntheticDataset(3, 16, seed=7)
    for i in range(3):
        np.testing.assert_array_equal(got[i], ds.load(i)[0])


@pytest.mark.parametrize("extra", [
    ("--sequence_parallel",), ("--model_parallel", "2"), ("--fsdp",), ("--use_wandb",),
    ("--zero1",), ("--plot_recon",),
    ("--use_perceptual_loss",),
])
def test_pretrain_cli_refuses_unported_flags(tmp_path, extra):
    from cross_scale_mae_torch.cli.pretrain import build_run

    with pytest.raises(SystemExit, match="ROADMAP"):
        build_run(_cli_args(tmp_path, *extra))


@pytest.fixture
def one_thread():
    """One intra-op thread for a test's small CPU run, which the other test
    workers would otherwise contend with; restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_pretrain_cli_refuses_fault_knobs(tmp_path, monkeypatch, one_thread):
    """The fault knobs run now (tests/test_torch_port_resume.py drives the
    fault itself): a drill aimed at another rank or another launch attempt
    leaves this process's run whole, and one aimed at it names its step."""
    from cross_scale_mae_torch.cli.pretrain import fault_step, main

    monkeypatch.setenv("CSM_FAULT_STEP", "1")
    for knob, value in (("CSM_FAULT_PROCESS", "1"), ("CSM_FAULT_ATTEMPT", "2")):
        with monkeypatch.context() as m:
            m.setenv(knob, value)
            assert fault_step(0) == 0
    with monkeypatch.context() as m:
        m.setenv("CSM_FAULT_PROCESS", "1")
        assert main(_cli_args(tmp_path, "--max_steps", "1"))["steps"] == 1
    assert fault_step(0) == 1 and fault_step(1) == 0
    monkeypatch.setenv("CSM_LAUNCH_ATTEMPT", "2")
    monkeypatch.setenv("CSM_FAULT_ATTEMPT", "2")
    assert fault_step(0) == 1


def test_pretrain_cli_resume_and_ckpt_interval_run(tmp_path, capsys, one_thread):
    """--ckpt_interval writes a checkpoint per interval and at the last
    epoch; --resume restores the newest and starts at the epoch after it,
    and a directory with no checkpoint starts fresh (JAX cli/pretrain.py:283);
    --start_epoch wins when given."""
    from cross_scale_mae_torch.cli.pretrain import build_run, main
    from cross_scale_mae_torch.utils.checkpoint import checkpoint_meta, latest_step

    empty = tmp_path / "empty"
    empty.mkdir()
    fresh = build_run(_cli_args(tmp_path, "--resume", str(empty)))
    assert fresh.start_epoch == 0 and fresh.state.step == 0
    out = tmp_path / "run"
    main(_cli_args(out, "--ckpt_interval", "1", "--synthetic_len", "4"))   # 1 step an epoch
    ckpt = str(out / "checkpoints")
    assert latest_step(ckpt) == 2 and checkpoint_meta(ckpt, 1)["epoch"] == 0
    run = build_run(_cli_args(out, "--resume", ckpt))
    assert run.start_epoch == 2 and run.state.step == 2 and run.state.opt_state.count == 2
    assert "resumed from" in capsys.readouterr().out
    assert build_run(_cli_args(out, "--resume", ckpt, "--start_epoch", "1")).start_epoch == 1


def test_pretrain_cli_runs_on_the_gpu_by_default():
    from cross_scale_mae_torch.cli.pretrain import get_args_parser

    args = get_args_parser().parse_args([])
    assert args.device == "cuda" and args.attention_impl == "pallas_v3"
    assert json.loads(pcfg.get_mae_config(args.model).to_json())["use_ce_ntxent"]
