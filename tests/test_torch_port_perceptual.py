"""The port's perceptual loss and the training paths of the eval slice, held
against the JAX package on the CPU: ``unpatchify`` and ``resize``, the VGG16
trunk (carried from the JAX init, imported from a seeded fake torchvision
``.pth`` in both key styles), its taps, ``perceptual_loss``,
``mae_loss_fn`` with ``use_perceptual``, a 5-step lockstep of the pretrain
step with ``--loss mse_ssim`` and with the perceptual loss, and a perceptual
checkpoint that resumes bit-equal.

Sizes are tiny (input 32, patch 8, width 64, 2 encoder layers); the VGG
trunk keeps its published widths (64 to 512 channels).

Tolerances, each with its reason:
* unpatchify, the trunk's carry and import: exact (moves and a transpose).
* resize, fp32: abs 1e-5 (two matrix products of a few dozen terms).
* VGG taps and the perceptual loss: rel 1e-5 of the largest tap or of the
  loss; ten 3x3 convolutions deep, sums of up to 4608 fp32 products in
  another order.
* mae_loss_fn: loss rtol 1e-5, gradients atol 1e-5 * max(1, max|g|), the
  bounds of tests/test_torch_port_train.py.
* The lockstep: the bounds of that file's 10-step lockstep (losses rtol
  3e-4, gradient norms rtol 1e-3, params atol 5e-4).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_tpu.losses import perceptual as jperc
from cross_scale_mae_torch import configs as pcfg
from cross_scale_mae_torch.losses import perceptual as pperc
from cross_scale_mae_torch.utils import params as pparams
from tests.test_torch_port_train import (
    TINY,
    _assert_tree_close,
    _jax_augment_draws,
    _jax_loss_draws,
    _t,
    _tree_np,
)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_trunk():
    return _tree_np(jperc.init_vgg16_params(jax.random.key(3)))


def _port_trunk(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------- ops


def test_unpatchify_inverts_patchify_as_jax():
    from cross_scale_mae_tpu.ops.patchify import unpatchify as junpatchify
    from cross_scale_mae_torch.ops.patchify import patchify, unpatchify

    x = np.random.default_rng(0).normal(size=(2, 16, 4 * 4 * 3)).astype(np.float32)
    got = unpatchify(_t(x), 4, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(junpatchify(jnp.asarray(x), 4, 3)))
    np.testing.assert_array_equal(patchify(got, 4).numpy(), x)
    with pytest.raises(ValueError, match="square"):
        unpatchify(torch.zeros(1, 15, 48), 4, 3)


@pytest.mark.parametrize("method,size", [("linear", 24), ("cubic", 40)])
def test_resize_matches_jax(method, size):
    from cross_scale_mae_tpu.ops.image import resize as jresize
    from cross_scale_mae_torch.ops.image import resize

    x = np.random.default_rng(1).normal(size=(2, 17, 17, 3)).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), size, method))
    np.testing.assert_allclose(resize(_t(x), size, method).numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- the trunk


def test_trunk_carried_from_the_jax_init(jax_trunk):
    cfg = pcfg.get_mae_config("mae_vit_tiny_MsLd", use_perceptual=True, **TINY)
    state = pparams.state_from_jax({"vgg": jax_trunk}, cfg)
    _assert_tree_close(pparams.params_to_jax(state)["vgg"], jax_trunk, 0.0)
    ours = pperc.init_vgg16_params(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == jax.tree.map(np.shape, jax_trunk)
    k = ours["conv1_0"]["kernel"]
    assert float(k.std()) == pytest.approx(np.sqrt(2.0 / (9 * 64)), rel=0.02)
    one_band = {**jax_trunk, "conv0_0": {**jax_trunk["conv0_0"],
                                         "kernel": jax_trunk["conv0_0"]["kernel"][:, :, :1]}}
    with pytest.raises(ValueError, match="shape"):
        pparams.state_from_jax({"vgg": one_band}, cfg)


def test_vgg16_feature_taps_match_jax(jax_trunk):
    x = np.random.default_rng(2).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    want = jperc.vgg16_features(jax_trunk, jnp.asarray(x))
    got = pperc.vgg16_features(_port_trunk(jax_trunk), _t(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("channels,style,resize_to,size", [
    (3, (), None, 32), (3, (1, 3), None, 32), (1, (0,), None, 24), (3, (), 224, 16)])
def test_perceptual_loss_matches_jax(jax_trunk, one_thread, channels, style, resize_to, size):
    rng = np.random.default_rng(4)
    n = 1 if resize_to else 2
    p = rng.uniform(size=(n, size, size, channels)).astype(np.float32)
    t = rng.uniform(size=(n, size, size, channels)).astype(np.float32)
    want = float(jperc.perceptual_loss(jax_trunk, jnp.asarray(p), jnp.asarray(t),
                                       style_layers=style, resize_to=resize_to))
    got = float(pperc.perceptual_loss(_port_trunk(jax_trunk), _t(p), _t(t),
                                      style_layers=style, resize_to=resize_to))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.fixture(scope="module")
def fake_vgg_pth(tmp_path_factory):
    """A seeded torchvision-shaped VGG16 state dict (``features.N.*`` keys)
    and the same tensors under the bare ``N.*`` keys."""
    gen = torch.Generator().manual_seed(9)
    sd, c_in = {}, 3
    for i, c_out in zip(pperc._TORCHVISION_CONVS, (64, 64, 128, 128, 256, 256, 256,
                                                   512, 512, 512)):
        sd[f"features.{i}.weight"] = 0.1 * torch.randn((c_out, c_in, 3, 3), generator=gen)
        sd[f"features.{i}.bias"] = 0.1 * torch.randn((c_out,), generator=gen)
        c_in = c_out
    sd["classifier.0.weight"] = torch.zeros(4, 4)   # the rest of a VGG16, unread
    root = tmp_path_factory.mktemp("vgg")
    full, bare = str(root / "vgg16.pth"), str(root / "features.pth")
    torch.save(sd, full)
    torch.save({k[len("features."):]: v for k, v in sd.items() if k.startswith("features.")},
               bare)
    return full, bare


def test_load_torch_vgg16_features_matches_jax_in_both_key_styles(fake_vgg_pth):
    for path in fake_vgg_pth:
        want = _tree_np(jperc.load_torch_vgg16_features(path))
        got = pparams.params_to_jax(pperc.load_torch_vgg16_features(path))
        _assert_tree_close(got, want, 0.0)
    with pytest.raises(ValueError, match="conv0_0/kernel"):
        pperc.load_torch_vgg16_features(fake_vgg_pth[0], in_channels=1)


def test_pretrain_cli_trains_on_imported_vgg_weights(fake_vgg_pth, tmp_path, one_thread):
    from cross_scale_mae_torch.cli.pretrain import build_run, get_args_parser, main

    path = fake_vgg_pth[0]
    args = get_args_parser().parse_args([
        "--model", "mae_vit_tiny_MsLd", "--input_size", "32", "--patch_size", "8",
        "--batch_size", "4", "--synthetic_len", "4", "--epochs", "1", "--device", "cpu",
        "--use_perceptual_loss", "--vgg_weights", path, "--output_dir", str(tmp_path)])
    run = build_run(args)
    assert run.vgg_trunk == f"imported:{path}"
    _assert_tree_close(pparams.params_to_jax(run.state.model_state["vgg"]),
                       _tree_np(jperc.load_torch_vgg16_features(path)), 0.0)
    result = main(args)
    assert np.isfinite(result["losses"]).all() and "loss_perceptual" in result["last_metrics"]


# ---------------------------------------------------------------- the model


def _cfgs(name="mae_vit_tiny_MsLd", **kw):
    kw = {**TINY, "compute_dtype": "float32", "attention_impl": "xla", **kw}
    return jcfg.get_mae_config(name, **kw), pcfg.get_mae_config(name, **kw)


def test_mae_loss_fn_with_the_perceptual_loss_matches_jax(rng_np, one_thread):
    from cross_scale_mae_tpu.models import mae_init as jinit
    from cross_scale_mae_tpu.models.mae import mae_loss_fn as jloss
    from cross_scale_mae_torch.models.mae import mae_loss_fn
    from cross_scale_mae_torch.train.state import tree_leaves

    jc, pc = _cfgs(use_perceptual=True, perceptual_weight=0.5)
    params, state = jinit(jax.random.key(0), jc)
    imgs = rng_np.normal(size=(2, 32, 32, 3)).astype(np.float32)
    rng = jax.random.key(7)

    def jfn(p):
        out = jloss(p, state, jc, jnp.asarray(imgs), rng)
        return out.loss, out.losses

    (jl, jterms), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)
    port = pparams.params_from_jax(_tree_np(params), pc, full=True)
    for leaf in tree_leaves(port):
        leaf.requires_grad_(True)
    pstate = pparams.state_from_jax(_tree_np(state), pc)
    boxes, noise = _jax_loss_draws(rng, 2, jc)
    out = mae_loss_fn(port, pstate, pc, _t(imgs), noise=noise, ms_boxes=boxes)
    out.loss.backward()
    assert "loss_perceptual" in out.losses and set(out.losses) == set(jterms)
    np.testing.assert_allclose(float(out.loss), float(jl), rtol=1e-5)
    for k in jterms:
        np.testing.assert_allclose(float(out.losses[k]), float(jterms[k]), rtol=1e-5)
    grads = jax.tree.map(lambda t: np.zeros(t.shape, np.float32) if t.grad is None
                         else t.grad.numpy(), port)
    _assert_tree_close(pparams.params_to_jax(jax.tree.map(torch.from_numpy, grads)),
                       _tree_np(jgrads), 1e-5, rel=True)
    assert all(not t.requires_grad for t in tree_leaves(pstate["vgg"]))


def test_single_view_perceptual_config_computes_no_perceptual_term_as_jax(rng_np):
    """The JAX quirk the pretrain CLI refuses: a non-multi-scale config
    returns before the perceptual term."""
    from cross_scale_mae_tpu.models import mae_init as jinit
    from cross_scale_mae_tpu.models.mae import mae_loss_fn as jloss
    from cross_scale_mae_torch.models.mae import mae_loss_fn

    jc, pc = _cfgs("mae_vit_tiny", use_perceptual=True)
    params, state = jinit(jax.random.key(0), jc)
    imgs = rng_np.normal(size=(2, 32, 32, 3)).astype(np.float32)
    rng = jax.random.key(1)
    jout = jloss(params, state, jc, jnp.asarray(imgs), rng)
    out = mae_loss_fn(pparams.params_from_jax(_tree_np(params), pc, full=True),
                      pparams.state_from_jax(_tree_np(state), pc), pc, _t(imgs),
                      noise=_t(jax.random.uniform(rng, (2, pc.num_patches))))
    assert set(out.losses) == set(jout.losses) == {"loss_d"}
    np.testing.assert_allclose(float(out.loss), float(jout.loss), rtol=1e-5)


# ---------------------------------------------------------------- the step


@pytest.mark.parametrize("extra", [{"loss": "mse_ssim", "loss_cd": "mse"},
                                   {"use_perceptual": True}])
def test_pretrain_step_5_step_lockstep_with_jax(extra, one_thread):
    """make_pretrain_step against the JAX one for 5 steps on the tiny
    MsLdCeCd config (fp32, uint8 input through the pretrain augmentation),
    from the same weights (and VGG trunk), with the JAX draws of every step
    injected, as tests/test_torch_port_train.py's 10-step lockstep."""
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

    jc, pc = _cfgs("mae_vit_tiny_MsLdCeCd", **extra)
    n, steps = 4, 5
    sched_args = (1e-3, 0.0, 1, 2, 5)
    params, mstate = jinit(jax.random.key(0), jc)
    jstate = JState.create(params, mstate, jopt(params, jsched(*sched_args), weight_decay=0.05))
    jstep = jstep_fn(jc, jcfg.TrainConfig(batch_size=n), jsched(*sched_args), donate=False,
                     augment=jaug(FMOW_RGB_MEAN, FMOW_RGB_STD, 32, dtype="float32"))
    sched = warmup_half_cosine(*sched_args)
    pp = pparams.params_from_jax(_tree_np(params), pc, full=True)
    pstate = TrainState.create(pp, pparams.state_from_jax(_tree_np(mstate), pc),
                               build_optimizer(pp, sched, weight_decay=0.05))
    pstep = make_pretrain_step(pc, pcfg.TrainConfig(batch_size=n), sched,
                               augment=make_pretrain_augment(FMOW_RGB_MEAN, FMOW_RGB_STD, 32,
                                                             dtype="float32"))
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
        assert set(pm) - {"lr"} == set(jm) - {"lr"}
    np.testing.assert_allclose(pl, jl, rtol=3e-4)
    np.testing.assert_allclose(*zip(*gn), rtol=1e-3)
    _assert_tree_close(pparams.params_to_jax(pstate.params), _tree_np(jstate.params), 5e-4)
    _assert_tree_close(pparams.params_to_jax(pstate.model_state),
                       _tree_np(jstate.model_state), 1e-5)


def test_perceptual_checkpoint_resumes_bit_equal(tmp_path, one_thread):
    """Four steps unbroken against two, a checkpoint, and two more after
    --resume: every leaf of the final state, the VGG trunk's included,
    equal bit for bit."""
    from cross_scale_mae_torch.cli.pretrain import get_args_parser, main
    from cross_scale_mae_torch.utils.checkpoint import restore_arrays_host

    def run(out, *extra):
        return main(get_args_parser().parse_args([
            "--model", "mae_vit_tiny_MsLd", "--input_size", "32", "--patch_size", "8",
            "--batch_size", "4", "--synthetic_len", "4", "--epochs", "4",
            "--warmup_epochs", "1", "--ckpt_interval", "1", "--device", "cpu",
            "--use_perceptual_loss", "--output_dir", str(tmp_path / out), *extra]))

    whole = run("a")
    assert whole["vgg_trunk"] == "random"
    first = run("b", "--max_steps", "2")
    assert first["steps"] == 2
    resumed = run("b", "--resume", os.path.join(first["output_dir"], "checkpoints"))
    assert resumed["steps"] == 2
    a, step_a = restore_arrays_host(os.path.join(whole["output_dir"], "checkpoints"),
                                    subset=None)
    b, step_b = restore_arrays_host(os.path.join(resumed["output_dir"], "checkpoints"),
                                    subset=None)
    assert step_a == step_b == 4 and "vgg" in a["model_state"]
    _assert_tree_close(b, a, 0.0)
