"""The port's evaluation and visualization (``viz/``, ``cli/evalviz.py`` and
the pretrain CLI's ``--plot_recon``) held against the JAX package on the
CPU: ``run_one_image`` on the mask noise that the JAX ``mae_apply`` draws,
``add_noise`` and ``run_eval`` on the JAX draws injected through the
``draws`` hook, the figure's four panels, the temporal-consistency report,
and the evalviz CLI's outputs against the JAX CLI's.

The model is a tiny MsLdCeCd (input 16, patch 8, width 128, 4 layers),
fp32, the plain attention.

Tolerances, each with its reason:
* run_one_image's arrays, fp32: abs 1e-5 (the same forward in another
  order of fp32 sums; values of magnitude ~1); its loss rel 1e-5.
* The sweep's metrics: rel 1e-4 (the pasted images differ by ~1e-6 and the
  metrics are sums and SSIM means over them).
* The figure: exact (it is written from the JAX arrays themselves).
* The temporal report: abs 1e-5 on the cosines (pooled fp32 features).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu.configs import get_mae_config as jconfig
from cross_scale_mae_tpu.models import mae_init as jinit
from cross_scale_mae_torch.configs import get_mae_config
from cross_scale_mae_torch.utils import params as pparams

MEAN, STD = (0.4, 0.5, 0.45), (0.2, 0.25, 0.22)
CFG = dict(input_size=16, patch_size=8, compute_dtype="float32")


@pytest.fixture(scope="module")
def models():
    """The JAX tiny model and its port, from the same weights."""
    jc = jconfig("mae_vit_tiny_MsLdCeCd", **CFG)
    pc = get_mae_config("mae_vit_tiny_MsLdCeCd", **CFG)
    params, _ = jinit(jax.random.key(0), jc)
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return jc, params, pc, pparams.params_from_jax(host, pc, full=True)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(1, 16, 16, 3)).astype(np.float32) for _ in range(2)]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jax_draws(seed: int):
    """The draws of the JAX run_eval (viz/recon.py:163-202): image i's key
    seed * 7919 + i gives mae_apply's mask noise, its fold_in(1) the noise."""
    def draws(i, kind, img, cfg):
        rng = jax.random.key(seed * 7919 + i)
        mask = _t(jax.random.uniform(rng, (img.shape[0], cfg.num_patches)))
        if kind is None:
            return None, mask
        k = jax.random.fold_in(rng, 1)
        shape = tuple(img.shape)
        draw = (jax.random.normal(k, shape) if kind == "gaussian"
                else jax.random.uniform(k, shape[:-1]))
        return _t(draw), mask

    return draws


def test_run_one_image_matches_jax_on_its_mask_noise(models, images):
    from cross_scale_mae_tpu.viz import run_one_image as jrun
    from cross_scale_mae_torch.viz import run_one_image

    jc, jp, pc, pp = models
    for ratio in (None, 0.5):
        key = jax.random.key(5)
        want = jrun(jp, jc, jnp.asarray(images[0]), key, ratio)
        lk = pc.replace(mask_ratio=ratio).len_keep if ratio else pc.len_keep
        noise = _t(jax.random.uniform(key, (1, pc.num_patches)))
        got = run_one_image(pp, pc, _t(images[0]), noise, ratio)
        assert set(got) == set(want)
        for k in ("original", "mask", "masked", "recon", "paste"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["mask"].sum() == (pc.num_patches - lk) * 64 * 3


@pytest.mark.parametrize("kind", ["gaussian", "salt_pepper"])
def test_add_noise_matches_jax_on_its_draw(images, kind):
    from cross_scale_mae_tpu.viz import add_noise as jnoise
    from cross_scale_mae_torch.viz import add_noise

    key = jax.random.key(2)
    want = np.asarray(jnoise(jnp.asarray(images[0]), key, kind, 0.3))
    d = (jax.random.normal(key, images[0].shape) if kind == "gaussian"
         else jax.random.uniform(key, images[0].shape[:-1]))
    got = add_noise(_t(images[0]), _t(d), kind, 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown noise"):
        add_noise(_t(images[0]), _t(d), "speckle")


def test_run_eval_matches_jax_on_injected_draws(models, images):
    from cross_scale_mae_tpu.viz import run_eval as jeval
    from cross_scale_mae_torch.viz import run_eval

    jc, jp, pc, pp = models
    kw = dict(metrics=("mse", "ssim", "l1", "sad"), noise_kinds=(None, "gaussian", "salt_pepper"),
              noise_amount=0.2, mask_ratio=0.5, seed=3)
    want = jeval({"m": (jp, jc)}, [jnp.asarray(x) for x in images], MEAN, STD, **kw)
    got = run_eval({"m": (pp, pc)}, [_t(x) for x in images], MEAN, STD, **kw,
                   draws=_jax_draws(3))
    assert set(got["m"]) == set(want["m"]) and len(got["m"]) == 12
    for k, v in want["m"].items():
        assert got["m"][k] == pytest.approx(v, rel=1e-4), k
    # The default draws: torch generators, the same keys.
    default = run_eval({"m": (pp, pc)}, [_t(x) for x in images], MEAN, STD, **kw)
    assert set(default["m"]) == set(want["m"])


def test_figure_panels_are_the_jax_arrays_in_uint8(models, images, tmp_path):
    from PIL import Image

    from cross_scale_mae_tpu.viz import run_one_image as jrun
    from cross_scale_mae_torch.viz import plot_reconstruction

    jc, jp, _, _ = models
    result = jrun(jp, jc, jnp.asarray(images[1]), jax.random.key(1))
    path = str(tmp_path / "sub" / "fig.png")
    plot_reconstruction(result, path, MEAN, STD, title="t loss=1")
    with Image.open(path) as im:
        assert im.text["Title"] == "t loss=1"
        strip = np.asarray(im.convert("RGB"))
    assert strip.shape == (16, 64, 3)
    for j, k in enumerate(("original", "masked", "recon", "paste")):
        want = np.round(np.clip(result[k][0] * np.asarray(STD) + np.asarray(MEAN), 0, 1)
                        * 255).astype(np.uint8)
        np.testing.assert_array_equal(strip[:, 16 * j:16 * (j + 1)], want, err_msg=k)


@pytest.fixture(scope="module")
def pairs_csv(tmp_path_factory):
    """Ten pairs of seeded JPEGs of varied sizes, gaps of 5 to 40 months."""
    from PIL import Image

    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(7)
    rows = ["category,image_path,image_path2,timestamp,timestamp2"]
    for i in range(10):
        for tag in "ab":
            Image.fromarray(rng.integers(0, 256, (20 + 2 * i, 26, 3), np.uint8)).save(
                d / f"p{i}{tag}.jpg", quality=92)
        rows.append(f"{i % 3},p{i}a.jpg,p{i}b.jpg,2014-{1 + i:02d}-05,{2014 + i // 2}-06-05")
    path = d / "pairs.csv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


@pytest.mark.parametrize("canvas,edges", [(16, (6, 12, 24)), (24, (12, 24))])
def test_temporal_consistency_matches_jax(models, pairs_csv, canvas, edges):
    from cross_scale_mae_tpu.data.datasets import FmowTemporalDataset as JDataset
    from cross_scale_mae_tpu.viz import temporal_consistency_by_gap as jreport
    from cross_scale_mae_torch.data.datasets import FmowTemporalDataset
    from cross_scale_mae_torch.viz import temporal_consistency_by_gap

    jc, jp, pc, pp = models
    want = jreport(jp, jc, JDataset(pairs_csv, canvas_size=canvas), batch_size=4,
                   bucket_edges=edges)
    got = temporal_consistency_by_gap(pp, pc, FmowTemporalDataset(pairs_csv, canvas_size=canvas),
                                      batch_size=4, bucket_edges=edges)
    assert got["gap_months"] == want["gap_months"]
    assert got["overall"]["n"] == want["overall"]["n"] == 10
    assert got["overall"]["mean_cos"] == pytest.approx(want["overall"]["mean_cos"], abs=1e-5)
    assert set(got["buckets"]) == set(want["buckets"])
    for k, b in want["buckets"].items():
        assert got["buckets"][k]["n"] == b["n"]
        assert got["buckets"][k]["mean_cos"] == pytest.approx(b["mean_cos"], abs=1e-5)


def test_temporal_consistency_refuses_an_empty_csv(models, tmp_path):
    from cross_scale_mae_torch.data.datasets import FmowTemporalDataset
    from cross_scale_mae_torch.viz import temporal_consistency_by_gap

    csv = tmp_path / "empty.csv"
    csv.write_text("category,image_path,image_path2,timestamp,timestamp2\n")
    _, _, pc, pp = models
    with pytest.raises(ValueError, match="no rows"):
        temporal_consistency_by_gap(pp, pc, FmowTemporalDataset(str(csv), canvas_size=16))


# ---------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One tiny JAX pretrain state, saved by the JAX package (Orbax) and,
    carried through train_state_from_jax, by the port."""
    from cross_scale_mae_tpu.train import TrainState, build_optimizer
    from cross_scale_mae_tpu.utils.checkpoint import save_checkpoint as jsave
    from cross_scale_mae_torch.train.optim import build_optimizer as pbuild
    from cross_scale_mae_torch.utils.checkpoint import save_checkpoint

    jc = jconfig("mae_vit_tiny_MsLdCeCd", **CFG)
    pc = get_mae_config("mae_vit_tiny_MsLdCeCd", **CFG)
    params, mstate = jinit(jax.random.key(0), jc)
    state = TrainState.create(params, mstate, build_optimizer(params, lambda s: 1e-3))
    root = tmp_path_factory.mktemp("ckpts")
    jdir, pdir = str(root / "jax_run" / "checkpoints"), str(root / "run" / "checkpoints")
    jsave(jdir, 0, state, config_json=jc.to_json())
    pp = pparams.params_from_jax(jax.tree.map(np.asarray, params), pc, full=True)
    port = pparams.train_state_from_jax(state, pc, pbuild(pp, lambda s: 1e-3))
    save_checkpoint(pdir, 0, port, pc.to_json(), {"epoch": 0})
    return jdir, pdir


def test_evalviz_cli_writes_the_jax_clis_files_and_report(checkpoints, pairs_csv, tmp_path,
                                                         capsys):
    from cross_scale_mae_tpu.cli import evalviz as jcli
    from cross_scale_mae_torch.cli import evalviz

    jdir, pdir = checkpoints
    flags = ["--metrics", "mse", "ssim", "--noise", "gaussian", "salt_pepper",
             "--temporal_csv", pairs_csv, "--temporal_batch", "4",
             "--temporal_gap_buckets", "12", "24"]
    want = jcli.main(jcli.get_args_parser().parse_args(
        ["--ckpt", jdir, "--out", str(tmp_path / "jax"), *flags]))
    got = evalviz.main(evalviz.get_args_parser().parse_args(
        ["--ckpt", pdir, "--out", str(tmp_path / "port"), "--device", "cpu", *flags]))
    capsys.readouterr()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        f.replace("jax_run", "run") for f in os.listdir(tmp_path / "jax"))
    assert set(got) == {"run", "temporal_consistency"}
    assert set(got["run"]) == set(want["jax_run"]) == {
        "mse", "ssim", "mse_gaussian", "ssim_gaussian", "mse_salt_pepper", "ssim_salt_pepper"}
    assert all(np.isfinite(v) for v in got["run"].values())
    rep, jrep = got["temporal_consistency"]["run"], want["temporal_consistency"]["jax_run"]
    assert rep["overall"]["n"] == jrep["overall"]["n"] == 10
    assert rep["overall"]["mean_cos"] == pytest.approx(jrep["overall"]["mean_cos"], abs=1e-5)
    assert rep["gap_months"] == jrep["gap_months"] and set(rep["buckets"]) == set(jrep["buckets"])
    with open(tmp_path / "port" / "metrics.json") as f:
        assert json.load(f) == got
    with open(tmp_path / "port" / "temporal_gaps.json") as f:
        assert json.load(f) == got["temporal_consistency"]


def test_evalviz_cli_refusals(checkpoints, tmp_path):
    from cross_scale_mae_torch.cli import evalviz
    from cross_scale_mae_torch.utils.checkpoint import save_checkpoint

    _, pdir = checkpoints
    parse = evalviz.get_args_parser().parse_args
    assert parse(["--ckpt", pdir]).device == "cuda"
    # --jax_platforms cpu runs as --device cpu (tests/test_torch_port_parallel_cli.py);
    # any other JAX platform refuses, naming --device.
    with pytest.raises(SystemExit, match="--device"):
        evalviz.main(parse(["--ckpt", pdir, "--jax_platforms", "tpu"]))
    empty = tmp_path / "empty.csv"
    empty.write_text("category,image_path,image_path2,timestamp,timestamp2\n")
    with pytest.raises(SystemExit, match="no pair rows"):
        evalviz.main(parse(["--ckpt", pdir, "--device", "cpu", "--temporal_csv", str(empty),
                            "--out", str(tmp_path / "o")]))
    assert not (tmp_path / "o").exists()
    cls_dir = str(tmp_path / "cls" / "checkpoints")
    save_checkpoint(cls_dir, 1, type("S", (), {"state_dict": lambda self: {
        "params/head/bias": torch.zeros(2)}})(), json.dumps({"embed_dim": 8}))
    with pytest.raises(SystemExit, match="classifier"):
        evalviz.main(parse(["--ckpt", cls_dir, "--device", "cpu"]))


def _pretrain_args(tmp_path, *extra):
    from cross_scale_mae_torch.cli.pretrain import get_args_parser

    return get_args_parser().parse_args([
        "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "16", "--patch_size", "8",
        "--batch_size", "4", "--synthetic_len", "4", "--epochs", "2", "--warmup_epochs", "1",
        "--device", "cpu", "--output_dir", str(tmp_path / "out"), *extra])


def test_pretrain_plot_recon_writes_a_figure_per_checkpoint(tmp_path):
    from PIL import Image

    from cross_scale_mae_torch.cli.pretrain import main

    result = main(_pretrain_args(tmp_path, "--plot_recon", "--ckpt_interval", "1"))
    names = [os.path.basename(p) for p in result["figures"]]
    assert names == ["epoch_0000.png", "epoch_0001.png"]
    for p in result["figures"]:
        with Image.open(p) as im:
            assert im.size == (64, 16) and im.text["Title"].startswith("epoch")
    config = os.path.join(result["output_dir"], "config.json")
    assert json.load(open(config))["vgg_trunk"] == "n/a"


def test_pretrain_val_img_path_file_directory_and_empty_directory(tmp_path):
    from PIL import Image

    from cross_scale_mae_torch.cli.pretrain import build_run, main

    pics = tmp_path / "pics"
    pics.mkdir()
    for name in ("b.png", "a.jpg"):
        Image.fromarray(np.random.default_rng(1).integers(0, 256, (30, 20, 3), np.uint8)).save(
            pics / name)
    (pics / "notes.txt").write_text("not an image")
    result = main(_pretrain_args(tmp_path, "--val_img_path", str(pics)))
    assert [os.path.basename(p) for p in result["figures"]] == ["epoch_0001_a.png",
                                                                "epoch_0001_b.png"]
    result = main(_pretrain_args(tmp_path, "--val_img_path", str(pics / "b.png"),
                                 "--max_steps", "1", "--ckpt_interval", "1"))
    assert [os.path.basename(p) for p in result["figures"]] == ["epoch_0000_b.png"]
    empty = tmp_path / "none"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no image files"):
        build_run(_pretrain_args(tmp_path, "--val_img_path", str(empty)))
    with pytest.raises(FileNotFoundError, match="no such file"):
        build_run(_pretrain_args(tmp_path, "--val_img_path", str(tmp_path / "missing.png")))


def test_pretrain_perceptual_flags(tmp_path):
    from cross_scale_mae_torch.cli.pretrain import build_run, main

    with pytest.raises(SystemExit, match="without --use_perceptual_loss"):
        build_run(_pretrain_args(tmp_path, "--vgg_weights", "v.pth"))
    with pytest.raises(SystemExit, match="multi-scale"):
        build_run(_pretrain_args(tmp_path, "--use_perceptual_loss", "--model", "mae_vit_tiny"))
    with pytest.raises(SystemExit, match="--loss_cd"):
        build_run(_pretrain_args(tmp_path, "--loss", "ssim"))
    assert build_run(_pretrain_args(tmp_path, "--loss", "ssim", "--loss_cd", "l1")).cfg.loss == "ssim"
    result = main(_pretrain_args(tmp_path, "--use_perceptual_loss", "--max_steps", "1"))
    assert result["vgg_trunk"] == "random" and "loss_perceptual" in result["last_metrics"]
    with open(os.path.join(result["output_dir"], "config.json")) as f:
        assert json.load(f)["vgg_trunk"] == "random"
