"""The port's ``cli/export`` (a ``torch.export`` artifact) and
``serving.load_artifact`` on the CPU.

* Every export form (baked, ``--no_bake_weights``, ``--quantize int8``,
  ``--symbolic_batch``, and a BN-head classifier baked) round-trips
  through ``load_artifact`` and ``cli/serve --artifact`` over HTTP, its
  answers held to the in-process forward with the same (plain) attention
  and weights at 1e-5 (fp32).
* The sidecars: the port's ``.params.npz`` and ``.q8.npz`` hold the keys
  and arrays of the JAX package's ``cli/export.py`` on the same weights,
  bit for bit, and its ``.json`` sidecar the JAX keys.
* The refusals and the sidecar fall-back next to a moved artifact.
"""

import io
import json
import os
import shutil
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_torch import serving as psrv
from cross_scale_mae_torch.cli import export as pexport
from cross_scale_mae_torch.utils import checkpoint as pckpt

torch.set_num_threads(1)

TINY = dict(input_size=16, patch_size=8, dim_model=32, encoder_num_layers=2,
            encoder_num_heads=4, decoder_embed_dim=16, decoder_num_layers=1,
            decoder_num_heads=4, predictor_hidden_size=16, attention_impl="pallas_v3",
            compute_dtype="float32")
VIT = dict(input_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4, num_classes=5,
           use_bn_head=True, compute_dtype="float32", attention_impl="pallas_v3")
JAX_SIDECAR_KEYS = {"ckpt", "kind", "pool", "dataset_type", "input", "output_dim", "bytes",
                    "platforms", "weights", "quantize", "verified"}


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The MAE weights as a JAX Orbax directory and an npz; a BN-head
    classifier as an npz with params and model_state."""
    from cross_scale_mae_tpu.models.mae import mae_init
    from cross_scale_mae_tpu.models.vit import vit_init
    from cross_scale_mae_tpu.utils.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("export")
    cfg = jcfg.get_mae_config("mae_vit_base_MsLdCeCd", **TINY)
    params, state = mae_init(jax.random.key(0), cfg)
    params = _perturbed(params, 0)
    jdir = str(root / "jax")
    save_checkpoint(jdir, 1, types.SimpleNamespace(
        params=params, model_state=state, opt_state={"count": np.zeros((), np.int32)},
        step=np.int32(1)), cfg.to_json())
    npz = str(root / "mae.npz")
    pckpt.save_params_npz(npz, params, cfg.to_json())
    vcfg = jcfg.ViTClassifierConfig(**VIT)
    vparams, _ = vit_init(jax.random.key(1), vcfg)
    rng = np.random.default_rng(3)
    vstate = {"head_bn": {"mean": rng.normal(0, 0.3, 32).astype(np.float32),
                          "var": rng.uniform(0.5, 2.0, 32).astype(np.float32)}}
    clf = str(root / "clf.npz")
    pckpt.save_params_npz(clf, {"params": _perturbed(vparams, 1), "model_state": vstate},
                          vcfg.to_json())
    return {"jax": jdir, "mae": npz, "clf": clf}


def _export(ckpt, out, *extra):
    return pexport.main(pexport.get_args_parser().parse_args(
        ["--ckpt", ckpt, "--output", out, "--batch_size", "4", "--platforms", "cpu",
         "--pool", "mean", *extra]))


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()))


FORMS = {"baked": ("mae", []), "params": ("mae", ["--no_bake_weights"]),
         "int8": ("mae", ["--quantize", "int8"]), "symbolic": ("mae", ["--symbolic_batch"]),
         "classifier": ("clf", [])}


@pytest.mark.parametrize("form", list(FORMS))
def test_export_form_serves_over_http(ckpts, tmp_path, form):
    from cross_scale_mae_torch.cli.serve import build_app, get_args_parser

    which, extra = FORMS[form]
    out = str(tmp_path / "a.pt2")
    meta = _export(ckpts[which], out, *extra)
    with open(out + ".json") as f:
        sidecar = json.load(f)
    assert JAX_SIDECAR_KEYS <= set(sidecar) and sidecar["verified"] == "roundtrip"
    assert sidecar["platforms"] == ["cpu"] and meta["bytes"] == os.path.getsize(out)
    assert sidecar["kind"] == ("classifier" if which == "clf" else "mae")
    assert sidecar["input"][0] == (None if form == "symbolic" else 4)
    assert sidecar["weights"] == {"params": out + ".params.npz", "int8": out + ".q8.npz"}.get(
        form, "baked")
    if form == "int8":
        assert 0.99 < sidecar["quantize"]["cosine_vs_fp_min"] <= 1.0
    ref = psrv.build_serving_model(ckpts[which], pool="mean", batch_size=4, device="cpu",
                                   portable=True, quantize="int8" if form == "int8" else None)
    server, batcher = build_app(get_args_parser().parse_args(
        ["--artifact", out, "--device", "cpu", "--port", "0", "--batch_size", "4",
         "--max_delay_ms", "1"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/info", timeout=30) as r:
            info = json.load(r)
        assert info["source"] == "artifact"
        assert info["input"] == [None if form == "symbolic" else 4, 18, 18, 3]
        u8 = np.random.default_rng(5).integers(0, 256, (6, 18, 18, 3), np.uint8)
        got = _post(url, u8)
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(5)
    np.testing.assert_allclose(got, ref.fn(u8), rtol=0, atol=1e-5)
    if form == "symbolic":
        model = psrv.load_artifact(out, device="cpu")
        assert model.batch_size is None
        for n in (1, 7):
            np.testing.assert_allclose(model.fn(u8[:1].repeat(n, 0)), ref.fn(u8[:1].repeat(n, 0)),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["params", "q8"])
def test_sidecars_match_the_jax_export(ckpts, tmp_path, mode):
    from cross_scale_mae_tpu.cli import export as jexport

    flag = ["--no_bake_weights"] if mode == "params" else ["--quantize", "int8"]
    jexport.main(jexport.get_args_parser().parse_args(
        ["--ckpt", ckpts["jax"], "--output", str(tmp_path / "j.stablehlo"), "--batch_size", "4",
         "--pool", "mean", *flag]))
    _export(ckpts["mae"], str(tmp_path / "p.pt2"), *flag)
    suffix = ".params.npz" if mode == "params" else ".q8.npz"
    with np.load(str(tmp_path / "j.stablehlo") + suffix) as j, \
            np.load(str(tmp_path / "p.pt2") + suffix) as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert j[k].dtype == p[k].dtype, k
            np.testing.assert_array_equal(j[k], p[k], err_msg=k)
        if mode == "q8":
            assert p["encoder_blocks/attn/qkv/kernel/__int8__"].dtype == np.int8
    with open(str(tmp_path / "j.stablehlo") + ".json") as f:
        jmeta = json.load(f)
    with open(str(tmp_path / "p.pt2") + ".json") as f:
        pmeta = json.load(f)
    assert set(jmeta) <= set(pmeta)
    for k in ("kind", "pool", "dataset_type", "input", "output_dim"):
        assert pmeta[k] == jmeta[k], k


@pytest.mark.parametrize("extra,match", [
    (["--platforms", "tpu"], "counterpart"), (["--platforms", "cpu", "cuda"], "one device"),
    (["--quantize", "int8", "--no_bake_weights"], "drop --no_bake_weights")])
def test_export_refusals(ckpts, tmp_path, extra, match):
    argv = ["--ckpt", ckpts["mae"], "--output", str(tmp_path / "a.pt2"), *extra]
    if "--platforms" not in extra:
        argv += ["--platforms", "cpu"]
    with pytest.raises(SystemExit, match=match):
        pexport.main(pexport.get_args_parser().parse_args(argv))


def test_moved_artifact_finds_its_sidecar(ckpts, tmp_path):
    out = str(tmp_path / "a" / "w.pt2")
    _export(ckpts["mae"], out, "--no_bake_weights")
    moved = tmp_path / "b"
    shutil.copytree(tmp_path / "a", moved)
    shutil.rmtree(tmp_path / "a")
    model = psrv.load_artifact(str(moved / "w.pt2"), device="cpu")
    assert model.meta["weights"] == out + ".params.npz"  # the recorded path, gone
    u8 = np.zeros((4, 18, 18, 3), np.uint8)
    ref = psrv.build_serving_model(ckpts["mae"], pool="mean", batch_size=4, device="cpu",
                                   portable=True)
    np.testing.assert_allclose(model.fn(u8), ref.fn(u8), rtol=0, atol=1e-5)
    os.remove(str(moved / "w.pt2") + ".json")
    with pytest.raises(SystemExit, match="sidecar"):
        psrv.load_artifact(str(moved / "w.pt2"), device="cpu")
