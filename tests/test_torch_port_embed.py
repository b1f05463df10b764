"""The port's ``cli/embed`` held against the JAX package's on the CPU: the
same pretrain weights (a JAX Orbax checkpoint for the JAX CLI, an npz of
the same trees for the port), the same ``--synthetic_len`` split with a
ragged last batch, and the features, labels and meta keys compared:
features at 1e-5 in fp32 and, in bf16, the budget of
tests/test_torch_port_serving.py (max 2**-4 x max(1, max|ref|), mean
2**-7 x max(1, mean|ref|)); labels equal.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_torch.utils import checkpoint as pckpt

torch.set_num_threads(1)

TINY = dict(input_size=16, patch_size=8, dim_model=32, encoder_num_layers=2,
            encoder_num_heads=4, decoder_embed_dim=16, decoder_num_layers=1,
            decoder_num_heads=4, predictor_hidden_size=16, attention_impl="xla")
# 21 images at batch 8: two full batches and a ragged one of 5 (the JAX
# CLI shards each batch over its 8 virtual CPU devices).
N_IMAGES, BATCH = 21, 8


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from cross_scale_mae_tpu.models.mae import mae_init
    from cross_scale_mae_tpu.utils.checkpoint import save_checkpoint

    out = {}
    root = tmp_path_factory.mktemp("embed")
    for dtype in ("float32", "bfloat16"):
        cfg = jcfg.get_mae_config("mae_vit_base_MsLdCeCd", **TINY, compute_dtype=dtype)
        params, state = mae_init(jax.random.key(0), cfg)
        rng = np.random.default_rng(0)
        params = jax.tree.map(
            lambda a: np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(np.float32),
            params)
        jdir = str(root / f"jax_{dtype}")
        save_checkpoint(jdir, 1, types.SimpleNamespace(
            params=params, model_state=state, opt_state={"count": np.zeros((), np.int32)},
            step=np.int32(1)), cfg.to_json())
        npz = str(root / f"port_{dtype}.npz")
        pckpt.save_params_npz(npz, params, cfg.to_json())
        out[dtype] = (jdir, npz)
    return out


def _argv(ckpt, out, pool, *extra):
    return ["--ckpt", ckpt, "--dataset_type", "synthetic", "--synthetic_len", str(N_IMAGES),
            "--batch_size", str(BATCH), "--pool", pool, "--output_dir", out,
            "--num_workers", "2", *extra]


def _read(out):
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    return (np.load(os.path.join(out, "features.npy")),
            np.load(os.path.join(out, "labels.npy")), meta)


@pytest.mark.parametrize("pool,dtype", [("cls", "float32"), ("mean", "float32"),
                                        ("tokens", "float32"), ("mean", "bfloat16")])
def test_embed_matches_jax(ckpts, tmp_path, pool, dtype):
    from cross_scale_mae_tpu.cli import embed as jembed
    from cross_scale_mae_torch.cli import embed as pembed

    jdir, npz = ckpts[dtype]
    jembed.main(jembed.get_args_parser().parse_args(_argv(jdir, str(tmp_path / "j"), pool)))
    res = pembed.main(pembed.get_args_parser().parse_args(
        _argv(npz, str(tmp_path / "p"), pool, "--device", "cpu")))
    (jf, jl, jm), (pf, pl, pm) = _read(tmp_path / "j"), _read(tmp_path / "p")
    assert res["count"] == N_IMAGES and res["batches"] == 3
    assert set(pm) == set(jm) and pm["count"] == jm["count"] == N_IMAGES
    assert pm["shape"] == jm["shape"] == list(jf.shape)
    np.testing.assert_array_equal(pl, jl)
    err = np.abs(pf - jf)
    if dtype == "float32":
        assert err.max() <= 1e-5, err.max()
    else:
        assert err.max() <= 2.0 ** -4 * max(1.0, np.abs(jf).max()), err.max()
        assert err.mean() <= 2.0 ** -7 * max(1.0, np.abs(jf).mean()), err.mean()


def test_embed_refuses_a_classifier_and_reports_unused_flags(tmp_path, capsys):
    from cross_scale_mae_torch.cli import embed as pembed

    clf = str(tmp_path / "clf.npz")
    pckpt.save_params_npz(clf, {"w": np.zeros(1)}, json.dumps({"embed_dim": 8}))
    with pytest.raises(SystemExit, match="classifier"):
        pembed.main(pembed.get_args_parser().parse_args(
            _argv(clf, str(tmp_path), "cls", "--device", "cpu", "--gelu", "exact")))
    assert "not applicable here: --gelu" in capsys.readouterr().out
