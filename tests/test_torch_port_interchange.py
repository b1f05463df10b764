"""The port's interchange with the reference's ``.pth`` schema held against
the JAX package's on the CPU.

* ``interpolate_pos_embed``: the JAX function's values at 1e-6 in fp32 (the
  same bicubic matrix, summed in another order).
* ``mae_state_dict`` and ``classifier_state_dict``: key for key, dtype for
  dtype and bit for bit the JAX package's on the same weights; the args
  payloads equal.
* The ``.pth`` import: the port's ``import_mae_checkpoint`` and
  ``import_classifier_checkpoint`` bit-equal to the JAX importers' trees
  carried into the port's layout, from the timm and the xFormers layouts.
* ``cli/export_torch``: the same ``.pth`` as the JAX CLI's from the same
  weights.
* ``cli/finetune --finetune x.pth``: the encoder's weights loaded, one step
  taken, on the CPU.
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_torch.configs import MAEConfig, ViTClassifierConfig
from cross_scale_mae_torch.utils import checkpoint as pckpt
from cross_scale_mae_torch.utils import torch_export as ptx
from cross_scale_mae_torch.utils import torch_import as pti
from cross_scale_mae_torch.utils.params import (
    params_from_jax,
    params_to_jax,
    state_from_jax,
    vit_params_from_jax,
)

torch.set_num_threads(1)

MAE_TINY = dict(input_size=16, patch_size=8, dim_model=32, encoder_num_layers=2,
                encoder_num_heads=4, decoder_embed_dim=16, decoder_num_layers=1,
                decoder_num_heads=4, predictor_hidden_size=16, compute_dtype="float32")
VIT_TINY = dict(input_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4,
                num_classes=5, compute_dtype="float32")


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(np.float32), tree)


def _mae(variant="MsLdCeCd", seed=0):
    from cross_scale_mae_tpu.models.mae import mae_init

    cfg = jcfg.get_mae_config(f"mae_vit_base_{variant}" if variant else "mae_vit_base",
                              **MAE_TINY)
    params, state = mae_init(jax.random.key(seed), cfg)
    state = _perturbed(state, seed + 1)
    return cfg, _perturbed(params, seed), state


def _vit(bn, seed=1, **kw):
    from cross_scale_mae_tpu.models.vit import vit_init

    cfg = jcfg.ViTClassifierConfig(**{**VIT_TINY, **kw}, use_bn_head=bn, global_pool=not bn)
    params, state = vit_init(jax.random.key(seed), cfg)
    return cfg, _perturbed(params, seed), _perturbed(state, seed + 1)


def _sd_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("old,new", [(4, 6), (6, 4), (14, 16), (8, 5), (3, 3)])
def test_interpolate_pos_embed_matches_jax(old, new):
    from cross_scale_mae_tpu.ops.pos_embed import get_2d_sincos_pos_embed
    from cross_scale_mae_tpu.ops.pos_embed import interpolate_pos_embed as jinterp
    from cross_scale_mae_torch.ops.pos_embed import interpolate_pos_embed

    rng = np.random.default_rng(old * 31 + new)
    tables = [np.asarray(get_2d_sincos_pos_embed(32, old, cls_token=True))[None],
              rng.normal(size=(1, 1 + old * old, 32)).astype(np.float32)]
    for table in tables:
        want = np.asarray(jinterp(jnp.asarray(table), new))
        got_np = interpolate_pos_embed(table, new)
        got_t = interpolate_pos_embed(torch.tensor(table[0]), new)
        assert got_np.shape == want.shape == (1, 1 + new * new, 32)
        np.testing.assert_allclose(got_np, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_t.numpy(), want[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got_np[:, 0], table[:, 0])   # the cls row passes


@pytest.mark.parametrize("variant", ["MsLdCeCd", "MsLdCe", ""])
def test_mae_state_dict_matches_jax(variant):
    from cross_scale_mae_tpu.utils import torch_export as jtx

    cfg, params, state = _mae(variant)
    pc = MAEConfig.from_json(cfg.to_json())
    got = ptx.mae_state_dict(params_from_jax(params, pc, full=True), pc,
                             state_from_jax(state, pc) if state else None)
    _sd_equal(got, jtx.mae_state_dict(params, cfg, state))
    assert ptx.reference_model_name(pc) == jtx.reference_model_name(cfg)
    assert ptx.reference_args(pc, "mae_vit_base") == jtx.reference_args(cfg, "mae_vit_base")


@pytest.mark.parametrize("bn", [False, True])
def test_classifier_state_dict_matches_jax(bn):
    from cross_scale_mae_tpu.utils import torch_export as jtx

    cfg, params, state = _vit(bn)
    pc = ViTClassifierConfig.from_json(cfg.to_json())
    pstate = {"head_bn": {k: torch.from_numpy(v) for k, v in state["head_bn"].items()}} \
        if bn else {}
    got = ptx.classifier_state_dict(vit_params_from_jax(params, pc), pc, pstate)
    _sd_equal(got, jtx.classifier_state_dict(params, cfg, state))
    assert ptx.classifier_args(pc, "vit_base_patch16") == jtx.classifier_args(
        cfg, "vit_base_patch16")
    if bn:
        with pytest.raises(ValueError, match="head_bn"):
            ptx.classifier_state_dict(vit_params_from_jax(params, pc), pc, {})


def _to_xformers(sd: dict) -> dict:
    """The timm names back into the xFormers layout, q/k/v split (the
    inverse of main_finetune.py:556-566)."""
    out = {}
    for k, v in sd.items():
        for part in ("encoder", "decoder"):
            if k.startswith(f"{part}.") and k.split(".")[1].isdigit():
                i, rest = k.split(".")[1], ".".join(k.split(".")[2:])
                base = f"{part}.encoders.{i}"
                if rest.startswith("attn.qkv."):
                    kind = rest.split(".")[-1]
                    for name, chunk in zip("qkv", np.split(v, 3, axis=0)):
                        out[f"{base}.wrap_att.sublayer.layer.in_proj_container."
                            f"{name}_proj.{kind}"] = chunk
                    break
                mapping = {"norm1.": "wrap_att.norm.", "attn.proj.": "wrap_att.sublayer.layer.proj.",
                           "norm2.": "wrap_ff.norm.", "mlp.fc1.": "wrap_ff.sublayer.layer.mlp.0.",
                           "mlp.fc2.": "wrap_ff.sublayer.layer.mlp.3."}
                src = next(s for s in mapping if rest.startswith(s))
                out[f"{base}.{mapping[src]}{rest[len(src):]}"] = v
                break
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("layout", ["timm", "xformers"])
def test_mae_pth_import_matches_jax(tmp_path, layout):
    from cross_scale_mae_tpu.utils import torch_export as jtx
    from cross_scale_mae_tpu.utils.torch_import import import_mae_checkpoint

    cfg, params, state = _mae("MsLdCd")
    sd = jtx.mae_state_dict(params, cfg, state)
    if layout == "xformers":
        sd = _to_xformers(sd)
        assert any(".wrap_att." in k for k in sd)
    path = str(tmp_path / "mae.pth")
    jtx.save_torch_checkpoint(path, sd, jtx.reference_args(cfg, "mae_vit_base"), epoch=7)
    want = jax.tree.map(np.asarray, import_mae_checkpoint(path, cfg))
    got = pti.import_mae_checkpoint(path, MAEConfig.from_json(cfg.to_json()))
    assert set(got) == set(want) and "predictor_cd" in got
    for a, b in zip(jax.tree.leaves(params_to_jax(got)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(params_to_jax(got)),
                    jax.tree.leaves({k: params[k] for k in want})):
        np.testing.assert_array_equal(a, b)   # and the weights exported


def test_classifier_pth_import_interpolates_like_jax(tmp_path):
    from cross_scale_mae_tpu.utils import torch_export as jtx
    from cross_scale_mae_tpu.utils.torch_import import import_classifier_checkpoint

    cfg, params, _ = _vit(False)
    path = str(tmp_path / "vit.pth")
    jtx.save_torch_checkpoint(path, jtx.classifier_state_dict(params, cfg))
    bigger = cfg.replace(input_size=24)      # grid 2 -> 3: pos_embed resampled
    want = jax.tree.map(np.asarray, import_classifier_checkpoint(path, bigger))
    got = params_to_jax(pti.import_classifier_checkpoint(
        path, ViTClassifierConfig.from_json(bigger.to_json())))
    assert got["pos_embed"].shape == (1, 10, 32)
    np.testing.assert_allclose(got["pos_embed"], want["pos_embed"], rtol=0, atol=1e-6)
    for k in ("patch_embed", "blocks", "head", "fc_norm", "cls_token"):
        for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want[k])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["mae", "linprobe"])
def test_export_torch_cli_matches_jax(tmp_path, kind):
    import types

    from cross_scale_mae_tpu.cli import export_torch as jcli
    from cross_scale_mae_tpu.utils.checkpoint import save_checkpoint
    from cross_scale_mae_torch.cli import export_torch as pcli

    if kind == "mae":
        cfg, params, state = _mae("MsLdCeCd")
    else:
        cfg, params, state = _vit(True)
    jdir = str(tmp_path / "jax")
    save_checkpoint(jdir, 2, types.SimpleNamespace(
        params=params, model_state=state, opt_state={"count": np.zeros((), np.int32)},
        step=np.int32(2)), cfg.to_json(), {"epoch": 4})
    npz = str(tmp_path / "port.npz")
    pckpt.save_params_npz(npz, {"params": params, "model_state": state}, cfg.to_json())
    jres = jcli.main(jcli.get_args_parser().parse_args(
        ["--ckpt", jdir, "--output", str(tmp_path / "j.pth"), "--model_name", "ref_name"]))
    pres = pcli.main(pcli.get_args_parser().parse_args(
        ["--ckpt", npz, "--output", str(tmp_path / "p.pth"), "--model_name", "ref_name",
         "--epoch", "4"]))
    assert {k: v for k, v in pres.items() if k not in ("output", "size_bytes")} == \
        {k: v for k, v in jres.items() if k not in ("output", "size_bytes")}
    with torch.serialization.safe_globals([argparse.Namespace]):
        j = torch.load(str(tmp_path / "j.pth"), weights_only=True)
        p = torch.load(str(tmp_path / "p.pth"), weights_only=True)
    assert vars(j["args"]) == vars(p["args"]) and j["epoch"] == p["epoch"] == 4
    _sd_equal({k: v.numpy() for k, v in p["model"].items()},
              {k: v.numpy() for k, v in j["model"].items()})


def test_finetune_from_a_pth_loads_the_encoder_and_steps(tmp_path):
    from cross_scale_mae_tpu.utils import torch_export as jtx
    from cross_scale_mae_torch.cli import finetune

    cfg, params, state = _mae("MsLdCeCd")
    path = str(tmp_path / "checkpoint-0.pth")
    jtx.save_torch_checkpoint(path, jtx.mae_state_dict(params, cfg, state),
                              jtx.reference_args(cfg, "mae_vit_base"))
    argv = ["--model", "vit_base_patch16", "--embed_dim", "32", "--depth", "2",
            "--num_heads", "4", "--input_size", "16", "--patch_size", "8", "--batch_size", "4",
            "--synthetic_len", "8", "--nb_classes", "3", "--max_steps", "1", "--device", "cpu",
            "--finetune", path, "--output_dir", str(tmp_path / "out")]
    run = finetune.build_run(finetune.get_args_parser().parse_args(argv))
    blocks = run.state.params["blocks"]
    np.testing.assert_array_equal(blocks[1]["mlp"]["fc1"]["kernel"].detach().numpy(),
                                  params["encoder_blocks"]["mlp"]["fc1"]["kernel"][1])
    np.testing.assert_array_equal(run.state.params["cls_token"].detach().numpy(),
                                  params["cls_token"])
    res = finetune.main(finetune.get_args_parser().parse_args(argv))
    assert res["steps"] == 1 and np.isfinite(res["losses"]).all()
