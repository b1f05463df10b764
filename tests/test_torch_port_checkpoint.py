"""The port's checkpoints (``utils/checkpoint.py``, ``TrainState.state_dict``)
on the CPU: the save -> restore round trip of the AdamW and LARS states,
bit for bit and in place; the atomic write; the JAX package's golden
checkpoint carried by ``train_state_from_jax``; the classifier CLIs resumed
after an epoch against unbroken runs; and checkpoint directories served
and finetuned from.

Tolerances, each with its reason:
* the golden loss: 1e-5 absolute, the bound the JAX package's own freeze
  test holds its restore to (``tests/test_ckpt_schema_freeze.py``); the
  port runs the same fp32 arithmetic in another order of sums.
* one AdamW step from the carried golden state against the JAX step:
  params 1e-6 absolute (elementwise fp32 on values of magnitude ~1; the
  moments' update is the same formula), moments 1e-7 (values ~1e-3).
* everything else bit-equal: a restore copies bytes, and a resumed run
  repeats the same arithmetic on the same draws.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_torch import configs as pcfg
from cross_scale_mae_torch.train.state import tree_leaves
from cross_scale_mae_torch.utils import checkpoint as pckpt
from tests.torch_jax_state import jax_moments

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "ckpt_v1")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small CPU runs, which the
    other test workers would otherwise contend with; restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
TINY = dict(input_size=32, patch_size=8, dim_model=64, encoder_num_layers=2,
            encoder_num_heads=4, decoder_embed_dim=32, decoder_num_layers=1,
            decoder_num_heads=4, predictor_hidden_size=32, compute_dtype="float32",
            attention_impl="xla")


def _mae_state(seed: int, **moment_dtypes):
    from cross_scale_mae_torch.models.mae import mae_init
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import TrainState

    cfg = pcfg.get_mae_config("mae_vit_tiny_MsLdCeCd", **TINY)
    params, mstate = mae_init(cfg, torch.Generator().manual_seed(seed))
    tx = build_optimizer(params, lambda s: 1e-3 * (s + 1), weight_decay=0.05, clip_grad=1.0,
                         **moment_dtypes)
    return TrainState.create(params, mstate, tx)


def _lars_state(seed: int):
    from cross_scale_mae_torch.cli.linprobe import head_only_mask
    from cross_scale_mae_torch.models.vit import vit_init
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import TrainState

    cfg = pcfg.get_vit_config("vit_base_patch16", input_size=32, patch_size=8, embed_dim=32,
                              depth=2, num_heads=4, num_classes=5, use_bn_head=True)
    params, mstate = vit_init(cfg, torch.Generator().manual_seed(seed))
    tx = build_optimizer(params, lambda s: 0.1, optimizer="lars", weight_decay=0.0,
                         frozen_mask=head_only_mask(params))
    return TrainState.create(params, mstate, tx)


def _random_steps(state, seed: int, steps: int = 2):
    """``steps`` updates with seeded random gradients (None on the frozen
    leaves of LARS) and a BatchNorm state moved, so nothing is at its init."""
    gen = torch.Generator().manual_seed(seed)
    trainable = getattr(state.tx, "trainable", None)
    for _ in range(steps):
        grads = [torch.randn(p.shape, generator=gen)
                 if trainable is None or trainable[i] else None
                 for i, p in enumerate(tree_leaves(state.params))]
        moved = jax.tree.map(lambda t: t + torch.rand(t.shape, generator=gen),
                             state.model_state)
        state.apply_gradients(grads, moved)
    return state


def _holders(state) -> list[torch.Tensor]:
    """Every tensor a step function may hold: the params, the BatchNorm
    state and the optimizer's moments."""
    opt = state.opt_state
    return [*tree_leaves(state.params), *tree_leaves(state.model_state), *opt.mu,
            *getattr(opt, "nu", [])]


@pytest.mark.parametrize("make", [_mae_state, _lars_state], ids=["adamw", "lars"])
def test_round_trip_is_bit_equal_and_restores_in_place(tmp_path, make):
    src = _random_steps(make(0), seed=1)
    pckpt.save_checkpoint(str(tmp_path), src.step, src, '{"dim_model": 8}', {"epoch": 3})
    dst = make(5)
    held = _holders(dst)
    ptrs = [t.data_ptr() for t in held]
    out, meta = pckpt.restore_checkpoint(str(tmp_path), dst)
    assert out is dst and meta == {"step": 2, "epoch": 3, "config": {"dim_model": 8}}
    # The same tensor objects, in the same storage, now holding the values.
    assert all(a is b for a, b in zip(_holders(dst), held))
    assert [t.data_ptr() for t in _holders(dst)] == ptrs
    assert dst.step == src.step == 2 and dst.opt_state.count == src.opt_state.count == 2
    for a, b in zip(_holders(dst), _holders(src)):
        assert torch.equal(a, b)
    assert set(dst.state_dict()) == set(src.state_dict())
    # And the next update from either is the same, bit for bit.
    for s in (src, dst):
        _random_steps(s, seed=7, steps=1)
    for a, b in zip(_holders(dst), _holders(src)):
        assert torch.equal(a, b)


def test_state_dict_keys_are_the_jax_tree_paths():
    """The flat keys are the JAX TrainState's paths: block leaves stacked on
    a leading layer axis, each moment under its parameter's path."""
    state = _mae_state(0)
    flat = state.state_dict()
    qkv = flat["params/encoder_blocks/attn/qkv/kernel"]
    assert qkv.shape == (2, 64, 192)
    assert torch.equal(qkv[1], state.params["encoder_blocks"][1]["attn"]["qkv"]["kernel"])
    assert flat["opt_state/mu/encoder_blocks/attn/qkv/kernel"].shape == qkv.shape
    assert flat["opt_state/nu/decoder_pred/bias"].shape == (192,)
    assert "model_state/predictor_cd/bn/mean" in flat
    assert int(flat["step"]) == 0 and int(flat["opt_state/count"]) == 0
    lars = _lars_state(0).state_dict()
    assert sorted(k for k in lars if k.startswith("opt_state/mu/")) == [
        "opt_state/mu/head/bias", "opt_state/mu/head/kernel"]


def test_restore_refuses_a_checkpoint_that_does_not_fit(tmp_path):
    src = _mae_state(0)
    pckpt.save_checkpoint(str(tmp_path), 0, src)
    other = pcfg.get_mae_config("mae_vit_tiny_MsLdCeCd", **{**TINY, "dim_model": 32})
    from cross_scale_mae_torch.models.mae import mae_init
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import TrainState

    params, mstate = mae_init(other, torch.Generator().manual_seed(0))
    dst = TrainState.create(params, mstate, build_optimizer(params, lambda s: 0.0))
    with pytest.raises(ValueError, match="shape"):
        pckpt.restore_checkpoint(str(tmp_path), dst)
    with pytest.raises(KeyError, match="lacks"):
        _lars_state(0).load_state_dict(src.state_dict())


@pytest.mark.parametrize("dtypes", [dict(mu_dtype="bfloat16"),
                                    dict(mu_dtype="bfloat16", nu_dtype="bfloat16")])
def test_bf16_moments_round_trip_and_do_not_restore_into_fp32_moments(tmp_path, dtypes):
    """A checkpoint of bf16 Adam moments holds them in bf16, restores bit
    for bit into a state with the same dtypes, and raises naming the dtype
    against an fp32-moment state (``copy_`` would cast without a word),
    and the other way round."""
    src = _random_steps(_mae_state(0, **dtypes), seed=1)
    # The bf16 moments are views of one flat buffer; fp32 ones are leaves of their own.
    opt = src.opt_state
    assert opt.mu_flat is not None and opt.mu[0].data_ptr() == opt.mu_flat.data_ptr()
    assert (opt.nu_flat is None) == ("nu_dtype" not in dtypes)
    flat = src.state_dict()
    assert flat["opt_state/mu/encoder_blocks/attn/qkv/kernel"].dtype == torch.bfloat16
    nu_dtype = torch.bfloat16 if "nu_dtype" in dtypes else torch.float32
    assert flat["opt_state/nu/decoder_pred/bias"].dtype == nu_dtype
    pckpt.save_checkpoint(str(tmp_path / "bf16"), src.step, src)
    dst = _mae_state(5, **dtypes)
    pckpt.restore_checkpoint(str(tmp_path / "bf16"), dst)
    for a, b in zip(_holders(dst), _holders(src)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="dtype torch.bfloat16 in the checkpoint"):
        pckpt.restore_checkpoint(str(tmp_path / "bf16"), _mae_state(5))
    pckpt.save_checkpoint(str(tmp_path / "fp32"), 0, _mae_state(0))
    with pytest.raises(ValueError, match="dtype torch.float32 in the checkpoint"):
        pckpt.restore_checkpoint(str(tmp_path / "fp32"), _mae_state(5, **dtypes))


@pytest.mark.parametrize("dtypes", [dict(mu_dtype="bfloat16"),
                                    dict(mu_dtype="bfloat16", nu_dtype="bfloat16")])
def test_train_state_from_jax_carries_bf16_moments(dtypes):
    """A live JAX TrainState with bf16 moments in both chain shapes (optax
    adamw's ScaleByAdamState with mu_dtype alone; the JAX package's own
    ScaleByAdamState from scale_by_adam_moment_dtypes with nu_dtype), two
    updates in: carried into a port state with the same dtypes, every
    moment bit-equal in bf16 and the count and step carried; into an
    fp32-moment state it raises."""
    from cross_scale_mae_tpu.configs import MAEConfig
    from cross_scale_mae_tpu.models import mae_init
    from cross_scale_mae_tpu.train import TrainState, build_optimizer
    from cross_scale_mae_torch.train.optim import build_optimizer as pbuild
    from cross_scale_mae_torch.utils.params import (
        params_from_jax,
        params_to_jax,
        train_state_from_jax,
    )

    pc = pcfg.get_mae_config("mae_vit_tiny_MsLdCeCd", **TINY)
    jc = MAEConfig.from_json(pc.to_json())
    params, mstate = mae_init(jax.random.key(0), jc)
    kw = dict(weight_decay=0.05, clip_grad=1.0, **dtypes)
    jstate = TrainState.create(params, mstate, build_optimizer(params, lambda s: 1e-3, **kw))
    rng = np.random.default_rng(4)
    for _ in range(2):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
                             params)
        jstate = jstate.apply_gradients(grads)
    adam = jax_moments(jstate.opt_state)
    assert adam["mu"]["decoder_pred"]["kernel"].dtype == jnp.bfloat16

    def template():
        return params_from_jax(jax.tree.map(np.asarray, jstate.params), pc, full=True)

    state = train_state_from_jax(jstate, pc, pbuild(template(), lambda s: 1e-3, **kw))
    assert state.step == 2 and state.opt_state.count == 2
    for name in ("mu", "nu"):
        ours = state.state_dict()
        for path, ref in jax.tree_util.tree_flatten_with_path(adam[name])[0]:
            key = "/".join(["opt_state", name, *(p.key for p in path)])
            assert ours[key].dtype == (torch.bfloat16 if ref.dtype == jnp.bfloat16
                                       else torch.float32), key
            np.testing.assert_array_equal(ours[key].float().numpy(),
                                          np.asarray(ref, np.float32), err_msg=key)
    got = params_to_jax(state.params)
    for path, ref in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        leaf = got
        for p in path:
            leaf = leaf[p.key]
        np.testing.assert_array_equal(leaf, np.asarray(ref), err_msg=str(path))
    with pytest.raises(ValueError, match="dtype"):
        train_state_from_jax(jstate, pc, pbuild(template(), lambda s: 1e-3, weight_decay=0.05,
                                                clip_grad=1.0))


def test_latest_step_ignores_interrupted_writes_and_a_corrupt_file_is_refused(tmp_path):
    state = _random_steps(_mae_state(0), seed=1)
    ckpt = str(tmp_path / "checkpoints")
    assert pckpt.latest_step(ckpt) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        pckpt.restore_checkpoint(ckpt, state)
    pckpt.save_checkpoint(ckpt, 2, state, extra={"epoch": 0})
    # A write killed before its rename: a step 4 with its file and sidecar
    # but still under <step>.tmp, and a bare step directory without one.
    os.makedirs(tmp_path / "checkpoints" / "4.tmp")
    shutil.copy(tmp_path / "checkpoints" / "2" / pckpt.STATE_FILE,
                tmp_path / "checkpoints" / "4.tmp" / pckpt.STATE_FILE)
    (tmp_path / "checkpoints" / "meta-4.json").write_text('{"step": 4, "epoch": 1}')
    os.makedirs(tmp_path / "checkpoints" / "6")
    assert pckpt.latest_step(ckpt) == 2
    assert pckpt.restore_checkpoint(ckpt, _mae_state(3))[1]["epoch"] == 0
    # A truncated file raises; it never loads as zeros.
    path = tmp_path / "checkpoints" / "2" / pckpt.STATE_FILE
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    with pytest.raises(RuntimeError):
        pckpt.restore_checkpoint(ckpt, _mae_state(3))


def test_restore_arrays_host_reads_the_jax_layout(tmp_path):
    state = _random_steps(_mae_state(0), seed=1)
    pckpt.save_checkpoint(str(tmp_path), 2, state, pcfg.get_mae_config(
        "mae_vit_tiny_MsLdCeCd", **TINY).to_json(), {"epoch": 0})
    tree, step = pckpt.restore_arrays_host(str(tmp_path))
    assert step == 2 and set(tree) == {"params", "model_state"}
    np.testing.assert_array_equal(tree["params"]["decoder_blocks"]["mlp"]["fc1"]["kernel"][0],
                                  state.params["decoder_blocks"][0]["mlp"]["fc1"]["kernel"]
                                  .detach().numpy())
    full, _ = pckpt.restore_arrays_host(str(tmp_path), subset=None)
    assert set(full) == {"params", "model_state", "opt_state", "step"}
    assert int(full["opt_state"]["count"]) == 2 and int(full["step"]) == 2
    meta = pckpt.checkpoint_meta(str(tmp_path), 2)
    assert pckpt.checkpoint_kind(meta) == "mae" and pckpt.checkpoint_meta(str(tmp_path), 9) == {}
    assert pckpt.checkpoint_kind({"config": {"embed_dim": 8}}) == "classifier"


# ---------------------------------------------------------------- the golden checkpoint


@pytest.fixture(scope="module")
def golden():
    """The golden checkpoint as the JAX package restores it: its host tree
    (``restore_arrays_host(subset=None)``), its TrainState
    (``restore_checkpoint``) and config, and the port's carried state."""
    from cross_scale_mae_tpu.configs import MAEConfig
    from cross_scale_mae_tpu.models import mae_init
    from cross_scale_mae_tpu.train import TrainState, build_optimizer, warmup_half_cosine
    from cross_scale_mae_tpu.utils.checkpoint import (
        checkpoint_meta,
        restore_arrays_host,
        restore_checkpoint,
    )
    from cross_scale_mae_torch.train.optim import build_optimizer as pbuild
    from cross_scale_mae_torch.train.schedule import warmup_half_cosine as psched
    from cross_scale_mae_torch.utils.params import params_from_jax, train_state_from_jax

    meta = checkpoint_meta(GOLDEN, 1)
    jc = MAEConfig.from_json(json.dumps(meta["config"]))
    sched = (1e-3, 0.0, 0, 1, 10)   # the schedule the artifact was made with
    # An abstract template (shapes only), as restore_checkpoint takes.
    params, mstate = jax.eval_shape(lambda k: mae_init(k, jc), jax.random.key(0))
    tx = build_optimizer(params, warmup_half_cosine(*sched), weight_decay=0.05)
    one_device = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    template = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=one_device),
        jax.eval_shape(lambda p, m: TrainState.create(p, m, tx), params, mstate))
    jstate, _ = restore_checkpoint(GOLDEN, template)
    tree, step = restore_arrays_host(GOLDEN, subset=None)
    pc = pcfg.MAEConfig.from_json(json.dumps(meta["config"]))

    def carry():
        template = params_from_jax(tree["params"], pc, full=True)
        return train_state_from_jax(tree, pc, pbuild(template, psched(*sched),
                                                     weight_decay=0.05))

    return {"jax": jstate, "jc": jc, "pc": pc, "step": step, "carry": carry}


def test_golden_checkpoint_carried_reproduces_loss_after_restore(golden):
    """The golden artifact, restored by the JAX host loader and carried by
    train_state_from_jax, reproduces golden_values.json's loss on the
    recorded batch with JAX's key(2) draws injected."""
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes
    from cross_scale_mae_torch.models.mae import mae_loss_fn

    jc, state = golden["jc"], golden["carry"]()
    assert golden["step"] == 1 and state.step == 1 and state.opt_state.count == 1
    with open(os.path.join(GOLDEN, "golden_values.json")) as f:
        want = json.load(f)["loss_after_restore"]
    batch = np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(np.float32)
    # mae_loss_fn's draws from key(2) (models/mae.py:288-316 of the JAX package).
    k_crop, k1, k2 = jax.random.split(jax.random.key(2), 3)
    boxes = sample_crop_boxes(k_crop, 4, jc.input_size, jc.input_size, jc.ms_range,
                              jc.ms_aspect_ratio)
    noise = jnp.concatenate([jax.random.uniform(k, (4, jc.num_patches)) for k in (k1, k2)])
    with torch.no_grad():
        out = mae_loss_fn(state.params, state.model_state, golden["pc"],
                          torch.from_numpy(batch), noise=torch.from_numpy(np.array(noise)),
                          ms_boxes=torch.from_numpy(np.array(boxes)), train=False)
    assert float(out.loss) == pytest.approx(want, abs=1e-5)


def test_golden_checkpoint_next_adamw_step_matches_jax(golden):
    """One AdamW update from the carried state against one from the JAX
    package's restore_checkpoint state, on the same seeded gradients: the
    moments and the count came across. The same update from fresh moments
    (count 0) is the control, far outside the tolerance."""
    from cross_scale_mae_torch.utils.params import params_from_jax, params_to_jax

    jstate, state, pc = golden["jax"], golden["carry"](), golden["pc"]
    rng = np.random.default_rng(11)
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jstate.params)
    jnext = jax.jit(lambda st, g: st.apply_gradients(grads=g))(
        jstate, jax.tree.map(jnp.asarray, grads))
    port_grads = tree_leaves(params_from_jax(grads, pc, full=True))
    fresh = _fresh_like(state)
    for s in (state, fresh):
        s.apply_gradients(port_grads)
    assert state.step == int(jnext.step) == 2 and state.opt_state.count == 2

    def worst(port_tree, jax_tree):
        got = dict(_paths(params_to_jax(port_tree)))
        return max(float(np.abs(got[k] - np.asarray(v)).max()) for k, v in _paths(jax_tree))

    adam = jnext.opt_state[0][0]
    assert worst(state.params, jnext.params) <= 1e-6
    from cross_scale_mae_torch.train.state import tree_like

    assert worst(tree_like(state.params, state.opt_state.mu), adam.mu) <= 1e-7
    assert worst(tree_like(state.params, state.opt_state.nu), adam.nu) <= 1e-7
    assert worst(fresh.params, jnext.params) > 1e-4


def _fresh_like(state):
    """A copy of ``state``'s params and BatchNorm state with a new optimizer
    state (zero moments, count 0)."""
    from cross_scale_mae_torch.train.state import TrainState

    params = jax.tree.map(lambda t: t.detach().clone(), state.params)
    return TrainState.create(params, state.model_state, state.tx)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


# ---------------------------------------------------------------- the classifier CLIs


def _classifier_argv(cli: str, out: str, *extra: str) -> list[str]:
    argv = ["--model", "vit_base_patch16", "--embed_dim", "64", "--depth", "2",
            "--num_heads", "4", "--input_size", "32", "--patch_size", "8",
            "--batch_size", "8", "--synthetic_len", "16", "--nb_classes", "4",
            "--epochs", "2", "--warmup_epochs", "1", "--ckpt_interval", "1",
            "--num_workers", "2", "--log_interval", "50", "--device", "cpu",
            "--output_dir", out, *extra]
    return argv + (["--dataset_type", "synthetic"] if cli == "linprobe" else [])


def _run_cli(cli: str, argv: list[str]) -> dict:
    import importlib

    mod = importlib.import_module(f"cross_scale_mae_torch.cli.{cli}")
    return mod.main(mod.get_args_parser().parse_args(argv))


def _ckpt_dir(cli: str, out: str, result: dict) -> str:
    return os.path.join(result["output_dir"], "checkpoints")


@pytest.mark.parametrize("cli", ["finetune", "linprobe"])
def test_classifier_resumed_after_an_epoch_equals_the_unbroken_run(tmp_path, cli):
    """An unbroken 2-epoch run against one stopped after epoch 0 (its
    checkpoint written) and resumed from it: the last checkpoint's state
    bit-equal, the resumed run starting at epoch 1 with the best acc1
    restored; a sidecar's max_acc carried into the resumed run."""
    whole_out, part_out = str(tmp_path / "whole"), str(tmp_path / "part")
    whole = _run_cli(cli, _classifier_argv(cli, whole_out))
    spe = whole["steps"] // 2
    part = _run_cli(cli, _classifier_argv(cli, part_out, "--max_steps", str(spe)))
    ckpt = _ckpt_dir(cli, part_out, part)
    assert pckpt.latest_step(ckpt) == spe
    patched = str(tmp_path / "patched")
    shutil.copytree(ckpt, patched)
    resumed = _run_cli(cli, _classifier_argv(cli, part_out, "--resume", ckpt))
    assert resumed["steps"] == spe and whole["max_acc"] == resumed["max_acc"]
    a = torch.load(os.path.join(_ckpt_dir(cli, whole_out, whole), str(2 * spe),
                                pckpt.STATE_FILE), weights_only=True)
    b = torch.load(os.path.join(_ckpt_dir(cli, part_out, resumed), str(2 * spe),
                                pckpt.STATE_FILE), weights_only=True)
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    # The sidecar's best acc1 is where the resumed run starts from.
    meta_path = os.path.join(patched, f"meta-{spe}.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["epoch"] == 0 and meta["max_acc"] == part["max_acc"]
    meta["max_acc"] = 99.5
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    again_out = str(tmp_path / "again")
    again = _run_cli(cli, _classifier_argv(cli, again_out, "--resume", patched))
    assert again["steps"] == spe and again["max_acc"] == 99.5
    last = pckpt.checkpoint_meta(_ckpt_dir(cli, again_out, again), 2 * spe)
    assert last["max_acc"] == 99.5 and last["epoch"] == 1


@pytest.mark.parametrize("cli", ["finetune", "linprobe"])
def test_classifier_resume_without_a_checkpoint_raises(tmp_path, cli):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        _run_cli(cli, _classifier_argv(cli, str(tmp_path / "o"), "--resume", str(empty)))


def test_finetune_save_every_is_the_ckpt_interval_alias():
    from cross_scale_mae_torch.cli.finetune import get_args_parser

    p = get_args_parser()
    assert p.parse_args([]).ckpt_interval == 20
    assert p.parse_args(["--save_every", "3"]).ckpt_interval == 3


# ---------------------------------------------------------------- checkpoint directories as inputs


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A tiny pretrain run with a checkpoint per epoch (steps 1 and 2) and
    its final npz."""
    from cross_scale_mae_torch.cli.pretrain import get_args_parser, main

    out = tmp_path_factory.mktemp("pre")
    result = main(get_args_parser().parse_args([
        "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
        "--batch_size", "4", "--synthetic_len", "4", "--epochs", "2", "--warmup_epochs", "1",
        "--ckpt_interval", "1", "--device", "cpu", "--output_dir", str(out)]))
    return {"ckpt": os.path.join(result["output_dir"], "checkpoints"), "npz": result["npz"]}


def test_serving_a_checkpoint_directory_at_a_step(pretrained):
    from cross_scale_mae_torch.serving import build_serving_model

    imgs = np.random.default_rng(0).integers(0, 256, (2, 37, 37, 3), np.uint8)
    feats = {}
    for name, path, step in (("npz", pretrained["npz"], None),
                             ("newest", pretrained["ckpt"], None),
                             ("step2", pretrained["ckpt"], 2), ("step1", pretrained["ckpt"], 1)):
        served = build_serving_model(path, step=step, pool="mean", batch_size=2, device="cpu")
        assert served.canvas == 37 and served.kind == "mae"
        feats[name] = served.fn(imgs)
    np.testing.assert_array_equal(feats["newest"], feats["npz"])
    np.testing.assert_array_equal(feats["step2"], feats["npz"])
    assert not np.array_equal(feats["step1"], feats["npz"])
    with pytest.raises(ValueError, match="step"):
        build_serving_model(pretrained["npz"], step=1, device="cpu")


def test_finetune_from_a_checkpoint_directory_equals_its_npz(pretrained, tmp_path):
    from cross_scale_mae_torch.cli.finetune import build_run, get_args_parser

    # The pretrain run's encoder width and depth.
    runs = [build_run(get_args_parser().parse_args(_classifier_argv(
        "finetune", str(tmp_path), "--embed_dim", "128", "--depth", "4", "--num_heads", "8",
        "--finetune", src)))
        for src in (pretrained["ckpt"], pretrained["npz"])]
    for a, b in zip(*(tree_leaves(r.state.params) for r in runs)):
        assert torch.equal(a, b)
    # The encoder came from the pretrain run, not the fresh init.
    from cross_scale_mae_torch.utils.checkpoint import load_flat_npz

    pre = load_flat_npz(pretrained["npz"])["cls_token"]
    np.testing.assert_array_equal(runs[0].state.params["cls_token"].detach().numpy(), pre)
