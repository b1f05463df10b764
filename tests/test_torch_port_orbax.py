"""The JAX package's Orbax checkpoints, read and written by the port with no
JAX, orbax or tensorstore (``cross_scale_mae_torch/utils/orbax.py``), on the
CPU.

The directories the JAX package writes here, each with its own
``save_checkpoint``: the golden artifact; a tiny MsLdCeCd pretrain state
after 2 and 4 seeded AdamW updates (epochs 0 and 1), with the options the
JAX pretrain CLI passes to ``build_optimizer``; the same state on the
8-device CPU mesh under FSDP (``shard_train_state(..., fsdp=True)``: one
zarr chunk per shard); with ``mu_dtype`` bfloat16; a finetune state (AdamW
under layer decay, the JAX finetune CLI's options) and a linear-probe state
(LARS on the head under the frozen mask, with the BN head's statistics);
and a directory two JAX processes write over gloo under FSDP, as
``tests/test_multiprocess.py`` does. The port's reader is held to the JAX
package's ``restore_arrays_host`` on each, leaf for leaf, dtype for dtype
and bit for bit; the port resumes each run (its CLIs' ``build_run``, one
process and two gloo ranks under FSDP) and takes the next update on seeded
gradients; its CLIs read a JAX run's directory as they read the run's npz;
the JAX package restores what the port writes; and every refusal names its
file and its check.

Tolerances, each with its reason:
* one update from a restored state against the JAX package's on the same
  seeded gradients: params 1e-6 absolute, moments (Adam's, LARS's) 1e-7,
  the bounds and reasons of ``tests/test_torch_port_checkpoint.py`` (the
  same elementwise fp32 formula in another order, on moments of ~1e-3 or
  less: the gradients are drawn at 1e-2 N(0, 1), the order of a ViT's).
* the golden loss: 1e-5 absolute, the bound of that file's golden test.
* everything else bit-equal: a restore copies bytes.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_torch.train.state import tree_leaves
from cross_scale_mae_torch.utils import checkpoint as pckpt
from cross_scale_mae_torch.utils import orbax
from cross_scale_mae_torch.utils import params as pparams
from tests import torch_mesh_driver as md
from tests.torch_jax_state import jax_moments

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "ckpt_v1")
DIGESTS = os.path.join(HERE, "torch_orbax_golden.json")
PRE_ARGS = ["--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
            "--batch_size", "8", "--synthetic_len", "16", "--epochs", "3",
            "--warmup_epochs", "1", "--lr", "1e-3", "--device", "cpu"]
CLF_ARGS = ["--model", "vit_base_patch16", "--embed_dim", "64", "--depth", "2",
            "--num_heads", "4", "--input_size", "32", "--patch_size", "8",
            "--dataset_type", "synthetic", "--synthetic_len", "16", "--nb_classes", "5",
            "--batch_size", "8", "--epochs", "2", "--warmup_epochs", "1", "--lr", "1e-3",
            "--device", "cpu"]
PARAMS_TOL, MOMENTS_TOL = 1e-6, 1e-7
MAX_ACC = 12.5

# Two JAX processes over gloo, 2 CPU devices each, one FSDP mesh across
# them, as tests/test_multiprocess.py starts its workers.
TWO_PROCESS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid, out, address = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from cross_scale_mae_tpu.parallel.dist import initialize_distributed
initialize_distributed(address, 2, pid)
import numpy as np
from cross_scale_mae_tpu.configs import get_mae_config
from cross_scale_mae_tpu.models import mae_init
from cross_scale_mae_tpu.parallel.mesh import make_mesh, shard_train_state
from cross_scale_mae_tpu.train import TrainState, build_optimizer
from cross_scale_mae_tpu.utils.checkpoint import save_checkpoint
cfg = get_mae_config("mae_vit_tiny_MsLdCeCd", input_size=16, patch_size=8, dim_model=8,
                     encoder_num_layers=1, encoder_num_heads=2, decoder_embed_dim=8,
                     decoder_num_layers=1, decoder_num_heads=2, predictor_hidden_size=8,
                     attention_impl="xla")
params, mstate = jax.jit(lambda k: mae_init(k, cfg))(jax.random.key(0))
tx = build_optimizer(params, lambda c: 1e-3)
rng = np.random.default_rng(3)
grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
state = jax.jit(lambda p, m, g: TrainState.create(p, m, tx).apply_gradients(grads=g))(
    params, mstate, grads)
state = shard_train_state(make_mesh(), state, tensor_parallel=False, fsdp=True)
save_checkpoint(out, 3, state, cfg.to_json(), {"epoch": 2})
"""

# One port rank of ``--resume`` under FSDP at two gloo ranks: the CLI's
# build_run restores the JAX run, the seeded gradients (whole, in the JAX
# layout) are applied as this rank's parts, and rank 0 writes the whole
# state gathered back.
RESUME_RANK = r"""
import json, sys
import torch
torch.set_num_threads(1)
from cross_scale_mae_torch.cli import pretrain
from cross_scale_mae_torch.parallel import dist
from cross_scale_mae_torch.parallel.mesh import spec_of, this_part
from cross_scale_mae_torch.train.state import tree_leaves
from cross_scale_mae_torch.utils.checkpoint import load_flat_npz
from cross_scale_mae_torch.utils.params import params_from_jax
spec = json.loads(sys.argv[1])
run = pretrain.build_run(pretrain.get_args_parser().parse_args(spec["argv"]))
assert run.layout.fsdp and run.rt.world_size == 2 and run.start_epoch == 2
grads = tree_leaves(params_from_jax(load_flat_npz(spec["grads"]), run.cfg, full=True))
run.state.apply_gradients([this_part(g, spec_of(p))
                           for g, p in zip(grads, tree_leaves(run.state.params))])
flat = run.state.state_dict()
split = sum(spec_of(p) is not None for p in tree_leaves(run.state.params))
if run.rt.rank == 0:
    torch.save({"flat": flat, "split": split}, spec["out"])
dist.barrier()
dist.shutdown()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand_grads(params, seed):
    """Seeded gradients at 1e-2 N(0, 1), the order of a ViT's gradient
    elements, at which Adam's moments have the scale the bounds are set for."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (1e-2 * rng.normal(size=a.shape)).astype(np.float32),
                        params)


@jax.jit
def _jax_update(state, grads):
    return state.apply_gradients(grads=grads)


def _jax_state(params, mstate, tx):
    from cross_scale_mae_tpu.train import TrainState

    return jax.jit(lambda p, m: TrainState.create(p, m, tx))(params, mstate)


def _jax_steps(state, steps, seed):
    for i in range(steps):
        state = _jax_update(state, _rand_grads(state.params, seed + i))
    return state


def _table(schedule, n: int = 16):
    """A port schedule as a traceable lookup of its first ``n`` values, for
    the JAX optimizer (the same fp32 learning rates)."""
    values = jnp.asarray([schedule(i) for i in range(n)], jnp.float32)
    return lambda count: values[count]


def _moved_state(model_state, seed):
    """BatchNorm statistics moved off their init, so a carry that drops
    them would show."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
        np.float32), model_state)


def _port_classifier_cfg(cli: str) -> dict:
    """The classifier config the port's CLI builds from CLF_ARGS, which the
    JAX states are made at."""
    from cross_scale_mae_torch.cli import finetune, linprobe

    mod = {"finetune": finetune, "linprobe": linprobe}[cli]
    run = mod.build_run(mod.get_args_parser().parse_args(CLF_ARGS + ["--output_dir", ""]))
    return json.loads(run.cfg.to_json())


def _jax_tx(kind: str, params, schedule, cfg=None, options=None):
    """The JAX package's build_optimizer with the options its CLIs pass
    (``options`` for a pretrain state of other options)."""
    from cross_scale_mae_tpu.train import build_optimizer

    if options:
        return build_optimizer(params, schedule, weight_decay=0.05, **options)
    if kind == "pretrain":
        return build_optimizer(params, schedule, weight_decay=0.05, b1=0.9, b2=0.95)
    if kind == "mu_bf16":
        return build_optimizer(params, schedule, weight_decay=0.05, b1=0.9, b2=0.95,
                               mu_dtype="bfloat16")
    if kind == "finetune":    # cross_scale_mae_tpu/cli/finetune.py:340
        return build_optimizer(params, schedule, weight_decay=0.05, b1=0.9, b2=0.999,
                               layer_decay=0.75, depth=cfg.depth,
                               no_decay_names=("pos_embed", "cls_token"))
    # linprobe: cross_scale_mae_tpu/cli/linprobe.py:165-172
    trainable = jax.tree_util.tree_map_with_path(
        lambda path, leaf: str(getattr(path[0], "key", "")) == "head", params)
    return build_optimizer(params, schedule, optimizer="lars", weight_decay=0.0,
                           frozen_mask=trainable)


def _jax_init(cfg):
    """Seeded random params and state (numpy) with the keys and shapes of
    the JAX package's ``mae_init`` or ``vit_init`` for ``cfg``
    (``utils/params``'s shape tables, which the carry holds to them)."""
    from cross_scale_mae_torch import configs as pcfg

    if isinstance(cfg, jcfg.MAEConfig):
        pc = pcfg.MAEConfig.from_json(cfg.to_json())
        state = pparams._random_tree(pparams.mae_state_shapes(pc), 1)
        return pparams.random_mae_tree(pc, 0), _moved_state(state, 1)
    pc = pcfg.ViTClassifierConfig.from_json(cfg.to_json())
    d = pc.embed_dim
    state = ({"head_bn": {"mean": np.zeros(d, np.float32), "var": np.ones(d, np.float32)}}
             if pc.use_bn_head else {})
    return pparams.random_vit_tree(pc, 0), _moved_state(state, 2)


def _sched(count):
    return 1e-3 * (count + 1)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Every JAX-written directory of the module docstring, with the npz
    export of the pretrain state's params."""
    from cross_scale_mae_tpu.parallel.mesh import make_mesh, shard_train_state
    from cross_scale_mae_tpu.utils.checkpoint import save_checkpoint, save_params_npz

    root = tmp_path_factory.mktemp("orbax")
    address = md.free_address()
    two = md.run_procs_async([[sys.executable, "-c", TWO_PROCESS, str(pid),
                               str(root / "two_process"), address] for pid in range(2)])
    out = {"golden": GOLDEN, "two_process": str(root / "two_process")}
    cfg = jcfg.get_mae_config("mae_vit_tiny_MsLdCeCd", input_size=32, patch_size=8,
                              attention_impl="xla")
    params, mstate = _jax_init(cfg)
    state = _jax_state(params, mstate, _jax_tx("pretrain", params, _sched))
    out["pretrain"] = str(root / "pretrain")
    for step in (2, 4):
        state = _jax_steps(state, 2, seed=step)
        save_checkpoint(out["pretrain"], step, state, cfg.to_json(), {"epoch": step // 2 - 1})
    out["pretrain_state"] = state
    out["npz"] = str(root / "pretrain.npz")
    save_params_npz(out["npz"], {"params": state.params, "model_state": state.model_state},
                    cfg.to_json())
    # bf16 first moments, and FSDP over the 8 CPU devices (the leaves
    # divisible by 8 split: one chunk per shard), at the golden's widths.
    small = jcfg.MAEConfig.from_json(json.dumps(pckpt.checkpoint_meta(GOLDEN, 1)["config"]))
    sparams, smstate = _jax_init(small)
    for kind in ("mu_bf16", "fsdp"):
        tx = _jax_tx("mu_bf16" if kind == "mu_bf16" else "pretrain", sparams, _sched)
        state = _jax_steps(_jax_state(sparams, smstate, tx), 2, seed=3)
        if kind == "fsdp":
            state = shard_train_state(make_mesh(jax.devices()[:8]), state,
                                      tensor_parallel=False, fsdp=True)
        out[kind] = str(root / kind)
        save_checkpoint(out[kind], 2, state, small.to_json(), {"epoch": 0})
    for kind in ("finetune", "linprobe"):
        vcfg = jcfg.ViTClassifierConfig.from_json(json.dumps(_port_classifier_cfg(kind)))
        vparams, vstate = _jax_init(vcfg)
        state = _jax_state(vparams, vstate, _jax_tx(kind, vparams, _sched, vcfg))
        out[kind] = str(root / kind)
        save_checkpoint(out[kind], 2, _jax_steps(state, 2, seed=9), vcfg.to_json(),
                        {"epoch": 0, "max_acc": MAX_ACC})
    md.wait(two)
    out["cfg"] = cfg
    return out


def _same(want, got, path="") -> int:
    """``got`` (the port's reader) is ``want`` (the JAX package's restore):
    the same containers, and each leaf of the same dtype and bytes; numpy's
    bfloat16 leaves are torch bfloat16 ones. Returns the leaves compared."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        return sum(_same(want[k], got[k], f"{path}/{k}") for k in want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        return sum(_same(a, b, f"{path}/{i}") for i, (a, b) in enumerate(zip(want, got)))
    if want is None:
        assert got is None, path
        return 0
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (path, got.dtype)
    assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    return 1


READS = {"golden_all": ("golden", None, None), "golden_default": ("golden", None, "default"),
         "pretrain_latest": ("pretrain", None, None), "pretrain_step2": ("pretrain", 2, None),
         "fsdp_chunked": ("fsdp", None, None), "mu_bf16": ("mu_bf16", None, None),
         "finetune": ("finetune", None, None), "linprobe": ("linprobe", None, None),
         "two_process": ("two_process", None, None)}


@pytest.mark.parametrize("case", list(READS))
def test_reader_is_jax_restore_arrays_host(dirs, case):
    from cross_scale_mae_tpu.utils.checkpoint import restore_arrays_host

    name, step, subset = READS[case]
    kw = {} if subset == "default" else {"subset": None}
    want, want_step = restore_arrays_host(dirs[name], step, **kw)
    got, got_step = pckpt.restore_orbax_host(dirs[name], step, **kw)
    assert got_step == want_step == (step or pckpt.latest_step(dirs[name]))
    assert _same(want, got) > 0
    db = orbax.OcdbtReader(os.path.join(dirs[name], str(got_step), "default"))
    files = {v[0] for v in db.entries.values() if isinstance(v, tuple)}
    if name in ("fsdp", "two_process"):   # one chunk per shard
        kernel = json.loads(db.get("params.decoder_pred.kernel/.zarray"))
        assert kernel["chunks"] != kernel["shape"]
    if name == "two_process":             # values in both processes' files
        assert {f.split(os.sep)[-3] for f in files} == {"ocdbt.process_0", "ocdbt.process_1"}
    if name == "mu_bf16":
        assert got["opt_state"][0][0]["mu"]["cls_token"].dtype == torch.bfloat16
    db.close()


def test_reader_follows_interior_nodes_and_older_versions(tmp_path):
    """A database tensorstore writes with 200-byte nodes over 20 commits:
    a B+tree of height > 0 with values inline and in data files across many
    files, and older generations in version-tree nodes. The port's reader
    lists tensorstore's keys of the newest generation and reads its values,
    byte for byte."""
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 200,
                                     "max_inline_value_bytes": 8}}).result()
    for g in range(20):
        with ts.Transaction() as txn:
            for i in range(10):
                kv.with_transaction(txn)[f"key{g:02d}_{i:03d}"] = b"v%d_%d" % (g, i) * (1 + i % 3)
    del kv[b"key07_004"]
    manifest = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path}/").result()).result()
    assert manifest["version_tree_nodes"] and manifest["versions"][-1]["root_height"] > 0
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/"}).result()
    db = orbax.OcdbtReader(str(tmp_path))
    keys = kv.list().result()
    assert sorted(db.entries) == sorted(keys) and len(keys) == 199
    assert all(db.get(k.decode()) == kv.read(k).result().value for k in keys)
    assert len({v[0] for v in db.entries.values() if isinstance(v, tuple)}) > 1
    db.close()


def _golden_record() -> dict:
    """What tests/torch_orbax_golden.json holds, from the JAX package: each
    golden leaf's digest, and the draws of the golden loss (key(2), as
    tests/test_torch_port_checkpoint.py draws them) for a host without JAX."""
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes
    from cross_scale_mae_tpu.utils.checkpoint import checkpoint_meta, restore_arrays_host

    tree, step = restore_arrays_host(GOLDEN, subset=None)
    c = jcfg.MAEConfig.from_json(json.dumps(checkpoint_meta(GOLDEN, step)["config"]))
    k_crop, k1, k2 = jax.random.split(jax.random.key(2), 3)
    boxes = sample_crop_boxes(k_crop, 4, c.input_size, c.input_size, c.ms_range,
                              c.ms_aspect_ratio)
    noise = jnp.concatenate([jax.random.uniform(k, (4, c.num_patches)) for k in (k1, k2)])
    return {"source": "tests/golden/ckpt_v1, step 1, restore_arrays_host(subset=None)",
            "step": step, "leaves": orbax.digests(tree),
            "batch": "np.random.default_rng(0).normal(size=(4, 16, 16, 3)), float32",
            "noise": np.asarray(noise).tolist(), "ms_boxes": np.asarray(boxes).tolist(),
            "ms_boxes_dtype": str(np.asarray(boxes).dtype)}


def test_golden_digests_are_the_jax_restore_and_the_port_reads_them():
    with open(DIGESTS) as f:
        held = json.load(f)
    assert held == _golden_record()
    tree, step = pckpt.restore_orbax_host(GOLDEN, subset=None)
    assert step == held["step"] and orbax.digests(tree) == held["leaves"]
    assert len(held["leaves"]) == 131    # and one empty node, optax's masked EmptyState


def test_golden_loss_from_the_port_reader_and_the_held_draws():
    """The golden loss on the recorded batch with the draws the digest file
    holds, from the port's own reading of the artifact, as chip_smoke.py
    [orbax] computes it on a host without JAX: the crop view resized at
    fp32 and given as a pair's second frame (on the card the training crop
    rounds its operands to bf16, as a TPU does); on the CPU the training
    crop is that same fp32 product, so both readings hold."""
    from cross_scale_mae_torch import configs as pcfg
    from cross_scale_mae_torch.models.mae import mae_loss_fn
    from cross_scale_mae_torch.ops.image import crop_resize
    from cross_scale_mae_torch.train.optim import build_optimizer

    with open(DIGESTS) as f:
        held = json.load(f)
    with open(os.path.join(GOLDEN, "golden_values.json")) as f:
        want = json.load(f)["loss_after_restore"]
    meta = pckpt.checkpoint_meta(GOLDEN, 1)
    cfg = pcfg.MAEConfig.from_json(json.dumps(meta["config"]))
    tree, _ = pckpt.restore_orbax_host(GOLDEN, subset=None)
    template = pparams.params_from_jax(tree["params"], cfg, full=True)
    state = pparams.train_state_from_jax(tree, cfg, build_optimizer(template, _sched,
                                                                      weight_decay=0.05))
    batch = torch.from_numpy(
        np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(np.float32))
    boxes = torch.from_numpy(np.asarray(held["ms_boxes"], held["ms_boxes_dtype"]))
    noise = torch.tensor(held["noise"], dtype=torch.float32)
    with torch.no_grad():
        crop = crop_resize(batch, boxes, cfg.input_size, "linear", exact=True)
        pair = mae_loss_fn(state.params, state.model_state, cfg, torch.stack([batch, crop], 1),
                           noise=noise, train=False)
        crop_path = mae_loss_fn(state.params, state.model_state, cfg, batch, noise=noise,
                                ms_boxes=boxes, train=False)
    assert float(pair.loss) == pytest.approx(want, abs=1e-5)
    assert float(crop_path.loss) == pytest.approx(want, abs=1e-5)


def test_latest_step_counts_finished_orbax_steps(dirs, tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(dirs["pretrain"], ckpt)
    # Orbax's unfinished forms: a temporary name, and a step without the
    # _CHECKPOINT_METADATA it writes last.
    shutil.copytree(ckpt / "4", ckpt / "6.orbax-checkpoint-tmp-1792296759")
    shutil.copytree(ckpt / "4", ckpt / "8")
    os.remove(ckpt / "8" / orbax.STEP_METADATA)
    assert pckpt.latest_step(str(ckpt)) == 4 and not orbax.is_step(str(ckpt / "8"))
    os.makedirs(ckpt / "5")
    (ckpt / "5" / pckpt.STATE_FILE).write_bytes(b"")
    assert pckpt.latest_step(str(ckpt)) == 5
    with pytest.raises(orbax.OrbaxFormatError, match=r"5: holds the port's state\.pt"):
        pckpt.restore_orbax_host(str(ckpt))


# ---------------------------------------------------------------- resume


def _jax_restored(path, kind, params, mstate, schedule, cfg=None, options=None):
    """The JAX package's restore_checkpoint of ``path`` into an abstract
    template of its own optimizer for ``kind``."""
    from cross_scale_mae_tpu.train import TrainState
    from cross_scale_mae_tpu.utils.checkpoint import restore_checkpoint

    tx = _jax_tx(kind, params, schedule, cfg, options)
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=one),
                            jax.eval_shape(lambda p, m: TrainState.create(p, m, tx),
                                           params, mstate))
    return restore_checkpoint(path, template)[0]


def _gaps(flat: dict, jstate) -> dict:
    """The largest |port - JAX| over the params and over each moment, and
    whether the counts and steps agree."""
    def worst(prefix, tree):
        ref = {f"{prefix}/{'/'.join(str(p.key) for p in path)}": np.asarray(v, np.float32)
               for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        return max(float(np.abs(flat[k].float().numpy() - v).max()) for k, v in ref.items())

    out = {"params": worst("params", jstate.params)}
    for name, tree in jax_moments(jstate.opt_state).items():
        out[name] = worst(f"opt_state/{name}", tree)
    return out


def _within(gaps: dict) -> bool:
    return gaps["params"] <= PARAMS_TOL and all(
        v <= MOMENTS_TOL for k, v in gaps.items() if k != "params")


@pytest.fixture(scope="module")
def pretrain_resumed(dirs, tmp_path_factory):
    """The port's cli/pretrain build_run with --resume <the JAX run>, one
    update on seeded gradients, and the JAX package's update from its own
    restore of the same directory under the port run's schedule."""
    from cross_scale_mae_torch.cli import pretrain
    from cross_scale_mae_torch.train.state import TrainState

    root = tmp_path_factory.mktemp("resume")
    run = pretrain.build_run(pretrain.get_args_parser().parse_args(
        PRE_ARGS + ["--output_dir", str(root), "--resume", dirs["pretrain"]]))
    # The control: the restored params under a fresh optimizer state.
    fresh = TrainState.create(jax.tree.map(lambda t: t.detach().clone(), run.state.params),
                              run.state.model_state, run.state.tx)
    fresh.step = run.state.step
    jstate = dirs["pretrain_state"]
    grads = _rand_grads(jstate.params, 77)
    npz = str(root / "grads.npz")
    pckpt.save_params_npz(npz, grads)
    restored = {k: v.clone() for k, v in run.state.state_dict().items()}
    schedule = run.state.tx.schedule
    jrestored = _jax_restored(dirs["pretrain"], "pretrain", jstate.params,
                              jstate.model_state, _table(schedule))
    port_grads = tree_leaves(pparams.params_from_jax(grads, run.cfg, full=True))
    for state in (run.state, fresh):
        state.apply_gradients(port_grads)
    return {"run": run, "restored": restored, "fresh": fresh, "grads": grads, "npz": npz,
            "jax_restored": jrestored, "jax_next": _jax_update(jrestored, grads),
            "root": root}


def test_pretrain_resume_from_a_jax_run_takes_its_next_step(dirs, pretrain_resumed):
    r = pretrain_resumed
    assert r["run"].start_epoch == 2 and r["run"].state.step == 5
    # The restore is JAX's, bit for bit: params, BatchNorm state, moments, counts.
    zero = _gaps(r["restored"], r["jax_restored"])
    assert all(v == 0.0 for v in zero.values()), zero
    assert int(r["restored"]["opt_state/count"]) == int(r["restored"]["step"]) == 4
    np.testing.assert_array_equal(
        r["restored"]["model_state/predictor_cd/bn/var"].numpy(),
        np.asarray(r["jax_restored"].model_state["predictor_cd"]["bn"]["var"]))
    gaps = _gaps(r["run"].state.state_dict(), r["jax_next"])
    assert _within(gaps), gaps
    assert int(r["jax_next"].step) == 5 and r["run"].state.opt_state.count == 5
    # The control: the same update from fresh moments (count 0) is far off.
    assert _gaps(r["fresh"].state_dict(), r["jax_next"])["params"] > 1e-4


def test_pretrain_resume_on_two_gloo_ranks_under_fsdp(dirs, pretrain_resumed, tmp_path):
    r = pretrain_resumed
    out = str(tmp_path / "rank0.pt")
    address = md.free_address()
    md.run_procs([[sys.executable, "-c", RESUME_RANK, json.dumps({
        "argv": PRE_ARGS + ["--output_dir", str(tmp_path), "--resume", dirs["pretrain"],
                            "--fsdp", "--coordinator_address", address,
                            "--num_processes", "2", "--process_id", str(rank)],
        "grads": r["npz"], "out": out})] for rank in range(2)])
    got = torch.load(out, weights_only=True)
    assert got["split"] > 0
    gaps = _gaps(got["flat"], r["jax_next"])
    assert _within(gaps), gaps
    assert int(got["flat"]["step"]) == 5 and int(got["flat"]["opt_state/count"]) == 5


def test_pretrain_cli_runs_on_from_a_jax_run(dirs, tmp_path, capsys):
    from cross_scale_mae_torch.cli import pretrain

    res = pretrain.main(pretrain.get_args_parser().parse_args(
        PRE_ARGS + ["--output_dir", str(tmp_path), "--resume", dirs["pretrain"],
                    "--ckpt_interval", "1"]))
    assert "at epoch 2 (step 4, " in capsys.readouterr().out
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))
    # The port's own checkpoint of the run it carried on.
    ckpt = os.path.join(res["output_dir"], "checkpoints")
    assert pckpt.latest_step(ckpt) == 6 and os.path.isfile(
        os.path.join(ckpt, "6", pckpt.STATE_FILE))


@pytest.mark.parametrize("cli", ["finetune", "linprobe"])
def test_classifier_resume_from_a_jax_run_takes_its_next_step(dirs, cli, tmp_path):
    from cross_scale_mae_torch.cli import finetune, linprobe

    mod = {"finetune": finetune, "linprobe": linprobe}[cli]
    run = mod.build_run(mod.get_args_parser().parse_args(
        CLF_ARGS + ["--output_dir", str(tmp_path), "--resume", dirs[cli]]))
    assert run.start_epoch == 1 and run.max_acc == MAX_ACC and run.state.step == 2
    vcfg = jcfg.ViTClassifierConfig.from_json(run.cfg.to_json())
    params, mstate = _jax_init(vcfg)
    jstate = _jax_restored(dirs[cli], cli, params, mstate, _table(run.state.tx.schedule), vcfg)
    zero = _gaps(run.state.state_dict(), jstate)
    assert all(v == 0.0 for v in zero.values()), zero
    if cli == "linprobe":
        np.testing.assert_array_equal(run.state.model_state["head_bn"]["mean"].numpy(),
                                      np.asarray(jstate.model_state["head_bn"]["mean"]))
    grads = _rand_grads(jstate.params, 5)
    trainable = getattr(run.state.tx, "trainable")
    port_grads = tree_leaves(pparams.vit_params_from_jax(grads, run.cfg))
    run.state.apply_gradients([g if t else None for g, t in zip(port_grads, trainable)])
    gaps = _gaps(run.state.state_dict(), _jax_update(jstate, grads))
    assert _within(gaps), gaps


# ---------------------------------------------------------------- the CLIs' readers


def _finetuned(cli, src, out):
    from cross_scale_mae_torch.cli import finetune, linprobe

    mod = {"finetune": finetune, "linprobe": linprobe}[cli]
    run = mod.build_run(mod.get_args_parser().parse_args(
        CLF_ARGS + ["--embed_dim", "128", "--depth", "4", "--num_heads", "8",
                    "--output_dir", out, "--finetune", src]))
    return [t.detach().numpy() for t in tree_leaves(run.state.params)]


def _served(src, out):
    from cross_scale_mae_torch.serving import build_serving_model

    imgs = np.random.default_rng(0).integers(0, 256, (2, 37, 37, 3), np.uint8)
    return [build_serving_model(src, pool="mean", batch_size=2, device="cpu").fn(imgs)]


def _embedded(src, out):
    from cross_scale_mae_torch.cli import embed

    embed.main(embed.get_args_parser().parse_args(
        ["--ckpt", src, "--dataset_type", "synthetic", "--synthetic_len", "10",
         "--batch_size", "4", "--pool", "cls", "--output_dir", out, "--num_workers", "2",
         "--device", "cpu"]))
    return [np.load(os.path.join(out, "features.npy"))]


def _exported_torch(src, out):
    from cross_scale_mae_torch.cli import export_torch

    pth = os.path.join(out, "ref.pth")
    export_torch.main(export_torch.get_args_parser().parse_args(
        ["--ckpt", src, "--output", pth, "--model_name", "mae_vit_tiny_MsLdCeCd"]))
    state = torch.load(pth, weights_only=False)["model"]
    return [state[k].numpy() for k in sorted(state)]


def _visualized(src, out):
    from cross_scale_mae_torch.viz.recon import prepare_model

    if src.endswith(".npz"):   # the surface takes directories: the npz through the carry
        config, tree, _, _ = pckpt.read_host_checkpoint(src)
        from cross_scale_mae_torch import configs as pcfg

        cfg = pcfg.MAEConfig.from_json(json.dumps(config))
        return [t.numpy() for t in tree_leaves(pparams.params_from_jax(tree, cfg, full=True))]
    return [t.numpy() for t in tree_leaves(prepare_model(src)[0])]


READERS = {"finetune": lambda s, o: _finetuned("finetune", s, o),
           "linprobe": lambda s, o: _finetuned("linprobe", s, o),
           "serve": _served, "embed": _embedded, "export_torch": _exported_torch,
           "evalviz": _visualized}


@pytest.mark.parametrize("surface", list(READERS))
def test_cli_reads_a_jax_run_as_its_npz(dirs, surface, tmp_path):
    """--finetune, serving, cli/embed, cli/export_torch and evalviz's
    prepare_model given the JAX run's Orbax directory give what they give
    from the same run's npz export (``save_params_npz`` of the JAX
    package), bit for bit."""
    got = READERS[surface](dirs["pretrain"], str(tmp_path / "orbax"))
    want = READERS[surface](dirs["npz"], str(tmp_path / "npz"))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the writer


WRITES = {"adamw_clip": ("pretrain", dict(clip_grad=1.0)),
          "bf16_moments": ("pretrain", dict(clip_grad=1.0, mu_dtype="bfloat16",
                                            nu_dtype="bfloat16")),
          "sgd": ("pretrain", dict(optimizer="sgd")),
          "lars_probe": ("linprobe", {})}


def _port_state(kind, options):
    from cross_scale_mae_torch import configs as pcfg
    from cross_scale_mae_torch.cli.linprobe import head_only_mask
    from cross_scale_mae_torch.models.mae import mae_init
    from cross_scale_mae_torch.models.vit import vit_init
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import TrainState

    gen = torch.Generator().manual_seed(0)
    if kind == "pretrain":
        cfg = pcfg.MAEConfig.from_json(json.dumps(pckpt.checkpoint_meta(GOLDEN, 1)["config"]))
        params, mstate = mae_init(cfg, gen)
        tx = build_optimizer(params, _sched, weight_decay=0.05, **options)
    else:
        cfg = pcfg.ViTClassifierConfig.from_json(json.dumps(_port_classifier_cfg(kind)))
        params, mstate = vit_init(cfg, gen)
        tx = build_optimizer(params, _sched, optimizer="lars", weight_decay=0.0,
                             frozen_mask=head_only_mask(params))
    state = TrainState.create(params, mstate, tx)
    for s in range(2):
        gen = torch.Generator().manual_seed(10 + s)
        state.apply_gradients([1e-2 * torch.randn(p.shape, generator=gen) if t else None
                               for p, t in zip(tree_leaves(state.params), tx.trainable)])
    return state, cfg


@pytest.mark.parametrize("case", list(WRITES))
def test_port_written_checkpoint_is_restored_by_jax(case, tmp_path):
    """save_orbax_checkpoint's directory, restored by the JAX package's
    restore_checkpoint into its own build_optimizer template with the same
    options, is the port's state bit for bit (restore_arrays_host and the
    port's reader agree on it too); the next update from it, JAX's and the
    port's, agree within the bounds (fp32 moments)."""
    from cross_scale_mae_tpu.utils.checkpoint import checkpoint_meta, restore_arrays_host

    kind, options = WRITES[case]
    state, cfg = _port_state(kind, options)
    ckpt = str(tmp_path / "ckpt")
    pckpt.save_orbax_checkpoint(ckpt, state.step, state, cfg.to_json(), {"epoch": 0})
    assert checkpoint_meta(ckpt, 2) == {"step": 2, "epoch": 0,
                                        "config": json.loads(cfg.to_json())}
    jcfg_ = (jcfg.MAEConfig if kind == "pretrain" else jcfg.ViTClassifierConfig).from_json(
        cfg.to_json())
    params, mstate = _jax_init(jcfg_)
    jstate = _jax_restored(ckpt, kind, params, mstate, _sched, options=options)
    flat = state.state_dict()
    zero = _gaps(flat, jstate)
    assert all(v == 0.0 for v in zero.values()), zero
    for name, tree in jax_moments(jstate.opt_state).items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = f"opt_state/{name}/" + "/".join(str(p.key) for p in path)
            assert (flat[key].dtype == torch.bfloat16) == (leaf.dtype == jnp.bfloat16), key
    assert int(jstate.step) == state.step == 2
    tree, _ = restore_arrays_host(ckpt, subset=None)
    assert _same(tree, pckpt.restore_orbax_host(ckpt, subset=None)[0]) > 0
    if case == "bf16_moments":
        # Each update rounds the moments to bf16, where a one-ulp tie goes
        # either way: the update is held by tests/test_torch_port_finetune.py.
        return
    grads = _rand_grads(jstate.params, 21)
    to_port = (pparams.vit_params_from_jax if kind == "linprobe"
               else lambda g, c: pparams.params_from_jax(g, c, full=True))
    port_grads = tree_leaves(to_port(grads, cfg))
    state.apply_gradients([g if t else None for g, t in zip(port_grads, state.tx.trainable)])
    gaps = _gaps(state.state_dict(), _jax_update(jstate, grads))
    assert _within(gaps), gaps


# ---------------------------------------------------------------- refusals


def _rewrite(item: str, edit) -> None:
    """The OCDBT database of ``item`` written again with ``edit`` applied
    to its {key: value} dict."""
    db = orbax.OcdbtReader(item)
    items = {k.decode(): db.get(k.decode()) for k in db.entries}
    db.close()
    edit(items)
    shutil.rmtree(os.path.join(item, "d"))
    orbax.write_ocdbt(item, items)


def _zarray_edit(key, **fields):
    def edit(items):
        meta = json.loads(items[key])
        meta.update(fields)
        items[key] = json.dumps(meta).encode()
    return edit


def _flip_crc(step):
    path = os.path.join(step, "default", orbax.MANIFEST)
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0x01
    open(path, "wb").write(bytes(raw))


def _truncate(step):
    # A process-0 data file cut inside the last value it holds.
    db = orbax.OcdbtReader(os.path.join(step, "default"))
    path, offset, length = max(v for v in db.entries.values() if isinstance(v, tuple))
    db.close()
    with open(path, "r+b") as f:
        f.truncate(offset + length - 1)


def _delete_chunk(step):
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + os.path.join(
        step, "default") + "/"}).result()
    del kv["params.cls_token/0.0.0"]    # a second generation without the key


def _zarr3(step):
    path = os.path.join(step, "default", orbax.TREE_METADATA)
    meta = json.load(open(path))
    meta["use_zarr3"] = True
    json.dump(meta, open(path, "w"))


REFUSALS = {
    "crc": (_flip_crc, r"manifest\.ocdbt: crc32c 0x[0-9a-f]+, stored"),
    "truncated": (_truncate, r"ocdbt\.process_0/d/\w+: truncated data file"),
    "missing_chunk": (_delete_chunk, r"manifest\.ocdbt: missing chunk "
                                     r"'params\.cls_token/0\.0\.0'"),
    "zarr3": (_zarr3, r"default/_METADATA: use_zarr3 is true"),
    "big_endian": (lambda s: _rewrite(os.path.join(s, "default"), _zarray_edit(
        "params.cls_token/.zarray", dtype=">f4")), r"key 'params\.cls_token/\.zarray'\): "
                                                    r"big-endian dtype '>f4'"),
    "filters": (lambda s: _rewrite(os.path.join(s, "default"), _zarray_edit(
        "params.cls_token/.zarray", filters=[{"id": "delta", "dtype": "<f4"}])),
        r"key 'params\.cls_token/\.zarray'\): filters"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_name_the_file_and_the_check(case, tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(GOLDEN, ckpt)
    edit, match = REFUSALS[case]
    edit(str(ckpt / "1"))
    with pytest.raises(orbax.OrbaxFormatError, match=match):
        pckpt.restore_orbax_host(str(ckpt), subset=None)


def test_refusal_without_libzstd(monkeypatch):
    monkeypatch.setattr(orbax, "ZSTD_LIBRARY", "libzstd-absent.so.1")
    monkeypatch.setattr(orbax, "_lib", None)
    with pytest.raises(orbax.OrbaxFormatError,
                       match=r"manifest\.ocdbt: zstd: libzstd-absent\.so\.1 could not be "
                             r"loaded"):
        pckpt.restore_orbax_host(GOLDEN)


def test_an_optimizer_state_the_port_cannot_place_is_refused(dirs, tmp_path):
    """The JAX finetune run (AdamW) resumed by the linear probe (LARS), and
    the JAX pretrain run resumed with a clip it was not run with: each
    refused naming the node, never restarted from zero."""
    from cross_scale_mae_torch.cli import linprobe, pretrain

    run = linprobe.build_run(linprobe.get_args_parser().parse_args(
        CLF_ARGS + ["--output_dir", str(tmp_path)]))
    with pytest.raises(ValueError, match=r"opt_state/0: the JAX optimizer state holds list "
                                         r"where the port's Lars has keys \['inner_state'\]"):
        pckpt.restore_checkpoint(dirs["finetune"], run.state)
    run = pretrain.build_run(pretrain.get_args_parser().parse_args(
        PRE_ARGS + ["--output_dir", str(tmp_path), "--clip_grad", "1.0"]))
    with pytest.raises(ValueError, match=r"opt_state: .* AdamW has a sequence of 2"):
        pckpt.restore_checkpoint(dirs["pretrain"], run.state)
    assert run.state.step == 0


if __name__ == "__main__":
    # Writes tests/torch_orbax_golden.json from the JAX package's restore.
    with open(DIGESTS, "w") as f:
        json.dump(_golden_record(), f, indent=1)
        f.write("\n")
