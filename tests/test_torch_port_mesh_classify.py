"""The classifier steps on the mesh, and a run that shrinks across layouts.

* The finetune step (``vit_apply`` through the K2 kernels' plain versions,
  AdamW with layer decay and --clip_grad) and the linear probe's step (a
  frozen backbone, the BatchNorm head on the global batch's statistics,
  LARS on the head alone) under FSDP on a (2, 1) mesh and under TP on
  (1, 2), and the finetune step with Fourier mixing (each rank's q
  gathered over the model group) under TP on (1, 2), held against JAX
  ``train/classify.make_classify_train_step``
  with ``shard_train_state`` on the same mesh, and against the port's one
  process, with the tolerances of ``tests/test_torch_port_mesh_data.py``.
  The probe's head (64 x 20 weights) is large enough for FSDP to split, so
  LARS's trust ratio takes its norms over both halves.
* The elastic launcher (``cli/launch.py --elastic``) under ``--fsdp``:
  rank 1 of 2 lost at step 3, the gang relaunched at 1 process with
  ``--resume`` (the checkpoint's whole leaves restored into the
  one-process layout), held to the unbroken 2-rank FSDP run with the
  2-rank-against-one-process bounds of ``tests/test_torch_port_resume.py``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu import configs as jcfg
from tests import torch_mesh_driver as md

# name -> (source, mesh); a source is the step's kind and the attention.
SRCS = {"finetune": ("finetune", "pallas"), "probe": ("probe", "pallas"),
        "finetune_fourier_mix": ("finetune", "fourier_mix")}
RUNS = {
    "ft_fsdp": ("finetune", dict(dp=2, fsdp=True)),
    "ft_tp": ("finetune", dict(tp=2)),
    "ft_one": ("finetune", dict()),
    "probe_fsdp": ("probe", dict(dp=2, fsdp=True)),
    "probe_tp": ("probe", dict(tp=2)),
    "probe_one": ("probe", dict()),
    "ft_tp_fourier_mix": ("finetune_fourier_mix", dict(tp=2)),
    "ft_one_fourier_mix": ("finetune_fourier_mix", dict()),
}


def _jax_classify(jc, tcfg, params, mstate, batch, labels, kind, dp, tp, fsdp):
    from cross_scale_mae_tpu.parallel import batch_sharding, make_mesh, shard_train_state
    from cross_scale_mae_tpu.train import TrainState, build_optimizer, warmup_half_cosine
    from cross_scale_mae_tpu.train.classify import make_classify_train_step

    mesh = make_mesh(jax.devices()[:dp * tp], model_parallel=tp)
    sched = warmup_half_cosine(*md.SCHED)
    if kind == "probe":
        mask = {k: jax.tree.map(lambda _: k == "head", v) for k, v in params.items()}
        tx = build_optimizer(params, sched, optimizer="lars", weight_decay=0.0,
                             frozen_mask=mask)
    else:
        tx = build_optimizer(params, sched, weight_decay=0.05, b1=0.9, b2=0.999,
                             clip_grad=tcfg.clip_grad, layer_decay=0.75, depth=jc.depth,
                             no_decay_names=("pos_embed", "cls_token"))
    state = shard_train_state(mesh, TrainState.create(params, mstate, tx),
                              tensor_parallel=tp > 1, fsdp=fsdp)
    nbytes = md.device_bytes(state)   # as laid out, before the step's own output layout
    step = make_classify_train_step(jc, tcfg, sched, donate=False,
                                    freeze_backbone=kind == "probe", mesh=mesh)
    sh = batch_sharding(mesh)
    b, lb = jax.device_put(jnp.asarray(batch), sh), jax.device_put(jnp.asarray(labels), sh)
    rng = jax.random.key(3)
    losses, norms = [], []
    for _ in range(md.STEPS):
        state, m = step(state, b, lb, rng)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"params": jax.tree.map(md.t32, state.params),
            "state": jax.tree.map(md.t32, state.model_state),
            "losses": np.array(losses), "grad_norms": np.array(norms),
            "bytes": nbytes}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    from cross_scale_mae_tpu.models.vit import vit_init
    from cross_scale_mae_torch.utils.checkpoint import save_params_npz

    root = tmp_path_factory.mktemp("mesh_classify")
    rng = np.random.default_rng(4)
    batch = rng.normal(size=(md.N, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, md.VIT["num_classes"], md.N).astype(np.int32)
    tcfg = jcfg.TrainConfig(batch_size=md.N, clip_grad=0.5, layer_decay=0.75)
    setups = {}
    for name, (kind, attention) in SRCS.items():
        jc = jcfg.get_vit_config("vit_base_patch16", use_bn_head=kind == "probe",
                                 **{**md.VIT, "attention_impl": attention})
        params, mstate = vit_init(jax.random.key(5), jc)
        src = root / f"src_{name}"
        os.makedirs(src)
        save_params_npz(str(src / "weights.npz"),
                        jax.tree.map(md.t32, {"params": params, "state": mstate}))
        (src / "meta.json").write_text(json.dumps(
            {"cfg": jc.to_json(), "tcfg": tcfg.to_json(), "sched": list(md.SCHED)}))
        np.savez(src / "data.npz", batch=batch, labels=labels, steps=md.STEPS)
        setups[name] = (jc, params, mstate)
    jobs = []
    for name, (src, spec) in RUNS.items():
        jobs += md.rank_jobs(name, {"kind": SRCS[src][0], "src": str(root / f"src_{src}"),
                                    **spec}, root)
    procs = md.run_procs_async(jobs)
    jax_runs = {}
    for name, (src, spec) in RUNS.items():
        if "one" in name:
            continue
        jc, params, mstate = setups[src]
        jax_runs[name] = _jax_classify(jc, tcfg, params, mstate, batch, labels, SRCS[src][0],
                                       spec.get("dp", 1), spec.get("tp", 1),
                                       spec.get("fsdp", False))
    md.wait(procs)
    return {"port": {name: md.read_run(root, name) for name in RUNS}, "jax": jax_runs}


@pytest.mark.parametrize("name", ["ft_fsdp", "ft_tp", "probe_fsdp", "probe_tp",
                                  "ft_tp_fourier_mix"])
def test_classifier_step_matches_the_jax_step_on_its_mesh(mesh_runs, name):
    got = mesh_runs["port"][name]
    gaps = md.misses(got, mesh_runs["jax"][name])
    assert max(gaps.values()) <= 1.0, gaps
    one = name.replace("_fsdp", "_one").replace("_tp", "_one")
    own = md.misses(got, mesh_runs["port"][one], loss_rtol=1e-6, norm_rtol=1e-5,
                    params_atol=1e-4, state_atol=1e-6)
    assert max(own.values()) <= 1.0, own
    for b in got["rank_bytes"]:
        assert b["params"] <= mesh_runs["jax"][name]["bytes"]["params"]


# ---------------------------------------------------------------- the elastic shrink


EPOCHS = 5
PRETRAIN = ["-m", "cross_scale_mae_torch.cli.pretrain", "--model", "mae_vit_tiny_MsLdCeCd",
            "--input_size", "32", "--patch_size", "8", "--batch_size", "4",
            "--synthetic_len", "8", "--epochs", str(EPOCHS), "--warmup_epochs", "1",
            "--ckpt_interval", "1", "--compute_dtype", "float32", "--device", "cpu",
            "--log_interval", "1", "--fsdp"]


def test_elastic_launcher_shrinks_an_fsdp_run_to_one_process(tmp_path):
    """2 ranks under --fsdp, rank 1 lost after its 3rd step; the launcher
    relaunches at 1 process with --resume, and the run ends where the
    unbroken 2-rank FSDP run ends, within the 2-rank-against-one-process
    bounds (params atol 1e-4, BatchNorm state atol 1e-6)."""
    import threading

    from cross_scale_mae_torch.cli import launch
    from cross_scale_mae_torch.utils import checkpoint as pckpt

    env = ["env", f"PYTHONPATH={md.REPO}", "OMP_NUM_THREADS=1"]
    work = str(tmp_path / "drill")
    os.makedirs(work)
    args = launch.get_args_parser().parse_args([
        "--nprocs", "2", "--workdir", work, "--grace_s", "2", "--poll_s", "0.1",
        "--max_restarts", "1", "--elastic", "--min_procs", "1", "--", *env,
        "CSM_FAULT_STEP=3", "CSM_FAULT_PROCESS=1", "CSM_FAULT_ATTEMPT=1", sys.executable,
        *PRETRAIN, "--output_dir", os.path.join(work, "out")])
    result = {}
    drill = threading.Thread(target=lambda: result.update(launch.main(args)))
    drill.start()
    address = md.free_address()
    md.run_procs([[*env, sys.executable, *PRETRAIN, "--output_dir", str(tmp_path / "two"),
                   "--coordinator_address", address, "--num_processes", "2",
                   "--process_id", str(r)] for r in range(2)])
    drill.join(timeout=2 * md.TIMEOUT_S)
    assert result == {"success": True, "attempts": 2, "final_nprocs": 1, "restarts": 1}
    log = open(os.path.join(work, "launcher", "attempt2.worker0.log")).read()
    assert "at epoch 1 (step 2" in log and "1 process(es)" in log

    def final(out):
        ckpt = launch.find_latest_checkpoints(out)
        step = pckpt.latest_step(ckpt)
        assert step == EPOCHS * 2
        return torch.load(os.path.join(ckpt, str(step), pckpt.STATE_FILE), weights_only=True)

    got, want = final(os.path.join(work, "out")), final(str(tmp_path / "two"))
    assert sorted(got) == sorted(want)

    def worst(prefix):
        return max(float((got[k].double() - want[k].double()).abs().max())
                   for k in got if k.startswith(prefix))

    assert worst("params/") <= 1e-4 and worst("model_state/") <= 1e-6
