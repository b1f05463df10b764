"""The port's mesh beyond plain data parallelism, on the data axis: ZeRO-1,
FSDP (with the global-norm clip) and the SSIM losses' global rescale under
the gspmd step, on two gloo ranks, held against the JAX step on a (2, 1)
mesh of the conftest's CPU devices with ``shard_train_state``; the
layouts' bytes, their shard-and-gather round trip, FSDP's per-block
gathers, ``--num_slices``, and checkpoints restored across layouts.

Each port rank is a subprocess that imports only torch and the port
(``tests/torch_mesh_driver.py``). Tolerances against JAX: those of
``tests/test_torch_port_parallel.py`` (losses rtol 3e-4, gradient norms
rtol 1e-3, params atol 5e-4, BatchNorm state atol 1e-5) over 3 steps.
Against the port's own one-process run on the same global batch and draws,
the same arithmetic but for the order of fp32 sums (the gradient average,
FSDP's reduce-scatter, the statistics' all-reduce): losses rtol 1e-6,
gradient norms rtol 1e-5, BatchNorm state atol 1e-6, params atol 1e-4 (that
file's reason: AdamW's first steps move each weight by about lr times the
sign of its gradient). Two controls must miss the JAX tolerances: the
clip's (and the reading's) gradient norm over a rank's local part under
FSDP, and the [0, 1] rescale on each rank's rows.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from cross_scale_mae_tpu import configs as jcfg
from tests import torch_mesh_driver as md

# name -> (source, driver spec)
RUNS = {
    "zero1": ("plain", dict(dp=2, zero1=True, save_ckpt=True)),
    "fsdp": ("clip", dict(dp=2, fsdp=True, save_ckpt=True)),
    "fsdp_local_norm": ("clip", dict(dp=2, fsdp=True, control="local_norm")),
    "ssim": ("ssim", dict(dp=2)),
    "ssim_local_scale": ("ssim", dict(dp=2, control="local_scale")),
    "one_plain": ("plain", dict()),
    "one_clip": ("clip", dict()),
    "one_ssim": ("ssim", dict()),
}
# Each layout's checkpoint restored into another layout and saved again.
RESTORES = {
    "fsdp_into_one": ("fsdp", "plain", dict()),
    "fsdp_into_zero1": ("fsdp", "plain", dict(dp=2, zero1=True)),
    "fsdp_into_tp": ("fsdp", "plain", dict(tp=2)),
    "zero1_into_fsdp": ("zero1", "plain", dict(dp=2, fsdp=True)),
}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_data")
    cfg = jcfg.get_mae_config("mae_vit_tiny_MsLdCeCd", **md.TINY)
    tcfg = jcfg.TrainConfig(batch_size=md.N, weight_decay=0.05)
    sources = {"plain": (cfg, tcfg), "clip": (cfg, tcfg.replace(clip_grad=0.5)),
               "ssim": (cfg.replace(loss="ssim", loss_ce="mse", loss_cd="mse"), tcfg)}
    inputs = {name: md.write_pretrain_src(str(root / f"src_{name}"), c, t)
              for name, (c, t) in sources.items()}
    jobs = []
    for name, (src, spec) in RUNS.items():
        jobs += md.rank_jobs(name, {"kind": "pretrain", "src": str(root / f"src_{src}"),
                                    **spec}, root)
    procs = md.run_procs_async(jobs)
    jax_runs = {
        "zero1": md.jax_pretrain(*sources["plain"], *inputs["plain"], 2, 1, zero1=True),
        "fsdp": md.jax_pretrain(*sources["clip"], *inputs["clip"], 2, 1, fsdp=True),
        "ssim": md.jax_pretrain(*sources["ssim"], *inputs["ssim"], 2, 1),
    }
    md.wait(procs)
    jobs = []
    for name, (layout, src, spec) in RESTORES.items():
        ckpt = str(root / layout / "ckpt")
        jobs += md.rank_jobs(name, {"kind": "pretrain", "src": str(root / f"src_{src}"),
                                    "restore": ckpt, **spec}, root)
    md.run_procs(jobs)
    port = {name: md.read_run(root, name) for name in RUNS}
    return {"root": root, "port": port, "jax": jax_runs, "cfg": cfg}


@pytest.mark.parametrize("layout,one", [("zero1", "one_plain"), ("fsdp", "one_clip"),
                                        ("ssim", "one_ssim")])
def test_data_axis_layout_matches_the_jax_step_on_a_two_device_mesh(mesh_runs, layout, one):
    """ZeRO-1, FSDP with --clip_grad, and the SSIM loss under gspmd at 2
    ranks against JAX on a (2, 1) mesh, and against the port's one process."""
    got = mesh_runs["port"][layout]
    gaps = md.misses(got, mesh_runs["jax"][layout])
    assert max(gaps.values()) <= 1.0, gaps
    own = md.misses(got, mesh_runs["port"][one], loss_rtol=1e-6, norm_rtol=1e-5,
                    params_atol=1e-4, state_atol=1e-6)
    assert max(own.values()) <= 1.0, own
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("control,layout,reading", [
    ("fsdp_local_norm", "fsdp", "grad_norms"), ("ssim_local_scale", "ssim", "losses")])
def test_the_lockstep_sees_local_clipping_and_a_local_rescale(mesh_runs, control, layout,
                                                               reading):
    """The clip's gradient norm taken over a rank's own part under FSDP
    (about 1/sqrt(2) of the whole; the step's grad_norm reading is the same
    norm, and AdamW's update is nearly blind to a clip factor that is the
    same at every step, so the reading shows it) misses; the rescale's min
    and max on each rank's rows moves the loss from the first step."""
    gaps = md.misses(mesh_runs["port"][control], mesh_runs["jax"][layout])
    assert gaps[reading] > 1.0, gaps


@pytest.mark.parametrize("layout,kind", [("zero1", "moments"), ("fsdp", "params"),
                                         ("fsdp", "moments")])
def test_per_rank_bytes_are_at_most_jaxs_per_device_bytes(mesh_runs, layout, kind):
    """Every rank holds at most the bytes of JAX's per-device shards (the
    sum of ``NamedSharding.shard_shape`` over the leaves), and less than a
    replicated copy; the layout's shard-and-gather gave its input back bit
    for bit."""
    got = mesh_runs["port"][layout]
    whole = mesh_runs["port"]["one_plain"]["bytes"][kind]
    for b in got["rank_bytes"]:
        assert b[kind] <= mesh_runs["jax"][layout]["bytes"][kind] < whole
    assert got["roundtrip"] is True


def test_fsdp_gathers_each_block_forward_and_backward(mesh_runs):
    """FSDP's gather counter (``parallel/collectives.FSDP_GATHERS``): per
    step one gather for the model's top level and one per block (2 encoder,
    1 decoder) in the forward, and the backward gathers the saved weights
    again rather than keeping them."""
    for g in mesh_runs["port"]["fsdp"]["gathers"]:
        assert g["forward"] == 1 + 3
        assert g["backward"] >= 3 * 4   # each block's qkv, proj, fc1 and fc2 kernels
    assert all(g == {"forward": 0, "backward": 0}
               for g in mesh_runs["port"]["zero1"]["gathers"])


@pytest.mark.parametrize("name", sorted(RESTORES))
def test_checkpoints_restore_bit_equal_across_layouts(mesh_runs, name):
    """A checkpoint written under FSDP or ZeRO-1 at 2 ranks holds whole
    leaves; restored at one process, under the other layout and under TP,
    and saved again, it is the same file's state bit for bit (JAX
    tests/test_parallel.py::test_checkpoint_restores_across_mesh_change)."""
    from cross_scale_mae_torch.utils.checkpoint import STATE_FILE, latest_step

    layout = RESTORES[name][0]
    src = str(mesh_runs["root"] / layout / "ckpt")
    again = str(mesh_runs["root"] / name / "ckpt_again")
    step = latest_step(src)
    assert latest_step(again) == step == md.STEPS
    a = torch.load(os.path.join(src, str(step), STATE_FILE), weights_only=True)
    b = torch.load(os.path.join(again, str(step), STATE_FILE), weights_only=True)
    assert sorted(a) == sorted(b)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


@pytest.mark.parametrize("dp,tp,zero1,fsdp", [(2, 1, False, True), (4, 1, True, False),
                                              (2, 2, False, True), (1, 2, False, False)])
def test_host_shard_and_gather_give_back_the_jax_arrays(mesh_runs, dp, tp, zero1, fsdp):
    """Every rank's part of the JAX init under a layout, joined back, is
    the JAX array bit for bit; a split leaf's part is the JAX shard's size."""
    from cross_scale_mae_tpu.models import mae_init
    from cross_scale_mae_torch.configs import MAEConfig
    from cross_scale_mae_torch.parallel.mesh import Layout, join_parts, leaf_specs, local_part
    from cross_scale_mae_torch.train.state import tree_items
    from cross_scale_mae_torch.utils.params import params_from_jax

    jparams, _ = mae_init(jax.random.key(0), mesh_runs["cfg"])
    cfg = MAEConfig.from_json(mesh_runs["cfg"].to_json())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, full=True)
    specs = leaf_specs(params, Layout(dp, tp, zero1, fsdp))
    for (path, leaf), spec in zip(tree_items(params), specs):
        parts = [[local_part(leaf, spec, d, m, dp, tp) for m in range(tp)] for d in range(dp)]
        assert torch.equal(join_parts(parts, spec), leaf), path
        split = (tp if spec and spec.model_axis is not None else 1) * (
            dp if spec and spec.data_axis is not None else 1)
        assert parts[0][0].numel() * split == leaf.numel(), path


def test_num_slices_accept_and_refuse_as_make_mesh():
    """The (world size, tp, slices) triples the JAX ``make_mesh`` accepts
    on CPU devices are those ``parallel/dist.init_mesh`` accepts; off a TPU
    the slices change nothing else."""
    from cross_scale_mae_tpu.parallel import make_mesh
    from cross_scale_mae_torch.parallel import dist

    for n in (1, 2, 4, 6, 8):
        for tp in (1, 2, 3, 4):
            for slices in (1, 2, 3):
                try:
                    make_mesh(jax.devices()[:n], model_parallel=tp, num_slices=slices)
                    want = True
                except AssertionError:
                    want = False
                try:
                    mh = dist.init_mesh(tp, slices, dist.Runtime(0, n, torch.device("cpu"),
                                                                 False))
                    got = (mh.dp, mh.tp) == (n // tp, tp)
                except SystemExit:
                    got = False
                finally:
                    dist.reset_mesh()
                assert got == want, (n, tp, slices)


def test_ddp_scaling_passes_a_layout_through_to_its_runs():
    """``tools/ddp_scaling.py --fsdp``: the one-process plain run, then two
    gloo ranks under FSDP with the gspmd step only (the shard_map step
    refuses the layout), each rank holding half of the split leaves'
    Adam moments."""
    out = subprocess.run(
        [sys.executable, os.path.join(md.REPO, "tools", "ddp_scaling.py"), "--nproc", "2",
         "--device", "cpu", "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32",
         "--patch_size", "8", "--per_rank_batch", "4", "--steps", "3", "--fsdp"],
        cwd=md.REPO, capture_output=True, text=True, timeout=md.TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = [json.loads(ln.split(" ", 1)[1]) for ln in out.stdout.splitlines()
             if ln.startswith("[ddp_scaling] ")]
    assert [(ln["world_size"], ln["ddp_mode"], ln["flags"]) for ln in lines] == [
        (1, "gspmd", []), (2, "gspmd", ["--fsdp"])]
    (one,), two = lines[0]["moment_bytes_by_rank"], lines[1]["moment_bytes_by_rank"]
    assert two[0] == two[1] and one / 2 <= two[0] < one
