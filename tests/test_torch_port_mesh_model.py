"""The port's mesh on its model axis: tensor parallelism (Megatron's split,
each rank running its H/tp heads through the K1 kernels' plain versions)
on a (1, 2) mesh, with FSDP on a (2, 2) mesh of 4 gloo ranks, and sequence
parallelism on (1, 2), held against the JAX step on a mesh of the same
shape with ``shard_train_state`` (the JAX package reaches the same
function through XLA: its split is a contiguous slice of the 3D qkv
columns, and its K1 partitioning runs every head on every model rank).

Each port rank is a subprocess that imports only torch and the port
(``tests/torch_mesh_driver.py``). Tolerances against JAX, and against the
port's one-process run on the same global batch and draws: those of
``tests/test_torch_port_mesh_data.py``. The tiny config's 5 encoder and 17
decoder tokens do not divide by 2, so SP pads them for its collectives.
Two controls must miss the JAX tolerances: TP given JAX's contiguous column
slice of qkv (rank 0 would run all of q against half of k), and the
predictor's BatchNorm without the model group's sum (its statistics over
this rank's half of the hidden axis).
"""

import pytest

from cross_scale_mae_tpu import configs as jcfg
from tests import torch_mesh_driver as md

RUNS = {
    "tp": dict(tp=2),
    "tp_linformer": dict(tp=2, src="src_linformer"),
    "tp_contiguous_qkv": dict(tp=2, control="contiguous_qkv"),
    "tp_bn_without_model_sum": dict(tp=2, control="bn_without_model_sum"),
    "tp_fsdp": dict(dp=2, tp=2, fsdp=True),
    "sp": dict(tp=2, sp=True),
    "one": dict(),
}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_model")
    cfg = jcfg.get_mae_config("mae_vit_tiny_MsLdCeCd", **md.TINY)
    tcfg = jcfg.TrainConfig(batch_size=md.N, weight_decay=0.05)
    inputs = md.write_pretrain_src(str(root / "src"), cfg, tcfg)
    lin = cfg.replace(attention_impl="linformer")
    lin_inputs = md.write_pretrain_src(str(root / "src_linformer"), lin, tcfg)
    jobs = []
    for name, spec in RUNS.items():
        spec = {"kind": "pretrain", **spec, "src": str(root / spec.get("src", "src"))}
        jobs += md.rank_jobs(name, spec, root)
    procs = md.run_procs_async(jobs)
    jax_runs = {
        "tp": md.jax_pretrain(cfg, tcfg, *inputs, 1, 2),
        "tp_linformer": md.jax_pretrain(lin, tcfg, *lin_inputs, 1, 2),
        "tp_fsdp": md.jax_pretrain(cfg, tcfg, *inputs, 2, 2, fsdp=True),
        "sp": md.jax_pretrain(cfg.replace(sequence_parallel=True), tcfg, *inputs, 1, 2),
    }
    md.wait(procs)
    return {"port": {name: md.read_run(root, name) for name in RUNS}, "jax": jax_runs}


@pytest.mark.parametrize("layout", ["tp", "tp_fsdp", "sp", "tp_linformer"])
def test_model_axis_layout_matches_the_jax_step_on_its_mesh(mesh_runs, layout):
    """TP on (1, 2), TP with FSDP on (2, 2) and SP on (1, 2) against JAX on
    the same mesh, and against the port's one process; linformer's
    attention (per head, its E and F replicated leaves) under TP against
    JAX's."""
    got = mesh_runs["port"][layout]
    gaps = md.misses(got, mesh_runs["jax"][layout])
    assert max(gaps.values()) <= 1.0, gaps
    if layout != "tp_linformer":
        own = md.misses(got, mesh_runs["port"]["one"], loss_rtol=1e-6, norm_rtol=1e-5,
                        params_atol=1e-4, state_atol=1e-6)
        assert max(own.values()) <= 1.0, own
    assert got["losses"][-1] < got["losses"][0]
    assert got["roundtrip"] is True


@pytest.mark.parametrize("control,reading", [("tp_contiguous_qkv", "losses"),
                                             ("tp_bn_without_model_sum", "state")])
def test_the_lockstep_sees_a_contiguous_qkv_split_and_a_local_batchnorm(mesh_runs, control,
                                                                       reading):
    """JAX's contiguous slice of the qkv columns breaks the K1 layout from
    the first forward; the predictor's BatchNorm over half its hidden axis
    moves the running statistics from the first step."""
    gaps = md.misses(mesh_runs["port"][control], mesh_runs["jax"]["tp"])
    assert gaps[reading] > 1.0, gaps


def test_tp_and_fsdp_hold_a_quarter_of_each_split_leaf(mesh_runs):
    """On (2, 2) each rank's params and moments are at most JAX's per-device
    bytes; under TP alone each rank holds its half of the split leaves."""
    for layout in ("tp", "tp_fsdp"):
        want = mesh_runs["jax"][layout]["bytes"]
        for b in mesh_runs["port"][layout]["rank_bytes"]:
            assert b["params"] <= want["params"] and b["moments"] <= want["moments"], layout
    whole = mesh_runs["port"]["one"]["bytes"]["params"]
    assert mesh_runs["port"]["tp_fsdp"]["bytes"]["params"] < mesh_runs["port"]["tp"][
        "bytes"]["params"] < whole


@pytest.mark.parametrize("tp,attention,reason", [
    ("2", "nystrom", "does not split by heads"),
    ("2", "orthoformer", "does not split by heads"),
    ("2", "fourier_mix", "does not split by heads"),
    ("3", "scaled_dot_product", "does not divide the encoder heads"),   # 8 heads
])
def test_tp_refuses_a_model_it_cannot_split(tmp_path, tp, attention, reason):
    """Before any device work: a variant attention whose math does not
    split by heads is refused by name, citing ROADMAP.md's item 11, and so
    is a tp that does not divide the heads or an MLP's hidden width."""
    from cross_scale_mae_torch.cli.pretrain import build_run, get_args_parser

    with pytest.raises(SystemExit, match=reason) as e:
        build_run(get_args_parser().parse_args([
            "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
            "--batch_size", "4", "--synthetic_len", "8", "--device", "cpu",
            "--model_parallel", tp, "--attention", attention, "--output_dir", str(tmp_path)]))
    if attention != "scaled_dot_product":
        assert attention in str(e.value) and "item 11" in str(e.value)
