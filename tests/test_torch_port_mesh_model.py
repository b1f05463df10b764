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

The variants under TP (Nystrom, orthoformer and Fourier mixing on (1, 2),
Fourier mixing under SP on (1, 2) and with FSDP on (2, 2)) run at 72 px,
patch 8: the decoder's 82 tokens exceed both landmark counts (64, 32), so
Nystrom and orthoformer approximate (the tiny config's 17 would fall back
to exact attention). Each is held to the same tolerances against JAX on
its mesh and against the port's one process of the same variant. Fourier
mixing's FFT runs over every head's features, so each rank gathers the
whole q (``collectives.gather_heads``); its control, the FFT over the
rank's own heads alone, must miss the JAX tolerances.

Each training CLI also runs a variant on the model axis at gloo ranks
(pretrain Nystrom with --sequence_parallel, finetune orthoformer with
--fsdp on 4 ranks, linprobe Fourier mixing with --sequence_parallel), its
attention calls counted by whether qkv held a head group, against the same
CLI in one process. ``gather_heads`` itself runs on 2 gloo ranks.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest

from cross_scale_mae_tpu import configs as jcfg
from tests import torch_mesh_driver as md

# The variants at 72 px: both landmark variants approximate in the decoder.
VARIANT_SIZE = dict(md.TINY, input_size=72)
VARIANT_RUNS = {
    "tp_nystrom": dict(tp=2, src="src_nystrom"),
    "tp_orthoformer": dict(tp=2, src="src_orthoformer"),
    "tp_fourier_mix": dict(tp=2, src="src_fourier_mix"),
    "sp_fourier_mix": dict(tp=2, sp=True, src="src_fourier_mix"),
    "tp_fsdp_fourier_mix": dict(dp=2, tp=2, fsdp=True, src="src_fourier_mix"),
    "tp_fourier_mix_no_gather": dict(tp=2, src="src_fourier_mix",
                                     control="fourier_mix_no_gather"),
    "one_nystrom": dict(src="src_nystrom"),
    "one_orthoformer": dict(src="src_orthoformer"),
    "one_fourier_mix": dict(src="src_fourier_mix"),
}
RUNS = {
    "tp": dict(tp=2),
    "tp_linformer": dict(tp=2, src="src_linformer"),
    "tp_contiguous_qkv": dict(tp=2, control="contiguous_qkv"),
    "tp_bn_without_model_sum": dict(tp=2, control="bn_without_model_sum"),
    "tp_fsdp": dict(dp=2, tp=2, fsdp=True),
    "sp": dict(tp=2, sp=True),
    "one": dict(),
    **VARIANT_RUNS,
}
# Each training CLI with a variant, on the model axis at (ranks, flags) and
# in one process.
CLI_ARGS = {
    "pretrain": ["--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "72", "--batch_size", "4",
                 "--synthetic_len", "8", "--max_steps", "2", "--attention", "nystrom"],
    "finetune": ["--model", "vit_base_patch16", "--embed_dim", "64", "--depth", "2",
                 "--num_heads", "4", "--input_size", "48", "--batch_size", "8",
                 "--synthetic_len", "16", "--max_steps", "2", "--attention", "orthoformer"],
    "linprobe": ["--model", "vit_base_patch16", "--embed_dim", "64", "--depth", "2",
                 "--num_heads", "4", "--input_size", "32", "--batch_size", "8",
                 "--synthetic_len", "16", "--nb_classes", "5", "--epochs", "1",
                 "--dataset_type", "synthetic", "--attention", "fourier_mix"],
}
CLI_MESH = {"pretrain": (2, ["--model_parallel", "2", "--sequence_parallel"]),
            "finetune": (4, ["--model_parallel", "2", "--fsdp"]),
            "linprobe": (2, ["--model_parallel", "2", "--sequence_parallel"])}
# A CLI run as __main__ with layers.attention wrapped: rank 0 prints its
# calls by impl, whether qkv held a head group, and sp.
CLI_WRAPPER = r"""
import atexit, collections, json, runpy, sys
import torch
torch.set_num_threads(1)
from cross_scale_mae_torch.models import layers
calls = collections.Counter()
attention = layers.attention
def counted(p, x, num_heads, impl="xla", sp=False, seq_len=None):
    heads = p["qkv"]["kernel"].shape[1] * num_heads // (3 * x.shape[-1])
    calls[f"{impl} split={heads != num_heads} sp={sp}"] += 1
    return attention(p, x, num_heads, impl, sp, seq_len)
layers.attention = counted
atexit.register(lambda: print("ATTENTION " + json.dumps(calls), flush=True))
sys.argv = sys.argv[1:]
runpy.run_module("cross_scale_mae_torch.cli." + sys.argv[0], run_name="__main__")
"""
# gather_heads on 2 gloo ranks: every rank draws both head groups and both
# ranks' cotangents of the whole from one seed.
GATHER_HEADS = r"""
import json, sys
import numpy as np
import torch
from cross_scale_mae_torch.parallel import collectives, dist
rank, address, out = json.loads(sys.argv[1])
dist.initialize_distributed(address, 2, rank, "cpu")
dist.init_mesh(2)
gen = torch.Generator().manual_seed(0)
parts = [torch.randn(2, 5, 3, 4, generator=gen) for _ in range(2)]
cots = [torch.randn(2, 5, 6, 4, generator=gen) for _ in range(2)]
q = parts[rank].clone().requires_grad_(True)
whole = collectives.gather_heads(q, 6)
whole.backward(cots[rank])
np.savez(f"{out}/rank{rank}.npz", whole=whole.detach().numpy(), grad=q.grad.numpy(),
         parts=torch.stack(parts).numpy(), cots=torch.stack(cots).numpy())
dist.barrier()
dist.shutdown()
"""


def _cli_jobs(root) -> tuple[list, dict]:
    """The CLI runs' argvs and, by name, the index of rank 0's job."""
    jobs, first = [], {}
    for cli, argv in CLI_ARGS.items():
        base = [sys.executable, "-c", CLI_WRAPPER, cli, *argv, "--patch_size", "8",
                "--compute_dtype", "float32", "--device", "cpu"]
        ranks, flags = CLI_MESH[cli]
        address = md.free_address()
        first[cli] = len(jobs)
        jobs += [[*base, "--output_dir", str(root / f"cli_{cli}"), *flags,
                  "--coordinator_address", address, "--num_processes", str(ranks),
                  "--process_id", str(r)] for r in range(ranks)]
        first[cli + "_one"] = len(jobs)
        jobs.append([*base, "--output_dir", str(root / f"cli_{cli}_one")])
    out = root / "gather_heads"
    os.makedirs(out)
    address = md.free_address()
    jobs += [[sys.executable, "-c", GATHER_HEADS, json.dumps([r, address, str(out)])]
             for r in range(2)]
    return jobs, first


def _cli_run(root, name: str, text: str) -> dict:
    """A CLI run's attention calls (rank 0's), last log line and params."""
    run = glob.glob(str(root / f"cli_{name}" / "run_*"))[0]
    calls = [json.loads(ln[len("ATTENTION "):]) for ln in text.splitlines()
             if ln.startswith("ATTENTION ")]
    with open(os.path.join(run, "log.jsonl")) as f:
        last = json.loads(f.read().splitlines()[-1])
    with np.load(os.path.join(run, "params.npz")) as z:
        params = {k: z[k] for k in z.files if k != "__config__"}
    return {"calls": calls[-1], "log": last, "params": params}


# Each layout's one-process run of the same variant and draws.
# Fourier mixing's last decoder block: its norm1 bias and qkv bias add one
# vector to every token, which the FFT over the tokens moves into row 0
# alone, the cls row the loss drops. Their gradient is analytically zero,
# read as rounding noise on every side, so they are held to steps * lr
# (as tests/test_torch_port_variants.py's lockstep holds them); every other
# leaf keeps the tp case's bounds.
FOURIER_ZERO_GRAD = ("/decoder_blocks/norm1/bias", "/decoder_blocks/attn/qkv/bias")
ONE = {"tp": "one", "tp_fsdp": "one", "sp": "one", "tp_nystrom": "one_nystrom",
       "tp_orthoformer": "one_orthoformer", "tp_fourier_mix": "one_fourier_mix",
       "sp_fourier_mix": "one_fourier_mix", "tp_fsdp_fourier_mix": "one_fourier_mix"}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_model")
    cfg = jcfg.get_mae_config("mae_vit_tiny_MsLdCeCd", **md.TINY)
    tcfg = jcfg.TrainConfig(batch_size=md.N, weight_decay=0.05)
    inputs = md.write_pretrain_src(str(root / "src"), cfg, tcfg)
    lin = cfg.replace(attention_impl="linformer")
    lin_inputs = md.write_pretrain_src(str(root / "src_linformer"), lin, tcfg)
    variants = {}
    for v in ("nystrom", "orthoformer", "fourier_mix"):
        vc = jcfg.get_mae_config("mae_vit_tiny_MsLdCeCd", **{**VARIANT_SIZE,
                                                             "attention_impl": v})
        variants[v] = (vc, md.write_pretrain_src(str(root / f"src_{v}"), vc, tcfg))
    jobs, cli_first = _cli_jobs(root)
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
    for v, (vc, vin) in variants.items():
        jax_runs["tp_" + v] = md.jax_pretrain(vc, tcfg, *vin, 1, 2)
    vc, vin = variants["fourier_mix"]
    jax_runs["sp_fourier_mix"] = md.jax_pretrain(vc.replace(sequence_parallel=True), tcfg,
                                                 *vin, 1, 2)
    jax_runs["tp_fsdp_fourier_mix"] = md.jax_pretrain(vc, tcfg, *vin, 2, 2, fsdp=True)
    outs = md.wait(procs)
    return {"port": {name: md.read_run(root, name) for name in RUNS}, "jax": jax_runs,
            "cli": {name: _cli_run(root, name, outs[i]) for name, i in cli_first.items()},
            "gather_heads": [dict(np.load(root / "gather_heads" / f"rank{r}.npz"))
                             for r in range(2)]}


@pytest.mark.parametrize("layout", ["tp", "tp_fsdp", "sp", "tp_linformer", "tp_nystrom",
                                    "tp_orthoformer", "tp_fourier_mix", "sp_fourier_mix",
                                    "tp_fsdp_fourier_mix"])
def test_model_axis_layout_matches_the_jax_step_on_its_mesh(mesh_runs, layout):
    """TP on (1, 2), TP with FSDP on (2, 2) and SP on (1, 2) against JAX on
    the same mesh, and against the port's one process; linformer's
    attention (per head, its E and F replicated leaves) under TP against
    JAX's; Nystrom, orthoformer and Fourier mixing (its q gathered over the
    model group) where they approximate, against both."""
    got = mesh_runs["port"][layout]
    zero_grad = FOURIER_ZERO_GRAD if layout.endswith("fourier_mix") else ()
    gaps = md.misses(got, mesh_runs["jax"][layout], zero_grad=zero_grad)
    assert max(gaps.values()) <= 1.0, gaps
    if layout != "tp_linformer":
        own = md.misses(got, mesh_runs["port"][ONE[layout]], loss_rtol=1e-6, norm_rtol=1e-5,
                        params_atol=1e-4, state_atol=1e-6, zero_grad=zero_grad)
        assert max(own.values()) <= 1.0, own
    assert got["losses"][-1] < got["losses"][0]
    assert got["roundtrip"] is True


@pytest.mark.parametrize("control,reading,ref", [
    ("tp_contiguous_qkv", "losses", "tp"),
    ("tp_bn_without_model_sum", "state", "tp"),
    ("tp_fourier_mix_no_gather", "losses", "tp_fourier_mix"),
])
def test_the_lockstep_sees_a_contiguous_qkv_split_and_a_local_batchnorm(mesh_runs, control,
                                                                       reading, ref):
    """JAX's contiguous slice of the qkv columns breaks the K1 layout from
    the first forward; the predictor's BatchNorm over half its hidden axis
    moves the running statistics from the first step; Fourier mixing over
    each rank's own heads' features (no gather) is another function from
    the first forward."""
    gaps = md.misses(mesh_runs["port"][control], mesh_runs["jax"][ref])
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
    ("3", "scaled_dot_product", "does not divide the encoder heads"),   # 8 heads
])
def test_tp_refuses_a_model_it_cannot_split(tmp_path, tp, attention, reason):
    """Before any device work: a tp that does not divide the heads or an
    MLP's hidden width is refused."""
    from cross_scale_mae_torch.cli.pretrain import build_run, get_args_parser

    with pytest.raises(SystemExit, match=reason):
        build_run(get_args_parser().parse_args([
            "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
            "--batch_size", "4", "--synthetic_len", "8", "--device", "cpu",
            "--model_parallel", tp, "--attention", attention, "--output_dir", str(tmp_path)]))


def test_gather_heads_concatenates_forward_and_reduce_scatters_backward(mesh_runs):
    """On 2 gloo ranks: the whole q is the head groups concatenated in rank
    order, bit for bit, on both ranks; each rank's gradient is the sum of
    the ranks' cotangents of the whole, at its own heads."""
    for r, got in enumerate(mesh_runs["gather_heads"]):
        parts, cots = got["parts"], got["cots"]
        np.testing.assert_array_equal(got["whole"], np.concatenate(list(parts), 2))
        np.testing.assert_array_equal(got["grad"], (cots[0] + cots[1])[:, :, 3 * r:3 * r + 3])


def test_gather_heads_is_the_identity_without_a_model_group():
    """One process: the whole q comes back as it is; a head group, with no
    model group to gather the rest from, is refused."""
    import torch

    from cross_scale_mae_torch.parallel.collectives import gather_heads

    q = torch.randn(2, 5, 6, 4)
    assert gather_heads(q, 6) is q
    with pytest.raises(RuntimeError, match="3 of 6 heads"):
        gather_heads(q[:, :, :3], 6)


@pytest.mark.parametrize("cli", ["pretrain", "finetune", "linprobe"])
def test_each_training_cli_runs_a_variant_on_the_model_axis(mesh_runs, cli):
    """Every attention call of the tp 2 run held a head group (with
    --sequence_parallel where given), none of the one-process run's did,
    and the two end within the port's one-process bounds (loss rtol 1e-6,
    params atol 1e-4)."""
    got, one = mesh_runs["cli"][cli], mesh_runs["cli"][cli + "_one"]
    impl = CLI_ARGS[cli][-1]
    sp = "--sequence_parallel" in CLI_MESH[cli][1]
    assert list(got["calls"]) == [f"{impl} split=True sp={sp}"], got["calls"]
    assert list(one["calls"]) == [f"{impl} split=False sp=False"], one["calls"]
    key = "train_loss" if cli == "pretrain" else "loss"
    assert abs(got["log"][key] - one["log"][key]) <= 1e-6 * abs(one["log"][key])
    assert sorted(got["params"]) == sorted(one["params"])
    gap = max(float(np.abs(got["params"][k] - one["params"][k]).max()) for k in one["params"])
    assert gap <= 1e-4, gap
