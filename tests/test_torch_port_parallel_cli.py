"""The port's data-parallel runtime on the CPU over gloo: the bootstrap,
the collectives, the loader's shards, and the three training CLIs run as 2
processes against 1, plus the pretrain CLI's flag surface against the JAX
parser's.

Each rank is a subprocess that imports only torch and the port; every one
is waited for with a time limit. Tolerances of the 2-process runs against
one process: losses rtol 1e-5 (the same arithmetic but for the order of
fp32 sums) and params atol 1e-4 (AdamW's first steps turn an fp32
difference in a near-zero gradient into up to 2.3e-5 of a weight,
``tests/test_torch_port_parallel.py``); the global eval accuracy, the
confusion matrix and the eval count equal.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

_CLI_DRIVER = r"""
import importlib, json, sys
import torch
torch.set_num_threads(1)
from cross_scale_mae_torch.parallel import dist
cli = importlib.import_module("cross_scale_mae_torch.cli." + sys.argv[1])
res = cli.main(cli.get_args_parser().parse_args(sys.argv[2:]))
out = {k: res[k] for k in ("steps", "losses", "npz", "output_dir", "rank", "world_size")
       if k in res}
if "eval" in res:
    out["eval"] = {k: (v.tolist() if k == "cm" else v) for k, v in res["eval"].items()}
print("RESULT " + json.dumps(out))
dist.shutdown()
"""

_COLLECTIVES_DRIVER = r"""
import sys
import torch
torch.set_num_threads(1)
from cross_scale_mae_torch.parallel import collectives, dist, mesh
rt = dist.initialize_distributed(sys.argv[1], 2, int(sys.argv[2]), "cpu")
r = rt.rank
assert (rt.world_size, rt.distributed, dist.world_size(), dist.rank()) == (2, True, 2, r)
assert dist.initialize_distributed(sys.argv[1], 2, r, "cpu") == rt   # idempotent
# Gradients copied into flat buffers (one a dtype) and averaged there in
# place: rank r holds r + 1 in every gradient.
grads = [torch.full((3,), r + 1.0), torch.full((2, 2), 10.0 * (r + 1)),
         torch.full((1,), -1.0 - r, dtype=torch.float64)]
flat = mesh.FlatGrads(grads)
assert len(flat.buffers) == 2
for _ in range(2):
    out = flat.all_reduce(grads)
    assert all(torch.equal(g, torch.full_like(g, v)) for g, v in zip(out, (1.5, 15.0, -1.5))), out
    assert out[0].data_ptr() == flat.buffers[0].data_ptr() and grads[0][0].item() == r + 1.0
totals = {"a": torch.tensor([r + 1.0]), "b": [torch.tensor([[2, 3]]) * (r + 1)]}
mesh.all_reduce_total(totals)
assert totals["a"].item() == 3.0 and totals["b"][0].tolist() == [[6, 9]]
params = {"w": torch.full((2,), float(r)), "b": [torch.tensor([r + 7.0])]}
mesh.broadcast_params(params)
assert params["w"].tolist() == [0.0, 0.0] and params["b"][0].tolist() == [7.0]
# The gather's rows in rank order; its backward sums over the ranks: the
# loss sum(w * gathered) with w = rank + 1 on each rank gives every row of
# every rank the gradient 1 + 2 = 3.
x = torch.full((2, 2), float(r), requires_grad=True)
g = collectives.all_gather_rows(x)
assert g[:, 0].tolist() == [0.0, 0.0, 1.0, 1.0]
(g * (r + 1)).sum().backward()
assert torch.equal(x.grad, torch.full((2, 2), 3.0)), x.grad
y = torch.tensor([float(r + 1)], requires_grad=True)
s = collectives.all_reduce_sum(y)
assert s.item() == 3.0
(s * (r + 1)).sum().backward()
assert y.grad.item() == 3.0
assert dist.broadcast_object("rank 0's" if r == 0 else None) == "rank 0's"
dist.barrier()
dist.shutdown()
dist.shutdown()   # a second call does nothing
print("OK")
"""

_HANG_DRIVER = r"""
import os, sys, time
import torch
import torch.distributed as tdist
from cross_scale_mae_torch.parallel import dist
rank, ready = int(sys.argv[2]), sys.argv[3]
# Both ranks have imported torch before either starts the 2 s rendezvous: a
# rank slow to import (six test workers share the cores) would otherwise
# time rank 0 out in init_process_group, before its all-reduce.
open(os.path.join(ready, str(rank)), "w").close()
deadline = time.monotonic() + 120
while not os.path.exists(os.path.join(ready, str(1 - rank))):
    assert time.monotonic() < deadline, "the other rank never started"
    time.sleep(0.01)
dist.initialize_distributed(sys.argv[1], 2, rank, "cpu", timeout_s=2)
if rank == 0:
    t0 = time.perf_counter()
    try:
        tdist.all_reduce(torch.ones(1))
        print("RETURNED")
    except RuntimeError:
        print("RAISED %.3f" % (time.perf_counter() - t0))
else:
    time.sleep(6)
# The line is out; leave without the interpreter's teardown, which can
# abort (SIGABRT) on a gloo group whose collective timed out.
sys.stdout.flush()
os._exit(0)
"""


def _free_port() -> str:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return str(sock.getsockname()[1])


def _address() -> str:
    return "127.0.0.1:" + _free_port()


def run_jobs(jobs: list[list[str]]) -> list[str]:
    """Start every job (``python -c`` argv) at once, wait for each with a
    time limit, and return their outputs; a failure or a timeout fails the
    test with the job's output."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", *argv], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for argv in jobs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for argv, p, out in zip(jobs, procs, outs):
        assert p.returncode == 0, f"{argv[1:]} failed:\n{out[-4000:]}"
    return outs


def _result(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1][7:])


def _two_ranks(cli: str, argv: list[str], out_dirs=None) -> list[str]:
    """argv for the CLI's two gloo ranks (rank r writes to out_dirs[r] when
    given)."""
    address = _address()
    return [[_CLI_DRIVER, cli, *argv, "--device", "cpu", "--coordinator_address", address,
             "--num_processes", "2", "--process_id", str(r),
             *(("--output_dir", out_dirs[r]) if out_dirs else ())] for r in range(2)]


# ---------------------------------------------------------------- runtime


def test_collectives_and_reductions_at_two_ranks():
    """The gradient average in flat buffers (its factor pinned: gloo takes
    ReduceOp.AVG), the sums, the broadcast, the gather's rank order and the SUM backward
    of both autograd collectives, idempotent init and shutdown."""
    address = _address()
    outs = run_jobs([[_COLLECTIVES_DRIVER, address, str(r)] for r in range(2)])
    assert all(o.rstrip().endswith("OK") for o in outs), outs


def test_a_hung_collective_raises_within_the_timeout(tmp_path):
    """Rank 1 never joins rank 0's all-reduce: rank 0 raises after the
    group's 2 s timeout, long before rank 1 wakes."""
    address = _address()
    outs = run_jobs([[_HANG_DRIVER, address, str(r), str(tmp_path)] for r in range(2)])
    line = [ln for ln in outs[0].splitlines() if ln.startswith(("RAISED", "RETURNED"))][-1]
    assert line.startswith("RAISED") and float(line.split()[1]) < 5.0, outs[0]


def test_without_flags_one_process_and_no_group(monkeypatch):
    import torch.distributed as tdist

    from cross_scale_mae_torch.parallel import dist

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    rt = dist.initialize_distributed(device="cpu")
    assert rt == dist.Runtime(0, 1, torch.device("cpu"), False)
    assert not tdist.is_initialized() and dist.world_size() == 1 and dist.is_main_process()
    dist.barrier()
    dist.shutdown()
    with pytest.raises(SystemExit, match="go together"):
        dist.initialize_distributed("127.0.0.1:1", None, 0, "cpu")
    with pytest.raises(SystemExit, match="not a rank"):
        dist.initialize_distributed("127.0.0.1:1", 2, 2, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            dist.initialize_distributed(device="cuda")


def test_a_torchrun_world_of_one_runs_its_collectives(monkeypatch):
    """torchrun's environment at world size 1: a gloo group, whose
    collectives run (here on one rank: the mean of one)."""
    from cross_scale_mae_torch.parallel import dist, mesh

    port = _free_port()
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", port)):
        monkeypatch.setenv(var, value)
    try:
        rt = dist.initialize_distributed(device="cpu")
        assert rt == dist.Runtime(0, 1, torch.device("cpu"), True)
        g = [torch.tensor([1.0, 2.0])]
        mesh.all_reduce_mean(g)
        assert g[0].tolist() == [1.0, 2.0]
    finally:
        dist.shutdown()


def test_setup_runtime_refuses_a_batch_the_ranks_do_not_split(monkeypatch):
    import argparse

    from cross_scale_mae_torch.cli import common
    from cross_scale_mae_torch.parallel.dist import Runtime

    monkeypatch.setattr(common, "initialize_distributed",
                        lambda *a: Runtime(1, 3, torch.device("cpu"), True))
    args = argparse.Namespace(coordinator_address="h:1", num_processes=3, process_id=1,
                              device="cpu", seed=5, batch_size=8)
    with pytest.raises(SystemExit, match="does not split over 3"):
        common.setup_runtime(args)
    args.batch_size = 9
    state = np.random.get_state()
    try:
        assert common.setup_runtime(args).world_size == 3
        # numpy seeded per rank: seed + rank (JAX cli/common.py:162).
        assert np.random.get_state()[1][0] == np.random.RandomState(6).get_state()[1][0]
    finally:
        np.random.set_state(state)


# ---------------------------------------------------------------- draws


def test_draws_shard_takes_each_ranks_rows_of_the_global_batch():
    from cross_scale_mae_torch import configs
    from cross_scale_mae_torch.train.classify import sample_finetune_draws
    from cross_scale_mae_torch.train.pretrain import _step_rng, sample_pretrain_draws

    cfg = configs.get_mae_config("mae_vit_tiny_MsLdCeCd", input_size=32, patch_size=8)
    tc = configs.TrainConfig()
    d = sample_pretrain_draws(_step_rng(tc, 1, 0, "cpu"), 6, cfg, tc, rot90=True)
    parts = [d.shard(r, 3) for r in range(3)]
    for r, part in enumerate(parts):
        assert torch.equal(part.hflip, d.hflip[r::3]) and torch.equal(part.rot_k, d.rot_k[r::3])
        assert torch.equal(part.noise, torch.cat([d.noise[:6][r::3], d.noise[6:][r::3]]))
        assert part.ms_boxes.shape == (2, 4)
    assert d.shard(0, 1) is d
    # shard_map draws: one generator per rank, the same one under mask_seed.
    a, b = (sample_pretrain_draws(_step_rng(tc, 1, 0, "cpu", rank=r), 2, cfg, tc)
            for r in range(2))
    assert not torch.equal(a.noise, b.noise)
    pinned = tc.replace(mask_seed=3)
    a, b = (sample_pretrain_draws(_step_rng(pinned, 1, 0, "cpu", rank=r), 2, cfg, pinned)
            for r in range(2))
    assert torch.equal(a.noise, b.noise)
    vcfg = configs.get_vit_config("vit_base_patch16", depth=3, drop_path_rate=0.5)
    f = sample_finetune_draws(torch.Generator().manual_seed(0), 4, vcfg, 32, rot90=True)
    half = f.shard(1, 2)
    assert torch.equal(half.drop_masks, f.drop_masks[:, 1::2])
    assert torch.equal(half.crop_boxes, f.crop_boxes[1::2])


# ---------------------------------------------------------------- the loader


@pytest.mark.parametrize("is_train,n", [(True, 29), (False, 29), (False, 6)])
def test_loader_shards_partition_the_epoch_as_the_jax_loader(is_train, n):
    """make_loader's shards at 2 and 3 ranks: each rank's batches equal to
    the JAX DataLoader(shard_id, num_shards)'s, together the epoch's
    (drop_last's truncated) order once; for eval, padded_epoch runs every
    shard to the largest shard's batch count with batches of no sample."""
    import argparse

    from cross_scale_mae_tpu.data.datasets import SyntheticDataset as JSynthetic
    from cross_scale_mae_tpu.data.loader import DataLoader as JLoader
    from cross_scale_mae_torch.cli.common import make_loader
    from cross_scale_mae_torch.data.datasets import build_dataset
    from cross_scale_mae_torch.parallel.dist import Runtime

    args = argparse.Namespace(num_workers=2)
    pd = build_dataset("synthetic", is_train, input_size=8, synthetic_len=n)
    jd = JSynthetic(n, 8, seed=0)
    for world in (2, 3):
        seen = []
        for r in range(world):
            loader = make_loader(args, pd, 2, Runtime(r, world, torch.device("cpu"), True),
                                 is_train=is_train, seed=5)
            ref = JLoader(jd, 2, shuffle=is_train, seed=5, drop_last=is_train,
                          shard_id=r, num_shards=world, use_native=False)
            got = list(loader.epoch(1))
            want = list(ref.epoch(1))
            assert len(got) == len(want)
            for (gi, gl), (ri, rl) in zip(got, want):
                np.testing.assert_array_equal(gi, ri)
                np.testing.assert_array_equal(gl, rl)
            seen += [int(i) for i in loader._epoch_indices(1)]
            padded = list(loader.padded_epoch(1))
            assert len(padded) == loader.max_shard_steps() == ref.max_shard_steps()
            assert all(len(lb) == 0 and im.shape == (0, 8, 8, 3)
                       for im, lb in padded[len(got):])
        order = (np.random.default_rng(5 * 100_003 + 1).permutation(n) if is_train
                 else np.arange(n))
        if is_train:
            order = order[:n // (2 * world) * 2 * world]
        assert sorted(seen) == sorted(order.tolist())


# ---------------------------------------------------------------- the CLIs


PRETRAIN = ["--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
            "--batch_size", "8", "--synthetic_len", "16", "--epochs", "2",
            "--warmup_epochs", "1", "--max_steps", "3", "--log_interval", "1",
            "--compute_dtype", "float32"]


def test_pretrain_cli_trains_across_two_gloo_processes(tmp_path):
    """gspmd and --reference_semantics (shard_map) at 2 ranks, each rank
    with its own --output_dir: rank 0 alone writes params.npz; the gspmd
    run equals one process on the same global batch."""
    from cross_scale_mae_torch.cli.pretrain import get_args_parser, main
    from cross_scale_mae_torch.utils.checkpoint import load_flat_npz

    dirs = {name: [str(tmp_path / name / f"r{r}") for r in range(2)]
            for name in ("gspmd", "shard_map")}
    outs = run_jobs(_two_ranks("pretrain", PRETRAIN, dirs["gspmd"])
                    + _two_ranks("pretrain", [*PRETRAIN, "--reference_semantics"],
                                 dirs["shard_map"]))
    single = main(get_args_parser().parse_args(
        [*PRETRAIN, "--device", "cpu", "--output_dir", str(tmp_path / "one")]))
    results = [_result(o) for o in outs]
    for name, (r0, r1), (o0, o1) in (("gspmd", results[:2], outs[:2]),
                                     ("shard_map", results[2:], outs[2:])):
        assert (r0["rank"], r1["rank"], r0["world_size"]) == (0, 1, 2)
        assert r0["steps"] == r1["steps"] == 3 and r0["losses"] == r1["losses"]
        assert os.path.exists(os.path.join(dirs[name][0], "params.npz"))
        assert not os.path.exists(dirs[name][1])
        assert f"ddp_mode {name}" in o0 and "params written" not in o1
    np.testing.assert_allclose(results[0]["losses"], single["losses"], rtol=1e-5)
    ref = dict(_leaves(load_flat_npz(single["npz"])))
    for k, v in _leaves(load_flat_npz(os.path.join(dirs["gspmd"][0], "params.npz"))):
        np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-4, err_msg=k)


def test_pretrain_cli_accumulates_across_two_processes(tmp_path):
    """accum_iter 2 at 2 ranks: microbatch k is each rank's k-th local
    microbatch, whose union (rows rank::2 of each global batch) is the
    one-process run's microbatch k, so the losses and params match it."""
    from cross_scale_mae_torch.cli.pretrain import get_args_parser, main
    from cross_scale_mae_torch.utils.checkpoint import load_flat_npz

    argv = [*PRETRAIN, "--accum_iter", "2", "--synthetic_len", "32"]
    outs = run_jobs(_two_ranks("pretrain", argv, [str(tmp_path / f"r{r}") for r in range(2)]))
    single = main(get_args_parser().parse_args(
        [*argv, "--device", "cpu", "--output_dir", str(tmp_path / "one")]))
    got = _result(outs[0])
    assert got["steps"] == single["steps"] == 3
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-5)
    ref = dict(_leaves(load_flat_npz(single["npz"])))
    for k, v in _leaves(load_flat_npz(os.path.join(tmp_path, "r0", "params.npz"))):
        np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-4, err_msg=k)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_reference_semantics_sets_exact_gelu_batch_crop_and_shard_map():
    from cross_scale_mae_torch.cli.pretrain import check_args, get_args_parser

    args = get_args_parser().parse_args(["--reference_semantics"])
    check_args(args)
    assert (args.gelu, args.batch_crop, args.ddp_mode) == ("exact", True, "shard_map")
    args = get_args_parser().parse_args([])
    check_args(args)
    assert (args.gelu, args.batch_crop, args.ddp_mode) == ("tanh", False, "gspmd")


CLASSIFIER = ["--model", "vit_base_patch16", "--embed_dim", "64", "--depth", "2",
              "--num_heads", "4", "--input_size", "16", "--patch_size", "8",
              "--batch_size", "8", "--dataset_type", "synthetic", "--synthetic_len", "260",
              "--nb_classes", "3",
              "--epochs", "1", "--warmup_epochs", "0", "--max_steps", "4",
              "--log_interval", "1", "--compute_dtype", "float32"]


@pytest.mark.parametrize("cli", ["finetune", "linprobe"])
def test_classifier_fit_at_two_ranks_matches_one(tmp_path, cli):
    """4 steps and the eval at 2 ranks and at 1. The eval set has 65
    images: in batches of 4 per rank, rank 0's shard runs 9 batches and
    rank 1's 8 and one of no sample, so neither waits on the other (the
    finetune's synthetic set on the device, the probe's through the
    loader's padded_epoch). Every rank reports the one-process run's
    global accuracy, confusion matrix and count."""
    import importlib

    mod = importlib.import_module(f"cross_scale_mae_torch.cli.{cli}")
    extra = ["--attention_impl", "pallas"] if cli == "finetune" else []
    outs = run_jobs(_two_ranks(cli, [*CLASSIFIER, *extra, "--output_dir",
                                     str(tmp_path / "two")]))
    single = mod.main(mod.get_args_parser().parse_args(
        [*CLASSIFIER, *extra, "--device", "cpu", "--output_dir", str(tmp_path / "one")]))
    r0, r1 = (_result(o) for o in outs)
    assert r0["steps"] == r1["steps"] == single["steps"] == 4
    np.testing.assert_allclose(r0["losses"], single["losses"], rtol=1e-5)
    assert r0["eval"] == r1["eval"]
    assert r0["eval"]["n"] == single["eval"]["n"] == 65
    assert r0["eval"]["acc1"] == single["eval"]["acc1"]
    assert r0["eval"]["cm"] == single["eval"]["cm"].tolist()
    np.testing.assert_allclose(r0["eval"]["loss"], single["eval"]["loss"], rtol=1e-5)
    if cli == "linprobe":
        assert r0["output_dir"] == r1["output_dir"]
        assert len(os.listdir(tmp_path / "two")) == 1


# ---------------------------------------------------------------- the flags


def _flags(parser) -> set[str]:
    return {s for a in parser._actions for s in a.option_strings if s.startswith("--")}


# Every flag of the JAX pretrain parser, by what the port does with it.
# Run: (argv, check of the built run). Refused: argv that must raise
# SystemExit naming ROADMAP.md. Not applicable: accepted and reported, as
# the JAX package reports the reference's own dead flags.
_RUN = {
    "--model": (["--model", "mae_vit_tiny_MsLd"], lambda r: not r.cfg.use_cd_pred),
    "--input_size": ([], lambda r: r.cfg.input_size == 32),
    "--patch_size": ([], lambda r: r.cfg.patch_size == 8),
    "--mask_ratio": (["--mask_ratio", "0.5"], lambda r: r.cfg.mask_ratio == 0.5),
    "--loss": (["--loss", "l1"], lambda r: r.cfg.loss == "l1"),
    "--norm_pix_loss": (["--norm_pix_loss"], lambda r: r.cfg.norm_pix_loss),
    "--loss_e": (["--loss_e", "l1"], lambda r: r.cfg.loss_name("e") == "l1"),
    "--loss_ce": (["--loss_ce", "l1"], lambda r: r.cfg.loss_name("ce") == "l1"),
    "--loss_cd": (["--loss_cd", "l1"], lambda r: r.cfg.loss_name("cd") == "l1"),
    "--ms_range": (["--ms_range", "0.3", "0.6"], lambda r: r.cfg.ms_range == (0.3, 0.6)),
    "--ms_decoder_loss_reduction": (["--ms_decoder_loss_reduction", "mean"],
                                    lambda r: r.cfg.ms_decoder_loss_reduction == "mean"),
    "--batch_crop": (["--batch_crop"], lambda r: not r.cfg.ms_per_sample_crop),
    "--consistent_mask": (["--consistent_mask"], lambda r: r.tcfg.consistent_mask),
    "--mask_seed": (["--mask_seed", "3"], lambda r: r.tcfg.mask_seed == 3),
    "--apply_encoder_norm": (["--apply_encoder_norm"], lambda r: r.cfg.apply_encoder_norm),
    "--epochs": (["--epochs", "3"], lambda r: r.tcfg.epochs == 3),
    "--warmup_epochs": (["--warmup_epochs", "2"], lambda r: r.tcfg.warmup_epochs == 2),
    "--batch_size": ([], lambda r: r.tcfg.batch_size == 4),
    "--accum_iter": (["--accum_iter", "2"], lambda r: r.tcfg.accum_iter == 2),
    "--blr": (["--blr", "1e-4"], lambda r: r.tcfg.blr == 1e-4),
    "--lr": (["--lr", "1e-3"], lambda r: r.tcfg.lr == 1e-3),
    "--min_lr": (["--min_lr", "1e-6"], lambda r: r.tcfg.min_lr == 1e-6),
    "--weight_decay": (["--weight_decay", "0.1"], lambda r: r.tcfg.weight_decay == 0.1),
    "--clip_grad": (["--clip_grad", "1.0"], lambda r: r.tcfg.clip_grad == 1.0),
    "--adam_mu_dtype": (["--adam_mu_dtype", "bfloat16"],
                        lambda r: r.state.opt_state.mu[0].dtype == torch.bfloat16),
    "--adam_nu_dtype": (["--adam_nu_dtype", "bfloat16"],
                        lambda r: r.state.opt_state.nu[0].dtype == torch.bfloat16
                        and r.state.tx.upcast_first),
    "--max_steps": (["--max_steps", "1"], lambda r: True),
    "--unroll_blocks": (["--unroll_blocks"], lambda r: not r.cfg.scan_blocks),
    "--remat": (["--remat"], lambda r: r.cfg.remat),
    "--watch_gradients": (["--watch_gradients"], lambda r: r.tcfg.watch_gradients),
    "--ddp_mode": (["--ddp_mode", "shard_map"], lambda r: r.ddp_mode is None),
    "--reference_semantics": (["--reference_semantics"],
                              lambda r: r.cfg.gelu == "exact" and not r.cfg.ms_per_sample_crop),
    "--dataset_type": (["--dataset_type", "synthetic"], lambda r: r.images is not None),
    "--train_path": ([], lambda r: True),
    "--test_path": ([], lambda r: True),
    "--masked_bands": ([], lambda r: True),
    "--dropped_bands": ([], lambda r: True),
    "--synthetic_len": ([], lambda r: len(r.images) == 8),
    "--canvas_scale": ([], lambda r: True),
    "--seed": (["--seed", "4"], lambda r: r.tcfg.seed == 4),
    "--output_dir": ([], lambda r: True),
    "--num_workers": (["--num_workers", "2"], lambda r: True),
    "--log_interval": (["--log_interval", "3"], lambda r: r.tcfg.log_interval == 3),
    "--attention_impl": (["--attention_impl", "xla"], lambda r: r.cfg.attention_impl == "xla"),
    "--attention": (["--attention", "scaled_dot_product"], lambda r: True),
    "--attn_name": (["--attn_name", "scaled_dot_product"], lambda r: True),
    "--ffn_name": (["--ffn_name", "MLP"], lambda r: True),
    "--gelu": (["--gelu", "exact"], lambda r: r.cfg.gelu == "exact"),
    "--compute_dtype": (["--compute_dtype", "float32"],
                        lambda r: r.cfg.compute_dtype == "float32"),
    "--output_dir_base": (["--output_dir_base", "base"], lambda r: True),
    "--start_epoch": (["--start_epoch", "1"], lambda r: r.start_epoch == 1),
    # A directory with no checkpoint starts fresh (JAX cli/pretrain.py:283).
    "--resume": (["--resume", "no_checkpoints_here"], lambda r: r.start_epoch == 0),
    "--ckpt_interval": (["--ckpt_interval", "5"], lambda r: True),
    "--device": (["--device", "cpu"], lambda r: r.device == torch.device("cpu")),
    "--coordinator_address": ([], lambda r: not r.rt.distributed),
    "--num_processes": ([], lambda r: r.rt.world_size == 1),
    "--process_id": ([], lambda r: r.rt.rank == 0),
}
_REFUSED = {
    "--model_parallel": ["--model_parallel", "2"], "--sequence_parallel": ["--sequence_parallel"],
    "--fsdp": ["--fsdp"], "--zero1": ["--zero1"], "--num_slices": ["--num_slices", "2"],
    "--use_perceptual_loss": ["--use_perceptual_loss"], "--vgg_weights": ["--vgg_weights", "v"],
    "--plot_recon": ["--plot_recon"], "--val_img_path": ["--val_img_path", "x.png"],
    "--use_tensorboard": ["--use_tensorboard"], "--use_wandb": ["--use_wandb"],
    "--wandb_project": ["--wandb_project", "p"], "--wandb_entity": ["--wandb_entity", "e"],
    "--wandb_id": ["--wandb_id", "i"], "--profile_dir": ["--profile_dir", "p"],
    "--jax_platforms": ["--jax_platforms", "cpu"],
}
_NOT_APPLICABLE = {
    "--log_dir": ["--log_dir", "logs"], "--device_batch_dtype": ["--device_batch_dtype", "f32"],
    "--pin_mem": ["--pin_mem"], "--no_pin_mem": ["--no_pin_mem"],
    "--world_size": ["--world_size", "2"], "--local_rank": ["--local_rank", "0"],
    "--dist_url": ["--dist_url", "env://"], "--dist_on_itp": ["--dist_on_itp"],
    "--use_xformers": ["--use_xformers"], "--print_level": ["--print_level", "1"],
    "--spatial_mask": ["--spatial_mask"],
}


def _tiny_run(tmp_path, *extra):
    from cross_scale_mae_torch.cli.pretrain import build_run, get_args_parser

    return build_run(get_args_parser().parse_args([
        "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
        "--batch_size", "4", "--synthetic_len", "8", "--device", "cpu",
        "--output_dir", str(tmp_path), *extra]))


def test_every_jax_pretrain_flag_is_run_or_refused_with_a_roadmap_item(tmp_path, capsys):
    """The JAX pretrain parser's flags, each parsed by the port and either
    run (it reaches the run's config, or its check holds), refused with a
    pointer to ROADMAP.md, or reported as not applicable as the JAX package
    reports the reference's dead flags; a new JAX flag fails this test
    until it is sorted here."""
    from cross_scale_mae_tpu.cli.pretrain import get_args_parser as jparser
    from cross_scale_mae_torch.cli.pretrain import get_args_parser

    jax_flags = _flags(jparser())
    assert jax_flags == set(_RUN) | set(_REFUSED) | set(_NOT_APPLICABLE)
    assert not set(_RUN) & set(_REFUSED) and not set(_NOT_APPLICABLE) & (
        set(_RUN) | set(_REFUSED))
    assert jax_flags <= _flags(get_args_parser())
    for flag, (argv, ok) in _RUN.items():
        assert ok(_tiny_run(tmp_path, *argv)), flag
    for flag, argv in _REFUSED.items():
        with pytest.raises(SystemExit, match="ROADMAP"):
            _tiny_run(tmp_path, *argv)
    capsys.readouterr()
    for flag, argv in _NOT_APPLICABLE.items():
        _tiny_run(tmp_path, *argv)
        assert f"not applicable here: {flag}" in capsys.readouterr().out, flag


# The classifier CLIs' flags, by what the port does with each, as for
# pretraining above. A check reads the FinetuneRun that build_run returns.
_CLASSIFIER_RUN = {
    "--model": (["--model", "vit_large_patch16"], lambda r: r.cfg.embed_dim == 32),
    "--input_size": ([], lambda r: r.cfg.input_size == 16),
    "--patch_size": ([], lambda r: r.cfg.patch_size == 8),
    "--global_pool": (["--global_pool"], lambda r: r.cfg.global_pool),
    "--cls_token": (["--cls_token"], lambda r: not r.cfg.global_pool),
    "--finetune": ([], lambda r: True),
    "--eval": (["--eval"], lambda r: True),
    "--embed_dim": ([], lambda r: r.cfg.embed_dim == 32),
    "--depth": ([], lambda r: r.cfg.depth == 2),
    "--num_heads": ([], lambda r: r.cfg.num_heads == 4),
    "--epochs": (["--epochs", "3"], lambda r: r.tcfg.epochs == 3),
    "--warmup_epochs": (["--warmup_epochs", "2"], lambda r: r.tcfg.warmup_epochs == 2),
    "--batch_size": ([], lambda r: r.tcfg.batch_size == 4),
    "--accum_iter": (["--accum_iter", "2"], lambda r: r.tcfg.accum_iter == 2),
    "--blr": (["--blr", "1e-4"], lambda r: r.tcfg.blr == 1e-4),
    "--lr": (["--lr", "1e-3"], lambda r: r.tcfg.lr == 1e-3),
    "--min_lr": (["--min_lr", "1e-7"], lambda r: r.tcfg.min_lr == 1e-7),
    "--ckpt_interval": (["--ckpt_interval", "5"], lambda r: True),
    "--save_every": (["--save_every", "5"], lambda r: True),
    "--eval_interval": (["--eval_interval", "2"], lambda r: True),
    "--max_steps": (["--max_steps", "1"], lambda r: True),
    "--unroll_blocks": (["--unroll_blocks"], lambda r: not r.cfg.scan_blocks),
    "--dataset_type": (["--dataset_type", "synthetic"], lambda r: True),
    "--train_path": ([], lambda r: True),
    "--test_path": ([], lambda r: True),
    "--masked_bands": ([], lambda r: True),
    "--dropped_bands": ([], lambda r: True),
    "--synthetic_len": ([], lambda r: True),
    "--canvas_scale": ([], lambda r: True),
    "--nb_classes": ([], lambda r: r.cfg.num_classes == 3),
    "--seed": (["--seed", "4"], lambda r: r.tcfg.seed == 4),
    "--output_dir": ([], lambda r: True),
    "--num_workers": (["--num_workers", "2"], lambda r: True),
    "--log_interval": (["--log_interval", "3"], lambda r: r.tcfg.log_interval == 3),
    "--attention_impl": (["--attention_impl", "xla"], lambda r: r.cfg.attention_impl == "xla"),
    "--attention": (["--attention", "scaled_dot_product"], lambda r: True),
    "--gelu": (["--gelu", "exact"], lambda r: r.cfg.gelu == "exact"),
    "--compute_dtype": (["--compute_dtype", "bfloat16"],
                        lambda r: r.cfg.compute_dtype == "bfloat16"),
    "--remat": (["--remat"], lambda r: r.cfg.remat),
    "--device": (["--device", "cpu"], lambda r: r.device == torch.device("cpu")),
    "--coordinator_address": ([], lambda r: not r.rt.distributed),
    "--num_processes": ([], lambda r: r.rt.world_size == 1),
    "--process_id": ([], lambda r: r.rt.rank == 0),
    "--output_dir_base": (["--output_dir_base", "base"], lambda r: True),
    "--start_epoch": (["--start_epoch", "1"], lambda r: r.start_epoch == 1),
    "--resume": (["--resume", "{ckpt}"], lambda r: r.start_epoch == 3 and r.max_acc == 7.0),
}
_CLASSIFIER_ROLE_RUN = {
    "finetune": {
        "--cls_token_pool": (["--cls_token_pool"], lambda r: not r.cfg.global_pool),
        "--drop_path": (["--drop_path", "0.2"], lambda r: r.cfg.drop_path_rate == 0.2),
        "--weight_decay": (["--weight_decay", "0.1"],
                           lambda r: r.tcfg.weight_decay == 0.1 and r.state.tx.wd == 0.1),
        "--layer_decay": (["--layer_decay", "0.5"],
                          lambda r: r.tcfg.layer_decay == 0.5 and 0.125 in r.state.tx.scales),
        "--clip_grad": (["--clip_grad", "1.0"], lambda r: r.state.tx.clip_grad == 1.0),
        "--adam_mu_dtype": (["--adam_mu_dtype", "bfloat16"],
                            lambda r: r.state.opt_state.mu[0].dtype == torch.bfloat16
                            and not r.state.tx.upcast_first),
        "--adam_nu_dtype": (["--adam_nu_dtype", "bfloat16"],
                            lambda r: r.state.opt_state.nu[0].dtype == torch.bfloat16),
        "--smoothing": (["--smoothing", "0.2"], lambda r: r.tcfg.label_smoothing == 0.2),
        "--mixup": (["--mixup", "0.8"], lambda r: r.mixup.mixup_alpha == 0.8),
        "--cutmix": (["--cutmix", "1.0"], lambda r: r.mixup.cutmix_alpha == 1.0),
        "--mixup_prob": (["--mixup", "0.8", "--mixup_prob", "0.5"],
                         lambda r: r.mixup.prob == 0.5),
        "--mixup_switch_prob": (["--mixup", "0.8", "--mixup_switch_prob", "0.3"],
                                lambda r: r.mixup.switch_prob == 0.3),
        "--cutmix_minmax": (["--cutmix_minmax", "0.2", "0.8"],
                            lambda r: r.mixup.cutmix_minmax == (0.2, 0.8)
                            and r.mixup.cutmix_alpha == 1.0),
        "--mixup_mode": (["--mixup", "0.8", "--mixup_mode", "pair"],
                         lambda r: r.mixup.mode == "pair"),
        "--color_jitter": (["--color_jitter", "0.4"], lambda r: r.extras.jitter == 0.4),
        "--aa": (["--aa", "rand-m9-mstd0.5-inc1"],
                 lambda r: r.extras.aa.magnitude == 9.0 and r.extras.jitter is None),
        "--reprob": (["--reprob", "0.25"], lambda r: r.extras.reprob == 0.25),
        "--remode": (["--reprob", "0.25", "--remode", "const"],
                     lambda r: r.extras.remode == "const"),
        "--recount": (["--reprob", "0.25", "--recount", "2"], lambda r: r.extras.recount == 2),
    },
    "linprobe": {
        # Accepted; the probe runs LARS with weight decay 0, as the JAX CLI.
        "--weight_decay": (["--weight_decay", "0.1"], lambda r: r.state.tx.wd == 0.0),
        "--loss": (["--loss", "classification_cross"], lambda r: True),
    },
}
_CLASSIFIER_REFUSED = {
    "--model_parallel": ["--model_parallel", "2"], "--sequence_parallel": ["--sequence_parallel"],
    "--fsdp": ["--fsdp"], "--num_slices": ["--num_slices", "2"],
    "--use_tensorboard": ["--use_tensorboard"], "--use_wandb": ["--use_wandb"],
    "--wandb_project": ["--wandb_project", "p"], "--wandb_entity": ["--wandb_entity", "e"],
    "--wandb_id": ["--wandb_id", "i"], "--profile_dir": ["--profile_dir", "p"],
    "--jax_platforms": ["--jax_platforms", "cpu"],
}
_CLASSIFIER_NOT_APPLICABLE = {
    "--log_dir": ["--log_dir", "logs"], "--device_batch_dtype": ["--device_batch_dtype", "f32"],
    "--pin_mem": ["--pin_mem"], "--no_pin_mem": ["--no_pin_mem"],
    "--world_size": ["--world_size", "2"], "--local_rank": ["--local_rank", "0"],
    "--dist_url": ["--dist_url", "env://"], "--dist_on_itp": ["--dist_on_itp"],
    "--model_type": ["--model_type", "vit"],
    "--transform_checkpoint_keys": ["--transform_checkpoint_keys"],
    "--dist_eval": ["--dist_eval"], "--use_psa": ["--use_psa"],
}
_CLASSIFIER_ROLE_NOT_APPLICABLE = {
    "finetune": {"--resplit": ["--resplit"]},
    "linprobe": {"--use_xformers": ["--use_xformers"], "--print_level": ["--print_level", "1"],
                 "--spatial_mask": ["--spatial_mask"], "--norm_pix_loss": ["--norm_pix_loss"]},
}


@pytest.mark.parametrize("cli", ["finetune", "linprobe"])
def test_every_jax_classifier_flag_is_run_refused_or_not_applicable(tmp_path, capsys, cli):
    """The JAX finetune and linprobe parsers' flags, each parsed by the
    port's CLI and either run (its check on the built run holds), refused
    naming a ROADMAP.md item, or reported as not applicable as the JAX
    package reports the reference's dead flags; a new JAX flag fails this
    test until it is sorted here."""
    import importlib

    from cross_scale_mae_torch.utils.checkpoint import save_checkpoint

    jmod = importlib.import_module(f"cross_scale_mae_tpu.cli.{cli}")
    pmod = importlib.import_module(f"cross_scale_mae_torch.cli.{cli}")
    run_table = {**_CLASSIFIER_RUN, **_CLASSIFIER_ROLE_RUN[cli]}
    na = {**_CLASSIFIER_NOT_APPLICABLE, **_CLASSIFIER_ROLE_NOT_APPLICABLE[cli]}
    jax_flags = _flags(jmod.get_args_parser())
    assert jax_flags == set(run_table) | set(_CLASSIFIER_REFUSED) | set(na)
    assert not set(run_table) & set(_CLASSIFIER_REFUSED) and not set(na) & (
        set(run_table) | set(_CLASSIFIER_REFUSED))
    assert jax_flags <= _flags(pmod.get_args_parser())

    def build(*extra):
        return pmod.build_run(pmod.get_args_parser().parse_args([
            "--model", "vit_base_patch16", "--embed_dim", "32", "--depth", "2",
            "--num_heads", "4", "--input_size", "16", "--patch_size", "8",
            "--batch_size", "4", "--dataset_type", "synthetic", "--synthetic_len", "8",
            "--nb_classes", "3", "--device", "cpu", "--output_dir", str(tmp_path), *extra]))

    ckpt = str(tmp_path / "ckpt")
    first = build()
    save_checkpoint(ckpt, 0, first.state, first.cfg.to_json(), {"epoch": 2, "max_acc": 7.0})
    for flag, (argv, ok) in run_table.items():
        assert ok(build(*(a.replace("{ckpt}", ckpt) for a in argv))), flag
    for flag, argv in _CLASSIFIER_REFUSED.items():
        with pytest.raises(SystemExit, match="ROADMAP"):
            build(*argv)
    capsys.readouterr()
    for flag, argv in na.items():
        build(*argv)
        assert f"not applicable here: {flag}" in capsys.readouterr().out, flag
