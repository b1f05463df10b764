"""The port's data-parallel pretrain step held against the JAX package's
two DDP semantics on the CPU, over gloo.

Each port rank is a subprocess that imports only torch and the port
(``_STEP_DRIVER``): it joins a gloo group through ``parallel/dist.py``,
loads the weights, the global batch and the injected JAX draws from npz
files, runs the step, and writes its params, BatchNorm state, losses and
gradient norms. The pytest process runs the JAX step on a 2-device mesh of
the conftest's 8 CPU devices and compares.

* gspmd: JAX ``make_pretrain_step`` on the batch sharded over 2 devices
  (its jit's global view), the draws of the global batch; each port rank
  takes rows rank::2 of the batch and of the draws
  (``PretrainDraws.shard``).
* shard_map: JAX ``make_pretrain_step_shard_map`` on 2 devices, shard r's
  draws from ``fold_in(step key, r)``; port rank r takes shard r's
  contiguous rows and its draws.

With ``accum_iter`` 2 (two microbatches of 4 rows a step) the JAX step
splits the global batch into rows [4k, 4k + 4) and draws microbatch k
from ``split(step key, 2)[k]`` (``_accum_value_and_grads``); port rank r
takes rows r::2 of the global batch, whose k-th local microbatch is rows
r::2 of that global microbatch, and the same rows of its draws. Under
shard_map each device splits its own 4 rows in two, with the keys split
from its folded key. These are the only microbatch semantics under which
a run resumed at another world size (``cli/launch.py --elastic``) equals
an unbroken one.

Tolerances: those of ``test_pretrain_step_10_step_lockstep_with_jax``
(losses rtol 3e-4, gradient norms rtol 1e-3, params atol 5e-4, BatchNorm
state atol 1e-5), over 3 steps. Two controls must miss them: the NT-Xent
gather's backward that only slices (no sum over the ranks), and the
predictor's BatchNorm on each rank's own statistics under gspmd. The
2-rank port against the 1-rank port on the same global batch and draws:
the same arithmetic but for the order of fp32 sums (the gradient average,
the statistics' all-reduce), held to losses rtol 1e-6, gradient norms rtol
1e-5, BatchNorm state atol 1e-6 and params atol 1e-4: AdamW's first steps
move each weight by about lr times the sign of its gradient, so a gradient
near zero turns an fp32 difference of its sums into up to 2.3e-5 of one
weight here (lr 1e-3), five times under the JAX comparison's 5e-4.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_torch.utils.checkpoint import load_flat_npz, save_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(input_size=32, patch_size=8, dim_model=64, encoder_num_layers=2,
            encoder_num_heads=4, decoder_embed_dim=32, decoder_num_layers=1,
            decoder_num_heads=4, predictor_hidden_size=32, compute_dtype="float32",
            attention_impl="pallas_v3")
N, STEPS, WORLD = 8, 3, 2
ACCUMS = (1, 2)
SCHED = (1e-3, 0.0, 1, 2, 5)
DRAW_KEYS = ("hflip", "vflip", "boxes", "ms_boxes", "noise")
TIMEOUT_S = 240

_STEP_DRIVER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from cross_scale_mae_torch import configs
from cross_scale_mae_torch.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
from cross_scale_mae_torch.models import layers
from cross_scale_mae_torch.ops.augment import make_pretrain_augment
from cross_scale_mae_torch.parallel import collectives, dist
from cross_scale_mae_torch.train.optim import build_optimizer
from cross_scale_mae_torch.train.pretrain import PretrainDraws, make_pretrain_step
from cross_scale_mae_torch.train.schedule import warmup_half_cosine
from cross_scale_mae_torch.train.state import TrainState
from cross_scale_mae_torch.utils.checkpoint import load_flat_npz, save_params_npz
from cross_scale_mae_torch.utils.params import params_from_jax, params_to_jax, state_from_jax

mode, control, src, out, address = sys.argv[1:6]
rank, world, accum = int(sys.argv[6]), int(sys.argv[7]), int(sys.argv[8])
if mode != "none":
    dist.initialize_distributed(address, world, rank, "cpu")
if control == "slice_only_gather":
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]
    collectives._AllGatherRows.backward = staticmethod(backward)
elif control == "local_bn":
    apply = layers.predictor_apply
    layers.predictor_apply = lambda *a, global_stats=False, **k: apply(*a, **k)
meta = json.load(open(src + "/meta.json"))
cfg = configs.MAEConfig.from_json(meta["cfg"])
tcfg = configs.TrainConfig.from_json(meta["tcfg"]).replace(accum_iter=accum)
tree = load_flat_npz(src + "/weights.npz")
draws = np.load(src + "/draws_" + ("global" if mode != "shard_map" else "shards")
                + f"_accum{accum}.npz")
params = params_from_jax(tree["params"], cfg, full=True)
sched = warmup_half_cosine(*meta["sched"])
state = TrainState.create(params, state_from_jax(tree["state"], cfg),
                          build_optimizer(params, sched, weight_decay=tcfg.weight_decay))
step = make_pretrain_step(cfg, tcfg, sched, augment=make_pretrain_augment(
    FMOW_RGB_MEAN, FMOW_RGB_STD, cfg.input_size, dtype="float32"),
    ddp_mode=None if mode == "none" else mode)
batch = torch.from_numpy(draws["batch"])
keys = ("hflip", "vflip", "boxes", "ms_boxes", "noise")
losses, norms = [], []
for s in range(draws["hflip"].shape[0]):
    # One set of draws per microbatch: the draw arrays' last leading axis.
    if mode == "shard_map":
        n = batch.shape[0] // world
        imgs = batch[rank * n:(rank + 1) * n]
        d = [PretrainDraws(*(torch.from_numpy(draws[k][s, rank, a]) for k in keys))
             for a in range(accum)]
    else:
        imgs = batch[rank::world]
        d = [PretrainDraws(*(torch.from_numpy(draws[k][s, a]) for k in keys)).shard(rank, world)
             for a in range(accum)]
    state, m = step(state, imgs, d)
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
save_params_npz(out + f"/rank{rank}.npz", {
    "params": params_to_jax(state.params), "state": params_to_jax(state.model_state),
    "losses": np.array(losses), "grad_norms": np.array(norms)})
dist.shutdown()
"""


def _free_port() -> str:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return str(sock.getsockname()[1])


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_ranks(jobs: list[tuple[str, list[str]]]) -> list[str]:
    """Start every (code, argv) job at once, wait for each with a time
    limit, and return their outputs; any failure or timeout fails the test
    with the job's output."""
    procs = [subprocess.Popen([sys.executable, "-c", code, *argv], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for code, argv in jobs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (_, argv), p, out in zip(jobs, procs, outs):
        assert p.returncode == 0, f"{argv} failed:\n{out[-4000:]}"
    return outs


def _t(a):
    return np.asarray(a, np.float32)


def _augment_draws(key, n):
    """The flips and crop boxes the JAX pretrain augment draws from ``key``
    (ops/augment.py:44, ops/image.py:47-53, 165-178)."""
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes

    k_flip, _, k_crop = jax.random.split(key, 3)
    kh, kv = jax.random.split(k_flip)
    return (np.array(jax.random.bernoulli(kh, 0.5, (n,))),
            np.array(jax.random.bernoulli(kv, 0.5, (n,))),
            _t(sample_crop_boxes(k_crop, n, 32, 32, (0.25, 1.0))))


def _loss_draws(key, n, cfg):
    """The MsLd crop boxes and mask noise JAX ``mae_loss_fn`` draws from
    ``key`` (models/mae.py:288-316)."""
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes

    k_crop, k1, k2 = jax.random.split(key, 3)
    boxes = sample_crop_boxes(k_crop, n, cfg.input_size, cfg.input_size, cfg.ms_range,
                              cfg.ms_aspect_ratio)
    return _t(boxes), _t(jnp.concatenate([jax.random.uniform(k, (n, cfg.num_patches))
                                          for k in (k1, k2)]))


def _draws(key, n, cfg):
    k_aug, k_loss = jax.random.split(key)
    return (*_augment_draws(k_aug, n), *_loss_draws(k_loss, n, cfg))


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """Weights, batch and draws on disk; the JAX gspmd and shard_map runs on
    a 2-device mesh; and every port run (2-rank gspmd, its two controls,
    2-rank shard_map, 1 process), all at once."""
    from cross_scale_mae_tpu.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_tpu.models import mae_init
    from cross_scale_mae_tpu.ops.augment import make_pretrain_augment
    from cross_scale_mae_tpu.train import TrainState, build_optimizer, warmup_half_cosine
    from cross_scale_mae_tpu.train.pretrain import (
        make_pretrain_step,
        make_pretrain_step_shard_map,
    )

    src = tmp_path_factory.mktemp("src")
    cfg = jcfg.get_mae_config("mae_vit_tiny_MsLdCeCd", **TINY)
    tcfg = jcfg.TrainConfig(batch_size=N, weight_decay=0.05)
    params, mstate = mae_init(jax.random.key(0), cfg)
    tree = jax.tree.map(_t, {"params": params, "state": mstate})
    save_params_npz(str(src / "weights.npz"), tree)
    (src / "meta.json").write_text(json.dumps(
        {"cfg": cfg.to_json(), "tcfg": tcfg.to_json(), "sched": list(SCHED)}))
    batch = np.random.default_rng(0).integers(0, 256, (N, 32, 32, 3), np.uint8)
    rng = jax.random.key(1)

    def micro_draws(key, n, accum):
        """The draws of each of ``accum`` microbatches of n // accum rows
        (``_accum_value_and_grads``: one split key each; the key itself at 1)."""
        keys = [key] if accum == 1 else list(jax.random.split(key, accum))
        return [_draws(k, n // accum, cfg) for k in keys]

    for accum in ACCUMS:
        glob = [micro_draws(jax.random.fold_in(rng, s), N, accum) for s in range(STEPS)]
        shards = [[micro_draws(jax.random.fold_in(jax.random.fold_in(rng, s), r), N // WORLD,
                               accum) for r in range(WORLD)] for s in range(STEPS)]
        np.savez(src / f"draws_global_accum{accum}.npz", batch=batch,
                 **{k: np.stack([np.stack([m[i] for m in step]) for step in glob])
                    for i, k in enumerate(DRAW_KEYS)})
        np.savez(src / f"draws_shards_accum{accum}.npz", batch=batch,
                 **{k: np.stack([np.stack([np.stack([m[i] for m in shard]) for shard in step])
                                 for step in shards]) for i, k in enumerate(DRAW_KEYS)})

    jobs, outs = [], {}
    for name, mode, control, world, accum in (
            ("gspmd", "gspmd", "", WORLD, 1),
            ("slice_only_gather", "gspmd", "slice_only_gather", WORLD, 1),
            ("local_bn", "gspmd", "local_bn", WORLD, 1), ("shard_map", "shard_map", "", WORLD, 1),
            ("one_process", "none", "", 1, 1), ("gspmd_accum2", "gspmd", "", WORLD, 2),
            ("shard_map_accum2", "shard_map", "", WORLD, 2)):
        out = tmp_path_factory.mktemp(name)
        outs[name] = (out, world)
        address = "127.0.0.1:" + _free_port()
        jobs += [(_STEP_DRIVER, [mode, control, str(src), str(out), address, str(r),
                                 str(world), str(accum)]) for r in range(world)]
    procs_started = time.perf_counter()
    run_ranks(jobs)
    port_s = time.perf_counter() - procs_started

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    augment = make_pretrain_augment(FMOW_RGB_MEAN, FMOW_RGB_STD, 32, dtype="float32")
    sched = warmup_half_cosine(*SCHED)
    jax_runs = {}
    for mode, accum in (("gspmd", 1), ("shard_map", 1), ("gspmd", 2), ("shard_map", 2)):
        tc = tcfg.replace(accum_iter=accum)
        step = (make_pretrain_step(cfg, tc, sched, donate=False, augment=augment)
                if mode == "gspmd" else
                make_pretrain_step_shard_map(cfg, tc, sched, mesh, donate=False,
                                             augment=augment))
        state = TrainState.create(params, mstate, build_optimizer(params, sched,
                                                                  weight_decay=0.05))
        state = jax.device_put(state, NamedSharding(mesh, P()))
        b = jax.device_put(jnp.asarray(batch), NamedSharding(mesh, P("data")))
        losses, norms = [], []
        for _ in range(STEPS):
            state, m = step(state, b, rng)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        jax_runs[mode if accum == 1 else f"{mode}_accum{accum}"] = {
            "params": jax.tree.map(_t, state.params), "state": jax.tree.map(_t, state.model_state),
            "losses": np.array(losses), "grad_norms": np.array(norms)}
    port = {}
    for name, (out, world) in outs.items():
        ranks = [load_flat_npz(str(out / f"rank{r}.npz")) for r in range(world)]
        port[name] = ranks
    return {"jax": jax_runs, "port": port, "port_s": port_s}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def misses(got: dict, ref: dict, loss_rtol=3e-4, norm_rtol=1e-3, params_atol=5e-4,
           state_atol=1e-5) -> dict:
    """Each reading over its limit (reading / limit > 1 misses): the worst
    relative loss and gradient-norm gaps, and the worst absolute params and
    BatchNorm-state gaps."""
    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - b) / np.abs(b)))

    def worst(a, b):
        ref_leaves = dict(_flat(b))
        return max(float(np.max(np.abs(v - ref_leaves[k]))) for k, v in _flat(a))

    return {"losses": rel(got["losses"], ref["losses"]) / loss_rtol,
            "grad_norms": rel(got["grad_norms"], ref["grad_norms"]) / norm_rtol,
            "params": worst(got["params"], ref["params"]) / params_atol,
            "state": worst(got["state"], ref["state"]) / state_atol}


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
def test_two_rank_step_matches_the_jax_step_on_a_two_device_mesh(lockstep, mode):
    ranks = lockstep["port"][mode]
    for other in ranks[1:]:   # every rank holds the same params and state
        for (k, a), (_, b) in zip(_flat(ranks[0]), _flat(other)):
            np.testing.assert_array_equal(a, b, err_msg=k)
    gaps = misses(ranks[0], lockstep["jax"][mode])
    assert max(gaps.values()) <= 1.0, gaps
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
def test_two_rank_accumulated_step_matches_the_jax_step_on_a_two_device_mesh(lockstep, mode):
    """accum_iter 2 over 2 ranks against the JAX step at accum_iter 2 on a
    2-device mesh: the same microbatch rows, so the same step."""
    name = f"{mode}_accum2"
    ranks = lockstep["port"][name]
    for (k, a), (_, b) in zip(_flat(ranks[0]), _flat(ranks[1])):
        np.testing.assert_array_equal(a, b, err_msg=k)
    gaps = misses(ranks[0], lockstep["jax"][name])
    assert max(gaps.values()) <= 1.0, gaps
    # And not the accum_iter-1 step: the microbatch split is seen.
    assert misses(ranks[0], lockstep["jax"][mode])["losses"] > 1.0


@pytest.mark.parametrize("control,reading", [("slice_only_gather", "grad_norms"),
                                             ("local_bn", "state")])
def test_the_lockstep_sees_a_slice_only_gather_and_local_batchnorm(lockstep, control, reading):
    """Each fault of the gspmd semantics misses the JAX comparison's
    tolerances on the reading it moves first: a gather whose backward only
    slices leaves NT-Xent's gradient 1/2 of the global one, which the
    step's gradient norm shows (41x its limit here); BatchNorm on local
    statistics moves the running state in the first step (1700x its
    limit), and the gradient norm (3x)."""
    gaps = misses(lockstep["port"][control][0], lockstep["jax"]["gspmd"])
    assert gaps[reading] > 1.0 and gaps["grad_norms"] > 1.0, gaps


def test_two_rank_gspmd_step_matches_one_process(lockstep):
    """The same global batch and draws through 2 ranks and through one
    process with no group: equal but for the order of fp32 sums."""
    gaps = misses(lockstep["port"]["gspmd"][0], lockstep["port"]["one_process"][0],
                  loss_rtol=1e-6, norm_rtol=1e-5, params_atol=1e-4, state_atol=1e-6)
    assert max(gaps.values()) <= 1.0, gaps
