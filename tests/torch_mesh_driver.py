"""What the mesh tests (tests/test_torch_port_mesh_*.py) share: the port's
rank driver, run as one subprocess per gloo rank that imports only torch
and the port, the JAX side on a mesh of the conftest's CPU devices, and the
comparison.

The driver takes one JSON spec: the step (``pretrain``, ``finetune`` or
``probe``), the mesh (``tp``; the world is dp x tp), the layout flags
(``zero1``, ``fsdp``, ``sp``), a ``control`` (a fault the lockstep must
catch), and the paths. It loads the weights, the global batch and the JAX
draws from ``src``, takes its data index's rows (d::dp) and draws
(``shard(d, dp)``), lays the params out (``parallel/mesh.shard_params``),
runs the steps and writes, from rank 0, the whole params gathered back, the
BatchNorm state, the losses, the gradient norms, its bytes of params and
moments, FSDP's gather counts, and whether the layout's shard-and-gather
gave back its input bit for bit. With ``restore`` it instead restores that
checkpoint into its layout and saves it again at once (``ckpt_again``).
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
TINY = dict(input_size=32, patch_size=8, dim_model=64, encoder_num_layers=2,
            encoder_num_heads=4, decoder_embed_dim=32, decoder_num_layers=1,
            decoder_num_heads=4, predictor_hidden_size=32, compute_dtype="float32",
            attention_impl="pallas_v3")
N, STEPS = 8, 3
SCHED = (1e-3, 0.0, 1, 2, 5)
DRAW_KEYS = ("hflip", "vflip", "boxes", "ms_boxes", "noise")
# The tiny classifier: a head of 64 x 20 = 1280 weights, so FSDP splits it.
VIT = dict(embed_dim=64, depth=2, num_heads=4, input_size=16, patch_size=8,
           num_classes=20, compute_dtype="float32", attention_impl="pallas")

DRIVER = r"""
import dataclasses, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
from cross_scale_mae_torch import configs
from cross_scale_mae_torch.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
from cross_scale_mae_torch.losses import recon
from cross_scale_mae_torch.models import layers
from cross_scale_mae_torch.ops.augment import make_pretrain_augment
from cross_scale_mae_torch.parallel import collectives, dist, mesh as pmesh
from cross_scale_mae_torch.train import optim, state as pstate
from cross_scale_mae_torch.train.classify import FinetuneDraws, make_classify_train_step
from cross_scale_mae_torch.train.pretrain import PretrainDraws, make_pretrain_step
from cross_scale_mae_torch.train.schedule import warmup_half_cosine
from cross_scale_mae_torch.utils.checkpoint import (load_flat_npz, restore_checkpoint,
                                                    save_checkpoint, save_params_npz)
from cross_scale_mae_torch.utils.params import (params_from_jax, params_to_jax,
                                                state_from_jax, vit_params_from_jax)

spec = json.loads(sys.argv[1])
rank, world, src, out = spec["rank"], spec["world"], spec["src"], spec["out"]
if world > 1:
    dist.initialize_distributed(spec["address"], world, rank, "cpu")
mh = dist.init_mesh(spec.get("tp", 1))
control = spec.get("control", "")
if control == "contiguous_qkv":       # JAX's contiguous slice of the 3D columns
    specs_of = pmesh.leaf_specs
    pmesh.leaf_specs = lambda p, l: [s if s is None else dataclasses.replace(s, qkv=False)
                                     for s in specs_of(p, l)]
elif control == "bn_without_model_sum":
    stats = layers.batch_stats
    layers.batch_stats = lambda x, dims, g=False, group="data": stats(
        x, dims, g, "data" if group is tdist.group.WORLD else group)
elif control == "fourier_mix_no_gather":   # the FFT over this rank's heads' features
    layers._fourier_mix_heads = lambda q, num_heads: layers.fourier_mix(q)
elif control == "local_scale":        # scale_01 on each rank's rows
    scale = recon.scale_01
    recon.scale_01 = lambda x, global_batch=False: scale(x, False)
elif control == "local_norm":         # the clip's and the metric's norm of this rank's part
    from cross_scale_mae_torch.train import classify, pretrain
    local = pstate.global_norm
    for mod in (optim, pretrain, classify):
        mod.global_norm = lambda ts, specs=None: local(ts)

meta = json.load(open(src + "/meta.json"))
kind = spec["kind"]
tcfg = configs.TrainConfig.from_json(meta["tcfg"])
sched = warmup_half_cosine(*meta["sched"])
tree = load_flat_npz(src + "/weights.npz")
data = np.load(src + "/data.npz")
layout = pmesh.Layout(mh.dp, mh.tp, spec.get("zero1", False), spec.get("fsdp", False))
if kind == "pretrain":
    cfg = configs.MAEConfig.from_json(meta["cfg"]).replace(sequence_parallel=spec.get("sp", False))
    params = params_from_jax(tree["params"], cfg, full=True)
    model_state = state_from_jax(tree["state"], cfg)
else:
    cfg = configs.ViTClassifierConfig.from_json(meta["cfg"]).replace(
        sequence_parallel=spec.get("sp", False))
    params = vit_params_from_jax(tree["params"], cfg)
    model_state = {k: {n: torch.from_numpy(np.asarray(v)) for n, v in d.items()}
                   for k, d in tree.get("state", {}).items()}
whole = pstate.flat_state(params, "params")
params = pmesh.shard_params(params, layout)
roundtrip = all(torch.equal(a, whole[k]) for k, a in pstate.flat_state(params, "params").items())
if kind == "probe":
    mask = {k: pstate.tree_like(v, [k == "head"] * len(pstate.tree_leaves(v)))
            for k, v in params.items()}
    tx = optim.build_optimizer(params, sched, optimizer="lars", weight_decay=0.0,
                               frozen_mask=mask)
elif kind == "finetune":
    tx = optim.build_optimizer(params, sched, weight_decay=0.05, b1=0.9, b2=0.999,
                               clip_grad=tcfg.clip_grad, layer_decay=0.75, depth=cfg.depth,
                               no_decay_names=("pos_embed", "cls_token"))
else:
    tx = optim.build_optimizer(params, sched, weight_decay=tcfg.weight_decay,
                               clip_grad=tcfg.clip_grad, zero1=layout.zero1)
state = pstate.TrainState.create(params, model_state, tx)
moments = [t for name in ("mu", "nu") for t in getattr(state.opt_state, name, [])]
nbytes = {"params": sum(t.numel() * t.element_size() for t in pstate.tree_leaves(state.params)),
          "moments": sum(t.numel() * t.element_size() for t in moments)}
if spec.get("restore"):
    restore_checkpoint(spec["restore"], state)
    save_checkpoint(out + "/ckpt_again", state.step, state)   # ends in a barrier
    dist.shutdown()
    sys.exit(0)
ddp = "gspmd" if world > 1 else None
if kind == "pretrain":
    step = make_pretrain_step(cfg, tcfg, sched, augment=make_pretrain_augment(
        FMOW_RGB_MEAN, FMOW_RGB_STD, cfg.input_size, dtype="float32"), ddp_mode=ddp)
else:
    step = make_classify_train_step(cfg, tcfg, sched, freeze_backbone=kind == "probe",
                                    data_parallel=world > 1)
rows = slice(mh.d, None, mh.dp)
batch = torch.from_numpy(data["batch"])[rows]
losses, norms, gathers = [], [], []
for s in range(data["steps"]):
    for k in collectives.FSDP_GATHERS:
        collectives.FSDP_GATHERS[k] = 0
    if kind == "pretrain":
        d = PretrainDraws(*(torch.from_numpy(data[k][s]) for k in
                            ("hflip", "vflip", "boxes", "ms_boxes", "noise")))
        state, m = step(state, batch, d.shard(mh.d, mh.dp))
    else:
        labels = torch.from_numpy(data["labels"])[rows].long()
        none = torch.zeros(data["batch"].shape[0], dtype=torch.bool)
        d = FinetuneDraws(none, none, torch.zeros(len(none), 4), None)
        state, m = step(state, batch, labels, d.shard(mh.d, mh.dp))
    gathers.append(dict(collectives.FSDP_GATHERS))
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
full = pmesh.full_params(state.params)
if spec.get("save_ckpt"):
    save_checkpoint(out + "/ckpt", state.step, state)
if rank == 0:
    save_params_npz(out + "/rank0.npz", {
        "params": params_to_jax(full), "state": params_to_jax(state.model_state),
        "losses": np.array(losses), "grad_norms": np.array(norms)})
    json.dump({"bytes": nbytes, "gathers": gathers, "roundtrip": roundtrip,
               "mesh": [mh.dp, mh.tp]}, open(out + "/rank0.json", "w"))
if world > 1:
    json.dump(nbytes, open(out + f"/bytes{rank}.json", "w"))
    dist.barrier()   # no rank leaves the group (rank 0 holds its store) before the rest
dist.shutdown()
"""


_GIVEN: set = set()


def free_address() -> str:
    """A localhost address for a process group's store: a port free now,
    not given out before by this process, and below the kernel's ephemeral
    range. A port the kernel picks (bind to 0) comes from that range, from
    which every gloo rank's own connections draw too, so with dozens of
    ranks starting at once it can be taken before the store binds it."""
    import random
    import socket

    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        ephemeral = int(f.read().split()[0])
    while True:
        port = random.randrange(ephemeral // 2, ephemeral)
        if port in _GIVEN:
            continue
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
        _GIVEN.add(port)
        return f"127.0.0.1:{port}"


def env() -> dict:
    e = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    return e


def run_procs(argvs: list[list[str]], timeout: float = TIMEOUT_S) -> list[str]:
    """Start every argv at once, wait for each with a time limit, and
    return their outputs; a failure or a timeout fails the test with the
    process's output."""
    return wait(run_procs_async(argvs), timeout)


def run_procs_async(argvs: list[list[str]]) -> list:
    """Start every argv at once; :func:`wait` collects them."""
    return [(argv, subprocess.Popen(argv, cwd=REPO, env=env(), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)) for argv in argvs]


def wait(started: list, timeout: float = TIMEOUT_S) -> list[str]:
    argvs = [a for a, _ in started]
    procs = [p for _, p in started]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for argv, p, out in zip(argvs, procs, outs):
        assert p.returncode == 0, f"{argv[-1][:300]} failed:\n{out[-4000:]}"
    return outs


def rank_jobs(name: str, spec: dict, root) -> list[list[str]]:
    """The argv of every rank of one driver run ``name`` (world dp x tp),
    writing into ``root/name``."""
    out = os.path.join(str(root), name)
    os.makedirs(out, exist_ok=True)
    world = spec.get("dp", 1) * spec.get("tp", 1)
    address = free_address()
    return [[sys.executable, "-c", DRIVER, json.dumps(
        {**spec, "rank": r, "world": world, "address": address, "out": out})]
        for r in range(world)]


def read_run(root, name: str) -> dict:
    from cross_scale_mae_torch.utils.checkpoint import load_flat_npz

    out = os.path.join(str(root), name)
    got = load_flat_npz(os.path.join(out, "rank0.npz"))
    got.update(json.load(open(os.path.join(out, "rank0.json"))))
    ranks = sorted(f for f in os.listdir(out) if f.startswith("bytes"))
    got["rank_bytes"] = [json.load(open(os.path.join(out, f))) for f in ranks] or [got["bytes"]]
    return got


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def misses(got: dict, ref: dict, loss_rtol=3e-4, norm_rtol=1e-3, params_atol=5e-4,
           state_atol=1e-5, zero_grad=()) -> dict:
    """Each reading over its limit (reading / limit > 1 misses): the worst
    relative loss and gradient-norm gaps, and the worst absolute params and
    BatchNorm-state gaps (the tolerances of tests/test_torch_port_parallel.py).
    The leaves named in ``zero_grad`` (flat keys), whose gradient is
    analytically zero, so rounding noise that Adam's normalized step moves
    by up to lr a step, are held apart to STEPS * lr."""
    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - b) / np.abs(b)))

    def worst(a, b, keep=lambda k: True):
        ref_leaves = dict(flat(b))
        gaps = [float(np.max(np.abs(v - ref_leaves[k]))) for k, v in flat(a) if keep(k)]
        return max(gaps, default=0.0)

    out = {"losses": rel(got["losses"], ref["losses"]) / loss_rtol,
           "grad_norms": rel(got["grad_norms"], ref["grad_norms"]) / norm_rtol,
           "params": worst(got["params"], ref["params"], lambda k: k not in zero_grad)
           / params_atol,
           "state": worst(got.get("state", {}), ref.get("state", {})) / state_atol}
    if zero_grad:
        out["zero_grad_params"] = worst(got["params"], ref["params"],
                                        lambda k: k in zero_grad) / (STEPS * SCHED[0])
    return out


# ---------------------------------------------------------------- JAX side


def t32(a):
    return np.asarray(a, np.float32)


def pretrain_draws(key, n, cfg):
    """The flips and crop boxes of the JAX pretrain augment and the MsLd
    boxes and mask noise of ``mae_loss_fn``, drawn from ``key`` as the JAX
    step draws them (tests/test_torch_port_parallel.py)."""
    import jax
    import jax.numpy as jnp
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes

    k_aug, k_loss = jax.random.split(key)
    k_flip, _, k_crop = jax.random.split(k_aug, 3)
    kh, kv = jax.random.split(k_flip)
    k_ms, k1, k2 = jax.random.split(k_loss, 3)
    ms = sample_crop_boxes(k_ms, n, cfg.input_size, cfg.input_size, cfg.ms_range,
                           cfg.ms_aspect_ratio)
    noise = jnp.concatenate([jax.random.uniform(k, (n, cfg.num_patches)) for k in (k1, k2)])
    return (np.array(jax.random.bernoulli(kh, 0.5, (n,))),
            np.array(jax.random.bernoulli(kv, 0.5, (n,))),
            t32(sample_crop_boxes(k_crop, n, cfg.input_size, cfg.input_size, (0.25, 1.0))),
            t32(ms), t32(noise))


def write_pretrain_src(src, cfg, tcfg, rng_seed=1):
    """Weights, the global batch and the JAX draws of every step on disk;
    returns (params, model_state, batch, rng) for the JAX side."""
    import jax
    from cross_scale_mae_tpu.models import mae_init
    from cross_scale_mae_torch.utils.checkpoint import save_params_npz

    os.makedirs(src, exist_ok=True)
    params, mstate = mae_init(jax.random.key(0), cfg)
    save_params_npz(os.path.join(src, "weights.npz"),
                    jax.tree.map(t32, {"params": params, "state": mstate}))
    with open(os.path.join(src, "meta.json"), "w") as f:
        json.dump({"cfg": cfg.to_json(), "tcfg": tcfg.to_json(), "sched": list(SCHED)}, f)
    batch = np.random.default_rng(0).integers(0, 256, (N, cfg.input_size, cfg.input_size, 3),
                                              np.uint8)
    rng = jax.random.key(rng_seed)
    draws = [pretrain_draws(jax.random.fold_in(rng, s), N, cfg) for s in range(STEPS)]
    np.savez(os.path.join(src, "data.npz"), batch=batch, steps=STEPS,
             **{k: np.stack([d[i] for d in draws]) for i, k in enumerate(DRAW_KEYS)})
    return params, mstate, batch, rng


def jax_pretrain(cfg, tcfg, params, mstate, batch, rng, dp, tp, zero1=False, fsdp=False):
    """The JAX ``make_pretrain_step`` on a (dp, tp) mesh of CPU devices
    with ``shard_train_state``: its readings and its per-device bytes of
    params and moments."""
    import jax
    import jax.numpy as jnp
    from cross_scale_mae_tpu.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_tpu.ops.augment import make_pretrain_augment
    from cross_scale_mae_tpu.parallel import batch_sharding, make_mesh, shard_train_state
    from cross_scale_mae_tpu.train import TrainState, build_optimizer, warmup_half_cosine
    from cross_scale_mae_tpu.train.pretrain import make_pretrain_step

    mesh = make_mesh(jax.devices()[:dp * tp], model_parallel=tp)
    sched = warmup_half_cosine(*SCHED)
    state = TrainState.create(params, mstate, build_optimizer(
        params, sched, weight_decay=tcfg.weight_decay, clip_grad=tcfg.clip_grad))
    state = shard_train_state(mesh, state, tensor_parallel=tp > 1, zero1=zero1, fsdp=fsdp)
    nbytes = device_bytes(state)
    step = make_pretrain_step(cfg, tcfg, sched, donate=False, mesh=mesh,
                              augment=make_pretrain_augment(FMOW_RGB_MEAN, FMOW_RGB_STD,
                                                            cfg.input_size, dtype="float32"))
    b = jax.device_put(jnp.asarray(batch), batch_sharding(mesh))
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, b, rng)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"params": jax.tree.map(t32, state.params), "state": jax.tree.map(t32,
                                                                             state.model_state),
            "losses": np.array(losses), "grad_norms": np.array(norms), "bytes": nbytes}


def device_bytes(state) -> dict:
    """JAX's bytes per device: every leaf's ``shard_shape`` on its
    sharding, of the params and of the optimizer's moments (its arrays of
    more than one element)."""
    import jax

    def total(tree):
        return sum(int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize
                   for x in jax.tree.leaves(tree) if hasattr(x, "sharding") and x.size > 1)

    return {"params": total(state.params), "moments": total(state.opt_state)}
