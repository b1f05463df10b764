"""The port's temporal pretraining (fMoW temporal pairs) held against the
JAX package on the CPU.

* ``FmowTemporalDataset``: paths, labels, timestamp features, the
  chronological order, ``time_gaps_months``, the errors, each pair, and the
  loader's (B, 2, S, S, C) batches, bit for bit against the JAX loader (both
  on the Python path: neither native core takes frame stacks).
* ``mae_loss_fn`` on a pair batch: loss, terms and gradients in fp32 with
  the JAX noise injected, within the tolerances of
  ``tests/test_torch_port_train.py`` (loss and terms rtol 1e-5, gradients
  1e-5 * max(1, max|g|) per leaf, BatchNorm state 1e-6); a single-view
  config refuses the batch with the JAX message.
* The step: the port's ``make_pretrain_step`` against JAX
  ``make_pretrain_step`` for 5 steps on the tiny MsLdCeCd config, uint8
  pairs through the pretrain augmentation with JAX's per-frame draws
  injected (row b * 2 + t of the augmentation is frame t of sample b), at
  accum_iter 1 and 2; the lockstep tolerances (losses rtol 3e-4, params
  atol 5e-4, BatchNorm state atol 1e-5). The same draws fed frame-major
  (rows t * N + b) must miss.
* Two gloo ranks in gspmd mode against the JAX step on a 2-device mesh,
  each rank holding samples rank::2 with both frames' draws
  (``PretrainDraws.shard``), at the same tolerances over 3 steps.
* The pretrain CLI on JPEG pairs in one process and in two gloo ranks in
  both DDP modes (gspmd against one process: losses rtol 1e-5, the order
  of fp32 sums), and its refusal of a single-view model.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_tpu.data import datasets as jds
from cross_scale_mae_torch import configs as pcfg
from cross_scale_mae_torch.data import datasets as pds
from cross_scale_mae_torch.utils import params as pparams
from cross_scale_mae_torch.utils.checkpoint import load_flat_npz, save_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(input_size=32, patch_size=8, dim_model=64, encoder_num_layers=2,
            encoder_num_heads=4, decoder_embed_dim=32, decoder_num_layers=1,
            decoder_num_heads=4, predictor_hidden_size=32)
SCHED = (1e-3, 0.0, 1, 2, 5)
TIMEOUT_S = 240


def _cfgs(name="mae_vit_tiny_MsLdCeCd", **kw):
    kw = {**TINY, "compute_dtype": "float32", "attention_impl": "pallas_v3", **kw}
    return jcfg.get_mae_config(name, **kw), pcfg.get_mae_config(name, **kw)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _assert_tree_close(got, ref, atol, rel=False):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_g) == len(flat_r)
    for path, g in flat_g:
        r = np.asarray(flat_r[path])
        tol = atol * max(1.0, float(np.abs(r).max())) if rel else atol
        np.testing.assert_allclose(np.asarray(g), r, rtol=0, atol=tol, err_msg=str(path))


def _write_pairs(root, n=9, stamps=None, fmt="jpg"):
    """An fMoW temporal CSV over pairs of images of several sizes (the
    loader resizes them to its canvas): the columns in another order than
    the reader's, an extra column, pairs whose first column is the later
    capture, a same-month pair ordered by the day, date-only stamps."""
    from PIL import Image

    rng = np.random.default_rng(0)
    stamps = stamps or [("2017-03-05T10:00:00Z", "2016-11-20T09:00:00Z"),
                        ("2015-01-02", "2015-01-01"), ("2016-06-01T23:00:00Z", "2018-02-11")]
    rows = ["site,timestamp2,image_path,category,image_path2,timestamp"]
    for i in range(n):
        for k in (1, 2):
            side = 20 + 3 * ((i + k) % 3)
            Image.fromarray(rng.integers(0, 256, (side, side + 1, 3), np.uint8)).save(
                root / f"p{i}_{k}.{fmt}")
        t1, t2 = stamps[i % len(stamps)]
        rows.append(f"s{i},{t2},p{i}_1.{fmt},{i % 4},p{i}_2.{fmt},{t1}")
    (root / "pairs.csv").write_text("\n".join(rows) + "\n")
    return str(root / "pairs.csv")


@pytest.fixture
def one_thread():
    """One intra-op thread for a test's small CPU run, which the other test
    workers would otherwise contend with; restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the dataset


def test_temporal_dataset_matches_jax(tmp_path):
    path = _write_pairs(tmp_path)
    jd, pd = (m.build_dataset("fmow_temporal", True, train_path=path, input_size=16)
              for m in (jds, pds))
    assert (pd.paths, pd.paths2, pd.labels.tolist(), pd.min_year) == (
        jd.paths, jd.paths2, jd.labels.tolist(), jd.min_year)
    np.testing.assert_array_equal(pd.timestamps, jd.timestamps)
    np.testing.assert_array_equal(pd.time_gaps_months(), jd.time_gaps_months())
    assert (pd.time_gaps_months() >= 0).all() and pd.time_gaps_months()[:3].tolist() == [4, 0, 20]
    assert pd.paths[0].endswith("p0_2.jpg") and pd.paths[1].endswith("p1_2.jpg")
    assert pd.sample_shape == jd.sample_shape == (2, 16, 16, 3)
    assert (pd.temporal, pd.frames, pd.mean, pd.normalize_on_device) == (
        jd.temporal, jd.frames, jd.mean, jd.normalize_on_device)
    for i in range(len(pd)):
        (gp, gl), (rp, rl) = pd.load(i), jd.load(i)
        assert gp.shape == (2, 16, 16, 3) and gl == rl
        np.testing.assert_array_equal(gp, rp)


def test_temporal_dataset_errors_match_jax(tmp_path):
    path = _write_pairs(tmp_path, n=2)
    lines = open(path).read().splitlines()
    (tmp_path / "no_t2.csv").write_text("\n".join(
        ",".join(v for j, v in enumerate(r.split(",")) if j != 1) for r in lines) + "\n")
    (tmp_path / "gone.csv").write_text(lines[0] + "\n" + lines[1].replace("p0_2", "nope") + "\n")
    for m in (jds, pds):
        with pytest.raises(ValueError, match="missing column 'timestamp2'"):
            m.FmowTemporalDataset(str(tmp_path / "no_t2.csv"), 16)
        with pytest.raises(FileNotFoundError, match="nope.jpg"):
            m.FmowTemporalDataset(str(tmp_path / "gone.csv"), 16)


@pytest.mark.parametrize("drop_last", [True, False])
def test_temporal_loader_yields_the_jax_batches(tmp_path, drop_last):
    """Two epochs at two shards, batch 2, on the Python path (both loaders
    choose it for pairs): (B, 2, S, S, C) batches equal, and the eval
    padding keeps the pair shape."""
    from cross_scale_mae_tpu.data.loader import DataLoader as JLoader
    from cross_scale_mae_torch.data.loader import DataLoader

    path = _write_pairs(tmp_path, n=11)
    jd, pd = (m.build_dataset("fmow_temporal", True, train_path=path, input_size=16)
              for m in (jds, pds))
    for shard in range(2):
        kw = dict(shuffle=True, seed=3, drop_last=drop_last, num_threads=3, shard_id=shard,
                  num_shards=2)
        jl, pl = JLoader(jd, 2, **kw), DataLoader(pd, 2, **kw)
        assert jl._native is None and pl.backend == "python"
        assert pl.steps_per_epoch() == jl.steps_per_epoch()
        for epoch in range(2):
            got, ref = list(pl.epoch(epoch)), list(jl.epoch(epoch))
            assert len(got) == len(ref) > 0
            for (gi, gl), (ri, rl) in zip(got, ref):
                assert gi.shape[1:] == (2, 16, 16, 3) and gi.dtype == np.uint8
                np.testing.assert_array_equal(gi, ri)
                np.testing.assert_array_equal(gl, rl)
        if not drop_last:
            padded = list(pl.padded_epoch(0))
            assert all(im.shape[1:] == (2, 16, 16, 3) for im, _ in padded)


# ---------------------------------------------------------------- the loss


def test_temporal_mae_loss_fn_value_and_grads_match_jax(rng_np):
    from cross_scale_mae_tpu.models import mae_init as jinit
    from cross_scale_mae_tpu.models.mae import mae_loss_fn as jloss
    from cross_scale_mae_torch.models.mae import mae_loss_fn
    from cross_scale_mae_torch.train.state import tree_leaves

    jc, pc = _cfgs()
    params, state = jinit(jax.random.key(0), jc)
    pairs = rng_np.normal(size=(4, 2, 32, 32, 3)).astype(np.float32)
    rng = jax.random.key(7)

    def jfn(p):
        out = jloss(p, state, jc, jnp.asarray(pairs), rng)
        return out.loss, (out.losses, out.state)

    (jl, (jterms, jstate)), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)
    _, k1, k2 = jax.random.split(rng, 3)
    noise = _t(jnp.concatenate([jax.random.uniform(k, (4, jc.num_patches)) for k in (k1, k2)]))
    port = pparams.params_from_jax(_tree_np(params), pc, full=True)
    for leaf in tree_leaves(port):
        leaf.requires_grad_(True)
    out = mae_loss_fn(port, pparams.state_from_jax(_tree_np(state), pc), pc,
                      torch.from_numpy(pairs), noise=noise, ms_boxes=None)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(jl), rtol=1e-5)
    assert set(out.losses) == set(jterms)
    for k in jterms:
        np.testing.assert_allclose(out.losses[k].item(), float(jterms[k]), rtol=1e-5)
    grads = jax.tree.map(lambda t: torch.zeros(t.shape) if t.grad is None else t.grad, port)
    _assert_tree_close(pparams.params_to_jax(grads), _tree_np(jgrads), 1e-5, rel=True)
    _assert_tree_close(pparams.params_to_jax(out.state), _tree_np(jstate), 1e-6)


def test_temporal_batch_needs_a_multi_scale_model():
    from cross_scale_mae_tpu.models import mae_init as jinit
    from cross_scale_mae_tpu.models.mae import mae_loss_fn as jloss
    from cross_scale_mae_torch.models.mae import mae_init, mae_loss_fn

    jc, pc = _cfgs("mae_vit_tiny")
    pairs = np.zeros((2, 2, 32, 32, 3), np.float32)
    with pytest.raises(ValueError, match="need a multi-scale variant") as jerr:
        jloss(*jinit(jax.random.key(0), jc), jc, jnp.asarray(pairs), jax.random.key(1))
    params, state = mae_init(pc, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as perr:
        mae_loss_fn(params, state, pc, torch.from_numpy(pairs), noise=None)
    assert str(perr.value) == str(jerr.value)


# ---------------------------------------------------------------- the step


def _jax_draws(key, n, cfg, frame_major=False):
    """The draws JAX's step makes from ``key`` for n pairs
    (train/pretrain.py:40-47, ops/augment.py:44, models/mae.py:288-316):
    the augmentation's flips and boxes for the 2n flattened frames, the
    (unused) MsLd boxes and the mask noise of both views. ``frame_major``
    reorders the augmentation's rows as t * n + b, the mis-pairing the
    lockstep must catch."""
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes as jboxes

    k_aug, k_loss = jax.random.split(key)
    k_flip, _, k_crop = jax.random.split(k_aug, 3)
    kh, kv = jax.random.split(k_flip)
    aug = [np.array(jax.random.bernoulli(k, 0.5, (2 * n,))) for k in (kh, kv)]
    aug.append(np.asarray(jboxes(k_crop, 2 * n, 32, 32, (0.25, 1.0)), np.float32))
    if frame_major:
        aug = [a.reshape((n, 2) + a.shape[1:]).swapaxes(0, 1).reshape(a.shape) for a in aug]
    k_crop, k1, k2 = jax.random.split(k_loss, 3)
    ms_boxes = np.asarray(jboxes(k_crop, n, 32, 32, cfg.ms_range, cfg.ms_aspect_ratio),
                          np.float32)
    noise = np.asarray(jnp.concatenate([jax.random.uniform(k, (n, cfg.num_patches))
                                        for k in (k1, k2)]), np.float32)
    return (*aug, ms_boxes, noise)


def _step_draws(rng, step, n, cfg, accum, frame_major=False):
    """One set of draws per microbatch of n // accum pairs: the step key,
    or its ``accum`` splits (_accum_value_and_grads)."""
    key = jax.random.fold_in(rng, step)
    keys = [key] if accum == 1 else list(jax.random.split(key, accum))
    return [_jax_draws(k, n // accum, cfg, frame_major) for k in keys]


def _draws_obj(d):
    from cross_scale_mae_torch.train.pretrain import PretrainDraws

    return PretrainDraws(*(torch.from_numpy(np.asarray(a)) for a in d))


@pytest.mark.parametrize("accum", [1, 2])
def test_temporal_pretrain_step_lockstep_with_jax(accum):
    from cross_scale_mae_tpu.models import mae_init as jinit
    from cross_scale_mae_tpu.ops.augment import make_pretrain_augment as jaug
    from cross_scale_mae_tpu.train import TrainState as JState
    from cross_scale_mae_tpu.train import build_optimizer as jopt
    from cross_scale_mae_tpu.train import warmup_half_cosine as jsched
    from cross_scale_mae_tpu.train.pretrain import make_pretrain_step as jstep_fn
    from cross_scale_mae_torch.ops.augment import make_pretrain_augment
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.pretrain import make_pretrain_step
    from cross_scale_mae_torch.train.schedule import warmup_half_cosine
    from cross_scale_mae_torch.train.state import TrainState

    jc, pc = _cfgs()
    n, steps = 4, 5
    mean, std = pds.FMOW_RGB_MEAN, pds.FMOW_RGB_STD
    params, mstate = jinit(jax.random.key(0), jc)
    jstate = JState.create(params, mstate, jopt(params, jsched(*SCHED), weight_decay=0.05))
    jstep = jstep_fn(jc, jcfg.TrainConfig(batch_size=n, weight_decay=0.05, accum_iter=accum),
                     jsched(*SCHED), donate=False, augment=jaug(mean, std, 32, dtype="float32"))
    sched = warmup_half_cosine(*SCHED)

    def port_run():
        pp = pparams.params_from_jax(_tree_np(params), pc, full=True)
        return TrainState.create(pp, pparams.state_from_jax(_tree_np(mstate), pc),
                                 build_optimizer(pp, sched, weight_decay=0.05))

    pstate, control = port_run(), port_run()
    pstep = make_pretrain_step(pc, pcfg.TrainConfig(batch_size=n, weight_decay=0.05,
                                                    accum_iter=accum), sched,
                               augment=make_pretrain_augment(mean, std, 32, dtype="float32"))
    batch = np.random.default_rng(0).integers(0, 256, (n, 2, 32, 32, 3), np.uint8)
    rng = jax.random.key(1)
    jl, pl = [], []
    for step in range(steps):
        jstate, jm = jstep(jstate, jnp.asarray(batch), rng)
        pstate, pm = pstep(pstate, torch.from_numpy(batch),
                           [_draws_obj(d) for d in _step_draws(rng, step, n, jc, accum)])
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    np.testing.assert_allclose(pl, jl, rtol=3e-4)
    assert pstate.step == int(jstate.step) == steps and pl[-1] < pl[0]
    _assert_tree_close(pparams.params_to_jax(pstate.params), _tree_np(jstate.params), 5e-4)
    _assert_tree_close(pparams.params_to_jax(pstate.model_state),
                       _tree_np(jstate.model_state), 1e-5)
    # The control: the same draws paired frame-major miss at the first step.
    _, cm = pstep(control, torch.from_numpy(batch),
                  [_draws_obj(d) for d in _step_draws(rng, 0, n, jc, accum, frame_major=True)])
    assert abs(float(cm["loss"]) / jl[0] - 1) > 3e-4


def test_temporal_draws_shard_keeps_each_samples_frames():
    """Rank r of W takes samples r::W and, of the augmentation's draws,
    rows 2b and 2b + 1 of each of its samples b; of the noise, its rows of
    each view's half. The ranks' shards together are the global draws."""
    from cross_scale_mae_torch.train.pretrain import _step_rng, sample_pretrain_draws

    _, pc = _cfgs()
    tc = pcfg.TrainConfig()
    d = sample_pretrain_draws(_step_rng(tc, 0, 2, "cpu"), 6, pc, tc, rot90=True, frames=2)
    assert d.hflip.shape == (12,) and d.crop_boxes.shape == (12, 4) and d.rot_k.shape == (12,)
    assert d.ms_boxes.shape == (6, 4) and d.noise.shape == (12, pc.num_patches)
    for world in (2, 3):
        for r in range(world):
            s = d.shard(r, world)
            rows = [2 * b + t for b in range(r, 6, world) for t in (0, 1)]
            for got, ref in ((s.hflip, d.hflip), (s.vflip, d.vflip), (s.rot_k, d.rot_k),
                             (s.crop_boxes, d.crop_boxes)):
                assert torch.equal(got, ref[rows])
            assert torch.equal(s.ms_boxes, d.ms_boxes[r::world])
            assert torch.equal(s.noise, torch.cat([d.noise[:6][r::world], d.noise[6:][r::world]]))


_RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from cross_scale_mae_torch import configs
from cross_scale_mae_torch.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
from cross_scale_mae_torch.ops.augment import make_pretrain_augment
from cross_scale_mae_torch.parallel import dist
from cross_scale_mae_torch.train.optim import build_optimizer
from cross_scale_mae_torch.train.pretrain import PretrainDraws, make_pretrain_step
from cross_scale_mae_torch.train.schedule import warmup_half_cosine
from cross_scale_mae_torch.train.state import TrainState
from cross_scale_mae_torch.utils.checkpoint import load_flat_npz, save_params_npz
from cross_scale_mae_torch.utils.params import params_from_jax, params_to_jax, state_from_jax

src, address, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
dist.initialize_distributed(address, 2, rank, "cpu")
cfg = configs.MAEConfig.from_json(open(src + "/cfg.json").read())
tree = load_flat_npz(src + "/weights.npz")
d = np.load(src + "/draws.npz")
sched = warmup_half_cosine(*d["sched"].tolist())
params = params_from_jax(tree["params"], cfg, full=True)
state = TrainState.create(params, state_from_jax(tree["state"], cfg),
                          build_optimizer(params, sched, weight_decay=0.05))
step = make_pretrain_step(cfg, configs.TrainConfig(batch_size=8, weight_decay=0.05), sched,
                          augment=make_pretrain_augment(FMOW_RGB_MEAN, FMOW_RGB_STD, 32),
                          ddp_mode="gspmd")
batch = torch.from_numpy(d["batch"])[rank::2]
losses = []
for s in range(d["hflip"].shape[0]):
    draws = PretrainDraws(*(torch.from_numpy(d[k][s]) for k in
                            ("hflip", "vflip", "boxes", "ms_boxes", "noise"))).shard(rank, 2)
    state, m = step(state, batch, draws)
    losses.append(float(m["loss"]))
save_params_npz(src + f"/rank{rank}.npz", {"params": params_to_jax(state.params),
                                           "state": params_to_jax(state.model_state),
                                           "losses": np.array(losses)})
dist.shutdown()
"""


def _free_address() -> str:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return "127.0.0.1:" + str(sock.getsockname()[1])


def _run(jobs: list[list[str]]) -> list[str]:
    """Start every ``python`` argv at once and wait for each with a time
    limit; a failure or a timeout fails the test with its output."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
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
        assert p.returncode == 0, f"{argv[-6:]} failed:\n{out[-4000:]}"
    return outs


def test_two_rank_temporal_step_matches_the_jax_step_on_a_two_device_mesh(tmp_path):
    """gspmd: JAX's step on 8 pairs sharded over 2 devices against 2 gloo
    ranks, each on samples rank::2 and their frames' draws, 3 steps."""
    from cross_scale_mae_tpu.models import mae_init
    from cross_scale_mae_tpu.ops.augment import make_pretrain_augment
    from cross_scale_mae_tpu.train import TrainState, build_optimizer, warmup_half_cosine
    from cross_scale_mae_tpu.train.pretrain import make_pretrain_step

    jc, _ = _cfgs()
    n, steps = 8, 3
    params, mstate = mae_init(jax.random.key(0), jc)
    save_params_npz(str(tmp_path / "weights.npz"),
                    jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 {"params": params, "state": mstate}))
    (tmp_path / "cfg.json").write_text(jc.to_json())
    batch = np.random.default_rng(0).integers(0, 256, (n, 2, 32, 32, 3), np.uint8)
    rng = jax.random.key(1)
    per_step = [_step_draws(rng, s, n, jc, 1)[0] for s in range(steps)]
    np.savez(tmp_path / "draws.npz", batch=batch, sched=np.array(SCHED),
             **{k: np.stack([d[i] for d in per_step])
                for i, k in enumerate(("hflip", "vflip", "boxes", "ms_boxes", "noise"))})
    address = _free_address()
    procs = [["-c", _RANK_SCRIPT, str(tmp_path), address, str(r)] for r in range(2)]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    running = [subprocess.Popen([sys.executable, *a], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True) for a in procs]

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    sched = warmup_half_cosine(*SCHED)
    step = make_pretrain_step(jc, jcfg.TrainConfig(batch_size=n, weight_decay=0.05), sched,
                              donate=False, augment=make_pretrain_augment(
                                  jds.FMOW_RGB_MEAN, jds.FMOW_RGB_STD, 32, dtype="float32"))
    state = jax.device_put(TrainState.create(params, mstate, build_optimizer(
        params, sched, weight_decay=0.05)), NamedSharding(mesh, P()))
    b = jax.device_put(jnp.asarray(batch), NamedSharding(mesh, P("data")))
    losses = []
    for _ in range(steps):
        state, m = step(state, b, rng)
        losses.append(float(m["loss"]))

    outs = []
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in running]
    finally:
        for p in running:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in running] == [0, 0], [o[-3000:] for o in outs]
    ranks = [load_flat_npz(str(tmp_path / f"rank{r}.npz")) for r in range(2)]
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=3e-4)
    _assert_tree_close(ranks[0]["params"], _tree_np(state.params), 5e-4)
    _assert_tree_close(ranks[0]["state"], _tree_np(state.model_state), 1e-5)


# ---------------------------------------------------------------- the CLI

_CLI_SCRIPT = r"""
import json, sys
import torch
torch.set_num_threads(1)
from cross_scale_mae_torch.cli import pretrain
from cross_scale_mae_torch.parallel import dist
res = pretrain.main(pretrain.get_args_parser().parse_args(sys.argv[1:]))
print("RESULT " + json.dumps({"losses": res["losses"], "steps": res["steps"]}))
dist.shutdown()
"""


def _cli_args(path, out, *extra):
    return ["--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
            "--dataset_type", "fmow_temporal", "--train_path", path, "--batch_size", "4",
            "--epochs", "2", "--warmup_epochs", "1", "--compute_dtype", "float32",
            "--num_workers", "2", "--device", "cpu", "--output_dir", out, *extra]


def test_pretrain_cli_trains_on_temporal_pairs_and_refuses_a_single_view_model(
        tmp_path, one_thread):
    from cross_scale_mae_torch.cli import pretrain

    path = _write_pairs(tmp_path, n=8)
    args = pretrain.get_args_parser().parse_args(_cli_args(path, str(tmp_path / "out")))
    run = pretrain.build_run(args)
    assert run.frames == 2 and run.loader.backend == "python"
    assert run.draws(0)[0].hflip.shape == (8,)
    res = pretrain.main(pretrain.get_args_parser().parse_args(_cli_args(path, str(tmp_path / "out"))))
    assert res["steps"] == 4 and all(np.isfinite(res["losses"]))
    assert os.path.exists(res["npz"])
    single = pretrain.get_args_parser().parse_args(
        _cli_args(path, str(tmp_path / "single")) + ["--model", "mae_vit_tiny"])
    with pytest.raises(SystemExit, match="needs a multi-scale model"):
        pretrain.build_run(single)


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
def test_temporal_pretrain_cli_at_two_ranks(tmp_path, mode):
    """Two gloo ranks on the pairs: both ranks log the same losses; under
    gspmd they equal one process's on the same global batches and draws
    (rtol 1e-5, the order of fp32 sums)."""
    path = _write_pairs(tmp_path, n=8)
    address = _free_address()
    jobs = [["-c", _CLI_SCRIPT, *_cli_args(path, str(tmp_path / f"r{r}"), "--ddp_mode", mode,
                                           "--coordinator_address", address,
                                           "--num_processes", "2", "--process_id", str(r))]
            for r in range(2)]
    if mode == "gspmd":
        jobs.append(["-c", _CLI_SCRIPT, *_cli_args(path, str(tmp_path / "one"))])
    results = [json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1][7:])
               for out in _run(jobs)]
    assert results[0] == results[1] and results[0]["steps"] == 4
    assert all(np.isfinite(results[0]["losses"]))
    if mode == "gspmd":
        np.testing.assert_allclose(results[0]["losses"], results[2]["losses"], rtol=1e-5)
