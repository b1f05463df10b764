"""The PyTorch port's Mixup/CutMix (cross_scale_mae_torch/train/mixup.py)
held against the JAX package's train/mixup.py on the CPU, and its
data-parallel form (the partner rows from the mirror rank,
parallel/collectives.mirror_rank_rows) held against the one-process step.

JAX's key splits cannot be reproduced in torch, so the tests rebuild the
JAX draws from the JAX keys in the JAX shapes of each mode and hand them to
``mixup_draws_from``.

Tolerances: Jöhnk's Beta 2e-7 relative (u ** (1 / a) in two libms);
masks and the area-corrected lambda bit-equal; mixed images and targets
fp32 1e-6, bf16 images one bf16 ulp of the largest value (the blend runs
in fp32 on both sides, then one cast). The 2-rank step against the
1-process step on the global batch: losses rtol 1e-6, gradient norms rtol
1e-5, params atol 1e-4 (``tests/test_torch_port_parallel.py``'s limits for
the same comparison: only the order of fp32 sums differs).
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

from cross_scale_mae_tpu.train import mixup as J
from cross_scale_mae_torch import configs as pcfg
from cross_scale_mae_torch.train import mixup as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("alpha,shape", [(0.8, ()), (1.0, (7,)), (0.2, (5, 3)), (4.0, (9,))])
def test_beta_johnk_matches_jax_on_its_uniforms(alpha, shape):
    key = jax.random.key(int(alpha * 10) + len(shape))
    ku, kv = jax.random.split(key)
    u = jax.random.uniform(ku, (16,) + shape, minval=1e-7)
    v = jax.random.uniform(kv, (16,) + shape, minval=1e-7)
    ref = np.asarray(J._beta(key, alpha, shape))
    got = P.beta_johnk(_t(u), _t(v), alpha).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0)


def test_beta_johnk_falls_back_to_one_half():
    u = torch.full((16, 3), 0.99)
    got = P.beta_johnk(u, u, 0.5)
    np.testing.assert_array_equal(got.numpy(), [0.5, 0.5, 0.5])


@pytest.mark.parametrize("minmax", [None, (0.2, 0.8)])
def test_cutmix_mask_matches_jax(minmax):
    key = jax.random.key(3)
    n, h, w = 9, 12, 10
    lam = np.linspace(0.05, 0.95, n).astype(np.float32)
    inside, lam_adj = J._cutmix_mask(key, n, h, w, jnp.asarray(lam), minmax=minmax)
    box = np.zeros((n, 4), np.float32)
    if minmax is not None:
        kh, kw, ky, kx = jax.random.split(key, 4)
        box[:, 0] = jax.random.uniform(kh, (n,), minval=minmax[0], maxval=minmax[1])
        box[:, 1] = jax.random.uniform(kw, (n,), minval=minmax[0], maxval=minmax[1])
        box[:, 2] = jax.random.uniform(ky, (n,))
        box[:, 3] = jax.random.uniform(kx, (n,))
    else:
        ky, kx = jax.random.split(key)
        box[:, 0] = jax.random.uniform(ky, (n,))
        box[:, 1] = jax.random.uniform(kx, (n,))
    got_in, got_lam = P.cutmix_mask(_t(box), _t(lam), h, w, minmax)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(inside))
    np.testing.assert_array_equal(got_lam.numpy(), np.asarray(lam_adj))


def test_mirror_pairs_matches_jax():
    v = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(P.mirror_pairs(_t(v)).numpy(),
                                  np.asarray(J._mirror_pairs(jnp.asarray(v))))


def _jax_mix_draws(key, n, mcfg: P.MixupConfig) -> P.MixupDraws:
    """mixup_cutmix's draws from ``key`` in the JAX shapes of the mode
    (mixup.py:118-170), expanded by the port's ``mixup_draws_from``."""
    k_apply, k_switch, k_lam, k_box = jax.random.split(key, 4)
    mode, a_mix, a_cut = mcfg.mode, mcfg.mixup_alpha, mcfg.cutmix_alpha
    s = () if mode == "batch" else (n,)
    if a_mix > 0 and a_cut > 0:
        use_cut = jax.random.bernoulli(k_switch, mcfg.switch_prob, s)
    else:
        use_cut = jnp.broadcast_to(jnp.asarray(a_cut > 0), s)
    lam_mix = J._beta(k_lam, a_mix, s) if a_mix > 0 else jnp.ones(s)
    lam_cut = J._beta(jax.random.fold_in(k_lam, 1), a_cut, s) if a_cut > 0 else jnp.ones(s)
    apply = jax.random.bernoulli(k_apply, mcfg.prob, s)
    m = {"batch": 1, "pair": n // 2, "elem": n}[mode]
    box = np.zeros((m, 4), np.float32)
    if mcfg.cutmix_minmax is not None:
        lo, hi = mcfg.cutmix_minmax
        kh, kw, ky, kx = jax.random.split(k_box, 4)
        box[:, 0] = jax.random.uniform(kh, (m,), minval=lo, maxval=hi)
        box[:, 1] = jax.random.uniform(kw, (m,), minval=lo, maxval=hi)
        box[:, 2] = jax.random.uniform(ky, (m,))
        box[:, 3] = jax.random.uniform(kx, (m,))
    else:
        ky, kx = jax.random.split(k_box)
        box[:, 0] = jax.random.uniform(ky, (m,))
        box[:, 1] = jax.random.uniform(kx, (m,))
    return P.mixup_draws_from(mode, n, _t(apply), _t(use_cut), _t(lam_mix), _t(lam_cut),
                              _t(box))


CASES = [dict(mixup=0.8, cutmix=1.0), dict(mixup=0.8, cutmix=0.0),
         dict(mixup=0.0, cutmix=1.0), dict(mixup=0.8, cutmix=1.0, cutmix_minmax=(0.2, 0.8)),
         dict(mixup=0.0, cutmix=0.0, cutmix_minmax=(0.3, 0.6)),
         dict(mixup=0.5, cutmix=1.0, mixup_prob=0.6, mixup_switch_prob=0.3)]


@pytest.mark.parametrize("mode", ["batch", "pair", "elem"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_mixup_cutmix_matches_jax(mode, case):
    """Every mode, Mixup alone, CutMix alone, both, the min/max range (which
    forces CutMix on), and partial apply and switch probabilities: mixed
    images and soft targets against JAX's mixup_cutmix, with the JAX draws
    and the reversed batch as the partners; every target row sums to 1."""
    tcfg = pcfg.TrainConfig(label_smoothing=0.1, mixup_mode=mode, **CASES[case])
    mcfg = P.MixupConfig.from_train_config(tcfg)
    rng = np.random.default_rng(case)
    n, c = 10, 7
    imgs = rng.normal(size=(n, 12, 12, 3)).astype(np.float32)
    labels = rng.integers(0, c, n)
    key = jax.random.key(20 + case)
    ref_i, ref_t = J.mixup_cutmix(
        key, jnp.asarray(imgs), jnp.asarray(labels), c, mixup_alpha=tcfg.mixup,
        cutmix_alpha=tcfg.cutmix, prob=tcfg.mixup_prob, switch_prob=tcfg.mixup_switch_prob,
        smoothing=0.1, mode=mode, cutmix_minmax=tcfg.cutmix_minmax)
    draws = _jax_mix_draws(key, n, mcfg)
    targets = P.smooth_one_hot(_t(labels), c, 0.1)
    got_i, got_t = P.mixup_cutmix(_t(imgs), targets, _t(imgs).flip(0), targets.flip(0),
                                  draws, mcfg.cutmix_minmax)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_t.sum(-1).numpy(), 1.0, atol=1e-6)
    if mode == "pair":
        np.testing.assert_array_equal(draws.lam_mix.numpy(), draws.lam_mix.flip(0).numpy())
        np.testing.assert_array_equal(draws.box.numpy(), draws.box.flip(0).numpy())
    if mode == "batch":
        assert len(set(draws.lam_cut.tolist())) == 1


@pytest.mark.parametrize("mode", ["batch", "pair", "elem"])
def test_mixup_cutmix_in_bf16_blends_in_fp32_and_casts_once(mode):
    """bf16 images (the augment's cast comes first in the JAX step): the
    Mixup blend runs in fp32 (lambda is fp32) and is cast back; targets stay
    fp32."""
    tcfg = pcfg.TrainConfig(mixup=0.8, cutmix=1.0, mixup_mode=mode)
    mcfg = P.MixupConfig.from_train_config(tcfg)
    rng = np.random.default_rng(30)
    imgs = rng.normal(size=(8, 10, 10, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 8)
    key = jax.random.key(31)
    ref_i, ref_t = J.mixup_cutmix(key, jnp.asarray(imgs, jnp.bfloat16), jnp.asarray(labels), 5,
                                  mode=mode)
    assert ref_i.dtype == jnp.bfloat16
    draws = _jax_mix_draws(key, 8, mcfg)
    x = _t(imgs).bfloat16()
    targets = P.smooth_one_hot(_t(labels), 5, 0.1)
    got_i, got_t = P.mixup_cutmix(x, targets, x.flip(0), targets.flip(0), draws)
    assert got_i.dtype == torch.bfloat16 and got_t.dtype == torch.float32
    ulp = 2.0 ** -7 * float(np.abs(imgs).max())
    np.testing.assert_allclose(got_i.float().numpy(), np.asarray(ref_i.astype(jnp.float32)),
                               rtol=0, atol=ulp)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=0, atol=1e-6)


def test_mixup_config_follows_timm_overrides():
    cfg = P.MixupConfig.from_train_config
    assert cfg(pcfg.TrainConfig()) is None
    assert cfg(pcfg.TrainConfig(mixup=0.0, cutmix=0.0, cutmix_minmax=None)) is None
    forced = cfg(pcfg.TrainConfig(mixup=0.0, cutmix=0.0, cutmix_minmax=(0.2, 0.8)))
    assert forced.cutmix_alpha == 1.0 and forced.cutmix_minmax == (0.2, 0.8)
    with pytest.raises(ValueError, match="mode"):
        cfg(pcfg.TrainConfig(mixup=0.8, mixup_mode="row"))
    with pytest.raises(ValueError, match="even"):
        P.mixup_draws_from("pair", 7, *(torch.zeros(7) for _ in range(4)), torch.zeros(3, 4))


@pytest.mark.parametrize("mode", ["batch", "pair", "elem"])
def test_sampled_draws_are_per_element_in_the_modes_shapes(mode):
    mcfg = P.MixupConfig(0.8, 1.0, 1.0, 0.5, mode, None)
    d = P.sample_mixup_draws(torch.Generator().manual_seed(0), 64, mcfg)
    assert d.apply.shape == d.use_cutmix.shape == d.lam_mix.shape == (64,)
    assert d.box.shape == (64, 4) and d.apply.all()
    assert d.lam_mix.min() >= 0 and d.lam_mix.max() <= 1
    distinct = len(set(d.lam_mix.tolist()))
    assert distinct == {"batch": 1, "pair": 32, "elem": 64}[mode]
    mm = P.sample_mixup_draws(torch.Generator().manual_seed(0), 64,
                              P.MixupConfig(0.0, 1.0, 1.0, 0.5, mode, (0.2, 0.8)))
    assert mm.use_cutmix.all() and mm.box[:, :2].min() >= 0.2 and mm.box[:, :2].max() <= 0.8


# ---------------------------------------------------------------- data parallel

N, STEPS, WORLD = 8, 2, 2
TIMEOUT_S = 240
MODES = ("batch", "pair", "elem")

_DRIVER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from cross_scale_mae_torch import configs
from cross_scale_mae_torch.models.vit import vit_init
from cross_scale_mae_torch.ops.augment import make_finetune_augment
from cross_scale_mae_torch.parallel import dist
from cross_scale_mae_torch.train import classify
from cross_scale_mae_torch.train.mixup import MixupConfig
from cross_scale_mae_torch.train.optim import build_optimizer
from cross_scale_mae_torch.train.state import TrainState, tree_leaves

control, out, address = sys.argv[1:4]
rank, world = int(sys.argv[4]), int(sys.argv[5])
if world > 1:
    dist.initialize_distributed(address, world, rank, "cpu")
if control == "rank_local_reversal":
    classify.mirror_rank_rows = lambda tensors: tensors
cfg = configs.get_vit_config("vit_base_patch16", input_size=16, patch_size=4, embed_dim=32,
                             depth=2, num_heads=4, num_classes=7, compute_dtype="float32",
                             attention_impl="pallas", drop_path_rate=0.1)
n, canvas = %(N)d, 20
rng = np.random.default_rng(0)
batch = torch.from_numpy(rng.integers(0, 256, (n, canvas, canvas, 3), np.uint8))
labels = torch.from_numpy(rng.integers(0, 7, n))
aug = make_finetune_augment((0.5,) * 3, (0.25,) * 3, 16, aa="rand-m9-mstd0.5-inc1",
                            reprob=0.25, dtype="float32")
result = {}
for mode in %(MODES)r:
    tcfg = configs.TrainConfig(batch_size=n, label_smoothing=0.1, mixup=0.8, cutmix=1.0,
                               mixup_mode=mode)
    mix = MixupConfig.from_train_config(tcfg)
    params, mstate = vit_init(cfg, torch.Generator().manual_seed(1))
    state = TrainState.create(params, mstate, build_optimizer(params, lambda s: 1e-3))
    step = classify.make_classify_train_step(cfg, tcfg, lambda s: 1e-3, augment=aug,
                                             data_parallel=world > 1)
    losses, norms = [], []
    for s in range(%(STEPS)d):
        draws = classify.sample_finetune_draws(torch.Generator().manual_seed(10 + s), n, cfg,
                                               canvas, extras=aug.extras, mixup=mix)
        state, m = step(state, batch[rank::world], labels[rank::world],
                        draws.shard(rank, world))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    result[mode] = {"losses": losses, "norms": norms,
                    "params": [p.detach().flatten().tolist() for p in tree_leaves(state.params)]}
if rank == 0:
    json.dump(result, open(out, "w"))
if world > 1:
    dist.shutdown()
""" % dict(N=N, MODES=MODES, STEPS=STEPS)


def _run(jobs):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", _DRIVER, *argv], cwd=REPO, env=env,
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
        assert p.returncode == 0, f"{argv} failed:\n{out[-4000:]}"


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The recipe step (RandAugment, erasing, Mixup/CutMix in each mode) at
    2 gloo ranks, the same with each rank reversing only its own rows (the
    control), and in one process on the global batch."""
    import socket

    tmp = tmp_path_factory.mktemp("mixup_dp")
    jobs = [["none", str(tmp / "single.json"), "-", "0", "1"]]
    for control in ("none", "rank_local_reversal"):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            address = f"localhost:{sock.getsockname()[1]}"
        jobs += [[control, str(tmp / f"{control}.json"), address, str(r), str(WORLD)]
                 for r in range(WORLD)]
    _run(jobs)
    return {name: json.load(open(tmp / f"{name}.json"))
            for name in ("single", "none", "rank_local_reversal")}


def _misses(got, ref) -> list[str]:
    out = []
    if not np.allclose(got["losses"], ref["losses"], rtol=1e-6, atol=0):
        out.append(f"losses {got['losses']} vs {ref['losses']}")
    if not np.allclose(got["norms"], ref["norms"], rtol=1e-5, atol=0):
        out.append(f"grad norms {got['norms']} vs {ref['norms']}")
    gap = max(float(np.abs(np.subtract(a, b)).max()) for a, b in zip(got["params"], ref["params"]))
    if gap > 1e-4:
        out.append(f"params differ by {gap}")
    return out


@pytest.mark.parametrize("mode", MODES)
def test_two_rank_mixup_step_matches_the_single_process_step(dp_runs, mode):
    """Each rank mixes its rows with the mirror rank's reversed rows: the
    2-rank step equals the one-process step on the global batch."""
    assert _misses(dp_runs["none"][mode], dp_runs["single"][mode]) == []


@pytest.mark.parametrize("mode", MODES)
def test_the_check_sees_a_rank_local_reversal(dp_runs, mode):
    """The control: each rank reversing only its own rows mixes the wrong
    partners, and the same check must catch it."""
    assert _misses(dp_runs["rank_local_reversal"][mode], dp_runs["single"][mode])


def test_mirror_rank_rows_is_the_identity_without_a_group():
    from cross_scale_mae_torch.parallel.collectives import mirror_rank_rows

    x = torch.arange(6)
    assert mirror_rank_rows([x])[0] is x
