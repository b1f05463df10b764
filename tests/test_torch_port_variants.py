"""The attention variants (linformer, Nystrom, orthoformer, local, Fourier
mix) of the PyTorch port held against the JAX package on the CPU: each
function, the landmark helpers, a block, the unmasked encoder, the pretrain
step in lockstep, linformer's E and F through every carry (the weight
carry, checkpoints, ``train_state_from_jax``, ``--resume``, the classifier
start), the refusals, and each variant through the CLIs, serving and
export.

Inputs and weights come from numpy seeds and go through both packages as
numpy. The JAX package runs the variants in plain XLA (no Pallas kernel).

Tolerances, each with its reason:
* fp32 functions: max|got - ref| <= 1e-5 * max(1, max|ref|). The two sides
  differ in the order of fp32 sums; fourier_mix's outputs grow as the sum
  of L * D inputs (up to ~200 here), so the bound scales with them.
  Nystrom is held to the same bound (1e-6 read): its six Newton-Schulz
  iterations run on a 64 x 64 row-stochastic matrix in fp32 on both sides.
* bf16 functions and blocks: the block bounds of ROADMAP.md queue 3, max
  2**-5 * max(1, max|ref|) and mean 2**-7 * max(1, mean|ref|): P, the
  projections and the outputs are rounded to bf16 once on both sides, so
  an fp32 sum in another order flips a rounding now and then. The encoder
  (2 layers) 2**-4, as tests/test_torch_port_model.py holds it.
* mae_loss_fn and the 2-step lockstep: the bounds of
  tests/test_torch_port_train.py (loss rtol 1e-5, gradients 1e-5 * max(1,
  max|g|); losses rtol 3e-4, params atol 5e-4), but fourier_mix's params
  at steps * lr (the lockstep's comment says why).
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_tpu.models import layers as jlayers
from cross_scale_mae_tpu.ops import attention as jattn
from cross_scale_mae_torch import configs as pcfg
from cross_scale_mae_torch.models import layers as players
from cross_scale_mae_torch.ops import attention as pattn
from cross_scale_mae_torch.utils import params as pparams
from tests.torch_jax_state import jax_moments

VARIANTS = ("linformer", "nystrom", "orthoformer", "local", "fourier_mix")
DTYPES = ("float32", "bfloat16")
# 72 px at patch 8: 81 patches, so the decoder's 82 tokens exceed both
# landmark counts (Nystrom 64, orthoformer 32), as the flagship decoder's
# 65 tokens exceed orthoformer's; the masked encoder's 21 stay exact.
TINY = dict(input_size=72, patch_size=8, dim_model=32, encoder_num_layers=2,
            encoder_num_heads=4, decoder_embed_dim=32, decoder_num_layers=1,
            decoder_num_heads=4, predictor_hidden_size=32)


def _close(got, ref, dtype: str, budget: float = 2.0 ** -5):
    got = (got.float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    if dtype == "float32":
        assert err.max() <= 1e-5 * max(1.0, np.abs(ref).max()), err.max()
    else:
        assert err.max() <= budget * max(1.0, np.abs(ref).max()), err.max()
        assert err.mean() <= 2.0 ** -7 * max(1.0, np.abs(ref).mean()), err.mean()


def _tdtype(dtype: str) -> torch.dtype:
    return getattr(torch, dtype)


def _jnp(x: np.ndarray, dtype: str):
    return jnp.asarray(x).astype(jnp.dtype(dtype))


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _cfgs(name="mae_vit_tiny_MsLdCeCd", **kw):
    kw = {**TINY, "compute_dtype": "float32", **kw}
    return jcfg.get_mae_config(name, **kw), pcfg.get_mae_config(name, **kw)


def _perturbed(tree, seed=0):
    """Every leaf moved off its init constant, so a mis-mapped one shows."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(np.float32), tree)


def _jax_mae_params(cfg, seed=0):
    from cross_scale_mae_tpu.models.mae import mae_init

    params, state = mae_init(jax.random.key(seed), cfg)
    return _perturbed(params, seed), _tree_np(state)


# ---------------------------------------------------------------- functions


def _variant_pair(variant: str, q, k, v, e, f, dtype: str):
    """(port output, JAX output as fp32 numpy) of one variant function."""
    t = [torch.from_numpy(a).to(_tdtype(dtype)) for a in (q, k, v)]
    j = [_jnp(a, dtype) for a in (q, k, v)]
    if variant == "linformer":
        got = pattn.linformer_mha(*t, torch.from_numpy(e), torch.from_numpy(f))
        ref = jattn.linformer_mha(*j, jnp.asarray(e), jnp.asarray(f))
    elif variant == "fourier_mix":
        got, ref = pattn.fourier_mix(t[0]), jattn.fourier_mix(j[0])
    else:
        name = {"nystrom": "nystrom_mha", "orthoformer": "orthoformer_mha",
                "local": "local_mha"}[variant]
        got, ref = getattr(pattn, name)(*t), getattr(jattn, name)(*j)
    return got, _f32(ref)


@pytest.mark.parametrize("seq_len", [17, 65, 257])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_function_matches_jax(variant, dtype, seq_len):
    """Each variant on (2, L, 2, 16) q, k, v at the encoder's length (every
    landmark variant exact), the flagship decoder's (Nystrom exact at 64
    landmarks, orthoformer approximate) and the longest (both approximate,
    257 rows in 64 uneven segments); E and F declared for 257 rows and
    sliced to L."""
    rng = np.random.default_rng(seq_len)
    q, k, v = (rng.normal(size=(2, seq_len, 2, 16)).astype(np.float32) for _ in range(3))
    e, f = (rng.uniform(-0.2, 0.2, (257, 64)).astype(np.float32) for _ in range(2))
    got, ref = _variant_pair(variant, q, k, v, e, f, dtype)
    assert got.dtype == _tdtype(dtype) and got.shape == q.shape
    _close(got, ref, dtype)


def test_orthoformer_landmark_rows_match_jax_for_every_length():
    """jnp.linspace(0, l-1, 32).astype(int32), truncated from float32, and
    the port's integer floor(i (l-1) / 31) pick the same rows at every
    length the models see (17-257)."""
    for seq_len in range(17, 258):
        want = np.asarray(jnp.linspace(0, seq_len - 1, 32).astype(jnp.int32))
        assert pattn.landmark_rows(seq_len, 32) == want.tolist(), seq_len


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq_len,m", [(65, 64), (257, 64), (82, 64), (40, 32), (17, 32)])
def test_segment_means_match_jax(seq_len, m, dtype):
    """The remainder spread over the first l % m segments, the sums in the
    input dtype (index_add_, as JAX's .at[].add): bit-equal on the CPU."""
    x = np.random.default_rng(seq_len).normal(size=(2, seq_len, 2, 8)).astype(np.float32)
    got = pattn.segment_means(torch.from_numpy(x).to(_tdtype(dtype)), m)
    ref = jattn._segment_means(_jnp(x, dtype), m)
    assert got.dtype == _tdtype(dtype)
    np.testing.assert_array_equal(got.float().numpy(), _f32(ref))
    counts = np.bincount(pattn.segment_ids(seq_len, m, torch.device("cpu")).numpy(),
                         minlength=m)
    assert counts.max() - counts.min() <= 1 and counts.sum() == seq_len


def test_iterative_pinv_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.uniform(size=(2, 3, 64, 64)).astype(np.float32)
    s /= s.sum(-1, keepdims=True)
    got = pattn.iterative_pinv(torch.from_numpy(s))
    ref = np.asarray(jattn._iterative_pinv(jnp.asarray(s)))
    _close(got, ref, "float32")


def test_iterative_pinv_recomputes_its_iterations_in_the_backward():
    """Under autograd the Newton-Schulz iterations are recomputed, not
    saved: the same gradient bits as differentiating them directly, with a
    few saved tensors in place of some 40."""
    rng = np.random.default_rng(4)
    s = rng.uniform(size=(2, 16, 16)).astype(np.float32)
    s /= s.sum(-1, keepdims=True)
    w = torch.from_numpy(rng.normal(size=(2, 16, 16)).astype(np.float32))
    grads, saved = [], []
    for fn in (pattn.iterative_pinv, lambda t: pattn._newton_schulz(t, 6)):
        x = torch.from_numpy(s).requires_grad_(True)
        count = [0]

        def pack(t, count=count):
            count[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            z = fn(x)
        (z * w).sum().backward()
        grads.append(x.grad)
        saved.append(count[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    assert saved[0] <= 4 < 20 < saved[1], saved
    with torch.no_grad():
        torch.testing.assert_close(pattn.iterative_pinv(torch.from_numpy(s)),
                                   pattn._newton_schulz(torch.from_numpy(s), 6))


def test_variants_run_in_float64_for_the_cards_reference():
    """The card's gates hold each variant against itself in float64: every
    fp32 step widens to float64 there (accum_dtype), never narrows."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 82, 2, 16)) for _ in range(3))
    e, f = (rng.uniform(-0.2, 0.2, (82, 20)) for _ in range(2))
    for variant in VARIANTS:
        t = [torch.from_numpy(a) for a in (q, k, v)]
        got, ref = _variant_pair(variant, q.astype(np.float32), k.astype(np.float32),
                                 v.astype(np.float32), e.astype(np.float32),
                                 f.astype(np.float32), "float32")
        if variant == "linformer":
            wide = pattn.linformer_mha(*t, torch.from_numpy(e), torch.from_numpy(f))
        elif variant == "fourier_mix":
            wide = pattn.fourier_mix(t[0])
        else:
            wide = getattr(pattn, f"{variant}_mha")(*t)
        assert wide.dtype == torch.float64
        _close(wide.float(), ref, "float32")


def test_nystrom_and_orthoformer_refuse_tf32_on_the_card(monkeypatch):
    """Their fp32 products must be IEEE fp32 on the card: a process that
    enabled TF32 is refused, not served 10-bit mantissas."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for what in ("nystrom attention", "orthoformer attention"):
        with pytest.raises(RuntimeError, match="TF32"):
            pattn.require_ieee_fp32(torch.device("cuda"), what)
    pattn.require_ieee_fp32(torch.device("cpu"), "nystrom attention")


# ---------------------------------------------------------------- blocks


def _block_params(rng, d, hidden, seq_len):
    def lin(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(o,))).astype(np.float32)}

    def norm():
        return {"scale": (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(d,))).astype(np.float32)}

    k = max(seq_len // 4, 1)
    attn = {"qkv": lin(d, 3 * d), "proj": lin(d, d),
            "e_proj": rng.uniform(-0.2, 0.2, (seq_len, k)).astype(np.float32),
            "f_proj": rng.uniform(-0.2, 0.2, (seq_len, k)).astype(np.float32)}
    return {"norm1": norm(), "attn": attn, "norm2": norm(),
            "mlp": {"fc1": lin(d, hidden), "fc2": lin(hidden, d)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_block_matches_jax(variant, dtype):
    """One pre-LN block (exact GELU) on 82 tokens, linformer's E and F in
    the block's attention params."""
    rng = np.random.default_rng(6)
    p = _block_params(rng, 32, 128, 82)
    x = rng.normal(size=(2, 82, 32)).astype(np.float32)
    ref = jlayers.block(jax.tree.map(jnp.asarray, p), _jnp(x, dtype), 4, variant, "pre",
                        "exact")
    got = players.block(_to_torch(p), torch.from_numpy(x).to(_tdtype(dtype)), 4, variant,
                        "pre", "exact")
    _close(got, _f32(ref), dtype)


def test_block_init_draws_linformer_projections():
    gen = torch.Generator().manual_seed(0)
    block = players.block_init(gen, 32, 4, "linformer", 82)
    lim = np.sqrt(6.0 / (82 + 20))
    for name in ("e_proj", "f_proj"):
        w = block["attn"][name]
        assert w.shape == (82, 20) and w.dtype == torch.float32
        assert float(w.abs().max()) <= lim and float(w.std()) > 0.5 * lim / np.sqrt(3)
    assert not torch.equal(block["attn"]["e_proj"], block["attn"]["f_proj"])
    assert set(players.block_init(gen, 32, 4, "nystrom", 82)["attn"]) == {"qkv", "proj"}
    with pytest.raises(ValueError, match="seq_len"):
        players.block_init(gen, 32, 4, "linformer")


@pytest.mark.parametrize("variant", VARIANTS)
def test_mae_init_tree_matches_jax(variant):
    """The port's init has the JAX init's tree and shapes for a variant
    (linformer: E and F in every encoder and decoder block, sized to
    num_patches + 1), and so have the shape tables of the carry."""
    from cross_scale_mae_tpu.models.mae import mae_init as jinit
    from cross_scale_mae_torch.models.mae import mae_init

    jc, pc = _cfgs(attention_impl=variant)
    jparams, _ = jinit(jax.random.key(0), jc)
    params, _ = mae_init(pc, torch.Generator().manual_seed(0))
    want = jax.tree.map(lambda a: a.shape, _tree_np(jparams))
    got = jax.tree.map(lambda a: a.shape, pparams.params_to_jax(params))
    assert got == want == pparams.mae_param_shapes(pc)
    if variant == "linformer":
        assert want["decoder_blocks"]["attn"]["e_proj"] == (1, 82, 20)


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_mae_encode_matches_jax(variant, dtype):
    """The unmasked encoder (82 tokens, serving's path) from the JAX
    params, linformer's E and F carried by params_from_jax."""
    from cross_scale_mae_tpu.models.mae import mae_encode as jencode
    from cross_scale_mae_torch.models.mae import mae_encode

    jc, pc = _cfgs("mae_vit_base_MsLdCeCd", attention_impl=variant, compute_dtype=dtype,
                   gelu="exact")
    params, _ = _jax_mae_params(jc)
    imgs = np.random.default_rng(8).normal(size=(2, 72, 72, 3)).astype(np.float32)
    ref = jencode(jax.tree.map(jnp.asarray, params), jc, jnp.asarray(imgs))
    got = mae_encode(pparams.params_from_jax(params, pc), pc, torch.from_numpy(imgs))
    assert got.dtype == _tdtype(dtype) and got.shape == (2, 82, 32)
    _close(got, _f32(ref), dtype, 2.0 ** -4)


def _jax_loss_draws(rng, n, cfg):
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes as jboxes

    k_crop, k1, k2 = jax.random.split(rng, 3)
    boxes = jboxes(k_crop, n, cfg.input_size, cfg.input_size, cfg.ms_range,
                   cfg.ms_aspect_ratio)
    noise = jnp.concatenate([jax.random.uniform(k, (n, cfg.num_patches)) for k in (k1, k2)])
    return torch.from_numpy(np.asarray(boxes)), torch.from_numpy(np.asarray(noise))


def _assert_tree_close(got, ref, atol, rel=False):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_g) == len(flat_r)
    for path, g in flat_g:
        r = np.asarray(flat_r[path])
        tol = atol * max(1.0, float(np.abs(r).max())) if rel else atol
        np.testing.assert_allclose(np.asarray(g), r, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_mae_loss_fn_value_and_grads_match_jax(variant):
    """The whole MsLdCeCd objective through both stacks (encoder exact at 21
    tokens for the landmark variants, the decoder approximate at 82), with
    every gradient, linformer's E and F among them."""
    from cross_scale_mae_tpu.models.mae import mae_loss_fn as jloss
    from cross_scale_mae_torch.models.mae import mae_loss_fn
    from cross_scale_mae_torch.train.state import tree_leaves

    jc, pc = _cfgs(attention_impl=variant)
    params, state = _jax_mae_params(jc)
    imgs = np.random.default_rng(4).normal(size=(4, 72, 72, 3)).astype(np.float32)
    rng = jax.random.key(7)

    def jfn(p):
        out = jloss(p, state, jc, jnp.asarray(imgs), rng)
        return out.loss, out.losses

    (jl, jterms), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    port = pparams.params_from_jax(params, pc, full=True)
    for leaf in tree_leaves(port):
        leaf.requires_grad_(True)
    boxes, noise = _jax_loss_draws(rng, 4, jc)
    out = mae_loss_fn(port, pparams.state_from_jax(state, pc), pc, torch.from_numpy(imgs),
                      noise=noise, ms_boxes=boxes)
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss), float(jl), rtol=1e-5)
    for k in jterms:
        np.testing.assert_allclose(float(out.losses[k]), float(jterms[k]), rtol=1e-5)
    grads = jax.tree.map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, port,
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    _assert_tree_close(pparams.params_to_jax(grads), _tree_np(jgrads), 1e-5, rel=True)
    if variant == "linformer":
        g = grads["decoder_blocks"][0]["attn"]["e_proj"]
        assert float(g.abs().max()) > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_pretrain_step_2_step_lockstep_with_jax(variant):
    """make_pretrain_step against the JAX one for 2 steps from the same
    weights, with the JAX draws injected (as the 10-step lockstep of
    tests/test_torch_port_train.py): losses, gradient norms, params (E and
    F too) and the BatchNorm statistics."""
    from cross_scale_mae_tpu.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_tpu.ops.augment import make_pretrain_augment as jaug
    from cross_scale_mae_tpu.train import TrainState as JState
    from cross_scale_mae_tpu.train import build_optimizer as jopt
    from cross_scale_mae_tpu.train import warmup_half_cosine as jsched
    from cross_scale_mae_tpu.train.pretrain import make_pretrain_step as jstep_fn
    from cross_scale_mae_torch.ops.augment import make_pretrain_augment
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.pretrain import PretrainDraws, make_pretrain_step
    from cross_scale_mae_torch.train.schedule import warmup_half_cosine
    from cross_scale_mae_torch.train.state import TrainState
    from test_torch_port_train import _jax_augment_draws

    jc, pc = _cfgs(attention_impl=variant)
    n, steps = 4, 2
    sched_args = (1e-3, 0.0, 0, 2, 5)
    params, mstate = _jax_mae_params(jc)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JState.create(jparams, jax.tree.map(jnp.asarray, mstate),
                           jopt(jparams, jsched(*sched_args), weight_decay=0.05))
    jstep = jstep_fn(jc, jcfg.TrainConfig(batch_size=n), jsched(*sched_args), donate=False,
                     augment=jaug(FMOW_RGB_MEAN, FMOW_RGB_STD, 72, dtype="float32"))
    sched = warmup_half_cosine(*sched_args)
    pp = pparams.params_from_jax(params, pc, full=True)
    pstate = TrainState.create(pp, pparams.state_from_jax(mstate, pc),
                               build_optimizer(pp, sched, weight_decay=0.05))
    pstep = make_pretrain_step(pc, pcfg.TrainConfig(batch_size=n), sched,
                               augment=make_pretrain_augment(FMOW_RGB_MEAN, FMOW_RGB_STD, 72,
                                                             dtype="float32"))
    batch = np.random.default_rng(0).integers(0, 256, (n, 72, 72, 3), np.uint8)
    rng = jax.random.key(1)
    jl, pl = [], []
    for step in range(steps):
        k_aug, k_loss = jax.random.split(jax.random.fold_in(rng, step))
        hflip, vflip, boxes = _jax_augment_draws(k_aug, n, 72, 72)
        ms_boxes, noise = _jax_loss_draws(k_loss, n, jc)
        jstate, jm = jstep(jstate, jnp.asarray(batch), rng)
        pstate, pm = pstep(pstate, torch.from_numpy(batch),
                           PretrainDraws(hflip, vflip, boxes, ms_boxes, noise))
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    np.testing.assert_allclose(pl, jl, rtol=3e-4)
    # fourier_mix's decoder q bias has an analytically zero gradient: it adds
    # one vector to every token, which the FFT over the sequence moves into
    # row 0 alone, the cls row that the one-layer decoder's loss drops. Both
    # sides read it at <= 7e-9; Adam's normalized step moves such a leaf by
    # up to lr on that noise, so the params are held to steps * lr.
    atol = steps * 1e-3 if variant == "fourier_mix" else 5e-4
    _assert_tree_close(pparams.params_to_jax(pstate.params), _tree_np(jstate.params), atol)
    _assert_tree_close(pparams.params_to_jax(pstate.model_state),
                       _tree_np(jstate.model_state), 1e-5)
    if variant == "linformer":
        moved = (pstate.params["encoder_blocks"][0]["attn"]["e_proj"].detach().numpy()
                 - params["encoder_blocks"]["attn"]["e_proj"][0])
        assert np.abs(moved).max() > 0


# ---------------------------------------------------------------- carries


def _linformer_state(seed: int):
    """A linformer TrainState after one AdamW update, its moments off zero."""
    from cross_scale_mae_torch.models.mae import mae_init
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import TrainState, tree_leaves

    _, pc = _cfgs(attention_impl="linformer")
    params, mstate = mae_init(pc, torch.Generator().manual_seed(seed))
    state = TrainState.create(params, mstate, build_optimizer(params, lambda s: 1e-3))
    gen = torch.Generator().manual_seed(seed + 1)
    return pc, state.apply_gradients([torch.randn(p.shape, generator=gen)
                                      for p in tree_leaves(params)])


def test_linformer_checkpoint_round_trips_e_and_f(tmp_path):
    from cross_scale_mae_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    pc, state = _linformer_state(0)
    save_checkpoint(str(tmp_path), state.step, state, pc.to_json(), {"epoch": 0})
    _, fresh = _linformer_state(9)
    restored, _ = restore_checkpoint(str(tmp_path), fresh)
    want, got = state.state_dict(), restored.state_dict()
    keys = [k for k in want if "e_proj" in k or "f_proj" in k]
    assert {k.split("/")[0] for k in keys} == {"params", "opt_state"} and len(keys) == 12
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_pretrain_cli_resumes_linformer_projections(tmp_path, capsys):
    """--resume restores E and F and their moments into a fresh linformer run."""
    from cross_scale_mae_torch.cli.pretrain import build_run, get_args_parser, main
    from cross_scale_mae_torch.utils.checkpoint import read_host_checkpoint

    argv = ["--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "16", "--patch_size", "8",
            "--batch_size", "2", "--synthetic_len", "4", "--epochs", "1",
            "--warmup_epochs", "0", "--device", "cpu", "--attention", "linformer",
            "--output_dir", str(tmp_path / "a")]
    ckpt = os.path.join(main(get_args_parser().parse_args(argv))["output_dir"], "checkpoints")
    _, tree, _, _ = read_host_checkpoint(ckpt)
    run = build_run(get_args_parser().parse_args(argv + ["--resume", ckpt, "--seed", "5"]))
    assert run.start_epoch == 1 and run.state.step == 2
    for i, block in enumerate(run.state.params["decoder_blocks"]):
        np.testing.assert_array_equal(block["attn"]["f_proj"].detach().numpy(),
                                      tree["decoder_blocks"]["attn"]["f_proj"][i])
    assert "resumed from" in capsys.readouterr().out


def test_train_state_from_jax_carries_linformer_projections():
    """A JAX linformer TrainState (params, Adam moments) into the port's."""
    from cross_scale_mae_tpu.train import TrainState as JState
    from cross_scale_mae_tpu.train import build_optimizer as jopt
    from cross_scale_mae_torch.train.optim import build_optimizer

    jc, pc = _cfgs(attention_impl="linformer")
    params, mstate = _jax_mae_params(jc)
    jparams = jax.tree.map(jnp.asarray, params)
    tx = jopt(jparams, lambda s: 1e-3, weight_decay=0.05)
    jstate = JState.create(jparams, jax.tree.map(jnp.asarray, mstate), tx)
    grads = jax.tree.map(lambda a: jnp.full_like(a, 0.25), jparams)
    jstate = jstate.apply_gradients(grads=grads)
    pp = pparams.params_from_jax(params, pc, full=True)
    port = pparams.train_state_from_jax(jstate, pc, build_optimizer(pp, lambda s: 1e-3))
    sd = port.state_dict()
    adam = jax_moments(jstate.opt_state)
    for stack in ("encoder_blocks", "decoder_blocks"):
        for name in ("e_proj", "f_proj"):
            path = f"{stack}/attn/{name}"
            np.testing.assert_array_equal(sd[f"params/{path}"].numpy(),
                                          np.asarray(jstate.params[stack]["attn"][name]))
            for m in ("mu", "nu"):
                ref = np.asarray(adam[m][stack]["attn"][name])
                assert np.abs(ref).max() > 0
                np.testing.assert_array_equal(sd[f"opt_state/{m}/{path}"].numpy(), ref)


def test_classifier_starts_from_a_linformer_mae_with_its_projections():
    """mae_encoder_to_classifier and merge_pretrained carry a linformer
    encoder's E and F into a linformer ViT of the same grid."""
    from cross_scale_mae_torch.models.vit import vit_init

    jc, pc = _cfgs(attention_impl="linformer")
    mae = pparams.params_from_jax(_jax_mae_params(jc)[0], pc, full=True)
    vcfg = pcfg.ViTClassifierConfig(input_size=72, patch_size=8, embed_dim=32, depth=2,
                                    num_heads=4, num_classes=3, attention_impl="linformer")
    fresh, _ = vit_init(vcfg, torch.Generator().manual_seed(0))
    pre, _ = pparams.mae_encoder_to_classifier(mae, vcfg)
    merged = pparams.merge_pretrained(fresh, pre)
    for i in range(2):
        for name in ("e_proj", "f_proj"):
            torch.testing.assert_close(merged["blocks"][i]["attn"][name],
                                       mae["encoder_blocks"][i]["attn"][name])
    shapes = pparams.vit_param_shapes(vcfg)
    assert shapes["blocks"]["attn"]["e_proj"] == (2, 82, 20)
    tree = pparams.params_to_jax(merged)
    back = pparams.vit_params_from_jax(tree, vcfg)
    torch.testing.assert_close(back["blocks"][1]["attn"]["f_proj"],
                               merged["blocks"][1]["attn"]["f_proj"])


# ---------------------------------------------------------------- refusals


@pytest.mark.parametrize("impl", [*VARIANTS, "pallas_t"])
def test_flat_blocks_refuses_what_the_jax_flat_path_refuses(impl):
    """JAX raises NotImplementedError when its flat-carry stack meets an
    impl it does not wire (layers.py:364-377); the port's config raises
    it, and a JAX config of that kind does not load."""
    from cross_scale_mae_tpu.models import mae_init as jinit
    from cross_scale_mae_tpu.models.mae import mae_forward_encoder

    kw = dict(input_size=16, patch_size=8, compute_dtype="float32", attention_impl=impl)
    jc = jcfg.get_mae_config("mae_vit_tiny", **kw).replace(flat_blocks=True)
    params, _ = jinit(jax.random.key(0), jc.replace(flat_blocks=False))
    with pytest.raises(NotImplementedError):
        mae_forward_encoder(params, jc, jnp.zeros((2, 16, 16, 3)), rng=jax.random.key(1))
    with pytest.raises(NotImplementedError, match="flat_blocks"):
        pcfg.get_mae_config("mae_vit_tiny", **kw).replace(flat_blocks=True)
    with pytest.raises(NotImplementedError, match="flat_blocks"):
        pcfg.MAEConfig.from_json(jc.to_json())
    for ok in pcfg.FLAT_BLOCKS_IMPLS:
        assert pcfg.get_mae_config("mae_vit_tiny", flat_blocks=True,
                                   attention_impl=ok).flat_blocks


def test_pth_export_refuses_to_drop_linformer_projections():
    """The reference .pth has no key for E and F: the port refuses, naming
    each key; the JAX export writes the file without them (its fault)."""
    from cross_scale_mae_tpu.utils.torch_export import mae_state_dict as jexport
    from cross_scale_mae_torch.utils.torch_export import mae_state_dict

    jc, pc = _cfgs(attention_impl="linformer")
    params, _ = _jax_mae_params(jc)
    jsd = jexport(params, jc)
    assert not [k for k in jsd if "e_proj" in k or "f_proj" in k]
    with pytest.raises(ValueError) as err:
        mae_state_dict(pparams.params_from_jax(params, pc, full=True), pc)
    for key in ("encoder.0.attn.e_proj", "encoder.1.attn.f_proj", "decoder.0.attn.e_proj"):
        assert key in str(err.value)
    # The other variants hold no parameter of their own and export as JAX does.
    jc, pc = _cfgs(attention_impl="nystrom")
    params, _ = _jax_mae_params(jc)
    sd = mae_state_dict(pparams.params_from_jax(params, pc, full=True), pc)
    ref = jexport(params, jc)
    assert set(sd) == set(ref)
    for k in ref:
        np.testing.assert_allclose(sd[k], np.asarray(ref[k]), rtol=0, atol=1e-7, err_msg=k)


def test_export_torch_cli_refuses_a_linformer_run(tmp_path):
    from cross_scale_mae_torch.cli import export_torch

    ckpt = _port_npz(tmp_path, "linformer")
    with pytest.raises(ValueError, match="encoder.0.attn.e_proj"):
        export_torch.main(export_torch.get_args_parser().parse_args(
            ["--ckpt", ckpt, "--output", str(tmp_path / "x.pth"), "--model_name",
             "mae_vit_base_MsLdCeCd"]))
    assert not (tmp_path / "x.pth").exists()


def _port_npz(tmp_path, variant, dtype="float32", name="mae_vit_base_MsLdCeCd"):
    """A JAX-initialised tree of ``variant`` as the npz both packages read."""
    from cross_scale_mae_torch.utils.checkpoint import save_params_npz

    jc, _ = _cfgs(name, attention_impl=variant, compute_dtype=dtype)
    path = str(tmp_path / f"{variant}_{dtype}.npz")
    save_params_npz(path, _jax_mae_params(jc)[0], jc.to_json())
    return path


@pytest.mark.parametrize("trained,asked", [("linformer", "xla"), ("nystrom", "pallas_v3"),
                                           ("pallas_v3", "local"), ("local", "nystrom")])
def test_embed_refuses_to_swap_a_variant(tmp_path, trained, asked):
    from cross_scale_mae_torch.cli import embed

    ckpt = _port_npz(tmp_path, trained)
    with pytest.raises(SystemExit) as err:
        embed.main(embed.get_args_parser().parse_args(
            ["--ckpt", ckpt, "--dataset_type", "synthetic", "--synthetic_len", "4",
             "--batch_size", "4", "--device", "cpu", "--attention_impl", asked,
             "--output_dir", str(tmp_path / "e")]))
    assert trained in str(err.value) and asked in str(err.value)
    embed.check_attention_swap("pallas_v3", "xla")   # exact for exact runs
    embed.check_attention_swap("local", "local")


# ---------------------------------------------------------------- serving


def _jax_orbax(path, cfg, params, state):
    from cross_scale_mae_tpu.utils.checkpoint import save_checkpoint

    save_checkpoint(path, 3, types.SimpleNamespace(
        params=params, model_state=state, opt_state={"count": np.zeros((), np.int32)},
        step=np.int32(3)), cfg.to_json(), {"epoch": 0})
    return path


@pytest.mark.parametrize("variant", VARIANTS)
def test_portable_serving_keeps_the_variant(tmp_path, variant):
    """``portable=True`` (the export's forward) keeps a variant: the port's
    portable forward is the JAX package's in-process (variant) forward on
    the same weights. The JAX portable forward swaps in exact attention
    (serving.py:98-99 there), which is another model."""
    from cross_scale_mae_tpu.serving import prepare_serving as jprepare
    from cross_scale_mae_torch.serving import prepare_serving

    jc, pc = _cfgs("mae_vit_base_MsLdCeCd", attention_impl=variant)
    params, state = _jax_mae_params(jc)
    jdir = _jax_orbax(str(tmp_path / "jax"), jc, params, state)
    npz = _port_npz(tmp_path, variant)
    u8 = np.random.default_rng(1).integers(0, 256, (2, 82, 82, 3), np.uint8)
    fwd, p, cfg, _, canvas, _ = prepare_serving(npz, pool="mean", device="cpu",
                                                portable=True)
    assert cfg.attention_impl == variant and canvas == 82
    with torch.no_grad():
        got = fwd(p, torch.from_numpy(u8)).numpy()
    jfwd, jp, jcfg_native, *_ = jprepare(jdir, pool="mean", portable=False)
    ref = np.asarray(jfwd(jp, jnp.asarray(u8)))
    assert jcfg_native.attention_impl == variant
    _close(got, ref, "float32")
    _, _, jcfg_portable, *_ = jprepare(jdir, pool="mean", portable=True)
    assert jcfg_portable.attention_impl == "xla"   # the JAX fault, not carried
    jexact, jpe, *_ = jprepare(jdir, pool="mean", portable=True)
    assert np.abs(np.asarray(jexact(jpe, jnp.asarray(u8))) - ref).max() > 1e-3


def test_portable_serving_still_swaps_a_kernel_for_the_plain_version(tmp_path):
    from cross_scale_mae_torch.serving import prepare_serving

    _, _, cfg, *_ = prepare_serving(_port_npz(tmp_path, "pallas_v3"), device="cpu",
                                    portable=True)
    assert cfg.attention_impl == "xla"


# ---------------------------------------------------------------- CLIs


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_runs_through_every_cli(tmp_path, variant, capsys):
    """``--attn_name`` <variant> through the pretrain CLI (2 steps and a
    checkpoint), then its checkpoint through finetuning and the linear
    probe (``--attention``), embedding, the torch.export artifact (its
    reload checked by the CLI itself), a served dispatch and evalviz, each
    on the variant: linformer's E and F carried from the pretrain run into
    the classifier."""
    from cross_scale_mae_torch.cli import embed, evalviz, export, finetune, linprobe
    from cross_scale_mae_torch.cli import pretrain
    from cross_scale_mae_torch.serving import build_serving_model

    out = tmp_path / "pre"
    res = pretrain.main(pretrain.get_args_parser().parse_args([
        "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "40", "--patch_size", "8",
        "--batch_size", "4", "--synthetic_len", "8", "--epochs", "1", "--warmup_epochs", "0",
        "--device", "cpu", "--attn_name", variant, "--output_dir", str(out)]))
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))
    ckpt = os.path.join(res["output_dir"], "checkpoints")
    assert json.load(open(os.path.join(res["output_dir"], "config.json"))
                     )["attention_impl"] == variant
    small = ["--model", "vit_base_patch16", "--embed_dim", "128", "--depth", "4",
             "--num_heads", "8", "--input_size", "40", "--patch_size", "8", "--device", "cpu",
             "--attention", variant, "--finetune", ckpt]
    ft_argv = small + ["--batch_size", "4", "--synthetic_len", "8", "--nb_classes", "3",
                       "--epochs", "1", "--warmup_epochs", "0",
                       "--output_dir", str(tmp_path / "ft")]
    ft = finetune.build_run(finetune.get_args_parser().parse_args(ft_argv))
    assert ft.cfg.attention_impl == variant
    if variant == "linformer":
        from cross_scale_mae_torch.utils.checkpoint import read_host_checkpoint

        _, tree, _, _ = read_host_checkpoint(ckpt)
        np.testing.assert_array_equal(
            ft.state.params["blocks"][3]["attn"]["e_proj"].detach().numpy(),
            tree["encoder_blocks"]["attn"]["e_proj"][3])
    r = finetune.main(finetune.get_args_parser().parse_args(ft_argv))
    assert r["steps"] == 2 and np.isfinite(r["eval"]["loss"])
    lp = linprobe.main(linprobe.get_args_parser().parse_args(
        small + ["--batch_size", "4", "--dataset_type", "synthetic", "--synthetic_len", "8",
                 "--nb_classes", "3", "--epochs", "1", "--warmup_epochs", "0",
                 "--output_dir", str(tmp_path / "lp")]))
    assert lp["run"].cfg.attention_impl == variant and lp["steps"] == 2
    emb = embed.main(embed.get_args_parser().parse_args(
        ["--ckpt", ckpt, "--dataset_type", "synthetic", "--synthetic_len", "5",
         "--batch_size", "4", "--device", "cpu", "--pool", "mean",
         "--output_dir", str(tmp_path / "emb")]))
    feats = np.load(tmp_path / "emb" / "features.npy")
    assert emb["count"] == 5 and feats.shape == (5, 128) and np.isfinite(feats).all()
    meta = export.main(export.get_args_parser().parse_args(
        ["--ckpt", ckpt, "--output", str(tmp_path / "a.pt2"), "--platforms", "cpu",
         "--batch_size", "2", "--pool", "mean"]))
    assert meta["verified"] == "roundtrip"
    assert meta["model_config"]["attention_impl"] == variant
    served = build_serving_model(ckpt, pool="mean", batch_size=2, device="cpu")
    u8 = np.random.default_rng(0).integers(0, 256, (2, 46, 46, 3), np.uint8)
    reloaded = torch.export.load(str(tmp_path / "a.pt2")).module()
    np.testing.assert_allclose(reloaded(torch.from_numpy(u8)).float().numpy(), served.fn(u8),
                               rtol=3e-2, atol=3e-2)   # bf16, the CLI's own bound
    sweep = evalviz.main(evalviz.get_args_parser().parse_args(
        ["--ckpt", ckpt, "--device", "cpu", "--out", str(tmp_path / "viz")]))
    run_name = os.path.basename(res["output_dir"])   # evalviz names a model by its run
    assert all(np.isfinite(v) for v in sweep[run_name].values())
    assert os.path.exists(tmp_path / "viz" / f"{run_name}_img0.png")
    capsys.readouterr()
