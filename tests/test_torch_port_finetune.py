"""The PyTorch port's finetune path (cross_scale_mae_torch: configs, the
'pallas'/'pallas_t' attention, models/vit.py, train/mixup.py,
train/optim.py layer decay, the finetune augmentation, train/classify.py,
utils/metrics.py, the classifier weight carry and cli/finetune.py) held
against the JAX package on the CPU, on the same inputs and weights.

On the CPU the port's K2 wrappers run their plain versions; the JAX side
runs the Pallas kernels in interpret mode, as its own tests do. JAX's key
splits cannot be reproduced in torch, so the tests rebuild the JAX draws
(flips, crop boxes, drop-path masks) from the JAX keys in the JAX order and
hand them to the port.

Tolerances: fp32 1e-5 (sums in another order) unless a test says
otherwise; bf16 bounds are stated where used.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_torch import configs as pcfg
from cross_scale_mae_torch.utils import params as pparams

# The lockstep's tiny classifier: depth 2, D 32, 4 heads, 16 px, patch 4.
TINY = dict(input_size=16, patch_size=4, embed_dim=32, depth=2, num_heads=4,
            num_classes=7, compute_dtype="float32", attention_impl="pallas")


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return (jcfg.get_vit_config("vit_base_patch16", **kw),
            pcfg.get_vit_config("vit_base_patch16", **kw))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _assert_tree_close(got, ref, atol, rel=False):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_g) == len(flat_r)
    for path, g in flat_g:
        r = np.asarray(flat_r[path])
        tol = atol * max(1.0, float(np.abs(r).max())) if rel else atol
        np.testing.assert_allclose(np.asarray(g), r, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _jax_vit(jc, seed=0):
    from cross_scale_mae_tpu.models import vit_init as jinit

    params, state = jinit(jax.random.key(seed), jc)
    # Non-zero biases and norms, so that no parameter is a constant a wrong
    # mapping could hide behind.
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith(("'bias']", "'scale']")) else a, params)
    return params, state


def _jax_drop_masks(key, jc, n):
    """The keep masks ``_drop_path_scan`` draws from ``key`` (vit.py:83-93)."""
    rates = jnp.asarray(np.linspace(0.0, jc.drop_path_rate, jc.depth), jnp.float32)
    keys = jax.random.split(key, jc.depth)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.bernoulli(keys[i], 1.0 - rates[i], (n, 1, 1))).reshape(n)
        for i in range(jc.depth)]))


# ---------------------------------------------------------------- configs


def test_vit_config_fields_and_json_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.ViTClassifierConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pcfg.ViTClassifierConfig)}
    assert jf == pf
    j = jcfg.get_vit_config("vit_large_patch16", input_size=64, patch_size=8,
                            num_classes=62, global_pool=True, attention_impl="pallas")
    back = pcfg.ViTClassifierConfig.from_json(j.to_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(j)
    assert jcfg.ViTClassifierConfig.from_json(back.to_json()) == j
    assert (back.num_patches, back.depth, back.embed_dim) == (64, 24, 1024)


@pytest.mark.parametrize("name", ["vit_base_patch16", "vit_large_patch16", "vit_huge_patch14"])
def test_vit_presets_match_jax(name):
    assert (dataclasses.asdict(pcfg.get_vit_config(name, num_classes=3))
            == dataclasses.asdict(jcfg.get_vit_config(name, num_classes=3)))
    with pytest.raises(ValueError, match="unknown classifier"):
        pcfg.get_vit_config("vit_giant")


# ---------------------------------------------------------------- attention


def _attn_params(d, seed):
    rng = np.random.default_rng(seed)
    return {"qkv": {"kernel": rng.normal(size=(d, 3 * d)).astype(np.float32) / d ** 0.5,
                    "bias": 0.1 * rng.normal(size=(3 * d,)).astype(np.float32)},
            "proj": {"kernel": rng.normal(size=(d, d)).astype(np.float32) / d ** 0.5,
                     "bias": 0.1 * rng.normal(size=(d,)).astype(np.float32)}}


@pytest.mark.parametrize("impl", ["pallas", "pallas_t"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_k2_paths_match_jax(impl, dtype):
    """layers.attention with 'pallas' (qkv slices folded) and 'pallas_t'
    (head-major einsums, layers.py:115-143) against the JAX block, forward
    and input gradient. bf16: both sides round the qkv and proj products
    and the kernel output; 2**-6 of the largest magnitude (two bf16 ulps)."""
    from cross_scale_mae_tpu.models import layers as jl
    from cross_scale_mae_torch.models import layers as pl_

    n, l, d, h = 2, 17, 64, 4
    p = _attn_params(d, 3)
    x = np.random.default_rng(4).normal(size=(n, l, d)).astype(np.float32)
    g = np.random.default_rng(5).normal(size=(n, l, d)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jax.tree.map(jnp.asarray, p)
    ref, vjp = jax.vjp(lambda a: jl.attention(jp, a, h, impl), jnp.asarray(x, jdt))
    (ref_dx,) = vjp(jnp.asarray(g, jdt))
    leaf = _t(x, tdt).requires_grad_(True)
    got = pl_.attention(jax.tree.map(_t, p), leaf, h, impl)
    got.backward(_t(g, tdt))
    for a, r in ((got, ref), (leaf.grad, ref_dx)):
        r = np.asarray(r.astype(jnp.float32))
        assert a.dtype == tdt
        atol = 1e-5 if dtype == "float32" else 2.0 ** -6 * max(1.0, np.abs(r).max())
        np.testing.assert_allclose(a.detach().float().numpy(), r, rtol=0, atol=atol)


def test_attention_pallas_runs_the_k2_wrapper(monkeypatch):
    """'pallas' and 'pallas_t' reach the K2 autograd node (the kernels on a
    CUDA tensor), not the v3 one."""
    from cross_scale_mae_torch.models import layers as pl_
    from cross_scale_mae_torch.ops import attention as pa

    calls = []
    real = pa._MhaFolded.apply
    monkeypatch.setattr(pa._MhaFolded, "apply", lambda *a: calls.append(1) or real(*a))
    p = jax.tree.map(_t, _attn_params(32, 1))
    x = torch.randn(2, 5, 32, requires_grad=True)
    for impl in ("pallas", "pallas_t"):
        pl_.attention(p, x, 4, impl).sum().backward()
    assert len(calls) == 2


# ---------------------------------------------------------------- the model


def test_vit_init_matches_jax_tree_shapes():
    from cross_scale_mae_tpu.models import vit_init as jinit
    from cross_scale_mae_torch.models.vit import vit_init

    for pool in (True, False):
        jc, pc = _cfgs(global_pool=pool, use_bn_head=True)
        jp, js = jinit(jax.random.key(0), jc)
        pp, ps = vit_init(pc, torch.Generator().manual_seed(0))
        assert (jax.tree.map(np.shape, _tree_np(pparams.params_to_jax(pp)))
                == jax.tree.map(np.shape, _tree_np(jp)))
        assert jax.tree.map(np.shape, pparams.params_to_jax(ps)) == jax.tree.map(np.shape, js)
        np.testing.assert_array_equal(pp["pos_embed"].numpy(), np.asarray(jp["pos_embed"]))
        head = pp["head"]["kernel"]
        assert float(head.abs().max()) <= 0.04 and float(head.std()) > 0.005


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_vit_apply_matches_jax_fp32(pool, train):
    """Eval mode, and train mode with the JAX drop-path masks injected
    (drop_path 0.5 so that several samples lose a block), fp32 1e-5."""
    from cross_scale_mae_tpu.models.vit import vit_apply as japply
    from cross_scale_mae_torch.models.vit import vit_apply

    jc, pc = _cfgs(global_pool=pool, drop_path_rate=0.5)
    params, state = _jax_vit(jc)
    imgs = np.random.default_rng(6).normal(size=(8, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(9)
    ref, _ = japply(params, state, jc, jnp.asarray(imgs), train=train, rng=key)
    masks = _jax_drop_masks(key, jc, 8) if train else None
    if train:
        assert not bool(masks.all())
    got, _ = vit_apply(pparams.vit_params_from_jax(_tree_np(params), pc), {}, pc, _t(imgs),
                       train=train, drop_masks=masks)
    assert got.dtype == torch.float32 and got.shape == (8, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_vit_apply_matches_jax_bf16():
    """bf16 with the K2 attention: both sides round every product and the
    LayerNorm outputs to bf16 and differ by an ulp where fp32 sums taken in
    another order land on a rounding boundary; GELU differs within its
    stated budget (ROADMAP.md queue 3). Held to 2**-4 of the largest logit
    and 2**-7 of the mean magnitude, the port's bf16 encoder budget."""
    from cross_scale_mae_tpu.models.vit import vit_apply as japply
    from cross_scale_mae_torch.models.vit import vit_apply

    jc, pc = _cfgs(compute_dtype="bfloat16")
    params, state = _jax_vit(jc, seed=1)
    imgs = np.random.default_rng(7).normal(size=(6, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(japply(params, state, jc, jnp.asarray(imgs))[0])
    got, _ = vit_apply(pparams.vit_params_from_jax(_tree_np(params), pc), {}, pc, _t(imgs))
    err = np.abs(got.numpy() - ref)
    assert err.max() <= 2.0 ** -4 * max(1.0, np.abs(ref).max())
    assert err.mean() <= 2.0 ** -7 * max(1.0, np.abs(ref).mean())


@pytest.mark.parametrize("train", [True, False])
def test_vit_apply_bn_head_and_frozen_backbone_match_jax(train):
    from cross_scale_mae_tpu.models.vit import vit_apply as japply
    from cross_scale_mae_torch.models.vit import vit_apply

    jc, pc = _cfgs(use_bn_head=True, attention_impl="xla")
    params, _ = _jax_vit(jc, seed=2)
    rng = np.random.default_rng(8)
    state = {"head_bn": {"mean": rng.normal(size=(32,)).astype(np.float32),
                         "var": rng.uniform(0.5, 2.0, size=(32,)).astype(np.float32)}}
    imgs = rng.normal(size=(5, 16, 16, 3)).astype(np.float32)

    def jloss(p):
        logits, new = japply(p, jax.tree.map(jnp.asarray, state), jc, jnp.asarray(imgs),
                             train=train, freeze_backbone=True)
        return jnp.sum(logits ** 2), (logits, new)

    (_, (ref, ref_state)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    from cross_scale_mae_torch.train.state import tree_leaves

    pp = pparams.vit_params_from_jax(_tree_np(params), pc)
    for leaf in tree_leaves(pp):
        leaf.requires_grad_(True)
    got, new_state = vit_apply(pp, jax.tree.map(_t, state), pc, _t(imgs), train=train,
                               freeze_backbone=True)
    got.square().sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    _assert_tree_close(jax.tree.map(lambda t: t.detach().numpy(), new_state),
                       _tree_np(ref_state), 1e-5)
    # The frozen backbone gets no gradient; the head gets JAX's.
    assert pp["blocks"][0]["attn"]["qkv"]["kernel"].grad is None
    np.testing.assert_allclose(pp["head"]["kernel"].grad.numpy(),
                               np.asarray(jgrads["head"]["kernel"]), rtol=1e-4, atol=1e-4)


def test_vit_apply_needs_drop_masks_in_training():
    from cross_scale_mae_torch.models.vit import vit_apply, vit_init

    _, pc = _cfgs(drop_path_rate=0.1)
    params, state = vit_init(pc, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="keep masks"):
        vit_apply(params, state, pc, torch.zeros(2, 16, 16, 3), train=True)


# ---------------------------------------------------------------- weights


def test_vit_weight_carry_round_trips_and_checks():
    jc, pc = _cfgs(global_pool=False)
    params, _ = _jax_vit(jc)
    tree = _tree_np(params)
    port = pparams.vit_params_from_jax(tree, pc)
    assert len(port["blocks"]) == 2 and "norm" in port
    _assert_tree_close(pparams.params_to_jax(port), tree, 0.0)
    with pytest.raises(KeyError, match="lacks head"):
        pparams.vit_params_from_jax({k: v for k, v in tree.items() if k != "head"}, pc)
    with pytest.raises(KeyError, match="unexpected"):
        pparams.vit_params_from_jax({**tree, "extra": np.zeros(1)}, pc)
    bad = dict(tree, cls_token=np.zeros((1, 1, 16), np.float32))
    with pytest.raises(ValueError, match="cls_token"):
        pparams.vit_params_from_jax(bad, pc)


@pytest.mark.parametrize("pool", [True, False])
def test_encoder_to_classifier_and_merge_match_jax(pool):
    from cross_scale_mae_tpu.models import mae_init as jmae_init
    from cross_scale_mae_tpu.utils.torch_import import mae_encoder_to_classifier as jto
    from cross_scale_mae_tpu.utils.torch_import import merge_pretrained as jmerge

    mae_kw = dict(input_size=16, patch_size=4, dim_model=32, encoder_num_layers=2,
                  encoder_num_heads=4, decoder_embed_dim=16, decoder_num_layers=1,
                  decoder_num_heads=4, apply_encoder_norm=True)
    jm = jcfg.get_mae_config("mae_vit_tiny", **mae_kw)
    pm = pcfg.get_mae_config("mae_vit_tiny", **mae_kw)
    mae_params, _ = jmae_init(jax.random.key(3), jm)
    jc, pc = _cfgs(global_pool=pool)
    template, _ = _jax_vit(jc, seed=4)
    jpre, jmissing = jto(mae_params, jc)
    ref = jmerge(template, jpre)

    port_mae = pparams.params_from_jax(_tree_np(mae_params), pm)
    ppre, pmissing = pparams.mae_encoder_to_classifier(port_mae, pc)
    assert pmissing == jmissing
    got = pparams.merge_pretrained(pparams.vit_params_from_jax(_tree_np(template), pc), ppre)
    _assert_tree_close(pparams.params_to_jax(got), _tree_np(ref), 0.0)


def test_merge_pretrained_names_the_misfit_parameter():
    from cross_scale_mae_tpu.utils.torch_import import merge_pretrained as jmerge

    _, pc = _cfgs()
    jc_wide, pc_wide = _cfgs(embed_dim=64)
    template = pparams.vit_params_from_jax(_tree_np(_jax_vit(_cfgs()[0])[0]), pc)
    wide = _tree_np(_jax_vit(jc_wide)[0])
    pre = {"cls_token": wide["cls_token"]}
    with pytest.raises(ValueError, match="'cls_token' has shape") as jerr:
        jmerge(pparams.params_to_jax(template), pre)
    with pytest.raises(ValueError, match="'cls_token' has shape") as perr:
        pparams.merge_pretrained(template, {"cls_token": _t(pre["cls_token"])})
    assert str(perr.value) == str(jerr.value)
    deep = pparams.vit_params_from_jax(_tree_np(_jax_vit(_cfgs(depth=3)[0])[0]),
                                       _cfgs(depth=3)[1])
    with pytest.raises(ValueError, match="'blocks' has 3 layers"):
        pparams.merge_pretrained(template, {"blocks": deep["blocks"]})


# ---------------------------------------------------------------- optimizer


def _vit_tree_np():
    return _tree_np(_jax_vit(_cfgs(global_pool=True)[0])[0])


def _jax_leaf(tree, path):
    """The JAX tree's entry for a port leaf path (block index dropped: the
    JAX block leaves are stacked), and the index."""
    index = path[1] if path[0] == "blocks" else None
    for k in (path[0], *path[2:]) if index is not None else path:
        tree = tree[k]
    return tree, index


def test_wd_mask_with_no_decay_names_matches_jax():
    from cross_scale_mae_tpu.train.optim import wd_mask as jmask
    from cross_scale_mae_torch.train.optim import wd_mask
    from cross_scale_mae_torch.train.state import tree_items

    tree = _vit_tree_np()
    port = pparams.vit_params_from_jax(tree, _cfgs(global_pool=True)[1])
    for names in ((), ("pos_embed", "cls_token")):
        ref = jmask(tree, extra_no_decay=names)
        got = wd_mask(port, names)
        for (path, _), decay in zip(tree_items(port), got):
            assert decay == bool(_jax_leaf(ref, path)[0]), path
    assert wd_mask(port, ("pos_embed",)).count(True) == wd_mask(port).count(True) - 1


def test_layer_decay_scales_match_jax():
    from cross_scale_mae_tpu.train.optim import layer_decay_scales as jscales
    from cross_scale_mae_torch.train.optim import layer_decay_scales
    from cross_scale_mae_torch.train.state import tree_items

    tree = _vit_tree_np()
    port = pparams.vit_params_from_jax(tree, _cfgs(global_pool=True)[1])
    ref = jscales(tree, 0.75, 2)
    got = layer_decay_scales(port, 0.75, 2)
    for (path, _), s in zip(tree_items(port), got):
        r, index = _jax_leaf(ref, path)
        r = np.asarray(r).reshape(-1)[index] if index is not None else float(r)
        assert s == pytest.approx(float(r), rel=1e-7), path
    assert sorted(set(got)) == pytest.approx([0.75 ** 3, 0.75 ** 2, 0.75, 1.0])


def test_adamw_with_layer_decay_matches_optax_chain():
    """Three updates of the port's AdamW (b2 0.999, layer decay 0.75, the
    finetune no-decay names, clipping) against the JAX build_optimizer
    chain on a classifier tree, fp32 1e-6."""
    import optax

    from cross_scale_mae_tpu.train.optim import build_optimizer as jopt
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import tree_leaves

    tree = _vit_tree_np()
    _, pc = _cfgs(global_pool=True)
    sched = lambda s: 1e-2 * (s + 1)  # noqa: E731
    kw = dict(weight_decay=0.1, b1=0.9, b2=0.999, clip_grad=5.0, layer_decay=0.75,
              depth=2, no_decay_names=("pos_embed", "cls_token"))
    jp = jax.tree.map(jnp.asarray, tree)
    jtx = jopt(jp, sched, **kw)
    js = jtx.init(jp)
    pp = pparams.vit_params_from_jax(tree, pc)
    tx = build_optimizer(pp, sched, **kw)
    ps = tx.init(pp)
    rng = np.random.default_rng(3)
    for k in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (k + 1)).astype(np.float32),
                         tree)
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        pg = pparams.vit_params_from_jax(g, pc)
        tx.update(tree_leaves(pp), tree_leaves(pg), ps)
    _assert_tree_close(pparams.params_to_jax(pp), _tree_np(jp), 1e-6)


def test_layer_decay_needs_depth():
    from cross_scale_mae_torch.train.optim import build_optimizer

    with pytest.raises(ValueError, match="depth"):
        build_optimizer({"w": {"kernel": torch.zeros(2, 2)}}, lambda s: 0.0, layer_decay=0.75)


# The leaves a frozen mask trains in the optimizer tests below: the head and
# the final norm (the blocks, patch embedding and tokens stay frozen).
TRAINED = ("head", "fc_norm")


def _run_both(kw, steps=4, trained=None, tx_hook=None):
    """``steps`` updates of the JAX build_optimizer chain and of the port's
    on the tiny classifier tree, with the same random gradients (frozen
    leaves' gradients None on the port's side, as a frozen backbone's
    stay). Returns the port's params in the JAX layout, the JAX params, the
    port's state and the JAX state."""
    import optax

    from cross_scale_mae_tpu.train.optim import build_optimizer as jopt
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import tree_items, tree_leaves, tree_like

    tree = _vit_tree_np()
    _, pc = _cfgs(global_pool=True)
    sched = lambda s: 1e-2 * (s + 1)  # noqa: E731
    jp = jax.tree.map(jnp.asarray, tree)
    pp = pparams.vit_params_from_jax(tree, pc)
    jmask = pmask = None
    if trained is not None:
        jmask = {k: jax.tree.map(lambda _: k in trained, v) for k, v in tree.items()}
        pmask = tree_like(pp, [path[0] in trained for path, _ in tree_items(pp)])
    jtx = jopt(jp, sched, frozen_mask=jmask, **kw)
    js = jtx.init(jp)
    tx = build_optimizer(pp, sched, frozen_mask=pmask, **kw)
    if tx_hook is not None:
        tx_hook(tx)
    ps = tx.init(pp)
    rng = np.random.default_rng(7)
    trainable = [True] * len(tree_leaves(pp)) if pmask is None else tree_leaves(pmask)
    for k in range(steps):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (k + 1)).astype(np.float32),
                         tree)
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        grads = [p if t else None
                 for p, t in zip(tree_leaves(pparams.vit_params_from_jax(g, pc)), trainable)]
        tx.update(tree_leaves(pp), grads, ps)
    return pparams.params_to_jax(pp), _tree_np(jp), ps, js


@pytest.mark.parametrize("kw,trained", [
    (dict(), None),
    (dict(clip_grad=0.5, layer_decay=0.75, depth=2), None),
    (dict(clip_grad=0.5), TRAINED),
])
def test_sgd_matches_optax_chain(kw, trained):
    """optax.sgd (momentum 0.9, no decay) after the clip and before the
    layer-decay scale, and under a frozen mask (the clip's norm over the
    trainable leaves), four updates, fp32 1e-6. (Layer decay under a frozen
    mask has no JAX reading: the JAX chain's scale_by_tree raises on
    optax.masked's MaskedNode leaves.)"""
    got, ref, state, _ = _run_both(dict(optimizer="sgd", weight_decay=0.05, **kw),
                                   trained=trained)
    _assert_tree_close(got, ref, 1e-6)
    assert state.count == 4
    if trained is not None:
        tree = _vit_tree_np()
        np.testing.assert_array_equal(got["blocks"]["mlp"]["fc1"]["kernel"],
                                      tree["blocks"]["mlp"]["fc1"]["kernel"])


@pytest.mark.parametrize("kw", [
    dict(clip_grad=0.5),
    dict(clip_grad=0.05, no_decay_names=("pos_embed", "cls_token")),
])
def test_adamw_under_a_frozen_mask_with_clip_matches_optax(kw):
    """AdamW inside optax.masked: the clip's global norm and the moments
    cover the trainable leaves only (a clip of 0.05 binds on them alone),
    and the frozen leaves never move (their updates are zero). Four
    updates, fp32 1e-6; the moments exist for the trainable leaves only."""
    from cross_scale_mae_torch.train.state import tree_leaves

    got, ref, state, _ = _run_both(dict(weight_decay=0.05, b2=0.999, **kw), trained=TRAINED)
    _assert_tree_close(got, ref, 1e-6)
    tree = _vit_tree_np()
    for k in ("blocks", "patch_embed", "cls_token", "pos_embed"):
        _assert_tree_close(got[k], tree[k], 0.0)
    n_trained = len(tree_leaves({k: tree[k] for k in TRAINED}))
    assert len(state.mu) == len(state.nu) == n_trained


# The moment-dtype tests read the gap of all params at once: its mean, and
# the share of elements past 5e-6. In fp32 the chain's sums in another
# order read a mean of 3.6e-7 after six updates of lr up to 0.06; a bf16
# moment whose fp32 sum lands on the other side of a rounding boundary flips
# one ulp (2**-8 of itself), which moves that element's update alone (one
# element in 2048 here, by up to 8.6e-5). The other rounding rule moves
# 97% of the elements past 5e-6, at a mean of 1.7e-4.
MOMENT_MEAN_TOL = 2e-6
MOMENT_SHARE_TOL = 1e-3


def _moment_gaps(got, ref) -> tuple[float, float]:
    a = np.concatenate([np.ravel(x) for x in jax.tree.leaves(got)])
    b = np.concatenate([np.ravel(x) for x in jax.tree.leaves(ref)])
    d = np.abs(a - b)
    return float(d.mean()), float((d > 5e-6).mean())


@pytest.mark.parametrize("mu,nu", [("bfloat16", None), (None, "bfloat16"),
                                   ("bfloat16", "bfloat16"), ("float32", "float32")])
def test_adam_moment_dtypes_match_jax_over_steps(mu, nu):
    """Both rounding rules of the JAX package over 6 updates with clipping
    and layer decay: ``mu_dtype`` alone runs optax.adamw (b1 m in bf16, b1
    rounded to bf16 too, before the fp32 sum), ``nu_dtype`` runs
    scale_by_adam_moment_dtypes (each moment upcast first). JAX's update
    runs eagerly here, the ops' own semantics (under jit XLA may keep the
    bf16 product in fp32). Params within MOMENT_MEAN_TOL and
    MOMENT_SHARE_TOL; the stored moments in their dtype, their summed gap
    within 2**-12 of their summed magnitude in bf16 (rare one-ulp flips),
    1e-5 in fp32."""
    kw = dict(weight_decay=0.05, b2=0.999, clip_grad=5.0, layer_decay=0.75, depth=2,
              mu_dtype=mu, nu_dtype=nu)
    got, ref, state, js = _run_both(kw, steps=6)
    mean, share = _moment_gaps(got, ref)
    assert mean <= MOMENT_MEAN_TOL and share <= MOMENT_SHARE_TOL, (mean, share)
    adam = pparams._adam_state(js)
    _, pc = _cfgs(global_pool=True)
    from cross_scale_mae_torch.train.state import tree_like

    template = pparams.vit_params_from_jax(_vit_tree_np(), pc)
    for name, dtype in (("mu", mu), ("nu", nu)):
        moments = getattr(state, name)
        want = getattr(torch, dtype) if dtype else torch.float32
        assert all(m.dtype == want for m in moments), name
        assert all(np.asarray(m).dtype == (jnp.bfloat16 if dtype == "bfloat16" else np.float32)
                   for m in jax.tree.leaves(adam[name])), name
        ours = np.concatenate([np.ravel(x) for x in jax.tree.leaves(
            pparams.params_to_jax(tree_like(template, moments)))])
        theirs = np.concatenate([np.ravel(x) for x in jax.tree.leaves(_tree_np(adam[name]))])
        rel = np.abs(ours - theirs).sum() / np.abs(theirs).sum()
        assert rel <= (2.0 ** -12 if dtype == "bfloat16" else 1e-5), (name, rel)


def test_the_moment_dtype_check_sees_the_other_rounding_rule():
    """The control of the test above: each bf16-mu case run under the other
    rule misses JAX's params at MOMENT_MEAN_TOL, so the check can tell the
    two rules apart."""
    def other_rule(tx):
        tx.upcast_first = not tx.upcast_first

    for nu in (None, "bfloat16"):
        kw = dict(weight_decay=0.05, b2=0.999, clip_grad=5.0, layer_decay=0.75, depth=2,
                  mu_dtype="bfloat16", nu_dtype=nu)
        got, ref, _, _ = _run_both(kw, steps=6, tx_hook=other_rule)
        mean, share = _moment_gaps(got, ref)
        assert mean > MOMENT_MEAN_TOL and share > MOMENT_SHARE_TOL, (nu, mean, share)


# ---------------------------------------------------------------- losses, augment


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_smooth_one_hot_and_soft_cross_entropy_match_jax(smoothing):
    from cross_scale_mae_tpu.train.mixup import smooth_one_hot as jsmooth
    from cross_scale_mae_tpu.train.mixup import soft_cross_entropy as jce
    from cross_scale_mae_torch.train.mixup import smooth_one_hot, soft_cross_entropy

    rng = np.random.default_rng(10)
    labels = rng.integers(0, 9, 12)
    logits = rng.normal(size=(12, 9)).astype(np.float32) * 3
    ref_t = np.asarray(jsmooth(jnp.asarray(labels), 9, smoothing))
    got_t = smooth_one_hot(torch.from_numpy(labels), 9, smoothing)
    np.testing.assert_allclose(got_t.numpy(), ref_t, rtol=0, atol=1e-7)
    ref = float(jce(jnp.asarray(logits), jnp.asarray(ref_t)))
    got = float(soft_cross_entropy(_t(logits).bfloat16(), got_t))
    ref_bf = float(jce(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(ref_t)))
    assert got == pytest.approx(ref_bf, rel=1e-6)
    assert float(soft_cross_entropy(_t(logits), got_t)) == pytest.approx(ref, rel=1e-6)


def _jax_finetune_augment_draws(key, n, canvas):
    """Flips and crop boxes ``make_finetune_augment``'s augment draws from
    ``key`` (augment.py:98-103, image.py:47-53, 181-198)."""
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes as jboxes

    k_flip, _, k_crop, _, _ = jax.random.split(key, 5)
    kh, kv = jax.random.split(k_flip)
    flips = [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (n,))))
             for k in (kh, kv)]
    return (*flips, _t(jboxes(k_crop, n, canvas, canvas, (0.25, 1.0))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finetune_augment_matches_jax_on_injected_draws(dtype):
    """Flips, bicubic crop, normalize after the crop, cast. bf16: the one
    cast at the end, 2**-8 relative (half an ulp) of the largest value."""
    from cross_scale_mae_tpu.ops.augment import make_finetune_augment as jaug
    from cross_scale_mae_torch.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_torch.ops.augment import make_finetune_augment

    batch = np.random.default_rng(11).integers(0, 256, (6, 20, 20, 3), np.uint8)
    key = jax.random.key(12)
    ref = jaug(FMOW_RGB_MEAN, FMOW_RGB_STD, 16, dtype=dtype)(key, jnp.asarray(batch))
    ref = np.asarray(ref.astype(jnp.float32))
    got = make_finetune_augment(FMOW_RGB_MEAN, FMOW_RGB_STD, 16, dtype=dtype)(
        torch.from_numpy(batch), *_jax_finetune_augment_draws(key, 6, 20))
    assert got.dtype == getattr(torch, dtype) and got.shape == (6, 16, 16, 3)
    atol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


# ---------------------------------------------------------------- eval and metrics


def test_eval_step_matches_jax_on_a_ragged_batch():
    """The eval step on a batch padded to 8 with 5 valid rows (uint8 on a
    1/0.875 canvas through the eval preprocess), against JAX make_eval_step:
    loss, acc1, acc5, n and the confusion matrix."""
    from cross_scale_mae_tpu.ops.augment import make_eval_preprocess as jpre
    from cross_scale_mae_tpu.train.classify import make_eval_step as jeval
    from cross_scale_mae_torch.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_torch.ops.augment import make_eval_preprocess
    from cross_scale_mae_torch.train.classify import make_eval_step

    jc, pc = _cfgs()
    params, state = _jax_vit(jc, seed=5)
    rng = np.random.default_rng(13)
    imgs = rng.integers(0, 256, (8, 18, 18, 3), np.uint8)
    imgs[5:] = 0
    labels = rng.integers(0, 7, 8).astype(np.int32)
    labels[5:] = 0
    valid = np.arange(8) < 5
    ref = jeval(jc, preprocess=jpre(FMOW_RGB_MEAN, FMOW_RGB_STD, 16))(
        params, state, jnp.asarray(imgs), jnp.asarray(labels), jnp.asarray(valid))
    got = make_eval_step(pc, make_eval_preprocess(FMOW_RGB_MEAN, FMOW_RGB_STD, 16))(
        pparams.vit_params_from_jax(_tree_np(params), pc), {}, torch.from_numpy(imgs),
        torch.from_numpy(labels).long(), torch.from_numpy(valid))
    for k in ("loss", "acc1", "acc5", "n"):
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-5, abs=1e-6), k
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(ref["cm"]))
    assert float(got["cm"].sum()) == 5
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(ref["logits"]), atol=1e-5)


def test_confusion_matrix_matches_jax():
    from cross_scale_mae_tpu.utils.metrics import ConfusionMatrix as JCM
    from cross_scale_mae_torch.utils.metrics import ConfusionMatrix

    rng = np.random.default_rng(14)
    j, p = JCM(6), ConfusionMatrix(6)
    for _ in range(3):
        labels, preds = rng.integers(0, 5, 40), rng.integers(0, 6, 40)
        j.update(preds, labels)
        p.update(preds, labels)
    np.testing.assert_array_equal(p.mat, j.mat)
    assert p.accuracy == j.accuracy
    for avg in ("macro", "micro"):
        assert p.f1(avg) == j.f1(avg)
    assert p.miou() == j.miou() and ConfusionMatrix(3).miou() == 0.0


def test_metric_logger_smooths():
    from cross_scale_mae_torch.utils.metrics import MetricLogger

    m = MetricLogger()
    for v in (1.0, 2.0, 6.0):
        m.update(loss=v)
    assert str(m) == "loss: 2.0000 (3.0000)"


# ---------------------------------------------------------------- the step


def test_classify_train_step_10_step_lockstep_with_jax():
    """The port's make_classify_train_step against the JAX one for 10 steps
    on the tiny classifier (fp32, 'pallas' on both sides, drop_path 0.1,
    smoothing 0.1, AdamW b2 0.999 with layer decay 0.75 and the finetune
    no-decay names, uint8 input through the finetune augmentation), from the
    same weights, with the JAX draws of every step injected: fold_in(rng,
    step), split 3 (classify.py:59, 84), the augment's split 5
    (augment.py:98) and the drop-path split (vit.py:83-93)."""
    from cross_scale_mae_tpu.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_tpu.ops.augment import make_finetune_augment as jaug
    from cross_scale_mae_tpu.train import TrainState as JState
    from cross_scale_mae_tpu.train import build_optimizer as jopt
    from cross_scale_mae_tpu.train import warmup_half_cosine as jsched
    from cross_scale_mae_tpu.train.classify import make_classify_train_step as jstep_fn
    from cross_scale_mae_torch.ops.augment import make_finetune_augment
    from cross_scale_mae_torch.train.classify import FinetuneDraws, make_classify_train_step
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.schedule import warmup_half_cosine
    from cross_scale_mae_torch.train.state import TrainState

    jc, pc = _cfgs(drop_path_rate=0.1, global_pool=True)
    n, steps, canvas = 8, 10, 20
    sched_args = (1e-3, 1e-6, 1, 3, 4)
    opt_kw = dict(weight_decay=0.05, b1=0.9, b2=0.999, layer_decay=0.75, depth=2,
                  no_decay_names=("pos_embed", "cls_token"))
    tkw = dict(batch_size=n, label_smoothing=0.1, layer_decay=0.75)
    params, mstate = _jax_vit(jc, seed=6)
    jstate = JState.create(params, mstate, jopt(params, jsched(*sched_args), **opt_kw))
    jstep = jstep_fn(jc, jcfg.TrainConfig(**tkw), jsched(*sched_args), donate=False,
                     augment=jaug(FMOW_RGB_MEAN, FMOW_RGB_STD, 16, dtype="float32"))

    sched = warmup_half_cosine(*sched_args)
    pp = pparams.vit_params_from_jax(_tree_np(params), pc)
    pstate = TrainState.create(pp, {}, build_optimizer(pp, sched, **opt_kw))
    pstep = make_classify_train_step(pc, pcfg.TrainConfig(**tkw), sched,
                                     augment=make_finetune_augment(
                                         FMOW_RGB_MEAN, FMOW_RGB_STD, 16, dtype="float32"))

    rng_np = np.random.default_rng(15)
    batch = rng_np.integers(0, 256, (n, canvas, canvas, 3), np.uint8)
    labels = rng_np.integers(0, 7, n).astype(np.int32)
    rng = jax.random.key(16)
    jl, pl, gn = [], [], []
    for step in range(steps):
        k_aug, _, k_model = jax.random.split(jax.random.fold_in(rng, step), 3)
        draws = FinetuneDraws(*_jax_finetune_augment_draws(k_aug, n, canvas),
                              _jax_drop_masks(k_model, jc, n))
        jstate, jm = jstep(jstate, jnp.asarray(batch), jnp.asarray(labels), rng)
        pstate, pm = pstep(pstate, torch.from_numpy(batch), torch.from_numpy(labels).long(),
                           draws)
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
        gn.append((float(pm["grad_norm"]), float(jm["grad_norm"])))
        assert pm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(pm["acc1"]) == pytest.approx(float(jm["acc1"]), abs=1e-6)

    np.testing.assert_allclose(pl, jl, rtol=3e-4)
    np.testing.assert_allclose(*zip(*gn), rtol=1e-3)
    assert pstate.step == int(jstate.step) == steps
    _assert_tree_close(pparams.params_to_jax(pstate.params), _tree_np(jstate.params), 5e-4)
    assert pl[-1] < pl[0]


RECIPES = {
    # scripts/finetune.sh's mixup/cutmix, the reference finetune's --aa and
    # --reprob defaults (ops/randaug.py:252-253 of the JAX package).
    "randaug": (dict(mixup=0.8, cutmix=1.0),
                dict(aa="rand-m9-mstd0.5-inc1", reprob=0.25)),
    "jitter": (dict(mixup=0.8, cutmix=1.0, mixup_mode="elem"),
               dict(color_jitter=0.4, reprob=0.25, remode="const", recount=2)),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_classify_train_step_recipe_10_step_lockstep_with_jax(recipe):
    """The sibling of the lockstep above with the whole finetuning recipe:
    Mixup 0.8 / CutMix 1.0 after the augment, RandAugment
    rand-m9-mstd0.5-inc1 and RandomErasing 0.25 (or ColorJitter 0.4 with
    const erasing of 2 rectangles, Mixup per element), 10 steps against
    the JAX step, every draw of every step injected: the augment's from
    k_aug (flips, crop, RandAugment or jitter, erasing), the mix's from
    k_mix (mixup.py:118-170), the drop-path masks from k_model. The same
    tolerances as the plain lockstep."""
    from tests.test_torch_port_mixup import _jax_mix_draws
    from tests.test_torch_port_randaug import _jax_chain_draws

    from cross_scale_mae_tpu.data.datasets import FMOW_RGB_MEAN, FMOW_RGB_STD
    from cross_scale_mae_tpu.ops.augment import make_finetune_augment as jaug
    from cross_scale_mae_tpu.train import TrainState as JState
    from cross_scale_mae_tpu.train import build_optimizer as jopt
    from cross_scale_mae_tpu.train import warmup_half_cosine as jsched
    from cross_scale_mae_tpu.train.classify import make_classify_train_step as jstep_fn
    from cross_scale_mae_torch.ops.augment import make_finetune_augment
    from cross_scale_mae_torch.train.classify import FinetuneDraws, make_classify_train_step
    from cross_scale_mae_torch.train.mixup import MixupConfig
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.schedule import warmup_half_cosine
    from cross_scale_mae_torch.train.state import TrainState

    mix_kw, aug_kw = RECIPES[recipe]
    jc, pc = _cfgs(drop_path_rate=0.1, global_pool=True)
    n, steps, canvas, size = 8, 10, 20, 16
    sched_args = (1e-3, 1e-6, 1, 3, 4)
    opt_kw = dict(weight_decay=0.05, b1=0.9, b2=0.999, layer_decay=0.75, depth=2,
                  no_decay_names=("pos_embed", "cls_token"))
    tkw = dict(batch_size=n, label_smoothing=0.1, layer_decay=0.75, **mix_kw)
    params, mstate = _jax_vit(jc, seed=6)
    jstate = JState.create(params, mstate, jopt(params, jsched(*sched_args), **opt_kw))
    jstep = jstep_fn(jc, jcfg.TrainConfig(**tkw), jsched(*sched_args), donate=False,
                     augment=jaug(FMOW_RGB_MEAN, FMOW_RGB_STD, size, dtype="float32", **aug_kw))

    sched = warmup_half_cosine(*sched_args)
    pp = pparams.vit_params_from_jax(_tree_np(params), pc)
    pstate = TrainState.create(pp, {}, build_optimizer(pp, sched, **opt_kw))
    ptcfg = pcfg.TrainConfig(**tkw)
    pstep = make_classify_train_step(pc, ptcfg, sched, augment=make_finetune_augment(
        FMOW_RGB_MEAN, FMOW_RGB_STD, size, dtype="float32", **aug_kw))
    mcfg = MixupConfig.from_train_config(ptcfg)

    rng_np = np.random.default_rng(15)
    batch = rng_np.integers(0, 256, (n, canvas, canvas, 3), np.uint8)
    labels = rng_np.integers(0, 7, n).astype(np.int32)
    rng = jax.random.key(16)
    jl, pl, gn = [], [], []
    for step in range(steps):
        k_aug, k_mix, k_model = jax.random.split(jax.random.fold_in(rng, step), 3)
        base, extra = _jax_chain_draws(
            k_aug, n, canvas, size, 3, aa=aug_kw.get("aa"), jitter=aug_kw.get("color_jitter"),
            reprob=aug_kw["reprob"], remode=aug_kw.get("remode", "pixel"),
            recount=aug_kw.get("recount", 1))
        draws = FinetuneDraws(*base[:3], _jax_drop_masks(k_model, jc, n), **extra,
                              mixup=_jax_mix_draws(k_mix, n, mcfg))
        jstate, jm = jstep(jstate, jnp.asarray(batch), jnp.asarray(labels), rng)
        pstate, pm = pstep(pstate, torch.from_numpy(batch), torch.from_numpy(labels).long(),
                           draws)
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
        gn.append((float(pm["grad_norm"]), float(jm["grad_norm"])))
        assert pm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(pm["acc1"]) == pytest.approx(float(jm["acc1"]), abs=1e-6)

    np.testing.assert_allclose(pl, jl, rtol=3e-4)
    np.testing.assert_allclose(*zip(*gn), rtol=1e-3)
    assert pstate.step == int(jstate.step) == steps
    _assert_tree_close(pparams.params_to_jax(pstate.params), _tree_np(jstate.params), 5e-4)


def test_classify_step_accumulates_microbatches():
    """accum_iter=2: the loss is the mean of the two microbatches', and the
    gradient norm no larger than the larger of theirs."""
    from cross_scale_mae_torch.models.vit import vit_init
    from cross_scale_mae_torch.train.classify import make_classify_train_step, sample_finetune_draws
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import TrainState, tree_leaves

    _, pc = _cfgs(drop_path_rate=0.1, attention_impl="xla")
    imgs = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 16, 16, 3)).astype(np.float32))
    labels = torch.tensor([0, 3, 5, 6])
    gen = torch.Generator().manual_seed(5)
    draws = [sample_finetune_draws(gen, 2, pc, 16) for _ in range(2)]
    assert draws[0].drop_masks.shape == (2, 2) and draws[0].crop_boxes.shape == (2, 4)
    tc = pcfg.TrainConfig(batch_size=2, accum_iter=2)

    def fresh():
        params, state = vit_init(pc, torch.Generator().manual_seed(0))
        return TrainState.create(params, state, build_optimizer(params, lambda s: 0.0))

    parts = [make_classify_train_step(pc, tc.replace(accum_iter=1), lambda s: 0.0)(
        fresh(), imgs[i * 2:(i + 1) * 2], labels[i * 2:(i + 1) * 2], draws[i])[1]
        for i in range(2)]
    st = fresh()
    _, m = make_classify_train_step(pc, tc, lambda s: 0.0)(st, imgs, labels, draws)
    assert float(m["loss"]) == pytest.approx(np.mean([float(p["loss"]) for p in parts]), rel=1e-5)
    assert float(m["grad_norm"]) <= max(float(p["grad_norm"]) for p in parts) * (1 + 1e-5)
    assert st.step == 1 and all(p.grad is None for p in tree_leaves(st.params))
    with pytest.raises(ValueError, match="accum_iter"):
        make_classify_train_step(pc, tc, lambda s: 0.0)(st, imgs, labels, draws[:1])


# ---------------------------------------------------------------- the CLI


def _ft_args(tmp_path, *extra):
    from cross_scale_mae_torch.cli.finetune import get_args_parser

    return get_args_parser().parse_args([
        "--model", "vit_base_patch16", "--embed_dim", "128", "--depth", "4",
        "--num_heads", "8", "--input_size", "32", "--patch_size", "8",
        "--batch_size", "4", "--synthetic_len", "12", "--nb_classes", "5",
        "--epochs", "2", "--warmup_epochs", "1", "--device", "cpu",
        "--log_interval", "1", "--output_dir", str(tmp_path / "ft"), *extra])


def test_finetune_cli_trains_from_a_pretrain_npz_and_evaluates(tmp_path, capsys):
    from cross_scale_mae_torch.cli.finetune import main
    from cross_scale_mae_torch.cli.pretrain import get_args_parser as pre_parser
    from cross_scale_mae_torch.cli.pretrain import main as pretrain
    from cross_scale_mae_torch.utils.checkpoint import load_flat_npz, read_config_json

    pre = pretrain(pre_parser().parse_args([
        "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
        "--batch_size", "4", "--synthetic_len", "8", "--max_steps", "1",
        "--device", "cpu", "--output_dir", str(tmp_path / "pre")]))
    result = main(_ft_args(tmp_path, "--finetune", pre["npz"], "--max_steps", "2",
                           "--attention_impl", "pallas"))
    out = capsys.readouterr().out
    assert "loaded pretrained encoder" in out and "Epoch 0: acc1" in out
    assert result["steps"] == 2 and len(result["losses"]) == 2
    assert all(np.isfinite(result["losses"]))
    stats = result["eval"]
    # The eval set is max(12 // 4, 64) = 64 images: 16 full batches of 4.
    assert stats["n"] == 64 and result["eval_batches"] == 16
    assert all(np.isfinite(stats[k]) for k in ("loss", "acc1", "acc5", "macro_f1", "miou"))
    saved = load_flat_npz(result["npz"])
    cfg = pcfg.ViTClassifierConfig.from_json(read_config_json(result["npz"]))
    assert cfg.attention_impl == "pallas" and cfg.num_classes == 5
    assert saved["blocks"]["attn"]["qkv"]["kernel"].shape == (4, 128, 384)
    # The backbone came from the pretrain npz and moved from there.
    pre_tree = load_flat_npz(pre["npz"])
    assert not np.array_equal(saved["cls_token"], pre_tree["cls_token"])
    np.testing.assert_allclose(saved["cls_token"], pre_tree["cls_token"], atol=1e-2)


def test_finetune_cli_pads_the_ragged_eval_batch(tmp_path):
    """An eval set of 64 in batches of 24: two full batches and one of 16
    valid rows padded to 24; every image counted once."""
    from cross_scale_mae_torch.cli.finetune import build_run, evaluate_run

    run = build_run(_ft_args(tmp_path, "--batch_size", "24", "--synthetic_len", "24"))
    stats, batches = evaluate_run(run, 24)
    assert batches == 3 and stats["n"] == 64 == int(stats["cm"].sum())
    np.testing.assert_array_equal(stats["cm"].sum(axis=0).sum(), 64)


@pytest.mark.parametrize("extra", [
    ("--sequence_parallel",), ("--model_parallel", "2"), ("--fsdp",),
    ("--num_slices", "2"), ("--jax_platforms", "cpu"), ("--use_tensorboard",),
])
def test_finetune_cli_refuses_unported_flags(tmp_path, extra):
    from cross_scale_mae_torch.cli.finetune import build_run

    with pytest.raises(SystemExit, match="ROADMAP"):
        build_run(_ft_args(tmp_path, *extra))


def test_finetune_cli_eval_only_evaluates(tmp_path, capsys):
    from cross_scale_mae_torch.cli.finetune import main

    result = main(_ft_args(tmp_path, "--eval", "--batch_size", "32"))
    assert result["eval_batches"] == 2 and result["eval"]["n"] == 64
    assert "eval: acc1" in capsys.readouterr().out
    assert not (tmp_path / "ft").exists()


@pytest.mark.parametrize("make", [lambda p: p.mkdir() or str(p), lambda p: str(p) + ".pth"])
def test_finetune_cli_refuses_orbax_dirs_and_pth(tmp_path, make):
    """A directory without the port's checkpoints (an Orbax one of the JAX
    package) is refused, and so is a .pth (ROADMAP.md queue 1 item 16)."""
    from cross_scale_mae_torch.cli.finetune import build_run

    path = make(tmp_path / "ckpt")
    with pytest.raises(SystemExit, match="Orbax" if os.path.isdir(path) else "ROADMAP"):
        build_run(_ft_args(tmp_path, "--finetune", path))


def test_finetune_cli_defaults_to_the_gpu_and_the_k2_kernels():
    from cross_scale_mae_torch.cli.finetune import get_args_parser

    args = get_args_parser().parse_args([])
    assert args.device == "cuda" and args.attention_impl == "pallas"
    assert (args.model, args.input_size, args.patch_size, args.batch_size) == (
        "vit_large_patch16", 64, 8, 512)
    assert (args.drop_path, args.smoothing, args.layer_decay, args.nb_classes) == (
        0.1, 0.1, 0.75, 62)
    assert json.loads(pcfg.get_vit_config(args.model).to_json())["depth"] == 24


def test_synthetic_classification_data_match_jax_dataset():
    from cross_scale_mae_tpu.data.datasets import build_dataset
    from cross_scale_mae_torch.data.datasets import canvas_size, synthetic_images, synthetic_labels

    canvas = canvas_size(64, 1.0 / 0.875)
    ds = build_dataset("synthetic", False, input_size=64, canvas_scale=1.0 / 0.875,
                       synthetic_len=5, num_classes=62)
    assert canvas == ds.canvas_size == 73
    imgs = synthetic_images(5, canvas, 3, 0, "cpu").numpy()
    labels = synthetic_labels(5, 62, 0, "cpu").numpy()
    for i in range(5):
        img, label = ds.load(i)
        np.testing.assert_array_equal(imgs[i], img)
        assert labels[i] == label


@pytest.mark.parametrize("patch", [4, 8])
def test_load_pretrained_encoder_from_a_jax_written_npz(tmp_path, patch):
    """An npz of the JAX package's save_params_npz: the encoder blocks and
    cls token come across; at another patch size the patch_embed shape
    differs and the fresh init stays (finetune.py:176-178)."""
    from cross_scale_mae_tpu.models import mae_init as jmae_init
    from cross_scale_mae_tpu.utils.checkpoint import save_params_npz as jsave
    from cross_scale_mae_torch.cli.finetune import load_pretrained_encoder
    from cross_scale_mae_torch.models.vit import vit_init

    jm = jcfg.get_mae_config("mae_vit_tiny", input_size=16, patch_size=4, dim_model=32,
                             encoder_num_layers=2, encoder_num_heads=4, decoder_embed_dim=16,
                             decoder_num_layers=1, decoder_num_heads=4)
    mae_params, _ = jmae_init(jax.random.key(5), jm)
    path = str(tmp_path / "mae.npz")
    jsave(path, mae_params, jm.to_json())
    _, pc = _cfgs(patch_size=patch, global_pool=True)
    fresh, _ = vit_init(pc, torch.Generator().manual_seed(0))
    before = fresh["patch_embed"]["kernel"].clone()
    got = load_pretrained_encoder(path, pc, fresh, torch.device("cpu"))
    ref = _tree_np(mae_params)
    _assert_tree_close(pparams.params_to_jax({"b": got["blocks"]})["b"],
                       ref["encoder_blocks"], 0.0)
    np.testing.assert_array_equal(got["cls_token"].numpy(), ref["cls_token"])
    if patch == 4:
        np.testing.assert_array_equal(got["patch_embed"]["kernel"].numpy(),
                                      ref["patch_embed"]["kernel"])
    else:
        assert torch.equal(got["patch_embed"]["kernel"], before)
    assert torch.equal(got["pos_embed"], fresh["pos_embed"])
