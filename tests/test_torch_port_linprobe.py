"""The PyTorch port's linear probe (train/optim.py LARS with a frozen mask,
models/vit.py's frozen backbone, train/classify.py's frozen step,
cli/common.py, utils/logging.py and cli/linprobe.py), and the pretrain and
finetune CLIs over a real dataset through the loader, held against the JAX
package on the CPU.

The JAX draws (fold_in(step), split 3, the pretrain augment's split into
flip, rot and crop keys) are rebuilt from the JAX keys and handed to the
port. Tolerances: LARS updates fp32 1e-6 (the same operations; the fused
multiply-add of the port's update rounds once); the 10-step lockstep as
the finetune lockstep (losses rtol 3e-4, params atol 5e-4 of the largest
value), the backbone exactly.
"""

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

TINY = dict(input_size=16, patch_size=4, embed_dim=32, depth=2, num_heads=4, num_classes=7,
            compute_dtype="float32", attention_impl="pallas_v3", use_bn_head=True,
            global_pool=False)


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return (jcfg.get_vit_config("vit_base_patch16", **kw),
            pcfg.get_vit_config("vit_base_patch16", **kw))


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_vit(jc, seed):
    from cross_scale_mae_tpu.models import vit_init as jinit

    params, state = jinit(jax.random.key(seed), jc)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith(("'bias']", "'scale']")) else a, params)
    return params, state


def _jax_head_mask(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, _: str(getattr(path[0], "key", "")) == "head", params)


# ---------------------------------------------------------------- LARS


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_lars_with_a_frozen_mask_matches_optax(weight_decay):
    """Five LARS updates under a frozen mask against the JAX chain
    (optax.masked lars + set_to_zero): a 2-D and a 1-D trainable leaf, a
    trainable leaf at zero (trust ratio 1), frozen leaves left untouched."""
    import optax

    from cross_scale_mae_tpu.train.optim import build_optimizer as jopt
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import tree_leaves

    rng = np.random.default_rng(1)
    tree = {"head": {"kernel": rng.normal(size=(6, 3)).astype(np.float32),
                     "bias": rng.normal(size=(3,)).astype(np.float32),
                     "zero": np.zeros((2, 2), np.float32)},
            "blocks": {"kernel": rng.normal(size=(4, 6)).astype(np.float32),
                       "bias": rng.normal(size=(6,)).astype(np.float32)}}
    mask = {"head": {k: True for k in tree["head"]}, "blocks": {k: False for k in tree["blocks"]}}
    sched = lambda s: 0.1 * (s + 1)  # noqa: E731
    jp = jax.tree.map(jnp.asarray, tree)
    jtx = jopt(jp, sched, optimizer="lars", weight_decay=weight_decay, frozen_mask=mask)
    js = jtx.init(jp)
    pp = jax.tree.map(torch.from_numpy, jax.tree.map(np.copy, tree))
    tx = build_optimizer(pp, sched, optimizer="lars", weight_decay=weight_decay,
                         frozen_mask=mask)
    ps = tx.init(pp)
    assert [m.shape for m in ps.mu] == [(3,), (6, 3), (2, 2)]
    for k in range(5):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (k + 1)).astype(np.float32), tree)
        g["head"]["zero"][:] = 0.0 if k % 2 else 1.0
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        grads = [torch.from_numpy(a) for a in tree_leaves(g)]
        frozen = [i for i, m in enumerate(tree_leaves(mask)) if not m]
        for i in frozen:
            grads[i] = None  # a frozen backbone's gradients stay None
        tx.update(tree_leaves(pp), grads, ps)
    assert ps.count == 5
    for path, ref in jax.tree_util.tree_flatten_with_path(_tree_np(jp))[0]:
        got = pp[path[0].key][path[1].key].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=str(path))
    for k in tree["blocks"]:
        np.testing.assert_array_equal(pp["blocks"][k].numpy(), tree["blocks"][k])


@pytest.mark.parametrize("kw,frozen", [
    (dict(clip_grad=0.5, layer_decay=0.75, depth=2), False),
    (dict(clip_grad=0.05, layer_decay=0.6, depth=2, weight_decay=0.05), False),
    (dict(clip_grad=0.5, weight_decay=0.05), True),
])
def test_lars_with_clip_and_layer_decay_matches_optax(kw, frozen):
    """Five updates of the JAX chain clip -> LARS -> layer scale (and clip
    -> LARS inside optax.masked) on a tree of unstacked leaves (the patch
    embedding at layer 0, a norm and the head at the top layer; no stacked
    blocks, whose shared norms the port does not copy), fp32 1e-6; a clip
    of 0.05 binds. (Layer decay under a frozen mask has no JAX reading: its
    scale_by_tree raises on optax.masked's MaskedNode leaves.)"""
    import optax

    from cross_scale_mae_tpu.train.optim import build_optimizer as jopt
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.state import tree_leaves

    rng = np.random.default_rng(2)
    tree = {"patch_embed": {"kernel": rng.normal(size=(8, 6)).astype(np.float32),
                            "bias": rng.normal(size=(6,)).astype(np.float32)},
            "fc_norm": {"scale": 1 + 0.1 * rng.normal(size=(6,)).astype(np.float32),
                        "bias": 0.1 * rng.normal(size=(6,)).astype(np.float32)},
            "head": {"kernel": rng.normal(size=(6, 3)).astype(np.float32),
                     "bias": rng.normal(size=(3,)).astype(np.float32)}}
    mask = ({k: {n: k == "head" for n in v} for k, v in tree.items()} if frozen else None)
    kw = {"weight_decay": 0.0, **kw}
    sched = lambda s: 0.1 * (s + 1)  # noqa: E731
    jp = jax.tree.map(jnp.asarray, tree)
    jtx = jopt(jp, sched, optimizer="lars", frozen_mask=mask, **kw)
    js = jtx.init(jp)
    pp = jax.tree.map(torch.from_numpy, jax.tree.map(np.copy, tree))
    tx = build_optimizer(pp, sched, optimizer="lars", frozen_mask=mask, **kw)
    ps = tx.init(pp)
    trainable = tree_leaves(mask) if frozen else [True] * len(tree_leaves(tree))
    for k in range(5):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (k + 1)).astype(np.float32), tree)
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        grads = [torch.from_numpy(a) if t else None for a, t in zip(tree_leaves(g), trainable)]
        tx.update(tree_leaves(pp), grads, ps)
    for path, ref in jax.tree_util.tree_flatten_with_path(_tree_np(jp))[0]:
        got = pp[path[0].key][path[1].key].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=str(path))
    if frozen:
        np.testing.assert_array_equal(pp["patch_embed"]["kernel"].numpy(),
                                      tree["patch_embed"]["kernel"])


# ---------------------------------------------------------------- frozen backbone


def _reachable_leaves(t: torch.Tensor) -> set:
    """ids of the leaf tensors an autograd graph reaches."""
    seen, stack, leaves = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if hasattr(fn, "variable"):
            leaves.add(id(fn.variable))
        stack.extend(f for f, _ in fn.next_functions)
    return leaves


def test_frozen_backbone_gives_the_same_logits_and_no_backbone_node():
    """The same logits bit for bit, and a graph that reaches the head's two
    leaves and nothing of the backbone (no block node, no saved qkv)."""
    from cross_scale_mae_torch.models.vit import vit_apply
    from cross_scale_mae_torch.train.state import tree_leaves

    jc, pc = _cfgs()
    params, mstate = _jax_vit(jc, 3)
    pp = pparams.vit_params_from_jax(_tree_np(params), pc)
    pm = {"head_bn": jax.tree.map(lambda a: torch.from_numpy(np.array(a)), mstate["head_bn"])}
    for leaf in tree_leaves(pp):
        leaf.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(6, 16, 16, 3)).astype(np.float32))
    frozen, fstate = vit_apply(pp, pm, pc, x, train=True, freeze_backbone=True)
    full, state = vit_apply(pp, pm, pc, x, train=True)
    assert torch.equal(frozen, full)
    for k in ("mean", "var"):
        assert torch.equal(fstate["head_bn"][k], state["head_bn"][k])
    assert _reachable_leaves(frozen) == {id(pp["head"]["kernel"]), id(pp["head"]["bias"])}
    assert _reachable_leaves(full) == {id(t) for t in tree_leaves(pp)}
    frozen.sum().backward()
    assert all(p.grad is None for k, v in pp.items() if k != "head" for p in tree_leaves(v))
    assert pp["head"]["kernel"].grad is not None


def _lockstep_draws(key, n, canvas):
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes as jboxes
    from cross_scale_mae_torch.train.classify import FinetuneDraws

    k_flip, k_rot, k_crop = jax.random.split(key, 3)
    kh, kv = jax.random.split(k_flip)
    flips = [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (n,)))) for k in (kh, kv)]
    boxes = torch.from_numpy(np.array(jboxes(k_crop, n, canvas, canvas, (0.25, 1.0)), np.float32))
    rot = torch.from_numpy(np.array(jax.random.randint(k_rot, (n,), 0, 4)))
    return FinetuneDraws(*flips, boxes, None, rot)


def test_linprobe_step_10_step_lockstep_with_jax():
    """The port's frozen-backbone classify step with LARS on the head alone
    and the BN head, against the JAX one for 10 steps on the tiny classifier
    (fp32, 'pallas_v3' on both sides, the NAIP pretrain chain with rot90 on
    uint8 input), from the same weights, with the JAX draws of every step
    injected."""
    from cross_scale_mae_tpu.ops.augment import make_pretrain_augment as jaug
    from cross_scale_mae_tpu.train import TrainState as JState
    from cross_scale_mae_tpu.train import build_optimizer as jopt
    from cross_scale_mae_tpu.train import warmup_half_cosine as jsched
    from cross_scale_mae_tpu.train.classify import make_classify_train_step as jstep_fn
    from cross_scale_mae_torch.cli.linprobe import head_only_mask
    from cross_scale_mae_torch.data.datasets import NaipDataset
    from cross_scale_mae_torch.ops.augment import make_pretrain_augment
    from cross_scale_mae_torch.train.classify import make_classify_train_step
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.train.schedule import warmup_half_cosine
    from cross_scale_mae_torch.train.state import TrainState, tree_items

    jc, pc = _cfgs()
    n, steps, canvas = 8, 10, 20
    sched_args = (0.4, 0.0, 1, 4, 3)
    mean, std = NaipDataset.mean, NaipDataset.std
    tkw = dict(batch_size=n, label_smoothing=0.0, weight_decay=0.0, optimizer="lars")
    params, mstate = _jax_vit(jc, 7)
    jtx = jopt(params, jsched(*sched_args), optimizer="lars", weight_decay=0.0,
               frozen_mask=_jax_head_mask(params))
    jstate = JState.create(params, mstate, jtx)
    jstep = jstep_fn(jc, jcfg.TrainConfig(**tkw), jsched(*sched_args), donate=False,
                     augment=jaug(mean, std, 16, rot90=True, dtype="float32"),
                     freeze_backbone=True)

    sched = warmup_half_cosine(*sched_args)
    pp = pparams.vit_params_from_jax(_tree_np(params), pc)
    pm = {"head_bn": jax.tree.map(lambda a: torch.from_numpy(np.array(a)), mstate["head_bn"])}
    before = {p: t.clone() for p, t in tree_items(pp)}
    pstate = TrainState.create(pp, pm, build_optimizer(
        pp, sched, optimizer="lars", weight_decay=0.0, frozen_mask=head_only_mask(pp)))
    pstep = make_classify_train_step(
        pc, pcfg.TrainConfig(**tkw), sched,
        augment=make_pretrain_augment(mean, std, 16, rot90=True, dtype="float32"),
        freeze_backbone=True)

    rng_np = np.random.default_rng(8)
    labels = rng_np.integers(0, 7, n).astype(np.int32)
    # Class-dependent brightness, so the probe has something to learn.
    batch = (rng_np.integers(0, 128, (n, canvas, canvas, 3)) + 16 * labels[:, None, None, None]
             ).astype(np.uint8)
    rng = jax.random.key(9)
    jl, pl, gn = [], [], []
    for step in range(steps):
        k_aug, _, _ = jax.random.split(jax.random.fold_in(rng, step), 3)
        jstate, jm = jstep(jstate, jnp.asarray(batch), jnp.asarray(labels), rng)
        pstate, pm_ = pstep(pstate, torch.from_numpy(batch), torch.from_numpy(labels).long(),
                            _lockstep_draws(k_aug, n, canvas))
        jl.append(float(jm["loss"]))
        pl.append(float(pm_["loss"]))
        gn.append((float(pm_["grad_norm"]), float(jm["grad_norm"])))
        assert pm_["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert all(p.grad is None for path, p in tree_items(pstate.params) if path[0] != "head")

    np.testing.assert_allclose(pl, jl, rtol=3e-4)
    np.testing.assert_allclose(*zip(*gn), rtol=1e-3)
    assert pstate.step == int(jstate.step) == steps and pstate.opt_state.count == steps
    ref = _tree_np(jstate.params)
    got = pparams.params_to_jax(pstate.params)
    for path, r in jax.tree_util.tree_flatten_with_path(ref)[0]:
        g = np.asarray(_get(got, path))
        if path[0].key == "head":
            np.testing.assert_allclose(g, r, rtol=0, atol=5e-4 * max(1.0, float(np.abs(r).max())),
                                       err_msg=jax.tree_util.keystr(path))
        else:
            np.testing.assert_array_equal(g, r, err_msg=jax.tree_util.keystr(path))
    for p, t in tree_items(pstate.params):
        if p[0] != "head":
            assert torch.equal(t, before[p]), p
    assert not torch.equal(pstate.params["head"]["kernel"], before[("head", "kernel")])
    for k in ("mean", "var"):
        np.testing.assert_allclose(pstate.model_state["head_bn"][k].numpy(),
                                   np.asarray(jstate.model_state["head_bn"][k]), rtol=0, atol=5e-4)
    assert pl[-1] < pl[0]


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


# ---------------------------------------------------------------- the CLIs


def _naip_dir(root, n_train=24, n_val=10, canvas=32, eval_canvas=37):
    """NAIP tiles with class-dependent brightness and their index CSVs."""
    rng = np.random.default_rng(0)
    paths = {}
    for split, n, side in (("train", n_train, canvas), ("val", n_val, eval_canvas)):
        rows = ["path,label"]
        for i in range(n):
            c = i % 4
            tile = (rng.integers(0, 128, (side, side, 3)) + 30 * c).astype(np.uint8)
            np.save(root / f"{split}_{i}.npy", tile.transpose(2, 0, 1) if i % 2 else tile)
            rows.append(f"{split}_{i}.npy,{c}")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")
        paths[split] = str(root / f"{split}.csv")
    return paths


def _pretrain_npz(tmp_path, *extra):
    from cross_scale_mae_torch.cli.pretrain import get_args_parser, main

    return main(get_args_parser().parse_args([
        "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
        "--batch_size", "4", "--synthetic_len", "8", "--max_steps", "2", "--device", "cpu",
        "--output_dir", str(tmp_path / "pre"), *extra]))


def _lp_args(tmp_path, data, *extra):
    from cross_scale_mae_torch.cli.linprobe import get_args_parser

    return get_args_parser().parse_args([
        "--model", "vit_base_patch16", "--embed_dim", "128", "--depth", "4",
        "--num_heads", "8", "--input_size", "32", "--patch_size", "8",
        "--dataset_type", "naip", "--train_path", data["train"], "--test_path", data["val"],
        "--nb_classes", "4", "--batch_size", "8", "--epochs", "2", "--warmup_epochs", "1",
        "--num_workers", "2", "--log_interval", "1", "--device", "cpu",
        "--output_dir", str(tmp_path / "lp"), *extra])


def test_linprobe_cli_probes_a_pretrain_npz_over_naip(tmp_path, capsys):
    """cli/linprobe.main on the CPU from a cli/pretrain npz over a tiny NAIP
    dir: 3 steps an epoch (drop_last), an eval per epoch with its ragged
    last batch padded, log.jsonl and params.npz in the run dir, the
    backbone exactly the pretrained encoder's, the head and BN moved."""
    from cross_scale_mae_torch.cli.linprobe import main
    from cross_scale_mae_torch.utils.checkpoint import load_flat_npz, read_config_json

    data = _naip_dir(tmp_path)
    pre = _pretrain_npz(tmp_path)
    result = main(_lp_args(tmp_path, data, "--finetune", pre["npz"]))
    out = capsys.readouterr().out
    assert "loaded pretrained encoder" in out and "attention xla" in out
    assert result["steps"] == 6 and len(result["losses"]) == 6
    assert all(np.isfinite(result["losses"]))
    assert result["eval_batches"] == 4 and result["eval"]["n"] == 10
    assert int(result["eval"]["cm"].sum()) == 10
    assert result["output_dir"].endswith("run_lin_vit_base_patch16-in_sz_32-lr_0.003125-ds_naip")
    lines = [json.loads(x) for x in open(f"{result['output_dir']}/log.jsonl")]
    assert [x["epoch"] for x in lines] == [0, 1] and "max_acc" in lines[-1]
    saved = load_flat_npz(result["npz"])
    cfg = pcfg.ViTClassifierConfig.from_json(read_config_json(result["npz"]))
    assert cfg.use_bn_head and not cfg.global_pool and cfg.num_classes == 4
    pre_tree = load_flat_npz(pre["npz"])
    np.testing.assert_array_equal(saved["blocks"]["attn"]["qkv"]["kernel"],
                                  pre_tree["encoder_blocks"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(saved["cls_token"], pre_tree["cls_token"])
    run = result["run"]
    assert not np.allclose(saved["head"]["kernel"], 0.0)
    assert float(run.state.model_state["head_bn"]["var"].sub(1).abs().max()) > 0
    assert all(p.grad is None for p in run.state.params["blocks"][0]["attn"]["qkv"].values())
    # A second run claims the next directory.
    again = main(_lp_args(tmp_path, data, "--finetune", pre["npz"], "--max_steps", "1"))
    assert again["output_dir"] == result["output_dir"] + "+1" and again["steps"] == 1


def test_linprobe_cli_eval_only_evaluates(tmp_path, capsys):
    from cross_scale_mae_torch.cli.linprobe import main

    data = _naip_dir(tmp_path)
    result = main(_lp_args(tmp_path, data, "--eval", "--batch_size", "4"))
    assert result["eval_batches"] == 3 and result["eval"]["n"] == 10
    assert "eval: acc1" in capsys.readouterr().out
    assert not (tmp_path / "lp").exists()


@pytest.mark.parametrize("extra", [
    ("--model_parallel", "2"), ("--fsdp",), ("--sequence_parallel",), ("--num_slices", "2"),
])
def test_linprobe_cli_refuses_unported_flags(tmp_path, extra):
    """The mesh flags run (--fsdp builds its layout) or, at one process,
    refuse as the JAX CLI does (see tests/test_torch_port_finetune.py)."""
    from cross_scale_mae_torch.cli.linprobe import build_run

    want = {"--sequence_parallel": "needs --model_parallel > 1",
            "--model_parallel": "do not split", "--num_slices": "do not split"}.get(extra[0])
    args = _lp_args(tmp_path, _naip_dir(tmp_path), *extra)
    if want is None:
        assert build_run(args).layout.fsdp
        return
    with pytest.raises(SystemExit, match=want):
        build_run(args)


@pytest.mark.parametrize("make", [lambda p: p.mkdir() or str(p), lambda p: str(p) + ".pth"])
def test_linprobe_cli_refuses_orbax_dirs_and_pth(tmp_path, make):
    """A directory without the port's checkpoints (an Orbax one of the JAX
    package) is refused, and so is a .pth that is not there (a reference
    .pth is read, tests/test_torch_port_interchange.py)."""
    from cross_scale_mae_torch.cli.linprobe import build_run

    path = make(tmp_path / "ckpt")
    with pytest.raises(SystemExit, match="Orbax" if os.path.isdir(path) else "no such"):
        build_run(_lp_args(tmp_path, _naip_dir(tmp_path), "--finetune", path))


@pytest.mark.parametrize("extra,match", [
    (("--loss", "mse"), "classification_cross"), (("--dataset_type", "resisc45"), "no loader"),
])
def test_linprobe_cli_checks_the_reference_flags(tmp_path, extra, match):
    from cross_scale_mae_torch.cli.linprobe import build_run

    with pytest.raises(ValueError, match=match):
        build_run(_lp_args(tmp_path, _naip_dir(tmp_path), *extra))


def test_linprobe_cli_has_the_jax_flags_and_defaults():
    """Every flag of the JAX linprobe parser that the port runs, with its
    default; the port's own: --device cuda, and the attention resolved to
    the K1 kernels on the GPU and the plain attention on the CPU."""
    from cross_scale_mae_tpu.cli.linprobe import get_args_parser as jparser
    from cross_scale_mae_torch.cli.common import resolve_attention
    from cross_scale_mae_torch.cli.linprobe import get_args_parser

    got, ref = vars(get_args_parser().parse_args([])), vars(jparser().parse_args([]))
    shared = ["model", "input_size", "patch_size", "global_pool", "finetune", "eval",
              "epochs", "warmup_epochs", "batch_size", "accum_iter", "blr", "lr", "min_lr",
              "weight_decay", "ckpt_interval", "eval_interval", "max_steps", "dataset_type",
              "train_path", "test_path", "synthetic_len", "canvas_scale", "nb_classes", "seed",
              "output_dir", "log_interval", "attention_impl", "attention", "gelu",
              "compute_dtype", "loss", "output_dir_base", "start_epoch"]
    assert {k: got[k] for k in shared} == {k: ref[k] for k in shared}
    assert (got["model"], got["input_size"], got["batch_size"], got["blr"]) == (
        "vit_base_patch16", 128, 1024, 0.1)
    assert got["device"] == "cuda" and got["attention_impl"] is None
    args = get_args_parser().parse_args([])
    assert resolve_attention(args, torch.device("cuda")) == "pallas_v3"
    args = get_args_parser().parse_args(["--attention_impl", "pallas"])
    assert resolve_attention(args, torch.device("cpu")) == "pallas"
    args = get_args_parser().parse_args(["--dataset_type", "rgb", "--output_dir_base", "b"])
    from cross_scale_mae_torch.cli.common import apply_reference_compat

    apply_reference_compat(args, "linprobe")
    assert args.dataset_type == "fmow_rgb" and args.output_dir == "b/./output_dir"


def test_pretrain_cli_trains_over_naip_through_the_loader(tmp_path):
    """2 steps on the CPU over a NAIP dir, with the rot90 chain and the
    crop boxes drawn on the loader's canvas."""
    data = _naip_dir(tmp_path, canvas=40)
    result = _pretrain_npz(tmp_path, "--dataset_type", "naip", "--train_path", data["train"],
                           "--canvas_scale", "1.25")
    assert result["steps"] == 2 and all(np.isfinite(result["losses"]))


def test_pretrain_cli_naip_run_draws_rotations_on_the_canvas(tmp_path):
    from cross_scale_mae_torch.cli.pretrain import build_run, get_args_parser

    data = _naip_dir(tmp_path, canvas=40)
    run = build_run(get_args_parser().parse_args([
        "--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "32", "--patch_size", "8",
        "--batch_size", "4", "--device", "cpu", "--dataset_type", "naip",
        "--train_path", data["train"], "--canvas_scale", "1.25"]))
    assert run.steps_per_epoch == 6 and run.images is None and run.rot90
    (d,) = run.draws(0)
    assert d.rot_k.shape == (4,) and float(d.crop_boxes[:, 2].max()) <= 40
    imgs = next(iter(run.batches(0)))
    assert imgs.shape == (4, 40, 40, 3) and imgs.dtype == torch.uint8


def test_finetune_cli_trains_over_naip_through_the_loader(tmp_path):
    from cross_scale_mae_torch.cli.finetune import get_args_parser, main

    data = _naip_dir(tmp_path)
    result = main(get_args_parser().parse_args([
        "--model", "vit_base_patch16", "--embed_dim", "128", "--depth", "4",
        "--num_heads", "8", "--input_size", "32", "--patch_size", "8", "--batch_size", "4",
        "--nb_classes", "4", "--max_steps", "2", "--device", "cpu", "--dataset_type", "naip",
        "--train_path", data["train"], "--test_path", data["val"], "--num_workers", "2",
        "--output_dir", str(tmp_path / "ft")]))
    assert result["steps"] == 2 and all(np.isfinite(result["losses"]))
    assert result["eval"]["n"] == 10 and result["eval_batches"] == 3


def test_run_dirs_and_the_jsonl_log(tmp_path):
    from cross_scale_mae_torch.utils.logging import RunLogger, auto_output_dir

    first = auto_output_dir(str(tmp_path), run="a_1", skip=None)
    assert first == str(tmp_path / "run_a_1")
    assert auto_output_dir(str(tmp_path), run="a_1") == first + "+1"
    log = RunLogger(first, config={"lr": 0.1})
    log.log_epoch({"epoch": 0, "acc1": 1.5})
    log.log_epoch({"epoch": 1, "acc1": 2.5})
    log.close()
    assert [json.loads(x)["acc1"] for x in open(f"{first}/log.jsonl")] == [1.5, 2.5]
    assert json.load(open(f"{first}/config.json")) == {"lr": 0.1}


def test_linprobe_flops_count_the_backbone_forward_and_the_head():
    from cross_scale_mae_torch.utils.flops import (
        linprobe_train_flops_per_image,
        vit_backbone_flops_per_image,
        vit_train_flops_per_image,
    )

    cfg = pcfg.get_vit_config("vit_base_patch16", input_size=128, num_classes=10)
    back, head = vit_backbone_flops_per_image(cfg), 2 * 768 * 10
    assert vit_train_flops_per_image(cfg) == 3 * (back + head)
    assert linprobe_train_flops_per_image(cfg) == back + 3 * head
    # ViT-B/16 at 128 px: 65 tokens through 12 blocks, about 11.3 GFLOP.
    assert 11.0e9 < back < 11.5e9
