"""Finetuning entry point, on the GPU.

Counterpart of ``cross_scale_mae_tpu/cli/finetune.py`` with its flag names
for what the port runs: a ViT classifier (``--model vit_large_patch16``, 64
px, patch 8 by default) started from a pretrained MAE encoder
(``--finetune params.npz``, written by the port's ``cli/pretrain`` or the
JAX package's ``save_params_npz``), the head re-initialised, AdamW (b2
0.999) with layer-wise lr decay under the warmup + half-cosine schedule,
label smoothing and drop-path, then the evaluation (loss, acc1, acc5, F1,
mIoU) with the ragged last batch padded under a validity mask. With
``--attention_impl pallas`` (the default) every attention forward and
backward runs in the hand-written CUDA kernels ``csrc/mha_fwd.cu`` and
``csrc/mha_bwd.cu``.

Data: the synthetic classification dataset only (seeded uint8 images and
labels, made as the JAX package's ``SyntheticDataset`` makes them and held
on the device). At the end the params are written as the JAX package's npz
(``<output_dir>/params.npz``). Mixup/CutMix, RandAugment, color jitter,
random erasing, real datasets and the loader, resume, DDP and TP/SP, the
Adam moment dtypes, Orbax and ``.pth`` checkpoints are not ported yet and
refuse with a pointer to ROADMAP.md.

Usage:
    python -m cross_scale_mae_torch.cli.finetune --finetune pretrain/params.npz \\
        --attention_impl pallas --output_dir out                         # GPU
    python -m cross_scale_mae_torch.cli.finetune --model vit_base_patch16 \\
        --embed_dim 128 --depth 4 --num_heads 8 --input_size 32 --patch_size 8 \\
        --batch_size 4 --synthetic_len 8 --max_steps 2 --device cpu \\
        --output_dir out                                                  # CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable

import torch

from cross_scale_mae_torch.configs import (
    MAEConfig,
    TrainConfig,
    ViTClassifierConfig,
    get_vit_config,
)
from cross_scale_mae_torch.data.datasets import (
    DATASET_STATS,
    canvas_size,
    synthetic_images,
    synthetic_labels,
)
from cross_scale_mae_torch.models.vit import trunc_normal, vit_init
from cross_scale_mae_torch.ops.augment import make_eval_preprocess, make_finetune_augment
from cross_scale_mae_torch.serving import resolve_device
from cross_scale_mae_torch.train.classify import (
    make_classify_train_step,
    make_eval_step,
    sample_finetune_draws,
)
from cross_scale_mae_torch.train.optim import build_optimizer
from cross_scale_mae_torch.train.pretrain import _step_rng
from cross_scale_mae_torch.train.schedule import warmup_half_cosine
from cross_scale_mae_torch.train.state import TrainState, finite_loss, tree_leaves
from cross_scale_mae_torch.utils.checkpoint import load_flat_npz, read_config_json, save_params_npz
from cross_scale_mae_torch.utils.metrics import ConfusionMatrix, MetricLogger
from cross_scale_mae_torch.utils.params import (
    mae_encoder_to_classifier,
    merge_pretrained,
    params_from_jax,
    params_to_jax,
)

# Flags of the JAX CLI that the port parses but does not run yet:
# flag -> ROADMAP.md queue 1 item.
UNPORTED_FLAGS = {
    "resume": 9, "train_path": 10, "test_path": 10, "canvas_scale": 10, "model_parallel": 11,
    "sequence_parallel": 11, "fsdp": 11, "adam_mu_dtype": 7, "adam_nu_dtype": 7,
    "cutmix_minmax": 12, "color_jitter": 12, "aa": 12, "use_wandb": 16,
    "use_tensorboard": 16, "profile_dir": 16,
}
# Flags whose default means "off": any other value is not ported yet.
UNPORTED_VALUES = {"mixup": 0.0, "cutmix": 0.0, "reprob": 0.0}


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Cross-Scale MAE finetuning (PyTorch)", add_help=False)
    p.add_argument("--model", default="vit_large_patch16")
    p.add_argument("--input_size", default=64, type=int)   # finetune.sh:7
    p.add_argument("--patch_size", default=8, type=int)    # finetune.sh:8
    p.add_argument("--global_pool", action="store_true", default=True)
    p.add_argument("--cls_token_pool", action="store_false", dest="global_pool")
    p.add_argument("--cls_token", action="store_false", dest="global_pool",
                   help="classify from the cls token (main_finetune.py:276-279)")
    p.add_argument("--drop_path", default=0.1, type=float)
    p.add_argument("--finetune", default="",
                   help="pretrained MAE params: an npz of save_params_npz")
    p.add_argument("--eval", action="store_true", help="evaluate only")
    p.add_argument("--embed_dim", default=None, type=int)
    p.add_argument("--depth", default=None, type=int)
    p.add_argument("--num_heads", default=None, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--warmup_epochs", default=5, type=int)
    p.add_argument("--batch_size", default=512, type=int)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--blr", default=1e-3, type=float)
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--min_lr", default=1e-6, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--layer_decay", default=0.75, type=float)
    p.add_argument("--clip_grad", default=None, type=float)
    p.add_argument("--smoothing", default=0.1, type=float)
    p.add_argument("--mixup", default=0.0, type=float)
    p.add_argument("--cutmix", default=0.0, type=float)
    p.add_argument("--eval_interval", default=1, type=int,
                   help="evaluate every N epochs and after the last")
    p.add_argument("--max_steps", default=None, type=int, help="hard step cap")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--attention_impl", default="pallas",
                   help="pallas or pallas_t (the K2 CUDA kernels on the GPU), "
                        "pallas_v3 (K1), xla (plain)")
    p.add_argument("--gelu", default="tanh", choices=["tanh", "exact", "exact_tanhbwd"])
    p.add_argument("--dataset_type", default="synthetic",
                   choices=["synthetic", "fmow_rgb", "coco", "euro_sat",
                            "fmow_sentinel", "naip", "fmow_temporal"])
    p.add_argument("--synthetic_len", default=4096, type=int)
    p.add_argument("--nb_classes", default=62, type=int)
    p.add_argument("--log_interval", default=20, type=int)
    p.add_argument("--output_dir", default="./output_dir")
    p.add_argument("--device", default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu)")
    g = p.add_argument_group("not ported yet (ROADMAP.md)")
    for flag in ("resume", "train_path", "test_path", "adam_mu_dtype", "adam_nu_dtype",
                 "aa", "profile_dir"):
        g.add_argument(f"--{flag}", default=None)
    g.add_argument("--color_jitter", default=None, type=float)
    g.add_argument("--canvas_scale", default=None, type=float)
    g.add_argument("--reprob", default=0.0, type=float)
    g.add_argument("--cutmix_minmax", default=None, type=float, nargs=2)
    g.add_argument("--model_parallel", default=None, type=int)
    for flag in ("sequence_parallel", "fsdp", "use_wandb", "use_tensorboard"):
        g.add_argument(f"--{flag}", action="store_true")
    return p


def refuse_unported(args) -> None:
    """SystemExit for a flag, value or dataset not ported yet."""
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(
                f"--{flag} is not ported yet; see ROADMAP.md (queue 1 item {item})")
    for flag, off in UNPORTED_VALUES.items():
        if getattr(args, flag) != off:
            raise SystemExit(
                f"--{flag} {getattr(args, flag)}: mixup, cutmix and random erasing are "
                "not ported yet; see ROADMAP.md (queue 1 item 12)")
    if args.dataset_type != "synthetic":
        raise SystemExit(
            f"--dataset_type {args.dataset_type}: the port trains on the synthetic "
            "dataset only; real datasets and the loader are queued in ROADMAP.md "
            "(queue 1 item 10)")


def load_pretrained_encoder(path: str, vcfg: ViTClassifierConfig, params: dict,
                            device: torch.device) -> dict:
    """Overlay a pretrained MAE encoder from an npz of ``save_params_npz``
    onto fresh classifier params. pos_embed and the head stay fresh (and
    fc_norm with the global-pool head); a patch_embed of another shape keeps
    the fresh init, any other misfit raises naming the parameter."""
    if os.path.isdir(path):
        raise SystemExit(
            f"--finetune {path}: restoring an Orbax checkpoint directory is not "
            "ported yet; see ROADMAP.md (queue 1 item 9). Pass the npz that "
            "cli/pretrain writes, or one from the JAX package's save_params_npz.")
    if not path.endswith(".npz"):
        raise SystemExit(
            f"--finetune {path}: the port reads save_params_npz files only; reference "
            ".pth import is not ported yet, see ROADMAP.md (queue 1 item 16)")
    cfg_json = read_config_json(path)
    if cfg_json is None:
        raise SystemExit(f"--finetune {path}: the npz has no model config entry")
    mae_cfg = MAEConfig.from_json(cfg_json).replace(apply_encoder_norm=not vcfg.global_pool)
    mae_params = params_from_jax(load_flat_npz(path), mae_cfg, device)
    pre, missing = mae_encoder_to_classifier(mae_params, vcfg)
    if pre["patch_embed"]["kernel"].shape != params["patch_embed"]["kernel"].shape:
        print("patch_embed shape mismatch; keeping fresh init", flush=True)
        pre.pop("patch_embed")
    merged = merge_pretrained(params, pre)
    print(f"loaded pretrained encoder from {path}; fresh: {missing}", flush=True)
    return merged


@dataclasses.dataclass
class FinetuneRun:
    """Everything one run's loop needs, built by :func:`build_run`."""

    cfg: ViTClassifierConfig
    tcfg: TrainConfig
    state: TrainState
    step_fn: Callable
    eval_fn: Callable
    images: torch.Tensor          # train set, uint8 on the device
    labels: torch.Tensor
    eval_images: torch.Tensor     # eval set on its 1/0.875 canvas
    eval_labels: torch.Tensor
    steps_per_epoch: int
    device: torch.device

    def draws(self, step: int) -> list:
        """The draws of ``step``: one set per microbatch, on the device."""
        gen = _step_rng(self.tcfg, self.tcfg.seed + 1, step, self.device)
        canvas = self.images.shape[1]
        return [sample_finetune_draws(gen, self.tcfg.batch_size, self.cfg, canvas)
                for _ in range(self.tcfg.accum_iter)]


def build_run(args) -> FinetuneRun:
    """Config, synthetic data, seeded init (and the pretrained encoder),
    AdamW with layer decay, and the train and eval steps, on
    ``args.device``."""
    refuse_unported(args)
    dev = resolve_device(args.device)
    overrides = {k: v for k, v in dict(embed_dim=args.embed_dim, depth=args.depth,
                                       num_heads=args.num_heads).items() if v is not None}
    vcfg = get_vit_config(
        args.model, input_size=args.input_size, patch_size=args.patch_size,
        num_classes=args.nb_classes, global_pool=args.global_pool,
        drop_path_rate=args.drop_path, compute_dtype=args.compute_dtype,
        attention_impl=args.attention_impl, gelu=args.gelu, **overrides)
    tcfg = TrainConfig(
        epochs=args.epochs, warmup_epochs=args.warmup_epochs, batch_size=args.batch_size,
        accum_iter=args.accum_iter, blr=args.blr, lr=args.lr, min_lr=args.min_lr,
        weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        layer_decay=args.layer_decay, label_smoothing=args.smoothing, seed=args.seed,
        log_interval=args.log_interval)
    c = vcfg.input_channels
    images = synthetic_images(args.synthetic_len, args.input_size, c, args.seed, dev)
    labels = synthetic_labels(args.synthetic_len, vcfg.num_classes, args.seed, dev)
    n_eval = max(args.synthetic_len // 4, 64)
    eval_canvas = canvas_size(args.input_size, 1.0 / 0.875 if args.input_size <= 224 else 1.0)
    eval_images = synthetic_images(n_eval, eval_canvas, c, args.seed, dev)
    eval_labels = synthetic_labels(n_eval, vcfg.num_classes, args.seed, dev)
    eff_batch = args.batch_size * args.accum_iter
    steps_per_epoch = args.synthetic_len // eff_batch
    if steps_per_epoch < 1 and not args.eval:
        raise SystemExit(f"--synthetic_len {args.synthetic_len} is smaller than one "
                         f"step's {eff_batch} images")
    lr = tcfg.resolved_lr(eff_batch)
    schedule = warmup_half_cosine(lr, args.min_lr, args.warmup_epochs, args.epochs,
                                  max(steps_per_epoch, 1))
    params, mstate = vit_init(vcfg, torch.Generator(device=dev).manual_seed(args.seed))
    if args.finetune:
        params = load_pretrained_encoder(args.finetune, vcfg, params, dev)
        # Head re-init (main_finetune.py:618): trunc_normal(2e-5).
        params["head"]["kernel"] = trunc_normal(
            torch.Generator(device=dev).manual_seed(args.seed + 2),
            tuple(params["head"]["kernel"].shape), 2e-5)
    tx = build_optimizer(params, schedule, weight_decay=args.weight_decay, b1=0.9, b2=0.999,
                         clip_grad=args.clip_grad, layer_decay=args.layer_decay,
                         depth=vcfg.depth, no_decay_names=("pos_embed", "cls_token"))
    state = TrainState.create(params, mstate, tx)
    mean, std = DATASET_STATS[args.dataset_type]
    augment = make_finetune_augment(mean, std, args.input_size, dtype=args.compute_dtype)
    preprocess = make_eval_preprocess(mean, std, args.input_size, dtype=args.compute_dtype)
    print(f"finetune {args.model}: {args.synthetic_len} train / {n_eval} eval, "
          f"{vcfg.num_classes} classes, lr {lr:.3e}, layer_decay {args.layer_decay}",
          flush=True)
    return FinetuneRun(vcfg, tcfg, state,
                       make_classify_train_step(vcfg, tcfg, schedule, augment=augment),
                       make_eval_step(vcfg, preprocess=preprocess), images, labels,
                       eval_images, eval_labels, steps_per_epoch, dev)


def evaluate(run: FinetuneRun, batch_size: int) -> tuple[dict, int]:
    """One pass over the eval set in batches of ``batch_size``, the last one
    padded with zero images under a validity mask (engine_finetune.py:127-236).
    Returns (loss, acc1, acc5, macro/micro F1 and mIoU in percent, and the
    valid count ``n``), and the number of batches."""
    cm = ConfusionMatrix(run.cfg.num_classes)
    sums = {"loss": 0.0, "acc1": 0.0, "acc5": 0.0}
    count, batches = 0.0, 0
    total = len(run.eval_labels)
    for start in range(0, total, batch_size):
        imgs = run.eval_images[start:start + batch_size]
        labels = run.eval_labels[start:start + batch_size]
        n = len(labels)
        if n < batch_size:
            pad = batch_size - n
            imgs = torch.cat([imgs, imgs.new_zeros((pad,) + imgs.shape[1:])])
            labels = torch.cat([labels, labels.new_zeros(pad)])
        valid = torch.arange(batch_size, device=labels.device) < n
        out = run.eval_fn(run.state.params, run.state.model_state, imgs, labels, valid)
        cm.mat += out["cm"].double().round().long().cpu().numpy()
        n_valid = float(out["n"])
        for k in sums:
            sums[k] += float(out[k]) * n_valid
        count += n_valid
        batches += 1
    count = max(count, 1.0)
    return {"loss": sums["loss"] / count, "acc1": 100.0 * sums["acc1"] / count,
            "acc5": 100.0 * sums["acc5"] / count, "macro_f1": 100.0 * cm.f1("macro"),
            "micro_f1": 100.0 * cm.f1("micro"), "miou": 100.0 * cm.miou(),
            "n": int(cm.mat.sum()), "cm": cm.mat}, batches


def main(args) -> dict[str, Any]:
    """Finetune, then evaluate; returns the step count, every step's loss,
    the last logged metrics, the last eval's stats, the eval batches run,
    the steady ms per step on the GPU (the train steps after the first,
    which builds the kernels, evaluation left out) and the npz path."""
    run = build_run(args)
    n_params = sum(p.numel() for p in tree_leaves(run.state.params))
    print(f"model {args.model}: {n_params / 1e6:.1f}M params on {run.device}; "
          f"{run.steps_per_epoch} steps/epoch", flush=True)
    if args.eval:
        stats, batches = evaluate(run, args.batch_size)
        print(f"eval: {_eval_line(stats)}", flush=True)
        return {"eval": stats, "eval_batches": batches}
    cuda = run.device.type == "cuda"
    batch = args.batch_size * args.accum_iter
    losses: list[float] = []
    last_metrics: dict[str, float] = {}
    stats: dict = {}
    prev_loss = None
    total = eval_batches = 0
    max_acc, train_s, t_mark = 0.0, 0.0, None
    for epoch in range(args.epochs):
        order = torch.randperm(len(run.images), device=run.device,
                               generator=torch.Generator(device=run.device)
                               .manual_seed(args.seed * 1_000_003 + epoch))
        mlog = MetricLogger()
        for it in range(run.steps_per_epoch):
            idx = order[it * batch:(it + 1) * batch]
            _, metrics = run.step_fn(run.state, run.images[idx], run.labels[idx],
                                     run.draws(run.state.step))
            # NaN abort one step behind, so the host does not wait for the
            # step it just enqueued.
            if prev_loss is not None:
                losses.append(finite_loss(prev_loss))
            prev_loss = metrics["loss"]
            total += 1
            if total == 1 and cuda:
                torch.cuda.synchronize(run.device)
                t_mark = time.perf_counter()
            if (total - 1) % args.log_interval == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                mlog.update(**last_metrics)
                print(f"epoch {epoch} step {total} {mlog}", flush=True)
            if args.max_steps and total >= args.max_steps:
                break
        last = epoch + 1 == args.epochs or (args.max_steps and total >= args.max_steps)
        if (epoch + 1) % args.eval_interval == 0 or last:
            if t_mark is not None:
                torch.cuda.synchronize(run.device)
                train_s += time.perf_counter() - t_mark
            stats, n = evaluate(run, args.batch_size)
            eval_batches += n
            max_acc = max(max_acc, stats["acc1"])
            print(f"Epoch {epoch}: {_eval_line(stats)} max_acc {max_acc:.2f}%", flush=True)
            if t_mark is not None:
                t_mark = time.perf_counter()
        if last:
            break
    if prev_loss is not None:
        losses.append(finite_loss(prev_loss))
    steady_ms = None
    if cuda and total > 1:
        torch.cuda.synchronize(run.device)
        steady_ms = train_s / (total - 1) * 1e3
    os.makedirs(args.output_dir, exist_ok=True)
    npz = os.path.join(args.output_dir, "params.npz")
    save_params_npz(npz, params_to_jax(run.state.params), run.cfg.to_json())
    print(f"finetuning done: {total} steps; params written to {npz}", flush=True)
    return {"steps": total, "losses": losses, "last_metrics": last_metrics, "eval": stats,
            "eval_batches": eval_batches, "max_acc": max_acc,
            "steady_ms_per_step": steady_ms, "npz": npz}


def _eval_line(stats: dict) -> str:
    return (f"acc1 {stats['acc1']:.2f}% acc5 {stats['acc5']:.2f}% loss {stats['loss']:.4f} "
            f"f1 {stats['macro_f1']:.2f} miou {stats['miou']:.2f} n {stats['n']}")


if __name__ == "__main__":
    main(argparse.ArgumentParser(parents=[get_args_parser()]).parse_args())
