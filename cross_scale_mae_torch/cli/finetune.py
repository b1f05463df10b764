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

Data: ``--dataset_type synthetic`` (the default: seeded uint8 images and
labels, made as the JAX package's ``SyntheticDataset`` makes them and held
on the device), or ``fmow_rgb``, ``coco`` or ``naip`` with ``--train_path``
and ``--test_path``, read by ``data/loader.DataLoader`` and moved by
``device_prefetch`` (NAIP adds the rot90 augmentation). At the end the
params are written as the JAX package's npz (``<output_dir>/params.npz``).
Mixup/CutMix, RandAugment, color jitter, random erasing, the TIFF and
temporal datasets, resume, DDP and TP/SP, the Adam moment dtypes, Orbax
and ``.pth`` checkpoints are not ported yet and refuse with a pointer to
ROADMAP.md.

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
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from cross_scale_mae_torch.cli.common import (
    UNPORTED_RUNTIME,
    add_data_args,
    add_runtime_args,
    apply_reference_compat,
    make_loader,
    refuse_unported,
)
from cross_scale_mae_torch.configs import (
    MAEConfig,
    TrainConfig,
    ViTClassifierConfig,
    get_vit_config,
)
from cross_scale_mae_torch.data.datasets import (
    DATASET_STATS,
    build_dataset,
    canvas_size,
    synthetic_images,
    synthetic_labels,
)
from cross_scale_mae_torch.data.loader import DataLoader, device_prefetch
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
    **UNPORTED_RUNTIME, "adam_mu_dtype": 7, "adam_nu_dtype": 7,
    "cutmix_minmax": 12, "color_jitter": 12, "aa": 12,
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
    add_data_args(p, pretrain=False, default="synthetic")
    add_runtime_args(p)
    # The K2 kernels, as the JAX finetune step runs them.
    p.set_defaults(attention_impl="pallas")
    g = p.add_argument_group("not ported yet (ROADMAP.md)")
    for flag in ("adam_mu_dtype", "adam_nu_dtype", "aa"):
        g.add_argument(f"--{flag}", default=None)
    g.add_argument("--color_jitter", default=None, type=float)
    g.add_argument("--reprob", default=0.0, type=float)
    g.add_argument("--cutmix_minmax", default=None, type=float, nargs=2)
    return p


def check_args(args) -> None:
    """Resolve the dataset aliases; SystemExit for a flag, value or dataset
    not ported yet."""
    apply_reference_compat(args, "finetune")
    refuse_unported(args, UNPORTED_FLAGS)
    for flag, off in UNPORTED_VALUES.items():
        if getattr(args, flag) != off:
            raise SystemExit(
                f"--{flag} {getattr(args, flag)}: mixup, cutmix and random erasing are "
                "not ported yet; see ROADMAP.md (queue 1 item 12)")


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
    """Everything one run's loop needs, built by :func:`build_run`: the
    synthetic sets on the device, or the real ones behind loaders."""

    cfg: ViTClassifierConfig
    tcfg: TrainConfig
    state: TrainState
    step_fn: Callable
    eval_fn: Callable
    steps_per_epoch: int
    device: torch.device
    canvas: int                                 # the train canvas the crops are drawn on
    rot90: bool = False                         # the NAIP rotations
    images: Optional[torch.Tensor] = None       # synthetic train set, uint8 on the device
    labels: Optional[torch.Tensor] = None
    eval_images: Optional[torch.Tensor] = None  # synthetic eval set on its 1/0.875 canvas
    eval_labels: Optional[torch.Tensor] = None
    train_loader: Optional[DataLoader] = None   # a real dataset's
    eval_loader: Optional[DataLoader] = None

    def draws(self, step: int) -> list:
        """The draws of ``step``: one set per microbatch, on the device."""
        gen = _step_rng(self.tcfg, self.tcfg.seed + 1, step, self.device)
        return [sample_finetune_draws(gen, self.tcfg.batch_size, self.cfg, self.canvas,
                                      self.rot90)
                for _ in range(self.tcfg.accum_iter)]

    def train_batches(self, epoch: int) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """The epoch's (uint8 images, int64 labels) step batches on the device."""
        if self.train_loader is not None:
            for imgs, labels in device_prefetch(self.train_loader.epoch(epoch), self.device):
                yield imgs, labels.long()
            return
        batch = self.tcfg.batch_size * self.tcfg.accum_iter
        order = torch.randperm(len(self.images), device=self.device,
                               generator=torch.Generator(device=self.device)
                               .manual_seed(self.tcfg.seed * 1_000_003 + epoch))
        for it in range(self.steps_per_epoch):
            idx = order[it * batch:(it + 1) * batch]
            yield self.images[idx], self.labels[idx]

    def eval_batches(self, batch_size: int) -> Iterable:
        """The eval set in order, in batches of ``batch_size`` (the last one
        ragged): host batches from the loader, or device slices."""
        if self.eval_loader is not None:
            return self.eval_loader.epoch(0)
        return ((self.eval_images[i:i + batch_size], self.eval_labels[i:i + batch_size])
                for i in range(0, len(self.eval_labels), batch_size))


def classifier_datasets(args, train_batch: int, eval_batch: int):
    """(train loader, eval loader) of a real dataset: the train canvas at
    ``--canvas_scale``, the eval canvas at 1/0.875 of the input size
    (util/datasets.py:140-148); shuffled with drop_last for training, in
    order and whole for eval."""
    common = dict(train_path=args.train_path, test_path=args.test_path,
                  input_size=args.input_size, synthetic_len=args.synthetic_len)
    syn = {"num_classes": args.nb_classes} if args.dataset_type == "synthetic" else {}
    train_ds = build_dataset(args.dataset_type, True, canvas_scale=args.canvas_scale,
                             **common, **syn)
    eval_ds = build_dataset(args.dataset_type, False,
                            canvas_scale=1.0 / 0.875 if args.input_size <= 224 else 1.0,
                            **{**common, "synthetic_len": max(args.synthetic_len // 4, 64)},
                            **syn)
    return (make_loader(args, train_ds, train_batch, seed=args.seed),
            make_loader(args, eval_ds, eval_batch, is_train=False, seed=args.seed))


def build_run(args) -> FinetuneRun:
    """Config, data, seeded init (and the pretrained encoder), AdamW with
    layer decay, and the train and eval steps, on ``args.device``."""
    check_args(args)
    dev = resolve_device(args.device)
    eff_batch = args.batch_size * args.accum_iter
    data: dict[str, Any] = {}
    if args.dataset_type == "synthetic":
        num_classes = args.nb_classes
    else:
        train_loader, eval_loader = classifier_datasets(args, eff_batch, args.batch_size)
        data = {"train_loader": train_loader, "eval_loader": eval_loader}
        num_classes = args.nb_classes or train_loader.dataset.num_classes
    overrides = {k: v for k, v in dict(embed_dim=args.embed_dim, depth=args.depth,
                                       num_heads=args.num_heads).items() if v is not None}
    vcfg = get_vit_config(
        args.model, input_size=args.input_size, patch_size=args.patch_size,
        num_classes=num_classes, global_pool=args.global_pool,
        drop_path_rate=args.drop_path, compute_dtype=args.compute_dtype,
        attention_impl=args.attention_impl, gelu=args.gelu, **overrides)
    tcfg = TrainConfig(
        epochs=args.epochs, warmup_epochs=args.warmup_epochs, batch_size=args.batch_size,
        accum_iter=args.accum_iter, blr=args.blr, lr=args.lr, min_lr=args.min_lr,
        weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        layer_decay=args.layer_decay, label_smoothing=args.smoothing, seed=args.seed,
        log_interval=args.log_interval)
    c = vcfg.input_channels
    if data:
        canvas = data["train_loader"].dataset.canvas_size
        steps_per_epoch = data["train_loader"].steps_per_epoch()
        n_train, n_eval = len(data["train_loader"].dataset), len(data["eval_loader"].dataset)
    else:
        canvas = args.input_size
        n_train, n_eval = args.synthetic_len, max(args.synthetic_len // 4, 64)
        eval_canvas = canvas_size(args.input_size,
                                  1.0 / 0.875 if args.input_size <= 224 else 1.0)
        data = {"images": synthetic_images(n_train, canvas, c, args.seed, dev),
                "labels": synthetic_labels(n_train, num_classes, args.seed, dev),
                "eval_images": synthetic_images(n_eval, eval_canvas, c, args.seed, dev),
                "eval_labels": synthetic_labels(n_eval, num_classes, args.seed, dev)}
        steps_per_epoch = n_train // eff_batch
    if steps_per_epoch < 1 and not args.eval:
        raise SystemExit(f"{n_train} train images are fewer than one step's {eff_batch}")
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
    # The dataset's own statistics, as the JAX CLI normalizes with them.
    train_loader = data.get("train_loader")
    mean, std = ((train_loader.dataset.mean, train_loader.dataset.std) if train_loader
                 else DATASET_STATS["synthetic"])
    rot90 = args.dataset_type == "naip"
    augment = make_finetune_augment(mean, std, args.input_size, rot90=rot90,
                                    dtype=args.compute_dtype)
    preprocess = make_eval_preprocess(mean, std, args.input_size, dtype=args.compute_dtype)
    print(f"finetune {args.model}: {n_train} train / {n_eval} eval, "
          f"{vcfg.num_classes} classes, lr {lr:.3e}, layer_decay {args.layer_decay}",
          flush=True)
    return FinetuneRun(vcfg, tcfg, state,
                       make_classify_train_step(vcfg, tcfg, schedule, augment=augment),
                       make_eval_step(vcfg, preprocess=preprocess), steps_per_epoch, dev,
                       canvas, rot90, **data)


def evaluate(eval_fn: Callable, state: TrainState, batches: Iterable, num_classes: int,
             batch_size: int, device: torch.device) -> tuple[dict, int]:
    """One pass over ``batches``, (images, labels) pairs on the host (numpy)
    or on the device, each moved to ``device`` and a short one padded with
    zero images to ``batch_size`` under a validity mask
    (engine_finetune.py:127-236). Returns (loss, acc1, acc5, macro/micro F1
    and mIoU in percent, the valid count ``n`` and the confusion matrix
    ``cm``), and the number of batches."""
    cm = ConfusionMatrix(num_classes)
    sums = {"loss": 0.0, "acc1": 0.0, "acc5": 0.0}
    count, n_batches = 0.0, 0
    for imgs, labels in batches:
        imgs = torch.as_tensor(imgs, device=device)
        labels = torch.as_tensor(labels, device=device).long()
        n = len(labels)
        if n < batch_size:
            pad = batch_size - n
            imgs = torch.cat([imgs, imgs.new_zeros((pad,) + imgs.shape[1:])])
            labels = torch.cat([labels, labels.new_zeros(pad)])
        valid = torch.arange(batch_size, device=device) < n
        out = eval_fn(state.params, state.model_state, imgs, labels, valid)
        cm.mat += out["cm"].double().round().long().cpu().numpy()
        n_valid = float(out["n"])
        for k in sums:
            sums[k] += float(out[k]) * n_valid
        count += n_valid
        n_batches += 1
    count = max(count, 1.0)
    return {"loss": sums["loss"] / count, "acc1": 100.0 * sums["acc1"] / count,
            "acc5": 100.0 * sums["acc5"] / count, "macro_f1": 100.0 * cm.f1("macro"),
            "micro_f1": 100.0 * cm.f1("micro"), "miou": 100.0 * cm.miou(),
            "n": int(cm.mat.sum()), "cm": cm.mat}, n_batches


def evaluate_run(run: FinetuneRun, batch_size: int) -> tuple[dict, int]:
    """:func:`evaluate` over the run's eval set."""
    return evaluate(run.eval_fn, run.state, run.eval_batches(batch_size),
                    run.cfg.num_classes, batch_size, run.device)


def fit(run: FinetuneRun, args,
        on_eval: Optional[Callable[[int, dict, float], None]] = None,
        on_epoch_end: Optional[Callable[[int, bool], None]] = None) -> dict[str, Any]:
    """The epoch loop of the classifier CLIs: one step per batch with the
    NaN abort one step behind (and after the last step), the metrics every
    ``--log_interval`` steps, an evaluation every ``--eval_interval``
    epochs and after the last (then ``on_eval(epoch, stats, max_acc)``),
    then ``on_epoch_end(epoch, last)``; ``--max_steps`` ends the run.

    Returns the step count, every step's loss, the last logged metrics, the
    last eval's stats, the eval batches run, the best acc1 and, on the GPU,
    the steady ms per step: the wall time of each epoch after the first,
    from the start of its batches (the loader's fill included) to the end
    of its last step, over its steps. Evaluation is left out, and so is the
    first epoch, whose first step builds the kernels while the loader reads
    ahead. None when a single epoch ran."""
    cuda = run.device.type == "cuda"
    losses: list[float] = []
    last_metrics: dict[str, float] = {}
    stats: dict = {}
    prev_loss = None
    total = eval_batches = timed_steps = 0
    max_acc, train_s = 0.0, 0.0
    first = getattr(args, "start_epoch", None) or 0
    for epoch in range(first, args.epochs):
        timed = cuda and epoch > first
        if timed:
            torch.cuda.synchronize(run.device)
            t0, steps_before = time.perf_counter(), total
        mlog = MetricLogger()
        for imgs, labels in run.train_batches(epoch):
            _, metrics = run.step_fn(run.state, imgs, labels, run.draws(run.state.step))
            # NaN abort one step behind, so the host does not wait for the
            # step it just enqueued.
            if prev_loss is not None:
                losses.append(finite_loss(prev_loss))
            prev_loss = metrics["loss"]
            total += 1
            if (total - 1) % args.log_interval == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                mlog.update(**last_metrics)
                print(f"epoch {epoch} step {total} {mlog}", flush=True)
            if args.max_steps and total >= args.max_steps:
                break
        if timed:
            torch.cuda.synchronize(run.device)
            train_s += time.perf_counter() - t0
            timed_steps += total - steps_before
        last = epoch + 1 == args.epochs or bool(args.max_steps and total >= args.max_steps)
        if (epoch + 1) % args.eval_interval == 0 or last:
            stats, n = evaluate_run(run, args.batch_size)
            eval_batches += n
            max_acc = max(max_acc, stats["acc1"])
            print(f"Epoch {epoch}: {eval_line(stats)} max_acc {max_acc:.2f}%", flush=True)
            if on_eval is not None:
                on_eval(epoch, stats, max_acc)
        if on_epoch_end is not None:
            on_epoch_end(epoch, last)
        if last:
            break
    # The one-behind abort never sees the last step's loss.
    if prev_loss is not None:
        losses.append(finite_loss(prev_loss))
    return {"steps": total, "losses": losses, "last_metrics": last_metrics, "eval": stats,
            "eval_batches": eval_batches, "max_acc": max_acc,
            "steady_ms_per_step": train_s / timed_steps * 1e3 if timed_steps else None}


def main(args) -> dict[str, Any]:
    """Finetune, then evaluate; returns :func:`fit`'s results and the npz
    path."""
    run = build_run(args)
    n_params = sum(p.numel() for p in tree_leaves(run.state.params))
    print(f"model {args.model}: {n_params / 1e6:.1f}M params on {run.device}; "
          f"{run.steps_per_epoch} steps/epoch", flush=True)
    if args.eval:
        stats, batches = evaluate_run(run, args.batch_size)
        print(f"eval: {eval_line(stats)}", flush=True)
        return {"eval": stats, "eval_batches": batches}
    result = fit(run, args)
    os.makedirs(args.output_dir, exist_ok=True)
    npz = os.path.join(args.output_dir, "params.npz")
    save_params_npz(npz, params_to_jax(run.state.params), run.cfg.to_json())
    print(f"finetuning done: {result['steps']} steps; params written to {npz}", flush=True)
    return {**result, "npz": npz}


def eval_line(stats: dict) -> str:
    return (f"acc1 {stats['acc1']:.2f}% acc5 {stats['acc5']:.2f}% loss {stats['loss']:.4f} "
            f"f1 {stats['macro_f1']:.2f} miou {stats['miou']:.2f} n {stats['n']}")


if __name__ == "__main__":
    main(argparse.ArgumentParser(parents=[get_args_parser()]).parse_args())
