"""Linear-probe entry point, on the GPU.

Counterpart of ``cross_scale_mae_tpu/cli/linprobe.py`` with its flag names
and defaults (linprobe.sh:6-9, main_linprobe.py:119-142): a ViT classifier
(``--model vit_base_patch16``, 128 px, patch 16, the cls-token head) with
the affine-free BatchNorm in front of the head (main_linprobe.py:517-520),
started from a pretrained MAE encoder (``--finetune params.npz``, written by
the port's ``cli/pretrain`` or the JAX package's ``save_params_npz``, or a
pretrain run's checkpoint directory) with
the head re-initialised as trunc_normal(0.01); everything but the head is
frozen (main_linprobe.py:521-525): the backbone runs without autograd and
LARS (blr 0.1, lr = blr * eff_batch / 256, weight decay 0) updates the head
alone under the warmup + half-cosine schedule. The train chain is the
pretrain augmentation (with rot90 for NAIP); evaluation pads the ragged
last batch under a validity mask. With ``--attention_impl pallas_v3`` (what
``--attention scaled_dot_product`` resolves to on the GPU) every attention
forward runs in the hand-written CUDA kernel ``csrc/mha3_fwd.cu``; nothing
runs a backward kernel.

Data: ``--dataset_type`` fmow_rgb, coco, naip, euro_sat, fmow_sentinel
(with ``--masked_bands``/``--dropped_bands``; the classifier takes the
channels left) or synthetic through ``data/loader.DataLoader`` (the native
core where it applies) and ``device_prefetch``. The run directory
(``<output_dir>/<run name>``) gets ``log.jsonl`` (one line per evaluation),
``params.npz`` (the JAX package's npz) and ``checkpoints/`` (the head's
LARS state with the rest; the epoch and the best acc1 in the sidecar),
written by rank 0 every ``--ckpt_interval`` epochs and after the last;
``--resume <dir>`` restores the newest checkpoint and starts at the epoch
after it. Data parallel as ``cli/pretrain``: one process per GPU, in the
JAX jit's global-batch semantics (the BN head's statistics over every
rank's rows). TP/SP/FSDP, TensorBoard/wandb (``--wandb_id`` too) and
``.pth`` inputs are not ported yet and refuse with a pointer to ROADMAP.md.

Usage:
    python -m cross_scale_mae_torch.cli.linprobe --finetune pretrain/params.npz \\
        --dataset_type naip --train_path train.csv --test_path val.csv \\
        --nb_classes 10 --output_dir out                                  # GPU
    python -m cross_scale_mae_torch.cli.linprobe --model vit_base_patch16 \\
        --embed_dim 128 --depth 4 --num_heads 8 --input_size 32 --patch_size 8 \\
        --finetune pretrain/params.npz --dataset_type synthetic --synthetic_len 64 \\
        --nb_classes 5 --batch_size 16 --epochs 2 --warmup_epochs 1 \\
        --device cpu --output_dir out                                     # CPU
"""

from __future__ import annotations

import argparse
import os
from typing import Any

import torch

from cross_scale_mae_torch.cli.common import (
    UNPORTED_RUNTIME,
    add_data_args,
    add_reference_compat_args,
    add_runtime_args,
    apply_reference_compat,
    encode_run_name,
    refuse_unported,
    resolve_attention,
    restore_classifier_run,
    setup_runtime,
)
from cross_scale_mae_torch.cli.finetune import (
    FinetuneRun,
    classifier_datasets,
    eval_line,
    evaluate_run,
    fit,
    load_pretrained_encoder,
)
from cross_scale_mae_torch.configs import TrainConfig, get_vit_config
from cross_scale_mae_torch.models.vit import trunc_normal, vit_init
from cross_scale_mae_torch.ops.augment import make_eval_preprocess, make_pretrain_augment
from cross_scale_mae_torch.parallel.dist import barrier, broadcast_object, shutdown
from cross_scale_mae_torch.parallel.mesh import broadcast_params
from cross_scale_mae_torch.train.classify import make_classify_train_step, make_eval_step
from cross_scale_mae_torch.train.optim import build_optimizer
from cross_scale_mae_torch.train.schedule import warmup_half_cosine
from cross_scale_mae_torch.train.state import TrainState, tree_leaves
from cross_scale_mae_torch.utils.checkpoint import save_params_npz
from cross_scale_mae_torch.utils.logging import RunLogger, auto_output_dir, rank0_print
from cross_scale_mae_torch.utils.params import params_to_jax


# Flags of the JAX CLI that the port parses but does not run yet:
# flag -> ROADMAP.md queue 1 item.
UNPORTED_FLAGS = {**UNPORTED_RUNTIME, "wandb_id": 16}


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Cross-Scale MAE linear probing (PyTorch)", add_help=False)
    p.add_argument("--model", default="vit_base_patch16")
    p.add_argument("--input_size", default=128, type=int)  # linprobe.sh:8
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--global_pool", action="store_true", default=False)
    p.add_argument("--cls_token", action="store_false", dest="global_pool",
                   help="classify from the cls token (the linprobe default)")
    p.add_argument("--finetune", default="",
                   help="pretrained MAE params: an npz of save_params_npz, or a "
                        "pretrain run's checkpoint directory")
    p.add_argument("--eval", action="store_true", help="evaluate only")
    p.add_argument("--embed_dim", default=None, type=int)
    p.add_argument("--depth", default=None, type=int)
    p.add_argument("--num_heads", default=None, type=int)
    # linprobe.sh:6-9 + main_linprobe.py:119-142 defaults
    p.add_argument("--epochs", default=50, type=int)
    p.add_argument("--warmup_epochs", default=10, type=int)
    p.add_argument("--batch_size", default=1024, type=int)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--blr", default=0.1, type=float)
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--min_lr", default=0.0, type=float)
    p.add_argument("--weight_decay", default=0.0, type=float,
                   help="accepted; the probe runs LARS with weight decay 0 "
                        "(main_linprobe.py:557-558), as the JAX package does")
    p.add_argument("--ckpt_interval", default=20, type=int,
                   help="write checkpoints/ every N epochs and after the last, and "
                        "params.npz then and at the end")
    p.add_argument("--save_every", dest="ckpt_interval", type=int,
                   default=argparse.SUPPRESS, help="reference alias for --ckpt_interval")
    p.add_argument("--eval_interval", default=1, type=int,
                   help="evaluate every N epochs and after the last")
    p.add_argument("--max_steps", default=None, type=int, help="hard step cap")
    p.add_argument("--unroll_blocks", action="store_true",
                   help="a layout knob of the JAX package (scan or unrolled); the port "
                        "runs the same loop for every setting")
    add_data_args(p, pretrain=False)
    add_runtime_args(p)
    add_reference_compat_args(p, "linprobe")
    return p


def _full_like(tree: Any, value: bool) -> Any:
    if isinstance(tree, dict):
        return {k: _full_like(v, value) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_full_like(v, value) for v in tree]
    return value


def head_only_mask(params: dict) -> dict:
    """A tree of bools like ``params``, True on the head's leaves alone: the
    optimizer's frozen mask (main_linprobe.py:521-525)."""
    return {k: _full_like(v, k == "head") for k, v in params.items()}


def build_run(args) -> FinetuneRun:
    """Config, loaders, the pretrained encoder under a fresh head, LARS on
    the head alone, and the train and eval steps, on ``args.device``."""
    apply_reference_compat(args, "linprobe")
    refuse_unported(args, UNPORTED_FLAGS)
    rt = setup_runtime(args)
    dev = rt.device
    resolve_attention(args, dev)
    eff_batch = args.batch_size * args.accum_iter
    # accum_iter loader batches per optimizer step keep lr = blr * eff_batch / 256.
    train_loader, eval_loader = classifier_datasets(
        args, eff_batch // rt.world_size, args.batch_size // rt.world_size, rt)
    train_ds = train_loader.dataset
    num_classes = args.nb_classes or train_ds.num_classes
    overrides = {k: v for k, v in dict(embed_dim=args.embed_dim, depth=args.depth,
                                       num_heads=args.num_heads).items() if v is not None}
    vcfg = get_vit_config(
        args.model, input_size=args.input_size, patch_size=args.patch_size,
        num_classes=num_classes, global_pool=args.global_pool, use_bn_head=True,
        compute_dtype=args.compute_dtype, attention_impl=args.attention_impl,
        gelu=args.gelu, remat=args.remat, scan_blocks=not args.unroll_blocks,
        input_channels=train_ds.in_c, **overrides)
    # Plain CE on minimal augmentation (main_linprobe.py:562-565).
    tcfg = TrainConfig(
        epochs=args.epochs, warmup_epochs=args.warmup_epochs, batch_size=args.batch_size,
        accum_iter=args.accum_iter, blr=args.blr, lr=args.lr, min_lr=args.min_lr,
        weight_decay=0.0, label_smoothing=0.0, mixup=0.0, cutmix=0.0, optimizer="lars",
        seed=args.seed, log_interval=args.log_interval)
    steps_per_epoch = max(train_loader.steps_per_epoch(), 1)
    lr = tcfg.resolved_lr(eff_batch)
    schedule = warmup_half_cosine(lr, args.min_lr, args.warmup_epochs, args.epochs,
                                  steps_per_epoch)
    params, mstate = vit_init(vcfg, torch.Generator(device=dev).manual_seed(args.seed))
    if args.finetune:
        params = load_pretrained_encoder(args.finetune, vcfg, params, dev)
        # Head init trunc_normal(0.01) (main_linprobe.py:516).
        params["head"]["kernel"] = trunc_normal(
            torch.Generator(device=dev).manual_seed(args.seed + 2),
            tuple(params["head"]["kernel"].shape), 0.01)
    broadcast_params([params, mstate])
    tx = build_optimizer(params, schedule, optimizer="lars", weight_decay=0.0,
                         frozen_mask=head_only_mask(params))
    state = TrainState.create(params, mstate, tx)
    state, start_epoch, max_acc = restore_classifier_run(args, state)
    rot90 = args.dataset_type == "naip"
    normalize = train_ds.normalize_on_device   # False: the loader normalized
    augment = make_pretrain_augment(train_ds.mean, train_ds.std, args.input_size,
                                    rot90=rot90, dtype=args.compute_dtype,
                                    normalize=normalize)
    preprocess = make_eval_preprocess(train_ds.mean, train_ds.std, args.input_size,
                                      dtype=args.compute_dtype, normalize=normalize)
    rank0_print(f"linprobe {args.model}: {len(train_ds)} train / {len(eval_loader.dataset)} "
                f"eval, {num_classes} classes, lr {lr:.3e} (LARS), attention "
                f"{args.attention_impl}; {rt.world_size} process(es)")
    return FinetuneRun(
        vcfg, tcfg, state,
        make_classify_train_step(vcfg, tcfg, schedule, augment=augment, freeze_backbone=True,
                                 data_parallel=rt.distributed),
        make_eval_step(vcfg, preprocess=preprocess), steps_per_epoch, rt,
        train_ds.canvas_size, rot90, train_loader=train_loader, eval_loader=eval_loader,
        start_epoch=start_epoch, max_acc=max_acc)


def main(args) -> dict[str, Any]:
    """Probe, evaluating every ``--eval_interval`` epochs into log.jsonl and
    writing a checkpoint and params.npz every ``--ckpt_interval`` epochs
    and after the last (rank 0 alone logs and writes, in the run directory
    it chose for every rank); returns :func:`cli.finetune.fit`'s results,
    the run directory, the npz path and the run itself."""
    run = build_run(args)
    if args.eval:
        stats, batches = evaluate_run(run, args.batch_size)
        rank0_print(f"eval: {eval_line(stats)}")
        return {"eval": stats, "eval_batches": batches, "run": run}
    lr = run.tcfg.resolved_lr(args.batch_size * args.accum_iter)
    run_name = encode_run_name(lin=args.model, in_sz=args.input_size, lr=lr,
                               ds=args.dataset_type)
    main_rank = run.rt.rank == 0
    # One directory for all ranks: rank 0 claims it and tells the others.
    output_dir = broadcast_object(
        auto_output_dir(args.output_dir, run=run_name) if main_rank else None)
    logger = RunLogger(output_dir) if main_rank else None
    npz = os.path.join(output_dir, "params.npz")

    def log_eval(epoch: int, stats: dict, max_acc: float) -> None:
        if logger is not None:
            logger.log_epoch({"epoch": epoch, **{k: v for k, v in stats.items() if k != "cm"},
                              "max_acc": max_acc})

    def save(epoch: int, last: bool) -> None:
        if main_rank and ((epoch + 1) % args.ckpt_interval == 0 or last):
            save_params_npz(npz, params_to_jax(run.state.params), run.cfg.to_json())

    result = fit(run, args, os.path.join(output_dir, "checkpoints"), on_eval=log_eval,
                 on_epoch_end=save)
    if logger is not None:
        logger.close()
    if run.rt.distributed:
        barrier()
    n_params = sum(p.numel() for p in tree_leaves(run.state.params))
    rank0_print(f"linear probe done: {result['steps']} steps, {n_params / 1e6:.1f}M params; "
                f"params written to {npz}")
    return {**result, "output_dir": output_dir, "npz": npz, "run": run}


if __name__ == "__main__":
    try:
        main(argparse.ArgumentParser(parents=[get_args_parser()]).parse_args())
    finally:
        shutdown()
