"""Finetuning entry point, on the GPU.

Counterpart of ``cross_scale_mae_tpu/cli/finetune.py`` with its flag names
for what the port runs: a ViT classifier (``--model vit_large_patch16``, 64
px, patch 8 by default) started from a pretrained MAE encoder
(``--finetune params.npz``, written by the port's ``cli/pretrain`` or the
JAX package's ``save_params_npz``, a pretrain run's checkpoint directory,
``<output_dir>/checkpoints``, or a reference ``.pth``), the head
re-initialised, AdamW (b2 0.999) with layer-wise lr decay under the warmup +
half-cosine schedule, label smoothing and drop-path, then the evaluation
(loss, acc1, acc5, F1, mIoU) with the ragged last batch padded under a
validity mask. With ``--attention_impl pallas`` (what ``--attention
scaled_dot_product``, the default, resolves to) every attention forward and
backward runs in the hand-written CUDA kernels ``csrc/mha_fwd.cu`` and
``csrc/mha_bwd.cu``; a variant attention (``--attention linformer`` ...)
runs in stock PyTorch ops, a linformer encoder's E and F carried over from
a linformer MAE.

Data: ``--dataset_type synthetic`` (the default: seeded uint8 images and
labels, made as the JAX package's ``SyntheticDataset`` makes them and held
on the device), or ``fmow_rgb``, ``coco``, ``naip``, ``euro_sat`` or
``fmow_sentinel`` with ``--train_path`` and ``--test_path``, read by
``data/loader.DataLoader`` (the native core where it applies) and moved by
``device_prefetch`` (NAIP adds the rot90 augmentation). The multi-band
families take ``--masked_bands`` and ``--dropped_bands`` (raw band
indices), are normalized by the loader (SentinelNormalize), and give the
classifier the channels left (``input_channels``). At the end the
params are written as the JAX package's npz (``<run dir>/params.npz``, the
run directory ``<output_dir>/run_<name>``, ``+N`` when it exists).
Checkpoints (``utils/checkpoint.py``) go to ``<run dir>/checkpoints``
every ``--ckpt_interval`` (``--save_every``) epochs and after the last,
with the epoch and the best acc1 in the sidecar; ``--resume <dir>``
restores the newest and starts at the epoch after it, the best acc1
carried on. Data parallel as ``cli/pretrain``: one process per GPU, in the
JAX jit's global-batch semantics; ``--batch_size`` is the global batch,
and every rank reports the global eval. The recipe's flags run as in the
JAX CLI: Mixup/CutMix (``--mixup``, ``--cutmix``, ``--cutmix_minmax``,
``--mixup_prob``, ``--mixup_switch_prob``, ``--mixup_mode``), RandAugment
(``--aa``), ColorJitter (``--color_jitter``), RandomErasing (``--reprob``,
``--remode``, ``--recount``) and bf16 Adam moments (``--adam_mu_dtype``,
``--adam_nu_dtype``). ``<run dir>/log.jsonl`` gets one record per
evaluation; ``--use_tensorboard`` and ``--use_wandb`` (``--wandb_project``,
``--wandb_entity``, ``--wandb_id``) set up and close their loggers as the JAX
CLI does, which logs no step there; ``--profile_dir`` is parsed and
reported as not applicable (the JAX CLI traces nothing here either);
``--jax_platforms cpu`` runs as ``--device cpu``. The mesh flags
(``--model_parallel``, ``--sequence_parallel``, ``--fsdp``, ``--num_slices``)
lay the classifier out as ``cli/pretrain.py`` does; the reference
launcher's torch-DDP flags are accepted and reported as not applicable.

Usage:
    python -m cross_scale_mae_torch.cli.finetune --finetune pretrain/params.npz \\
        --attention_impl pallas --output_dir out                         # GPU
    python -m cross_scale_mae_torch.cli.finetune --model vit_base_patch16 \\
        --embed_dim 128 --depth 4 --num_heads 8 --input_size 32 --patch_size 8 \\
        --batch_size 4 --synthetic_len 8 --max_steps 2 --device cpu \\
        --output_dir out                                                  # CPU
    python -m cross_scale_mae_torch.cli.finetune ... --mixup 0.8 --cutmix 1.0 \\
        --smoothing 0.1 --aa rand-m9-mstd0.5-inc1 --reprob 0.25      # the recipe
    torchrun --nproc_per_node 4 -m cross_scale_mae_torch.cli.finetune \\
        --finetune pretrain/params.npz --output_dir out                  # 4 GPUs
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from cross_scale_mae_torch.cli.common import (
    add_data_args,
    add_reference_compat_args,
    add_runtime_args,
    apply_reference_compat,
    check_model_parallel,
    encode_run_name,
    make_loader,
    resolve_attention,
    restore_classifier_run,
    run_layout,
    run_output_dir,
    setup_runtime,
    validate_parallel_args,
)
from cross_scale_mae_torch.configs import (
    MAEConfig,
    TrainConfig,
    ViTClassifierConfig,
    get_mae_config,
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
from cross_scale_mae_torch.ops.augment import (
    AugmentExtras,
    make_eval_preprocess,
    make_finetune_augment,
)
from cross_scale_mae_torch.parallel.dist import Runtime, barrier, mesh, shutdown
from cross_scale_mae_torch.parallel.mesh import (
    Layout,
    all_reduce_total,
    broadcast_params,
    full_params,
    shard_params,
)
from cross_scale_mae_torch.train.classify import (
    make_classify_train_step,
    make_eval_step,
    sample_finetune_draws,
)
from cross_scale_mae_torch.train.mixup import MIXUP_MODES, MixupConfig
from cross_scale_mae_torch.train.optim import MOMENT_DTYPES, build_optimizer
from cross_scale_mae_torch.train.pretrain import _step_rng
from cross_scale_mae_torch.train.schedule import warmup_half_cosine
from cross_scale_mae_torch.train.state import TrainState, finite_loss, tree_leaves
from cross_scale_mae_torch.utils.checkpoint import (
    checkpoint_kind,
    read_host_checkpoint,
    save_checkpoint,
    save_params_npz,
)
from cross_scale_mae_torch.utils.logging import LogOptions, RunLogger, rank0_print
from cross_scale_mae_torch.utils.metrics import ConfusionMatrix, MetricLogger
from cross_scale_mae_torch.utils.params import (
    mae_encoder_to_classifier,
    merge_pretrained,
    params_from_jax,
    params_to_jax,
)
from cross_scale_mae_torch.utils.torch_import import import_mae_checkpoint

# What --attention scaled_dot_product runs: the K2 kernels, as the JAX
# finetune step runs them.
EXACT_IMPL = "pallas"


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
                   help="pretrained MAE params: an npz of save_params_npz, or a "
                        "pretrain run's checkpoint directory (the port's, or a JAX "
                        "run's Orbax one)")
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
    p.add_argument("--adam_mu_dtype", default=None, choices=list(MOMENT_DTYPES),
                   help="dtype of Adam's first moment (bfloat16 halves its memory)")
    p.add_argument("--adam_nu_dtype", default=None, choices=list(MOMENT_DTYPES),
                   help="dtype of Adam's second moment")
    # Augmentation (main_finetune.py:188-268)
    p.add_argument("--smoothing", default=0.1, type=float)
    p.add_argument("--mixup", default=0.0, type=float)
    p.add_argument("--cutmix", default=0.0, type=float)
    p.add_argument("--mixup_prob", default=1.0, type=float)
    p.add_argument("--mixup_switch_prob", default=0.5, type=float)
    p.add_argument("--cutmix_minmax", default=None, type=float, nargs=2,
                   help="min/max cut fraction; overrides --cutmix alpha and enables cutmix")
    p.add_argument("--mixup_mode", default="batch", choices=list(MIXUP_MODES))
    p.add_argument("--color_jitter", default=None, type=float,
                   help="ColorJitter factor; only when --aa is unset")
    p.add_argument("--aa", default=None, help="RandAugment policy, e.g. rand-m9-mstd0.5-inc1")
    p.add_argument("--reprob", default=0.0, type=float, help="RandomErasing probability")
    p.add_argument("--remode", default="pixel", choices=["pixel", "const"])
    p.add_argument("--recount", default=1, type=int)
    p.add_argument("--ckpt_interval", default=20, type=int,
                   help="write <run dir>/checkpoints every N epochs and after the last")
    p.add_argument("--save_every", dest="ckpt_interval", type=int,
                   default=argparse.SUPPRESS, help="reference alias for --ckpt_interval")
    p.add_argument("--eval_interval", default=1, type=int,
                   help="evaluate every N epochs and after the last")
    p.add_argument("--max_steps", default=None, type=int, help="hard step cap")
    p.add_argument("--unroll_blocks", action="store_true",
                   help="a layout knob of the JAX package (scan or unrolled); the port "
                        "runs the same loop for every setting")
    add_data_args(p, pretrain=False, default="synthetic")
    add_runtime_args(p)
    add_reference_compat_args(p, "finetune")
    return p


def check_args(args) -> None:
    """Resolve the compat flags, the dataset aliases and the attention;
    SystemExit for a mesh flag combination the JAX CLI refuses."""
    apply_reference_compat(args, "finetune")
    validate_parallel_args(args)
    resolve_attention(args, torch.device(args.device), EXACT_IMPL)


def load_pretrained_encoder(path: str, vcfg: ViTClassifierConfig, params: dict,
                            device: torch.device) -> dict:
    """Overlay a pretrained MAE encoder onto fresh classifier params, from
    an npz of ``save_params_npz``, a reference ``.pth``
    (``utils/torch_import``, read at the classifier's widths) or the newest
    step of a pretrain run's checkpoint directory, the port's or a JAX
    run's Orbax one (its params and sidecar config). pos_embed and the
    head stay fresh (and fc_norm with the global-pool head); a patch_embed
    of another shape keeps the fresh init, any other misfit raises naming
    the parameter."""
    if path.endswith(".pth"):
        if not os.path.isfile(path):
            raise SystemExit(f"--finetune {path}: no such .pth file")
        # The reference's schema carries no config: the encoder takes the
        # classifier's widths (the JAX package's finetune.py:141-152).
        mae_cfg = get_mae_config(
            "mae_vit_base", dim_model=vcfg.embed_dim, encoder_num_layers=vcfg.depth,
            encoder_num_heads=vcfg.num_heads, input_size=vcfg.input_size,
            patch_size=vcfg.patch_size, apply_encoder_norm=not vcfg.global_pool)
        mae_params = import_mae_checkpoint(path, mae_cfg, device, encoder_only=True)
    elif os.path.isdir(path) or path.endswith(".npz"):
        try:
            config, tree, _, _ = read_host_checkpoint(path)
        except (FileNotFoundError, ValueError) as e:
            raise SystemExit(f"--finetune {path}: {e}") from None
        if checkpoint_kind({"config": config}) != "mae":
            raise SystemExit(f"--finetune {path}: not a pretrain run's checkpoint")
        mae_cfg = MAEConfig.from_json(json.dumps(config)).replace(
            apply_encoder_norm=not vcfg.global_pool)
        mae_params = params_from_jax(tree, mae_cfg, device)
    else:
        raise SystemExit(
            f"--finetune {path}: the port reads save_params_npz files (.npz), "
            "reference checkpoints (.pth) and checkpoint directories (its own and "
            "the JAX package's Orbax ones)")
    pre, missing = mae_encoder_to_classifier(mae_params, vcfg)
    if pre["patch_embed"]["kernel"].shape != params["patch_embed"]["kernel"].shape:
        rank0_print("patch_embed shape mismatch; keeping fresh init")
        pre.pop("patch_embed")
    merged = merge_pretrained(params, pre)
    rank0_print(f"loaded pretrained encoder from {path}; fresh: {missing}")
    return merged


@dataclasses.dataclass
class FinetuneRun:
    """Everything one run's loop needs, built by :func:`build_run`: the
    synthetic sets on the device, or the real ones behind loaders (this
    rank's shards)."""

    cfg: ViTClassifierConfig
    tcfg: TrainConfig
    state: TrainState
    step_fn: Callable
    eval_fn: Callable
    steps_per_epoch: int
    rt: Runtime                                 # this process's rank, world and device
    canvas: int                                 # the train canvas the crops are drawn on
    rot90: bool = False                         # the NAIP rotations
    images: Optional[torch.Tensor] = None       # synthetic train set, uint8 on the device
    labels: Optional[torch.Tensor] = None
    eval_images: Optional[torch.Tensor] = None  # synthetic eval set on its 1/0.875 canvas
    eval_labels: Optional[torch.Tensor] = None
    train_loader: Optional[DataLoader] = None   # a real dataset's
    eval_loader: Optional[DataLoader] = None
    start_epoch: int = 0                        # after --resume, the checkpoint's epoch + 1
    max_acc: float = 0.0                        # the best acc1 so far, from the checkpoint
    extras: Optional[AugmentExtras] = None      # RandAugment, ColorJitter, RandomErasing
    mixup: Optional[MixupConfig] = None         # Mixup/CutMix
    log: LogOptions = LogOptions()              # TensorBoard and wandb
    layout: Layout = Layout()                   # what each rank holds of the params

    @property
    def device(self) -> torch.device:
        return self.rt.device

    def draws(self, step: int) -> list:
        """The draws of ``step``, this rank's rows of the global batch's: one
        set per microbatch, on the device."""
        gen = _step_rng(self.tcfg, self.tcfg.seed + 1, step, self.device)
        return [sample_finetune_draws(gen, self.tcfg.batch_size, self.cfg, self.canvas,
                                      self.rot90, self.extras, self.mixup
                                      ).shard(mesh().d, mesh().dp)
                for _ in range(self.tcfg.accum_iter)]

    def train_batches(self, epoch: int) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """The epoch's (uint8 images, int64 labels) step batches on the
        device, this rank's rows (d::dp of each global batch for data index
        d)."""
        if self.train_loader is not None:
            for imgs, labels in device_prefetch(self.train_loader.epoch(epoch), self.device):
                yield imgs, labels.long()
            return
        batch = self.tcfg.batch_size * self.tcfg.accum_iter
        order = torch.randperm(len(self.images), device=self.device,
                               generator=torch.Generator(device=self.device)
                               .manual_seed(self.tcfg.seed * 1_000_003 + epoch))
        for it in range(self.steps_per_epoch):
            idx = order[it * batch:(it + 1) * batch][mesh().d::mesh().dp]
            yield self.images[idx], self.labels[idx]

    def eval_batches(self, batch_size: int) -> Iterable:
        """This rank's shard of the eval set in order (d::dp), in batches of
        ``batch_size`` (the last one ragged), then batches of no sample up to
        the largest shard's count: host batches from the loader, or device
        slices."""
        if self.eval_loader is not None:
            return self.eval_loader.padded_epoch(0)
        rank, world = mesh().d, mesh().dp
        images, labels = self.eval_images[rank::world], self.eval_labels[rank::world]
        largest = -(-len(self.eval_labels) // world)
        return ((images[i:i + batch_size], labels[i:i + batch_size])
                for i in range(0, largest, batch_size))


def classifier_datasets(args, train_batch: int, eval_batch: int, rt: Runtime):
    """(train loader, eval loader) of a real dataset, this rank's shards of
    ``train_batch`` and ``eval_batch`` rows: the train canvas at
    ``--canvas_scale``, the eval canvas at 1/0.875 of the input size
    (util/datasets.py:140-148); shuffled with drop_last for training, in
    order and whole for eval."""
    common = dict(train_path=args.train_path, test_path=args.test_path,
                  input_size=args.input_size, synthetic_len=args.synthetic_len,
                  masked_bands=args.masked_bands, dropped_bands=args.dropped_bands)
    syn = {"num_classes": args.nb_classes} if args.dataset_type == "synthetic" else {}
    train_ds = build_dataset(args.dataset_type, True, canvas_scale=args.canvas_scale,
                             **common, **syn)
    eval_ds = build_dataset(args.dataset_type, False,
                            canvas_scale=1.0 / 0.875 if args.input_size <= 224 else 1.0,
                            **{**common, "synthetic_len": max(args.synthetic_len // 4, 64)},
                            **syn)
    return (make_loader(args, train_ds, train_batch, rt, seed=args.seed),
            make_loader(args, eval_ds, eval_batch, rt, is_train=False, seed=args.seed))


def build_run(args) -> FinetuneRun:
    """Config, data, seeded init (and the pretrained encoder), AdamW with
    layer decay, and the train and eval steps, on ``args.device``."""
    check_args(args)
    rt = setup_runtime(args)
    dev = rt.device
    eff_batch = args.batch_size * args.accum_iter
    data: dict[str, Any] = {}
    if args.dataset_type == "synthetic":
        num_classes = args.nb_classes
    else:
        train_loader, eval_loader = classifier_datasets(
            args, eff_batch // mesh().dp, args.batch_size // mesh().dp, rt)
        data = {"train_loader": train_loader, "eval_loader": eval_loader}
        num_classes = args.nb_classes or train_loader.dataset.num_classes
    overrides = {k: v for k, v in dict(embed_dim=args.embed_dim, depth=args.depth,
                                       num_heads=args.num_heads).items() if v is not None}
    train_ds = data["train_loader"].dataset if data else None
    vcfg = get_vit_config(
        args.model, input_size=args.input_size, patch_size=args.patch_size,
        num_classes=num_classes, global_pool=args.global_pool,
        drop_path_rate=args.drop_path, compute_dtype=args.compute_dtype,
        attention_impl=args.attention_impl, gelu=args.gelu, remat=args.remat,
        scan_blocks=not args.unroll_blocks,
        input_channels=train_ds.in_c if train_ds else 3,
        sequence_parallel=args.sequence_parallel, **overrides)
    check_model_parallel(args.model_parallel,
                         {"heads": vcfg.num_heads, "MLP": vcfg.embed_dim * vcfg.mlp_ratio})
    tcfg = TrainConfig(
        epochs=args.epochs, warmup_epochs=args.warmup_epochs, batch_size=args.batch_size,
        accum_iter=args.accum_iter, blr=args.blr, lr=args.lr, min_lr=args.min_lr,
        weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        layer_decay=args.layer_decay, label_smoothing=args.smoothing,
        mixup=args.mixup, cutmix=args.cutmix, mixup_prob=args.mixup_prob,
        mixup_switch_prob=args.mixup_switch_prob, mixup_mode=args.mixup_mode,
        cutmix_minmax=tuple(args.cutmix_minmax) if args.cutmix_minmax else None,
        seed=args.seed, log_interval=args.log_interval)
    mixup = MixupConfig.from_train_config(tcfg)
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
    broadcast_params([params, mstate])
    layout = run_layout(args)
    params = shard_params(params, layout)
    tx = build_optimizer(params, schedule, weight_decay=args.weight_decay, b1=0.9, b2=0.999,
                         clip_grad=args.clip_grad, layer_decay=args.layer_decay,
                         depth=vcfg.depth, no_decay_names=("pos_embed", "cls_token"),
                         mu_dtype=args.adam_mu_dtype, nu_dtype=args.adam_nu_dtype)
    state = TrainState.create(params, mstate, tx)
    state, start_epoch, max_acc = restore_classifier_run(args, state)
    # The dataset's own statistics, as the JAX CLI normalizes with them.
    mean, std = (train_ds.mean, train_ds.std) if train_ds else DATASET_STATS["synthetic"]
    normalize = train_ds.normalize_on_device if train_ds else True
    rot90 = args.dataset_type == "naip"
    try:
        augment = make_finetune_augment(
            mean, std, args.input_size, rot90=rot90, dtype=args.compute_dtype,
            normalize=normalize, color_jitter=args.color_jitter, aa=args.aa,
            reprob=args.reprob, remode=args.remode, recount=args.recount)
    except ValueError as e:
        raise SystemExit(f"--aa {args.aa}: {e}") from None
    preprocess = make_eval_preprocess(mean, std, args.input_size, dtype=args.compute_dtype,
                                      normalize=normalize)
    rank0_print(f"finetune {args.model}: {n_train} train / {n_eval} eval, "
                f"{vcfg.num_classes} classes, lr {lr:.3e}, layer_decay {args.layer_decay}")
    return FinetuneRun(vcfg, tcfg, state,
                       make_classify_train_step(vcfg, tcfg, schedule, augment=augment,
                                                data_parallel=rt.distributed),
                       make_eval_step(vcfg, preprocess=preprocess), steps_per_epoch, rt,
                       canvas, rot90, **data, start_epoch=start_epoch, max_acc=max_acc,
                       extras=augment.extras, mixup=mixup, log=LogOptions.from_args(args),
                       layout=layout)


def evaluate(eval_fn: Callable, state: TrainState, batches: Iterable, num_classes: int,
             batch_size: int, device: torch.device, distributed: bool = False
             ) -> tuple[dict, int]:
    """One pass over ``batches``, (images, labels) pairs on the host (numpy)
    or on the device, each moved to ``device`` and a short one padded with
    zero images to ``batch_size`` under a validity mask
    (engine_finetune.py:127-236). ``distributed``: the sums and the
    confusion matrix are summed over the ranks, so every rank returns the
    global stats. Returns (loss, acc1, acc5, macro/micro F1 and mIoU in
    percent, the valid count ``n`` and the confusion matrix ``cm``), and the
    number of batches this rank ran."""
    cm = torch.zeros((num_classes, num_classes), dtype=torch.float64, device=device)
    sums = torch.zeros(4, dtype=torch.float64, device=device)   # loss, acc1, acc5, n
    n_batches = 0
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
        cm += out["cm"].double()
        sums += torch.stack([out["loss"], out["acc1"], out["acc5"], torch.ones_like(out["n"])]
                            ).double() * out["n"].double()
        n_batches += 1
    if distributed:
        all_reduce_total([cm, sums])
    mat = ConfusionMatrix(num_classes)
    mat.mat = cm.round().long().cpu().numpy()
    loss, acc1, acc5, count = sums.tolist()
    count = max(count, 1.0)
    return {"loss": loss / count, "acc1": 100.0 * acc1 / count,
            "acc5": 100.0 * acc5 / count, "macro_f1": 100.0 * mat.f1("macro"),
            "micro_f1": 100.0 * mat.f1("micro"), "miou": 100.0 * mat.miou(),
            "n": int(mat.mat.sum()), "cm": mat.mat}, n_batches


def evaluate_run(run: FinetuneRun, batch_size: int) -> tuple[dict, int]:
    """:func:`evaluate` over the run's eval set, ``batch_size`` the global
    eval batch (each data rank runs its 1/dp of it)."""
    local = batch_size // mesh().dp
    return evaluate(run.eval_fn, run.state, run.eval_batches(local), run.cfg.num_classes,
                    local, run.device, run.rt.distributed)


def fit(run: FinetuneRun, args, ckpt_dir: Optional[str] = None,
        on_eval: Optional[Callable[[int, dict, float], None]] = None,
        on_epoch_end: Optional[Callable[[int, bool], None]] = None) -> dict[str, Any]:
    """The epoch loop of the classifier CLIs, from ``run.start_epoch`` with
    ``run.max_acc`` as the best acc1 so far: one step per batch with the
    NaN abort one step behind (and after the last step), the metrics every
    ``--log_interval`` steps, an evaluation every ``--eval_interval``
    epochs and after the last (then ``on_eval(epoch, stats, max_acc)``), a
    checkpoint in ``ckpt_dir`` every ``--ckpt_interval`` epochs and after
    the last (JAX cli/finetune.py:429-438: the epoch and the best acc1 in
    its sidecar), then ``on_epoch_end(epoch, last)``; ``--max_steps`` ends
    the run.

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
    max_acc, train_s = run.max_acc, 0.0
    first = run.start_epoch
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
                rank0_print(f"epoch {epoch} step {total} {mlog}")
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
            rank0_print(f"Epoch {epoch}: {eval_line(stats)} max_acc {max_acc:.2f}%")
            if on_eval is not None:
                on_eval(epoch, stats, max_acc)
        if ckpt_dir and ((epoch + 1) % args.ckpt_interval == 0 or epoch + 1 == args.epochs):
            save_checkpoint(ckpt_dir, run.state.step, run.state, run.cfg.to_json(),
                            {"epoch": epoch, "max_acc": max_acc})
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
    """Finetune, then evaluate, in a run directory of its own
    (``<output_dir>/run_<name>``, ``+N`` when it exists, as the JAX CLI);
    returns :func:`fit`'s results, the run directory (``output_dir``) and
    its npz path (written by rank 0)."""
    run = build_run(args)
    n_params = sum(p.numel() for p in tree_leaves(run.state.params))
    rank0_print(f"model {args.model}: {n_params / 1e6:.1f}M params on {run.device}; "
                f"{run.steps_per_epoch} steps/epoch; {run.rt.world_size} process(es)")
    if args.eval:
        stats, batches = evaluate_run(run, args.batch_size)
        rank0_print(f"eval: {eval_line(stats)}")
        return {"eval": stats, "eval_batches": batches}
    run_name = encode_run_name(ft=args.model, in_sz=args.input_size,
                               lr=run.tcfg.resolved_lr(args.batch_size * args.accum_iter),
                               ld=args.layer_decay, ds=args.dataset_type)
    # JAX cli/finetune.py:385-388.
    output_dir = run_output_dir(args, run_name)
    rank0_print(f"output dir: {output_dir}")
    with RunLogger.from_options(output_dir, run.log, run_name) as logger:
        result = fit(run, args, ckpt_dir=os.path.join(output_dir, "checkpoints"),
                     on_eval=epoch_logger(logger))
        tb_dir = logger.tensorboard_dir
    npz = os.path.join(output_dir, "params.npz")
    whole = full_params(run.state.params) if run.rt.distributed else run.state.params
    if run.rt.rank == 0:
        save_params_npz(npz, params_to_jax(whole), run.cfg.to_json())
    if run.rt.distributed:
        barrier()
    rank0_print(f"finetuning done: {result['steps']} steps; params written to {npz}")
    return {**result, "output_dir": output_dir, "npz": npz, "tensorboard_dir": tb_dir}


def epoch_logger(logger: RunLogger) -> Callable[[int, dict, float], None]:
    """``fit``'s ``on_eval``: one log.jsonl record per evaluation, the
    confusion matrix left out (JAX cli/finetune.py:428)."""
    def log_eval(epoch: int, stats: dict, max_acc: float) -> None:
        logger.log_epoch({"epoch": epoch, **{k: v for k, v in stats.items() if k != "cm"},
                          "max_acc": max_acc})
    return log_eval


def eval_line(stats: dict) -> str:
    return (f"acc1 {stats['acc1']:.2f}% acc5 {stats['acc5']:.2f}% loss {stats['loss']:.4f} "
            f"f1 {stats['macro_f1']:.2f} miou {stats['miou']:.2f} n {stats['n']}")


if __name__ == "__main__":
    try:
        main(argparse.ArgumentParser(parents=[get_args_parser()]).parse_args())
    finally:
        shutdown()
