"""Pretraining entry point, on the GPU.

Counterpart of ``cross_scale_mae_tpu/cli/pretrain.py`` with its flag names
for what the port runs: the model registry (``--model
mae_vit_base_MsLdCeCd``), the loss flags, the lr rule lr = blr * eff_batch
/ 256, AdamW under the warmup + half-cosine schedule, and the whole step
(augment, two-view forward, losses, backward, AdamW) with the attention in
the hand-written CUDA kernels when ``--attention_impl pallas_v3`` (what
``--attention scaled_dot_product``, the default, resolves to). The
reference's variant attentions (``--attention`` or ``--attn_name``
linformer, nystrom, orthoformer, local or fourier_mix) run in stock PyTorch
ops in the encoder and the decoder, with no attention kernel.

Data parallel: one process per GPU over ``torch.distributed`` (NCCL on the
card, gloo with ``--device cpu``), launched by torchrun or given
``--coordinator_address host:port --num_processes W --process_id r``.
``--batch_size`` is the global batch; each rank runs its 1/W of it.
``--ddp_mode gspmd`` (the default) computes the JAX jit's global loss:
NT-Xent over the gathered batch, the predictors' BatchNorm on global
statistics. ``--ddp_mode shard_map`` computes the reference DDP's
per-rank loss, as ``--reference_semantics`` (with ``--gelu exact`` and
``--batch_crop``) asks. Only rank 0 prints and writes files.

Data: ``--dataset_type synthetic`` (the default: seeded uint8 images, made
as the JAX package's ``SyntheticDataset`` makes them and held on the
device), or ``fmow_rgb``, ``coco``, ``naip``, ``euro_sat``,
``fmow_sentinel`` (with ``--masked_bands``/``--dropped_bands``) or
``fmow_temporal`` with ``--train_path``, read by ``data/loader.DataLoader``
(the native core where it applies) and moved by ``device_prefetch`` (NAIP
adds the rot90 augmentation; the SentinelNormalize families are normalized
by the loader). ``fmow_temporal`` reads pairs of captures of one site and
needs a multi-scale model: each frame is augmented with its own draws, and
the later frame stands in for the low-GSD crop as the second view. At the
end the params are written as the JAX package's npz
(``<run dir>/params.npz``), which ``cli/serve.py`` serves.

Checkpoints and recovery, as the JAX CLI: ``<run dir>/checkpoints/``
(``utils/checkpoint.py``) every ``--ckpt_interval`` epochs, after the last
and on a stop request; ``--resume <dir>`` restores its newest step and
starts at the epoch after the checkpoint's (a directory with no checkpoint
starts fresh; ``--start_epoch`` wins when given). A checkpoint written on
a stop in the middle of an epoch resumes at the next epoch, leaving that
epoch's remaining steps out, as the JAX package does. SIGTERM or SIGINT
finishes the current step, writes a checkpoint and exits 0; under data
parallelism the ranks agree on the step to stop after through the step's
own reduction (``train/pretrain.make_pretrain_step``'s ``stop``). The
failure drills: ``CSM_FAULT_STEP=k`` ends the process with
``os._exit(13)`` after k steps of this launch, on rank
``CSM_FAULT_PROCESS`` (0) when ``CSM_LAUNCH_ATTEMPT`` (1, set by
``cli/launch.py``) equals ``CSM_FAULT_ATTEMPT`` (1). ``cli/launch.py``
restarts a gang that loses a process from the newest checkpoint.

``--adam_mu_dtype``/``--adam_nu_dtype bfloat16`` store Adam's moments in
bf16 (the checkpoint then holds them so, and restores only into a run with
the same dtypes). ``--loss`` takes the SSIM family too (``ssim``,
``ms_ssim``, ``mse_ssim``, ``mse_ms_ssim``; ``ms_ssim`` needs an input above
160 px); a model with latent terms then needs ``--loss_e``/``--loss_ce``/
``--loss_cd`` naming a loss of embeddings. ``--use_perceptual_loss`` adds
the VGG16 perceptual term (a multi-scale model only), on a random trunk or
on ``--vgg_weights``' torchvision state dict; ``<run dir>/config.json``
records which as ``vgg_trunk``. ``--plot_recon`` (or ``--val_img_path``,
an image file or a directory of them) writes rank 0's reconstruction
figures at every checkpoint into ``<run dir>/reconstructions/``.
Logging, as the JAX CLI: ``log.jsonl`` in the run directory (one record an
epoch, with ``epoch_time_s`` and ``imgs_per_sec_per_host``) and
``config.json``; at every ``--log_interval``-th step of an epoch the
metrics (with ``--watch_gradients`` the gradient norms too) go to
TensorBoard (``--use_tensorboard``: ``<run dir>/tb``) and wandb (``--use_wandb``,
``--wandb_project``, ``--wandb_entity``, ``--wandb_id``) on the epoch_1000x
axis, each where its package imports. ``--profile_dir`` writes a
torch.profiler Chrome trace of steps 10-30 of the first epoch
(``utils/profiling.TraceWindow``), closed when the run ends sooner; the
step's spans (``utils/profiling.span``: step, augment, forward, backward,
exchange, optimizer) lie on its timeline above the kernels they launched.
``--jax_platforms cpu`` runs as ``--device cpu``.

The mesh beyond the data axis (``parallel/mesh.py``), under the gspmd step:
``--model_parallel tp`` (Megatron's split; rank = d * tp + m, the ranks of
one model group reading the same rows), ``--sequence_parallel`` (with tp >
1), ``--fsdp`` (params and moments split over the data group), ``--zero1``
(Adam's moments split over it), ``--num_slices`` (the world must split into
tp x slices). As in the JAX CLI, ``--fsdp`` with ``--zero1``, any of them
with ``--reference_semantics`` and each with ``--ddp_mode shard_map``
refuse. Checkpoints hold whole leaves, so a run resumes in any layout.

Every run writes into its own directory, ``<output_dir>/run_<name>`` (a
``+N`` suffix when it exists; the JAX CLI's ``auto_output_dir``), which
``main`` returns as ``output_dir``.

Usage:
    python -m cross_scale_mae_torch.cli.pretrain --model mae_vit_base_MsLdCeCd \\
        --dataset_type synthetic --batch_size 384 --output_dir out   # GPU
    torchrun --nproc_per_node 4 -m cross_scale_mae_torch.cli.pretrain \\
        --batch_size 1536 --output_dir out                            # 4 GPUs
    python -m cross_scale_mae_torch.cli.pretrain --model mae_vit_tiny_MsLdCeCd \\
        --input_size 32 --patch_size 8 --batch_size 8 --synthetic_len 16 \\
        --max_steps 2 --device cpu --output_dir out                   # CPU
    python -m cross_scale_mae_torch.cli.pretrain ... --device cpu \\
        --coordinator_address localhost:29500 --num_processes 2 --process_id 0
                                      # and --process_id 1: two gloo ranks
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
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
    run_layout,
    run_output_dir,
    setup_runtime,
    validate_parallel_args,
)
from cross_scale_mae_torch.configs import MAEConfig, TrainConfig, get_mae_config
from cross_scale_mae_torch.data.datasets import DATASET_STATS, build_dataset, synthetic_images
from cross_scale_mae_torch.data.loader import DataLoader, device_prefetch
from cross_scale_mae_torch.losses.perceptual import load_torch_vgg16_features
from cross_scale_mae_torch.losses.recon import RECON_LOSSES, SSIM_LOSSES
from cross_scale_mae_torch.models.mae import mae_init
from cross_scale_mae_torch.ops.augment import make_pretrain_augment
from cross_scale_mae_torch.ops.image import center_crop_resize, normalize_images
from cross_scale_mae_torch.parallel.dist import Runtime, barrier, mesh, shutdown
from cross_scale_mae_torch.parallel.mesh import (
    Layout,
    broadcast_params,
    full_params,
    shard_params,
)
from cross_scale_mae_torch.train.optim import MOMENT_DTYPES, build_optimizer
from cross_scale_mae_torch.train.pretrain import (
    DDP_MODES,
    _step_rng,
    make_pretrain_step,
    sample_pretrain_draws,
)
from cross_scale_mae_torch.train.schedule import warmup_half_cosine
from cross_scale_mae_torch.train.state import TrainState, finite_loss, tree_leaves
from cross_scale_mae_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    save_params_npz,
)
from cross_scale_mae_torch.utils.logging import LogOptions, RunLogger, epoch_1000x, rank0_print
from cross_scale_mae_torch.utils.params import params_to_jax
from cross_scale_mae_torch.utils.profiling import TraceWindow
from cross_scale_mae_torch.viz import plot_reconstruction, prepare_image, run_one_image

# What --attention scaled_dot_product runs: the K1 kernels, as the flagship
# step runs them (bench.py).
EXACT_IMPL = "pallas_v3"
IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".tif", ".tiff", ".bmp")
FAULT_EXIT_CODE = 13


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Cross-Scale MAE pretraining (PyTorch)", add_help=False)
    p.add_argument("--model", default="mae_vit_base_MsLdCeCd")
    p.add_argument("--input_size", default=128, type=int)
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--mask_ratio", default=0.75, type=float)
    p.add_argument("--loss", default="mse", choices=sorted(RECON_LOSSES))
    p.add_argument("--norm_pix_loss", action="store_true")
    p.add_argument("--loss_e", default=None)
    p.add_argument("--loss_ce", default=None)
    p.add_argument("--loss_cd", default=None)
    p.add_argument("--ms_range", default=(0.25, 0.75), type=float, nargs=2)
    p.add_argument("--ms_decoder_loss_reduction", default="sum", choices=["sum", "mean"])
    p.add_argument("--batch_crop", action="store_true",
                   help="one shared crop box per batch (reference behavior)")
    p.add_argument("--consistent_mask", action="store_true")
    p.add_argument("--mask_seed", default=None, type=int)
    p.add_argument("--use_perceptual_loss", action="store_true")
    p.add_argument("--vgg_weights", default=None,
                   help="torchvision VGG16 .pth for the perceptual trunk; without it the "
                        "trunk is random (config.json records which as vgg_trunk)")
    p.add_argument("--apply_encoder_norm", action="store_true")
    p.add_argument("--epochs", default=400, type=int)
    p.add_argument("--warmup_epochs", default=40, type=int)
    p.add_argument("--batch_size", default=512, type=int,
                   help="global batch per optimizer step (pre-accum)")
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--blr", default=5e-5, type=float)
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--min_lr", default=0.0, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--clip_grad", default=None, type=float)
    p.add_argument("--ckpt_interval", default=25, type=int,
                   help="write <run dir>/checkpoints every N epochs, after the last "
                        "and on SIGTERM/SIGINT")
    p.add_argument("--plot_recon", action="store_true",
                   help="save reconstruction figures at checkpoint epochs")
    p.add_argument("--val_img_path", default=None,
                   help="image file or directory to reconstruct at each checkpoint epoch "
                        "(main_pretrain.py:590-626); implies --plot_recon; default: the "
                        "first dataset sample")
    p.add_argument("--max_steps", default=None, type=int, help="hard step cap")
    p.add_argument("--unroll_blocks", action="store_true",
                   help="a layout knob of the JAX package (scan or unrolled); the port "
                        "runs the same loop for every setting")
    p.add_argument("--watch_gradients", action="store_true",
                   help="log per-subtree gradient norms (main_pretrain.py:537)")
    p.add_argument("--ddp_mode", default="gspmd", choices=list(DDP_MODES),
                   help="gspmd: the global batch's NT-Xent negatives and BatchNorm "
                        "statistics; shard_map: each rank's own (the reference DDP's)")
    p.add_argument("--reference_semantics", action="store_true",
                   help="--gelu exact --batch_crop --ddp_mode shard_map in one switch")
    add_data_args(p, pretrain=True, default="synthetic")
    add_runtime_args(p)
    add_reference_compat_args(p, "pretrain")
    p.add_argument("--adam_mu_dtype", default=None, choices=list(MOMENT_DTYPES),
                   help="dtype of Adam's first moment (bfloat16 halves its memory)")
    p.add_argument("--adam_nu_dtype", default=None, choices=list(MOMENT_DTYPES),
                   help="dtype of Adam's second moment")
    p.add_argument("--zero1", action="store_true",
                   help="shard Adam's moments over the data group (ZeRO-1)")
    return p


def check_args(args) -> None:
    """Resolve the compat flags, the attention and --reference_semantics in
    place; SystemExit for a combination the JAX CLI refuses."""
    apply_reference_compat(args, "pretrain")
    resolve_attention(args, torch.device(args.device), EXACT_IMPL)
    layouts = (args.model_parallel > 1 or args.zero1 or args.fsdp or args.sequence_parallel)
    if args.reference_semantics:
        # JAX cli/pretrain.py:136-160: exact GELU, the reference's batch-shared
        # crop box, and the per-rank NT-Xent and BatchNorm of its DDP.
        if layouts:
            raise SystemExit(
                "--reference_semantics forces --ddp_mode shard_map (pure data-parallel, "
                "per-device NT-Xent/BN like DDP) and is incompatible with "
                "--model_parallel/--zero1/--fsdp/--sequence_parallel — the reference has no "
                "TP/ZeRO to be faithful to")
        args.gelu, args.batch_crop, args.ddp_mode = "exact", True, "shard_map"
    validate_parallel_args(args)
    if args.ddp_mode == "shard_map" and layouts:
        # JAX cli/pretrain.py:300-309.
        raise SystemExit(
            "--ddp_mode shard_map is pure data-parallel: --sequence_parallel needs the gspmd "
            "step, and --model_parallel, --zero1 and --fsdp run under it")


@dataclasses.dataclass
class PretrainRun:
    """Everything one run's loop needs, built by :func:`build_run`."""

    cfg: MAEConfig
    tcfg: TrainConfig
    state: TrainState
    step_fn: Callable
    images: Optional[torch.Tensor]   # the synthetic dataset, uint8 on the device
    steps_per_epoch: int
    rt: Runtime                           # this process's rank, world and device
    loader: Optional[DataLoader] = None   # a real dataset's, this rank's shard
    rot90: bool = False                   # the NAIP rotations
    frames: int = 1                       # frames a sample: 2 for temporal pairs
    ddp_mode: Optional[str] = None        # the step's semantics; None without a group
    start_epoch: int = 0                  # after --resume, the checkpoint's epoch + 1
    mean: tuple = ()                      # the normalization's statistics
    std: tuple = ()
    vgg_trunk: str = "n/a"                # "random", "imported:<path>" or "n/a"
    val_images: Optional[list] = None     # --val_img_path's files
    log: LogOptions = LogOptions()        # TensorBoard and wandb
    profile_dir: Optional[str] = None     # --profile_dir's trace window
    layout: Layout = Layout()             # what each rank holds of the params

    @property
    def device(self) -> torch.device:
        return self.rt.device

    def draws(self, step: int) -> list:
        """The draws of ``step``, this rank's rows: one set per microbatch,
        on the device. Under shard_map each rank draws its own rows from its
        own generator; else every rank draws the global batch and keeps its
        data index's rows."""
        rank, world = mesh().d, mesh().dp
        own = self.ddp_mode == "shard_map"
        gen = _step_rng(self.tcfg, self.tcfg.seed + 1, step, self.device,
                        rank=rank if own else None)
        canvas = self.loader.dataset.canvas_size if self.loader else None
        n = self.tcfg.batch_size // world if own else self.tcfg.batch_size
        return [sample_pretrain_draws(gen, n, self.cfg, self.tcfg, canvas, self.rot90,
                                      self.frames)
                .shard(*((0, 1) if own else (rank, world)))
                for _ in range(self.tcfg.accum_iter)]

    def batches(self, epoch: int) -> Iterator[torch.Tensor]:
        """The epoch's uint8 step batches on the device, this rank's rows
        (d::dp of each global batch for data index d, as the loader's shard
        holds)."""
        if self.loader is not None:
            for imgs, _ in device_prefetch(self.loader.epoch(epoch), self.device):
                yield imgs
            return
        rank, world = mesh().d, mesh().dp
        batch = self.tcfg.batch_size * self.tcfg.accum_iter
        order = torch.randperm(len(self.images), device=self.device,
                               generator=torch.Generator(device=self.device)
                               .manual_seed(self.tcfg.seed * 1_000_003 + epoch))
        for it in range(self.steps_per_epoch):
            yield self.images[order[it * batch:(it + 1) * batch][rank::world]]


def build_run(args) -> PretrainRun:
    """Config, runtime, data, seeded init (rank 0's on every rank), AdamW
    and the step, on this rank's device; with --resume, the newest
    checkpoint restored into the state (on every rank, from the file)."""
    check_args(args)
    cfg = get_mae_config(
        args.model, input_size=args.input_size, patch_size=args.patch_size,
        mask_ratio=args.mask_ratio, loss=args.loss, norm_pix_loss=args.norm_pix_loss,
        loss_e=args.loss_e, loss_ce=args.loss_ce, loss_cd=args.loss_cd,
        ms_range=tuple(args.ms_range), ms_decoder_loss_reduction=args.ms_decoder_loss_reduction,
        ms_per_sample_crop=not args.batch_crop, apply_encoder_norm=args.apply_encoder_norm,
        compute_dtype=args.compute_dtype, attention_impl=args.attention_impl,
        remat=args.remat, gelu=args.gelu, scan_blocks=not args.unroll_blocks,
        use_perceptual=args.use_perceptual_loss, sequence_parallel=args.sequence_parallel)
    widths = {"encoder heads": cfg.encoder_num_heads, "decoder heads": cfg.decoder_num_heads,
              "encoder MLP": cfg.dim_model * cfg.ffn_ratio,
              "decoder MLP": cfg.decoder_embed_dim * cfg.ffn_ratio}
    if cfg.use_ce_pred or cfg.use_cd_pred:
        widths["predictor hidden"] = cfg.predictor_hidden_size
    check_model_parallel(args.model_parallel, widths)
    rt = setup_runtime(args)
    dev = rt.device
    ddp_mode = args.ddp_mode if rt.distributed else None
    check_losses(cfg)
    if args.vgg_weights and not cfg.use_perceptual:
        raise SystemExit(
            "--vgg_weights given without --use_perceptual_loss: the trunk would be loaded "
            "for nothing — add --use_perceptual_loss or drop --vgg_weights")
    val_images = val_image_files(args.val_img_path) if args.val_img_path else None
    tcfg = TrainConfig(
        epochs=args.epochs, warmup_epochs=args.warmup_epochs,
        batch_size=args.batch_size, accum_iter=args.accum_iter, blr=args.blr,
        lr=args.lr, min_lr=args.min_lr, weight_decay=args.weight_decay,
        clip_grad=args.clip_grad, seed=args.seed, log_interval=args.log_interval,
        mask_seed=args.mask_seed, consistent_mask=args.consistent_mask,
        watch_gradients=args.watch_gradients)
    eff_batch = args.batch_size * args.accum_iter
    if args.dataset_type == "fmow_temporal" and not cfg.multi_scale:
        raise SystemExit(
            "--dataset_type fmow_temporal needs a multi-scale model (mae_vit_*_MsLd*): the "
            "second frame replaces the on-device crop as the second view (models/mae.py); "
            "single-view MAE has no slot for it")
    images = loader = None
    if args.dataset_type == "synthetic":
        images = synthetic_images(args.synthetic_len, args.input_size, cfg.input_channels,
                                  args.seed, dev)
        n_train, steps_per_epoch = args.synthetic_len, args.synthetic_len // eff_batch
    else:
        dataset = build_dataset(args.dataset_type, True, train_path=args.train_path,
                                input_size=args.input_size, canvas_scale=args.canvas_scale,
                                masked_bands=args.masked_bands,
                                dropped_bands=args.dropped_bands)
        loader = make_loader(args, dataset, eff_batch // mesh().dp, rt, seed=args.seed)
        n_train, steps_per_epoch = len(dataset), loader.steps_per_epoch()
    if steps_per_epoch < 1:
        raise SystemExit(f"{n_train} train images are fewer than one step's {eff_batch}")
    schedule = warmup_half_cosine(tcfg.resolved_lr(eff_batch), args.min_lr,
                                  args.warmup_epochs, args.epochs, steps_per_epoch)
    params, mstate = mae_init(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    vgg_trunk = "n/a"
    if cfg.use_perceptual:
        vgg_trunk = "random"
        if args.vgg_weights:
            trunk = load_torch_vgg16_features(args.vgg_weights, cfg.input_channels)
            mstate["vgg"] = {k: {n: t.to(dev) for n, t in v.items()} for k, v in trunk.items()}
            vgg_trunk = f"imported:{args.vgg_weights}"
        rank0_print(f"perceptual trunk: {vgg_trunk}")
    broadcast_params([params, mstate])
    layout = run_layout(args)
    params = shard_params(params, layout)
    tx = build_optimizer(params, schedule, weight_decay=args.weight_decay,
                         b1=tcfg.adam_b1, b2=tcfg.adam_b2, clip_grad=args.clip_grad,
                         mu_dtype=args.adam_mu_dtype, nu_dtype=args.adam_nu_dtype,
                         zero1=args.zero1)
    state = TrainState.create(params, mstate, tx)
    start_epoch = 0
    if args.resume and latest_step(args.resume) is not None:
        t0 = time.perf_counter()
        state, meta = restore_checkpoint(args.resume, state)
        start_epoch = int(meta.get("epoch", 0)) + 1
        rank0_print(f"resumed from {args.resume} at epoch {start_epoch} (step {state.step}, "
                    f"{(time.perf_counter() - t0) * 1e3:.1f} ms)")
    if args.start_epoch is not None:
        # The reference's --start_epoch wins only when given (JAX cli/pretrain.py:287-291).
        start_epoch = args.start_epoch
    # The dataset's own statistics, as the JAX CLI normalizes with them.
    mean, std = (loader.dataset.mean, loader.dataset.std) if loader else DATASET_STATS["synthetic"]
    rot90 = args.dataset_type == "naip"
    augment = make_pretrain_augment(
        mean, std, args.input_size, rot90=rot90, dtype=args.compute_dtype,
        normalize=loader.dataset.normalize_on_device if loader else True)
    step_fn = make_pretrain_step(cfg, tcfg, schedule, augment=augment, ddp_mode=ddp_mode)
    frames = getattr(loader.dataset, "frames", 1) if loader else 1
    return PretrainRun(cfg, tcfg, state, step_fn, images, steps_per_epoch, rt, loader, rot90,
                       frames, ddp_mode, start_epoch, tuple(mean), tuple(std), vgg_trunk,
                       val_images, LogOptions.from_args(args), args.profile_dir, layout)


def check_losses(cfg: MAEConfig) -> None:
    """SystemExit for a loss setup that cannot train:
    * the perceptual loss on a single-view model, which the JAX package's
      ``mae_loss_fn`` silently leaves out (it returns before the term);
    * an SSIM loss on a latent term: the SSIM family compares images, and
      the JAX package fails on it at the first step."""
    if cfg.use_perceptual and not cfg.multi_scale:
        raise SystemExit(
            "--use_perceptual_loss needs a multi-scale model (mae_vit_*_MsLd*): the JAX "
            "package's single-view objective returns before the perceptual term, so the "
            "run would train without it (ROADMAP.md, queue 3)")
    terms = [t for t, on in (("e", cfg.use_le), ("ce", cfg.use_ce_pred),
                             ("cd", cfg.use_cd_pred)) if on]
    for term in terms:
        if cfg.loss_name(term) in SSIM_LOSSES:
            raise SystemExit(
                f"the {term} latent term's loss is {cfg.loss_name(term)!r}: the SSIM losses "
                f"compare images, not embeddings; give --loss_{term} (mse, l1, ...)")


def val_image_files(path: str) -> list[str]:
    """--val_img_path's images: the file, or the image files of the
    directory in name order; FileNotFoundError when there is none."""
    if not os.path.isdir(path):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"--val_img_path {path!r}: no such file or directory")
        return [path]
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith(IMAGE_SUFFIXES))
    if not files:
        # Plotting dataset sample 0 instead of the images asked for would hide it.
        raise FileNotFoundError(f"--val_img_path {path!r}: no image files "
                                f"({'/'.join(IMAGE_SUFFIXES)}) found")
    return files


def plot_epoch_recon(run: PretrainRun, output_dir: str, epoch: int) -> list[str]:
    """Rank 0's reconstruction figures of a checkpoint epoch
    (main_pretrain.py:590-626): each --val_img_path image, else the
    dataset's sample 0 (a temporal pair's first frame), center-cropped to
    the input size when its canvas differs; the mask noise from a generator
    seeded 0. Returns the paths written. Every rank calls it: a layout's
    split leaves are gathered whole first."""
    params = full_params(run.state.params) if run.rt.distributed else run.state.params
    if run.rt.rank != 0:
        return []
    cfg, dev = run.cfg, run.device
    if run.val_images:
        batches = [(prepare_image(f, cfg, run.mean, run.std),
                    "_" + os.path.splitext(os.path.basename(f))[0]) for f in run.val_images]
    else:
        if run.loader is not None:
            img, normalize = run.loader.dataset.load(0)[0], run.loader.dataset.normalize_on_device
        else:
            img, normalize = run.images[0].cpu().numpy(), True
        if img.ndim == 4:
            img = img[0]
        x = torch.from_numpy(img.astype(np.float32) / 255.0).to(dev)
        if normalize:
            x = normalize_images(x, run.mean, run.std)
        if x.shape[0] != cfg.input_size or x.shape[1] != cfg.input_size:
            x = center_crop_resize(x[None], cfg.input_size)[0]
        batches = [(x[None], "")]
    paths = []
    for batch, suffix in batches:
        noise = torch.rand((1, cfg.num_patches), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
        result = run_one_image(params, cfg, batch.to(dev), noise)
        path = os.path.join(output_dir, "reconstructions", f"epoch_{epoch:04d}{suffix}.png")
        plot_reconstruction(result, path, run.mean, run.std,
                            title=f"epoch {epoch} loss {result['loss']:.4f}")
        paths.append(path)
    return paths


def fault_step(rank: int) -> int:
    """The step count after which this process ends itself for a failure
    drill (``CSM_FAULT_STEP``), or 0: the drill names one rank
    (``CSM_FAULT_PROCESS``, 0) and one launch attempt (``CSM_FAULT_ATTEMPT``
    against ``CSM_LAUNCH_ATTEMPT``, both 1 by default), so the relaunch
    does not fault again."""
    env = os.environ
    step = int(env.get("CSM_FAULT_STEP", "0"))
    if step and (rank != int(env.get("CSM_FAULT_PROCESS", "0"))
                 or env.get("CSM_LAUNCH_ATTEMPT", "1") != env.get("CSM_FAULT_ATTEMPT", "1")):
        return 0
    return step


class StopRequest:
    """Set by SIGTERM or SIGINT while installed (in the main thread): the
    loop finishes its step, checkpoints and ends."""

    def __init__(self):
        self.requested = False
        self._previous: dict = {}

    def _handle(self, signum, frame) -> None:
        rank0_print(f"signal {signum}: checkpoint-and-exit after this step")
        self.requested = True

    def __enter__(self) -> "StopRequest":
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous[sig] = signal.signal(sig, self._handle)
            except ValueError:
                pass   # not the main thread: no handler
        return self

    def __exit__(self, *exc) -> None:
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)


def main(args) -> dict[str, Any]:
    """Train; returns the step count, every step's loss, the last logged
    metrics, the steady ms per step on the GPU (the steps after the first,
    which builds the kernels), images/s per process and in total, the rank
    and world size, the run directory (``output_dir``) and its npz (written
    by rank 0), the perceptual trunk, the reconstruction figures written,
    the TensorBoard directory (None without one) and the trace window's
    files, traced steps and seconds (``trace``)."""
    run = build_run(args)
    rt = run.rt
    config = {**json.loads(run.cfg.to_json()), "vgg_trunk": run.vgg_trunk}
    run_name = encode_run_name(
        model=args.model, loss=args.loss, in_sz=args.input_size, p_sz=args.patch_size,
        lr=run.tcfg.resolved_lr(args.batch_size * args.accum_iter), ds=args.dataset_type)
    n_params = sum(p.numel() for p in tree_leaves(run.state.params))
    mh = mesh()
    rank0_print(f"model {args.model}: {n_params / 1e6:.1f}M params on {run.device} (this "
                f"rank's part); {run.steps_per_epoch} steps/epoch; {rt.world_size} "
                f"process(es), mesh (data {mh.dp}, model {mh.tp}), ddp_mode {run.ddp_mode}")
    # A directory of its own per run (+N), chosen by rank 0 (JAX cli/pretrain.py:325-328).
    output_dir = run_output_dir(args, run_name)
    rank0_print(f"output dir: {output_dir}")
    losses: list[float] = []
    figures: list[str] = []
    last_metrics: dict[str, float] = {}
    prev_loss = prev_stop = None
    t_first = None
    total = 0
    stopping = False
    ckpt_dir = os.path.join(output_dir, "checkpoints")
    fault = fault_step(rt.rank)
    logger = RunLogger.from_options(output_dir, run.log, run_name, config)
    tb_dir = logger.tensorboard_dir
    window = TraceWindow(run.profile_dir, device=run.device)
    per_host_batch = args.batch_size // mh.dp
    with StopRequest() as stop, logger, window:
        for epoch in range(run.start_epoch, args.epochs):
            epoch_t0 = time.time()
            for it, imgs in enumerate(run.batches(epoch)):
                window.before_step(total, epoch == run.start_epoch)
                _, metrics = run.step_fn(run.state, imgs, run.draws(run.state.step),
                                         stop=stop.requested)
                # NaN abort (engine_pretrain.py:57-59) one step behind, so the
                # host does not wait for the step it just enqueued. The ranks'
                # consensus on a stop is read with it; one process stops on
                # its own request.
                if prev_loss is not None:
                    losses.append(finite_loss(prev_loss))
                    if prev_stop is not None and float(prev_stop) > 0:
                        stopping = True
                prev_loss, prev_stop = metrics["loss"], metrics.pop("stop", None)
                if not rt.distributed and stop.requested:
                    stopping = True
                total += 1
                if total == 1 and run.device.type == "cuda":
                    torch.cuda.synchronize(run.device)
                    t_first = time.perf_counter()
                # On the in-epoch index, as the JAX CLI (cli/pretrain.py:400-407).
                if it % args.log_interval == 0:
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    rank0_print(f"epoch {epoch} step {total} " + " ".join(
                        f"{k}={v:.5g}" for k, v in last_metrics.items()))
                    logger.log_step(epoch_1000x(epoch + it / run.steps_per_epoch),
                                    last_metrics)
                if fault and total >= fault:
                    print(f"[fault-injection] killing process {rt.rank} at step {total}",
                          flush=True)
                    os._exit(FAULT_EXIT_CODE)
                if stopping or (args.max_steps and total >= args.max_steps):
                    break
            epoch_time = time.time() - epoch_t0
            logger.log_epoch({
                "epoch": epoch, "epoch_time_s": epoch_time,
                "imgs_per_sec_per_host": run.steps_per_epoch * per_host_batch * args.accum_iter
                / max(epoch_time, 1e-9),
                **{f"train_{k}": v for k, v in last_metrics.items()}})
            if args.output_dir and ((epoch + 1) % args.ckpt_interval == 0
                                    or epoch + 1 == args.epochs or stopping):
                save_checkpoint(ckpt_dir, run.state.step, run.state, run.cfg.to_json(),
                                {"epoch": epoch})
                if args.plot_recon or args.val_img_path:
                    # --val_img_path alone plots too (main_pretrain.py:589-626).
                    figures += plot_epoch_recon(run, output_dir, epoch)
            if stopping:
                rank0_print("preemption checkpoint written; exiting")
                break
            if args.max_steps and total >= args.max_steps:
                break
    if prev_loss is not None:
        losses.append(finite_loss(prev_loss))
    steady_ms = imgs_per_s = None
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        if total > 1:
            steady_ms = (time.perf_counter() - t_first) / (total - 1) * 1e3
            imgs_per_s = args.batch_size * args.accum_iter / (steady_ms / 1e3)
            rank0_print(f"{steady_ms:.2f} ms per step: {imgs_per_s / rt.world_size:.1f} "
                        f"images/s per process, {imgs_per_s:.1f} in total")
    npz = os.path.join(output_dir, "params.npz")
    whole = full_params(run.state.params) if rt.distributed else run.state.params
    if rt.rank == 0:
        save_params_npz(npz, params_to_jax(whole), run.cfg.to_json())
    if rt.distributed:
        barrier()
    rank0_print(f"training done: {total} steps; params written to {npz}")
    trace = {"files": window.files, "steps": window.steps, "window_s": window.window_s,
             "overhead_s": window.overhead_s}
    return {"steps": total, "losses": losses, "last_metrics": last_metrics,
            "steady_ms_per_step": steady_ms, "imgs_per_s": imgs_per_s, "npz": npz,
            "output_dir": output_dir, "rank": rt.rank, "world_size": rt.world_size,
            "vgg_trunk": run.vgg_trunk, "figures": figures, "tensorboard_dir": tb_dir,
            "trace": trace}


if __name__ == "__main__":
    try:
        main(argparse.ArgumentParser(parents=[get_args_parser()]).parse_args())
    finally:
        shutdown()
