"""Pretraining entry point, on the GPU.

Counterpart of ``cross_scale_mae_tpu/cli/pretrain.py`` with its flag names
for what the port runs: the model registry (``--model
mae_vit_base_MsLdCeCd``), the lr rule lr = blr * eff_batch / 256, AdamW
under the warmup + half-cosine schedule, and the whole step (augment,
two-view forward, losses, backward, AdamW) on one device, with the
attention in the hand-written CUDA kernels when ``--attention_impl
pallas_v3`` (the default).

Data: the synthetic dataset only (seeded uint8 images, made as the JAX
package's ``SyntheticDataset`` makes them and held on the device). At the
end the params are written as the JAX package's npz
(``<output_dir>/params.npz``), which ``cli/serve.py`` serves. Real datasets,
the loader, resume, DDP, TP/SP, wandb and the fault knobs are not ported
yet and refuse with a pointer to ROADMAP.md.

Usage:
    python -m cross_scale_mae_torch.cli.pretrain --model mae_vit_base_MsLdCeCd \\
        --dataset_type synthetic --batch_size 384 --output_dir out   # GPU
    python -m cross_scale_mae_torch.cli.pretrain --model mae_vit_tiny_MsLdCeCd \\
        --input_size 32 --patch_size 8 --batch_size 8 --synthetic_len 16 \\
        --max_steps 2 --device cpu --output_dir out                   # CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from cross_scale_mae_torch.configs import MAEConfig, TrainConfig, get_mae_config
from cross_scale_mae_torch.data.datasets import DATASET_STATS
from cross_scale_mae_torch.losses.recon import RECON_LOSSES
from cross_scale_mae_torch.models.mae import mae_init
from cross_scale_mae_torch.ops.augment import make_pretrain_augment
from cross_scale_mae_torch.serving import resolve_device
from cross_scale_mae_torch.train.optim import build_optimizer
from cross_scale_mae_torch.train.pretrain import (
    _step_rng,
    make_pretrain_step,
    sample_pretrain_draws,
)
from cross_scale_mae_torch.train.schedule import warmup_half_cosine
from cross_scale_mae_torch.train.state import TrainState, tree_leaves
from cross_scale_mae_torch.utils.checkpoint import save_params_npz
from cross_scale_mae_torch.utils.params import params_to_jax

# Flags of the JAX CLI that the port parses but does not run yet:
# flag -> ROADMAP.md queue 1 item.
UNPORTED_FLAGS = {
    "resume": 9, "train_path": 10, "test_path": 10, "canvas_scale": 10,
    "model_parallel": 11, "sequence_parallel": 11, "fsdp": 11, "zero1": 11,
    "ddp_mode": 11, "use_wandb": 16, "use_tensorboard": 16, "profile_dir": 16,
    "use_perceptual_loss": 14, "adam_mu_dtype": 7, "adam_nu_dtype": 7,
}
FAULT_ENV = ("CSM_FAULT_STEP", "CSM_FAULT_PROCESS", "CSM_FAULT_ATTEMPT")


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Cross-Scale MAE pretraining (PyTorch)", add_help=False)
    p.add_argument("--model", default="mae_vit_base_MsLdCeCd")
    p.add_argument("--input_size", default=128, type=int)
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--mask_ratio", default=0.75, type=float)
    p.add_argument("--loss", default="mse", choices=sorted(RECON_LOSSES))
    p.add_argument("--norm_pix_loss", action="store_true")
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
    p.add_argument("--max_steps", default=None, type=int, help="hard step cap")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--attention_impl", default="pallas_v3",
                   help="pallas_v3 (the CUDA kernels on the GPU) or xla (plain)")
    p.add_argument("--gelu", default="tanh", choices=["tanh", "exact", "exact_tanhbwd"])
    p.add_argument("--dataset_type", default="synthetic",
                   choices=["synthetic", "fmow_rgb", "coco", "euro_sat",
                            "fmow_sentinel", "naip", "fmow_temporal"])
    p.add_argument("--synthetic_len", default=4096, type=int)
    p.add_argument("--log_interval", default=20, type=int)
    p.add_argument("--output_dir", default="./output_dir")
    p.add_argument("--device", default="cuda",
                   help="torch device the step runs on (cuda, cuda:1, cpu)")
    g = p.add_argument_group("not ported yet (ROADMAP.md)")
    for flag in ("resume", "train_path", "test_path", "profile_dir", "adam_mu_dtype",
                 "adam_nu_dtype", "ddp_mode"):
        g.add_argument(f"--{flag}", default=None)
    g.add_argument("--canvas_scale", default=None, type=float)
    g.add_argument("--model_parallel", default=None, type=int)
    for flag in ("sequence_parallel", "fsdp", "zero1", "use_wandb", "use_tensorboard",
                 "use_perceptual_loss"):
        g.add_argument(f"--{flag}", action="store_true")
    return p


def refuse_unported(args) -> None:
    """SystemExit for a flag, dataset or environment knob not ported yet."""
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(
                f"--{flag} is not ported yet; see ROADMAP.md (queue 1 item {item})")
    if args.dataset_type != "synthetic":
        raise SystemExit(
            f"--dataset_type {args.dataset_type}: the port trains on the synthetic "
            "dataset only; real datasets and the loader are queued in ROADMAP.md "
            "(queue 1 item 10)")
    for name in FAULT_ENV:
        if os.environ.get(name):
            raise SystemExit(
                f"{name}: the fault-injection knobs are not ported yet; see "
                "ROADMAP.md (queue 1 item 16)")


def synthetic_images(n: int, canvas: int, channels: int, seed: int,
                     device: torch.device) -> torch.Tensor:
    """(n, canvas, canvas, C) uint8 on ``device``: image i is the JAX
    package's ``SyntheticDataset(n, canvas, seed=seed).load(i)``."""
    imgs = np.empty((n, canvas, canvas, channels), np.uint8)
    for i in range(n):
        rng = np.random.default_rng(seed * 1_000_003 + i)
        imgs[i] = rng.integers(0, 256, (canvas, canvas, channels), np.uint8)
    return torch.from_numpy(imgs).to(device)


@dataclasses.dataclass
class PretrainRun:
    """Everything one run's loop needs, built by :func:`build_run`."""

    cfg: MAEConfig
    tcfg: TrainConfig
    state: TrainState
    step_fn: Callable
    images: torch.Tensor          # the synthetic dataset, uint8 on the device
    steps_per_epoch: int
    device: torch.device

    def draws(self, step: int) -> list:
        """The draws of ``step``: one set per microbatch, on the device."""
        gen = _step_rng(self.tcfg, self.tcfg.seed + 1, step, self.device)
        return [sample_pretrain_draws(gen, self.tcfg.batch_size, self.cfg, self.tcfg)
                for _ in range(self.tcfg.accum_iter)]


def build_run(args) -> PretrainRun:
    """Config, synthetic data, seeded init, AdamW and the step, on
    ``args.device``."""
    refuse_unported(args)
    dev = resolve_device(args.device)
    cfg = get_mae_config(
        args.model, input_size=args.input_size, patch_size=args.patch_size,
        mask_ratio=args.mask_ratio, loss=args.loss, norm_pix_loss=args.norm_pix_loss,
        compute_dtype=args.compute_dtype, attention_impl=args.attention_impl,
        gelu=args.gelu)
    tcfg = TrainConfig(
        epochs=args.epochs, warmup_epochs=args.warmup_epochs,
        batch_size=args.batch_size, accum_iter=args.accum_iter, blr=args.blr,
        lr=args.lr, min_lr=args.min_lr, weight_decay=args.weight_decay,
        clip_grad=args.clip_grad, seed=args.seed, log_interval=args.log_interval)
    images = synthetic_images(args.synthetic_len, args.input_size, cfg.input_channels,
                              args.seed, dev)
    eff_batch = args.batch_size * args.accum_iter
    steps_per_epoch = args.synthetic_len // eff_batch
    if steps_per_epoch < 1:
        raise SystemExit(f"--synthetic_len {args.synthetic_len} is smaller than one "
                         f"step's {eff_batch} images")
    schedule = warmup_half_cosine(tcfg.resolved_lr(eff_batch), args.min_lr,
                                  args.warmup_epochs, args.epochs, steps_per_epoch)
    params, mstate = mae_init(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    tx = build_optimizer(params, schedule, weight_decay=args.weight_decay,
                         b1=tcfg.adam_b1, b2=tcfg.adam_b2, clip_grad=args.clip_grad)
    state = TrainState.create(params, mstate, tx)
    mean, std = DATASET_STATS[args.dataset_type]
    augment = make_pretrain_augment(mean, std, args.input_size, dtype=args.compute_dtype)
    step_fn = make_pretrain_step(cfg, tcfg, schedule, augment=augment)
    return PretrainRun(cfg, tcfg, state, step_fn, images, steps_per_epoch, dev)


def main(args) -> dict[str, Any]:
    """Train; returns the step count, every step's loss, the last logged
    metrics, the steady ms per step on the GPU (the steps after the first,
    which builds the kernels) and the npz path."""
    run = build_run(args)
    n_params = sum(p.numel() for p in tree_leaves(run.state.params))
    print(f"model {args.model}: {n_params / 1e6:.1f}M params on {run.device}; "
          f"{run.steps_per_epoch} steps/epoch", flush=True)
    batch = args.batch_size * args.accum_iter
    losses: list[float] = []
    last_metrics: dict[str, float] = {}
    prev_loss = None
    t_first = None
    total = 0
    for epoch in range(args.epochs):
        order = torch.randperm(len(run.images), device=run.device,
                               generator=torch.Generator(device=run.device)
                               .manual_seed(args.seed * 1_000_003 + epoch))
        for it in range(run.steps_per_epoch):
            imgs = run.images[order[it * batch:(it + 1) * batch]]
            _, metrics = run.step_fn(run.state, imgs, run.draws(run.state.step))
            # NaN abort (engine_pretrain.py:57-59) one step behind, so the
            # host does not wait for the step it just enqueued.
            if prev_loss is not None:
                losses.append(_finite(prev_loss))
            prev_loss = metrics["loss"]
            total += 1
            if total == 1 and run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
                t_first = time.perf_counter()
            # On the global step: an epoch may be a single step.
            if (total - 1) % args.log_interval == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                print(f"epoch {epoch} step {total} " + " ".join(
                    f"{k}={v:.5g}" for k, v in last_metrics.items()), flush=True)
            if args.max_steps and total >= args.max_steps:
                break
        if args.max_steps and total >= args.max_steps:
            break
    if prev_loss is not None:
        losses.append(_finite(prev_loss))
    steady_ms = None
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        if total > 1:
            steady_ms = (time.perf_counter() - t_first) / (total - 1) * 1e3
    os.makedirs(args.output_dir, exist_ok=True)
    npz = os.path.join(args.output_dir, "params.npz")
    save_params_npz(npz, params_to_jax(run.state.params), run.cfg.to_json())
    print(f"training done: {total} steps; params written to {npz}", flush=True)
    return {"steps": total, "losses": losses, "last_metrics": last_metrics,
            "steady_ms_per_step": steady_ms, "npz": npz}


def _finite(loss: torch.Tensor) -> float:
    value = float(loss)
    if not np.isfinite(value):
        raise FloatingPointError(f"Loss is {value}, stopping training")
    return value


if __name__ == "__main__":
    main(argparse.ArgumentParser(parents=[get_args_parser()]).parse_args())
