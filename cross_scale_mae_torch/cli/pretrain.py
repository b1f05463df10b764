"""Pretraining entry point, on the GPU.

Counterpart of ``cross_scale_mae_tpu/cli/pretrain.py`` with its flag names
for what the port runs: the model registry (``--model
mae_vit_base_MsLdCeCd``), the lr rule lr = blr * eff_batch / 256, AdamW
under the warmup + half-cosine schedule, and the whole step (augment,
two-view forward, losses, backward, AdamW) on one device, with the
attention in the hand-written CUDA kernels when ``--attention_impl
pallas_v3`` (the default).

Data: ``--dataset_type synthetic`` (the default: seeded uint8 images, made
as the JAX package's ``SyntheticDataset`` makes them and held on the
device), or ``fmow_rgb``, ``coco`` or ``naip`` with ``--train_path``, read
by ``data/loader.DataLoader`` and moved by ``device_prefetch`` (NAIP adds
the rot90 augmentation). At the end the params are written as the JAX
package's npz (``<output_dir>/params.npz``), which ``cli/serve.py`` serves.
The TIFF and temporal datasets, resume, DDP, TP/SP, wandb and the fault
knobs are not ported yet and refuse with a pointer to ROADMAP.md.

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
from typing import Any, Callable, Iterator, Optional

import torch

from cross_scale_mae_torch.cli.common import (
    UNPORTED_RUNTIME,
    add_data_args,
    add_runtime_args,
    apply_reference_compat,
    make_loader,
    refuse_unported,
)
from cross_scale_mae_torch.configs import MAEConfig, TrainConfig, get_mae_config
from cross_scale_mae_torch.data.datasets import DATASET_STATS, build_dataset, synthetic_images
from cross_scale_mae_torch.data.loader import DataLoader, device_prefetch
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
from cross_scale_mae_torch.train.state import TrainState, finite_loss, tree_leaves
from cross_scale_mae_torch.utils.checkpoint import save_params_npz
from cross_scale_mae_torch.utils.params import params_to_jax

# Flags of the JAX CLI that the port parses but does not run yet:
# flag -> ROADMAP.md queue 1 item.
UNPORTED_FLAGS = {
    **UNPORTED_RUNTIME, "zero1": 11, "ddp_mode": 11, "use_perceptual_loss": 14,
    "adam_mu_dtype": 7, "adam_nu_dtype": 7,
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
    add_data_args(p, pretrain=True, default="synthetic")
    add_runtime_args(p)
    # The K1 kernels, as the flagship step runs them (bench.py).
    p.set_defaults(attention_impl="pallas_v3")
    g = p.add_argument_group("not ported yet (ROADMAP.md)")
    for flag in ("adam_mu_dtype", "adam_nu_dtype", "ddp_mode"):
        g.add_argument(f"--{flag}", default=None)
    for flag in ("zero1", "use_perceptual_loss"):
        g.add_argument(f"--{flag}", action="store_true")
    return p


def check_args(args) -> None:
    """SystemExit for a flag, dataset or environment knob not ported yet."""
    apply_reference_compat(args, "pretrain")
    refuse_unported(args, UNPORTED_FLAGS)
    for name in FAULT_ENV:
        if os.environ.get(name):
            raise SystemExit(
                f"{name}: the fault-injection knobs are not ported yet; see "
                "ROADMAP.md (queue 1 item 16)")


@dataclasses.dataclass
class PretrainRun:
    """Everything one run's loop needs, built by :func:`build_run`."""

    cfg: MAEConfig
    tcfg: TrainConfig
    state: TrainState
    step_fn: Callable
    images: Optional[torch.Tensor]   # the synthetic dataset, uint8 on the device
    steps_per_epoch: int
    device: torch.device
    loader: Optional[DataLoader] = None   # a real dataset's
    rot90: bool = False                   # the NAIP rotations

    def draws(self, step: int) -> list:
        """The draws of ``step``: one set per microbatch, on the device."""
        gen = _step_rng(self.tcfg, self.tcfg.seed + 1, step, self.device)
        canvas = self.loader.dataset.canvas_size if self.loader else None
        return [sample_pretrain_draws(gen, self.tcfg.batch_size, self.cfg, self.tcfg,
                                      canvas, self.rot90)
                for _ in range(self.tcfg.accum_iter)]

    def batches(self, epoch: int) -> Iterator[torch.Tensor]:
        """The epoch's uint8 step batches on the device."""
        if self.loader is not None:
            for imgs, _ in device_prefetch(self.loader.epoch(epoch), self.device):
                yield imgs
            return
        batch = self.tcfg.batch_size * self.tcfg.accum_iter
        order = torch.randperm(len(self.images), device=self.device,
                               generator=torch.Generator(device=self.device)
                               .manual_seed(self.tcfg.seed * 1_000_003 + epoch))
        for it in range(self.steps_per_epoch):
            yield self.images[order[it * batch:(it + 1) * batch]]


def build_run(args) -> PretrainRun:
    """Config, data, seeded init, AdamW and the step, on ``args.device``."""
    check_args(args)
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
    eff_batch = args.batch_size * args.accum_iter
    images = loader = None
    if args.dataset_type == "synthetic":
        images = synthetic_images(args.synthetic_len, args.input_size, cfg.input_channels,
                                  args.seed, dev)
        n_train, steps_per_epoch = args.synthetic_len, args.synthetic_len // eff_batch
    else:
        dataset = build_dataset(args.dataset_type, True, train_path=args.train_path,
                                input_size=args.input_size, canvas_scale=args.canvas_scale)
        loader = make_loader(args, dataset, eff_batch, seed=args.seed)
        n_train, steps_per_epoch = len(dataset), loader.steps_per_epoch()
    if steps_per_epoch < 1:
        raise SystemExit(f"{n_train} train images are fewer than one step's {eff_batch}")
    schedule = warmup_half_cosine(tcfg.resolved_lr(eff_batch), args.min_lr,
                                  args.warmup_epochs, args.epochs, steps_per_epoch)
    params, mstate = mae_init(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    tx = build_optimizer(params, schedule, weight_decay=args.weight_decay,
                         b1=tcfg.adam_b1, b2=tcfg.adam_b2, clip_grad=args.clip_grad)
    state = TrainState.create(params, mstate, tx)
    # The dataset's own statistics, as the JAX CLI normalizes with them.
    mean, std = (loader.dataset.mean, loader.dataset.std) if loader else DATASET_STATS["synthetic"]
    rot90 = args.dataset_type == "naip"
    augment = make_pretrain_augment(mean, std, args.input_size, rot90=rot90,
                                    dtype=args.compute_dtype)
    step_fn = make_pretrain_step(cfg, tcfg, schedule, augment=augment)
    return PretrainRun(cfg, tcfg, state, step_fn, images, steps_per_epoch, dev, loader, rot90)


def main(args) -> dict[str, Any]:
    """Train; returns the step count, every step's loss, the last logged
    metrics, the steady ms per step on the GPU (the steps after the first,
    which builds the kernels) and the npz path."""
    run = build_run(args)
    n_params = sum(p.numel() for p in tree_leaves(run.state.params))
    print(f"model {args.model}: {n_params / 1e6:.1f}M params on {run.device}; "
          f"{run.steps_per_epoch} steps/epoch", flush=True)
    losses: list[float] = []
    last_metrics: dict[str, float] = {}
    prev_loss = None
    t_first = None
    total = 0
    for epoch in range(args.epochs):
        for imgs in run.batches(epoch):
            _, metrics = run.step_fn(run.state, imgs, run.draws(run.state.step))
            # NaN abort (engine_pretrain.py:57-59) one step behind, so the
            # host does not wait for the step it just enqueued.
            if prev_loss is not None:
                losses.append(finite_loss(prev_loss))
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
        losses.append(finite_loss(prev_loss))
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


if __name__ == "__main__":
    main(argparse.ArgumentParser(parents=[get_args_parser()]).parse_args())
