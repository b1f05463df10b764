"""The pretrain step (counterpart of ``cross_scale_mae_tpu/train/pretrain.py``):
augment + two-view forward + every loss + backward + AdamW.

The JAX step splits one key per step into the flip, crop, MsLd-crop and
mask draws. Here the draws are explicit: :func:`sample_pretrain_draws`
makes them on the device from a ``torch.Generator`` (seeded per step by
:func:`_step_rng`), and the step takes them as an argument, so a test can
inject the JAX package's draws instead. Gradient accumulation
(``accum_iter``) is a Python loop over microbatches, one set of draws each.
A batch of temporal pairs (B, 2, H, W, C) is augmented frame by frame, each
frame with draws of its own, in the JAX step's flattened order (row b * 2 +
t of the augmentation's draws is frame t of sample b), and the frames then
stand in for the two views.

Data parallelism (``ddp_mode``, with a process group: one process per GPU)
has the JAX package's two semantics. ``gspmd``, its jit over a
batch-sharded array: every rank draws for the global batch from the same
generator and takes its own rows (:meth:`PretrainDraws.shard`), and the
loss sees the global batch (NT-Xent's negatives gathered, the predictors'
BatchNorm statistics summed over the ranks). ``shard_map`` (the JAX
package's ``make_pretrain_step_shard_map``): each rank draws for its own rows from
its own generator, the loss is the rank's own, and the BatchNorm running
state is averaged. Either way the gradients are averaged over the data
ranks once, after the last microbatch, before the norm and the clipping;
the metrics are the ranks' means.

On a (data, model) mesh (``parallel/dist.init_mesh``) "rank" above is the
data index d of dp: the ranks of one model group hold the same rows and
the same draws, and the params are this rank's parts of a layout
(``parallel/mesh.py``): FSDP's gradients come out of the backward summed
over the data group and are divided by dp, the others are averaged; the
gradient norm is that of the whole leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from cross_scale_mae_torch.configs import MAEConfig, TrainConfig
from cross_scale_mae_torch.models.mae import mae_loss_fn
from cross_scale_mae_torch.ops.augment import PRETRAIN_CROP_SCALE
from cross_scale_mae_torch.ops.image import sample_crop_boxes
from cross_scale_mae_torch.parallel.mesh import (
    FlatGrads,
    all_reduce_mean,
    average_gradients,
    spec_of,
)
from cross_scale_mae_torch.train.state import TrainState, global_norm, tree_items, tree_leaves

DDP_MODES = ("gspmd", "shard_map")


@dataclasses.dataclass
class PretrainDraws:
    """The random numbers of one (micro)batch of N samples of T frames
    each (T = 2 for temporal pairs, else 1): the augmentation's draws have a
    row per frame, N * T, frame t of sample n at row n * T + t."""

    hflip: torch.Tensor       # (N*T,) bool: augment's horizontal flips
    vflip: torch.Tensor       # (N*T,) bool: augment's vertical flips
    crop_boxes: torch.Tensor  # (N*T, 4) augment's RandomResizedCrop boxes
    ms_boxes: torch.Tensor    # (N, 4) the low-GSD view's crop boxes (unused for pairs)
    noise: torch.Tensor       # (2N, L) mask noise of both views (N, L single-scale)
    rot_k: Optional[torch.Tensor] = None  # (N*T,) NAIP rotations in {0..3}, or None

    def shard(self, rank: int, world: int) -> "PretrainDraws":
        """Rank ``rank``'s rows of draws made for a global batch: samples
        rank::world, the rows of each global batch that the loader's shard
        holds (and so the single-process run's pairing of draws with
        images), with every frame of each; of the mask noise, those rows of
        each view's half."""
        if world == 1:
            return self
        n = self.ms_boxes.shape[0]
        frames = self.hflip.shape[0] // n
        rows = (torch.arange(rank, n, world, device=self.hflip.device)[:, None] * frames
                + torch.arange(frames, device=self.hflip.device)).flatten()
        noise = torch.cat([half[rank::world] for half in self.noise.split(n)])
        rot_k = None if self.rot_k is None else self.rot_k[rows]
        return PretrainDraws(self.hflip[rows], self.vflip[rows], self.crop_boxes[rows],
                             self.ms_boxes[rank::world], noise, rot_k)


def sample_pretrain_draws(gen: torch.Generator, n: int, cfg: MAEConfig,
                          tcfg: TrainConfig, canvas: Optional[int] = None,
                          rot90: bool = False, frames: int = 1) -> PretrainDraws:
    """Draw what one step of ``n`` samples of ``frames`` frames needs, on
    ``gen``'s device, with the JAX package's distributions: Bernoulli(0.5)
    flips and crop boxes from four uniforms each
    (``ops/image.sample_crop_boxes``) on the batch's ``canvas`` (the input
    size by default) for every frame, uniform mask noise, and with
    ``rot90`` uniform rotations in {0, 1, 2, 3}, drawn last. The consistent
    mask (``consistent_mask`` or ``mask_seed``) repeats the original view's
    noise for the second view; ``ms_per_sample_crop=False`` shares one MsLd
    box across the batch."""
    dev = gen.device
    size = cfg.input_size
    canvas = canvas or size

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    rows = n * frames
    hflip, vflip = uniform(rows) < 0.5, uniform(rows) < 0.5
    crop_boxes = sample_crop_boxes(uniform(4, rows), canvas, canvas, PRETRAIN_CROP_SCALE)
    ms_boxes = sample_crop_boxes(uniform(4, n if cfg.ms_per_sample_crop else 1),
                                 size, size, cfg.ms_range, cfg.ms_aspect_ratio).expand(n, 4)
    noise = uniform(n, cfg.num_patches)
    if cfg.multi_scale:
        consistent = tcfg.consistent_mask or tcfg.mask_seed is not None
        noise = torch.cat([noise, noise if consistent else uniform(n, cfg.num_patches)])
    rot_k = torch.randint(0, 4, (rows,), generator=gen, device=dev) if rot90 else None
    return PretrainDraws(hflip, vflip, crop_boxes, ms_boxes, noise, rot_k)


def _step_rng(tcfg: TrainConfig, seed: int, step: int, device: torch.device | str,
              rank: Optional[int] = None) -> torch.Generator:
    """The generator of one step: seeded from (seed, step), so one run seed
    covers the whole run, and from ``rank`` too for the shard_map
    semantics' per-rank draws (the JAX step's ``fold_in`` of the axis
    index); or from ``mask_seed`` alone, which repeats the same crops, flips
    and masks every step on every rank (the reference's torch.manual_seed
    semantics, MAE_ViT_Baseline.py:301-302; JAX train/pretrain.py:144-148)."""
    gen = torch.Generator(device=device)
    if tcfg.mask_seed is not None:
        return gen.manual_seed(tcfg.mask_seed)
    seed = seed * 1_000_003 + step
    if rank is not None:
        seed = seed * 4_099 + 1 + rank
    return gen.manual_seed(seed % 2 ** 63)


def make_pretrain_loss_fn(cfg: MAEConfig, augment: Callable | None,
                          global_batch: bool = False):
    """The per-(micro)batch objective the step differentiates:
    ``loss_fn(params, model_state, imgs, draws) -> (loss, MAEOutput)``.
    (The JAX one also takes the TrainConfig for the consistent mask; here
    the draws carry it.) ``global_batch``: see ``mae_loss_fn``."""

    def loss_fn(params, model_state, imgs: torch.Tensor, draws: PretrainDraws):
        if augment is not None:
            # A pair's frames are rows b * T + t of the augmentation
            # (JAX train/pretrain.py:40-47); the pair axis comes back after.
            lead = imgs.shape[:-3]
            flat = augment(imgs.reshape((-1,) + imgs.shape[-3:]), draws.hflip, draws.vflip,
                           draws.crop_boxes, draws.rot_k)
            imgs = flat.reshape(lead + flat.shape[1:])
        out = mae_loss_fn(params, model_state, cfg, imgs, noise=draws.noise,
                          ms_boxes=draws.ms_boxes, train=True, global_batch=global_batch)
        return out.loss, out

    return loss_fn


def make_pretrain_step(cfg: MAEConfig, tcfg: TrainConfig,
                       schedule: Callable[[int], float],
                       augment: Callable | None = None,
                       ddp_mode: Optional[str] = None) -> Callable:
    """Returns ``step(state, batch, draws, stop=False) -> (state, metrics)``.

    batch: (B, H, W, C) normalized images, or raw uint8 when ``augment``
    (``ops/augment.make_pretrain_augment``) is given, or temporal pairs (B,
    2, H, W, C); B = accum_iter * microbatch, this rank's rows. draws: one
    :class:`PretrainDraws` per microbatch (a single one when accum_iter is
    1). The state's params are updated in place. metrics hold 0-d device
    tensors (the loss terms, ``loss`` and ``grad_norm``, before clipping; with
    ``tcfg.watch_gradients`` each top-level subtree's gradient norm as
    ``gnorm/<name>``) and the step's ``lr``; nothing in the step waits on
    the device. ``ddp_mode`` None runs one process with no collective;
    'gspmd' or 'shard_map' (the module's docstring) needs a process group.
    There ``stop`` is this rank's request to stop (a preemption signal): it
    rides the step's reduction of its metrics, and ``metrics["stop"]``, the
    ranks' mean, is above 0 on every rank when any rank asked, so the ranks
    agree on the step to stop after without a collective of their own."""
    if ddp_mode not in (None, *DDP_MODES):
        raise ValueError(f"ddp_mode must be one of {DDP_MODES} or None, got {ddp_mode!r}")
    loss_fn = make_pretrain_loss_fn(cfg, augment, global_batch=ddp_mode == "gspmd")
    accum = tcfg.accum_iter
    if accum < 1:
        raise ValueError(f"accum_iter must be >= 1, got {accum}")
    flat: Optional[FlatGrads] = None   # data parallel: the gradients' buffers

    def step(state: TrainState, batch: torch.Tensor,
             draws: PretrainDraws | Sequence[PretrainDraws], stop: bool = False):
        nonlocal flat
        draws = [draws] if isinstance(draws, PretrainDraws) else list(draws)
        if len(draws) != accum or batch.shape[0] % accum:
            raise ValueError(
                f"batch of {batch.shape[0]} with {len(draws)} draws does not split "
                f"into accum_iter={accum} microbatches")
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.grad = None
        micro = batch.shape[0] // accum
        model_state = state.model_state
        loss, losses = 0.0, {}
        for k, d in enumerate(draws):
            mb_loss, out = loss_fn(state.params, model_state, batch[k * micro:(k + 1) * micro], d)
            mb_loss.backward()
            loss = loss + mb_loss.detach()
            for name, v in out.losses.items():
                losses[name] = losses.get(name, 0.0) + v.detach()
            model_state = out.state
        # A parameter the objective does not reach (encoder_norm while
        # apply_encoder_norm is False) has a zero gradient, as in JAX.
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
        specs = [spec_of(p) for p in leaves]
        stops = {}
        if ddp_mode is not None:
            flat, grads = average_gradients(flat, grads, specs)
            # A fill, not a copy from the host: the step does not wait.
            stops["stop"] = torch.full((), float(stop), device=batch.device)
            # shard_map averages the BatchNorm running state; the frozen
            # VGG trunk is the same on every rank and stays out.
            stats = ({k: v for k, v in model_state.items() if k != "vgg"}
                     if ddp_mode == "shard_map" else {})
            all_reduce_mean([loss, losses, stops, stats], world=True)
        if accum > 1:
            torch._foreach_mul_(grads, 1.0 / accum)
            loss = loss / accum
            losses = {k: v / accum for k, v in losses.items()}
        metrics = dict(losses, loss=loss, grad_norm=global_norm(grads, specs),
                       lr=schedule(state.step), **stops)
        if tcfg.watch_gradients:
            # wandb.watch's per-subtree gradient norms (main_pretrain.py:537).
            names = [path[0] for path, _ in tree_items(state.params)]
            for name in dict.fromkeys(names):
                mine = [i for i, owner in enumerate(names) if owner == name]
                metrics[f"gnorm/{name}"] = global_norm([grads[i] for i in mine],
                                                       [specs[i] for i in mine])
        state.apply_gradients(grads, model_state)
        for p in leaves:
            p.grad = None
        return state, metrics

    return step
