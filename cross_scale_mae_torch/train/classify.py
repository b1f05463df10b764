"""The finetune step and the eval step of the downstream classifier
(counterpart of ``cross_scale_mae_tpu/train/classify.py``; reference
``engine_finetune.py:24-236``).

The JAX step folds the step into one key and splits it into the augment,
mixup and model (drop-path) draws. Here the draws are explicit: a
:class:`FinetuneDraws` per microbatch, made by :func:`sample_finetune_draws`
from a ``torch.Generator`` or, in a test, from the JAX package's keys.
Gradient accumulation (``accum_iter``) is a Python loop over microbatches.
Data parallelism has the JAX package's one semantics for these steps, its
jit over a batch-sharded array: every rank draws for the global batch and
takes its own rows (:meth:`FinetuneDraws.shard`), the BN head's statistics
are the global batch's, Mixup/CutMix mixes each row with its partner in
the reversed global (micro)batch (rank W-1-r's rows, reversed:
``parallel/collectives.mirror_rank_rows``), and the gradients are averaged
over the ranks once per step. On a (data, model) mesh a rank's rows and
draws are those of its data index, and the params are this rank's parts
of a layout (``parallel/mesh.py``), as in ``train/pretrain.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from cross_scale_mae_torch.configs import TrainConfig, ViTClassifierConfig
from cross_scale_mae_torch.models.vit import drop_path_rates, vit_apply
from cross_scale_mae_torch.ops.augment import PRETRAIN_CROP_SCALE, AugmentExtras
from cross_scale_mae_torch.ops.image import sample_crop_boxes
from cross_scale_mae_torch.ops.randaug import EraseDraws, RandAugDraws
from cross_scale_mae_torch.parallel.collectives import mirror_rank_rows
from cross_scale_mae_torch.parallel.mesh import (
    FlatGrads,
    all_reduce_mean,
    average_gradients,
    spec_of,
)
from cross_scale_mae_torch.train.mixup import (
    MixupConfig,
    MixupDraws,
    mixup_cutmix,
    sample_mixup_draws,
    smooth_one_hot,
    soft_cross_entropy,
)
from cross_scale_mae_torch.train.state import TrainState, global_norm, tree_leaves


@dataclasses.dataclass
class FinetuneDraws:
    """The random numbers of one (micro)batch of N samples."""

    hflip: torch.Tensor                  # (N,) bool: augment's horizontal flips
    vflip: torch.Tensor                  # (N,) bool: augment's vertical flips
    crop_boxes: torch.Tensor             # (N, 4) RandomResizedCrop boxes on the canvas
    drop_masks: Optional[torch.Tensor]   # (depth, N) bool drop-path keeps, or None
    rot_k: Optional[torch.Tensor] = None  # (N,) NAIP rotations in {0..3}, or None
    randaug: Optional[RandAugDraws] = None  # the augment's RandAugment (--aa)
    jitter: Optional[torch.Tensor] = None   # (N, 3) ColorJitter factors
    erase: Optional[EraseDraws] = None      # RandomErasing (--reprob)
    mixup: Optional[MixupDraws] = None      # Mixup/CutMix, per element

    def augment_extras(self) -> dict:
        """The finetune augment's extra draws, keyed as it takes them."""
        return {k: v for k, v in (("randaug", self.randaug), ("jitter", self.jitter),
                                  ("erase", self.erase)) if v is not None}

    def shard(self, rank: int, world: int) -> "FinetuneDraws":
        """Rank ``rank``'s rows (rank::world, the rows of each global batch
        the loader's shard holds) of draws made for a global batch."""
        if world == 1:
            return self
        rows = slice(rank, None, world)

        def take(v):
            return None if v is None else v.take(rows)

        return FinetuneDraws(
            self.hflip[rows], self.vflip[rows], self.crop_boxes[rows],
            None if self.drop_masks is None else self.drop_masks[:, rows],
            None if self.rot_k is None else self.rot_k[rows],
            take(self.randaug), None if self.jitter is None else self.jitter[rows],
            take(self.erase), take(self.mixup))


def sample_finetune_draws(gen: torch.Generator, n: int, cfg: ViTClassifierConfig,
                          canvas: int, rot90: bool = False,
                          extras: Optional[AugmentExtras] = None,
                          mixup: Optional[MixupConfig] = None) -> FinetuneDraws:
    """Draw what one step of ``n`` samples needs on ``gen``'s device, with
    the JAX package's distributions: Bernoulli(0.5) flips, crop boxes from
    four uniforms each on a ``canvas``-sized image, Bernoulli(1 - rate)
    drop-path keeps per block when ``drop_path_rate > 0``, with ``rot90``
    uniform rotations in {0, 1, 2, 3}; then the draws of the augment's
    ``extras`` (``AugmentExtras.sample`` on the model's input size and
    channels) and of ``mixup`` (``train/mixup.sample_mixup_draws``), in that
    order, so the draws without them are those of a run without them."""
    dev = gen.device

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    hflip, vflip = uniform(n) < 0.5, uniform(n) < 0.5
    boxes = sample_crop_boxes(uniform(4, n), canvas, canvas, PRETRAIN_CROP_SCALE)
    masks = None
    if cfg.drop_path_rate > 0:
        keep = 1.0 - torch.from_numpy(drop_path_rates(cfg)).to(dev)
        masks = uniform(cfg.depth, n) < keep[:, None]
    rot_k = torch.randint(0, 4, (n,), generator=gen, device=dev) if rot90 else None
    more = {} if extras is None else extras.sample(gen, n, cfg.input_size, cfg.input_channels)
    mix = None if mixup is None else sample_mixup_draws(gen, n, mixup)
    return FinetuneDraws(hflip, vflip, boxes, masks, rot_k, **more, mixup=mix)


def make_classify_loss_fn(cfg: ViTClassifierConfig, tcfg: TrainConfig,
                          augment: Callable | None = None, freeze_backbone: bool = False,
                          global_stats: bool = False):
    """``loss_fn(params, model_state, imgs, labels, draws) -> (loss, (acc1,
    new_model_state))``: augment, smoothed one-hot targets, Mixup/CutMix
    when ``tcfg`` asks for it (``MixupConfig.from_train_config``; the
    partner of each row is its mirror in the reversed batch), the
    classifier with drop-path (its backbone frozen with
    ``freeze_backbone``), soft cross-entropy. ``global_stats``: the
    global-batch semantics under data parallelism (the BN head's statistics
    over every rank's rows, the mix partners from the mirror rank). The mix
    runs in a ``torch.profiler`` range, ``mixup_cutmix``."""
    mix_cfg = MixupConfig.from_train_config(tcfg)

    def loss_fn(params, model_state, imgs, labels, draws: FinetuneDraws):
        if augment is not None:
            imgs = augment(imgs, draws.hflip, draws.vflip, draws.crop_boxes, draws.rot_k,
                           **draws.augment_extras())
        targets = smooth_one_hot(labels, cfg.num_classes, tcfg.label_smoothing)
        if mix_cfg is not None:
            if draws.mixup is None:
                raise ValueError("the step mixes (Mixup/CutMix) and needs its draws")
            with record_function("mixup_cutmix"):
                partner_imgs, partner_labels = (mirror_rank_rows([imgs, labels])
                                                if global_stats else (imgs, labels))
                imgs, targets = mixup_cutmix(
                    imgs, targets, partner_imgs.flip(0),
                    smooth_one_hot(partner_labels.flip(0), cfg.num_classes,
                                   tcfg.label_smoothing),
                    draws.mixup, mix_cfg.cutmix_minmax)
        logits, new_state = vit_apply(params, model_state, cfg, imgs, train=True,
                                      drop_masks=draws.drop_masks,
                                      freeze_backbone=freeze_backbone,
                                      global_stats=global_stats)
        acc1 = (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
        return soft_cross_entropy(logits, targets), (acc1.detach(), new_state)

    return loss_fn


def make_classify_train_step(cfg: ViTClassifierConfig, tcfg: TrainConfig,
                             schedule: Callable[[int], float],
                             augment: Callable | None = None,
                             freeze_backbone: bool = False,
                             data_parallel: bool = False) -> Callable:
    """Returns ``step(state, imgs, labels, draws) -> (state, metrics)``.

    imgs: (B, H, W, C), raw uint8 when ``augment``
    (``ops/augment.make_finetune_augment``, or ``make_pretrain_augment``
    for the linear probe) is given; B = accum_iter * microbatch. draws: one
    :class:`FinetuneDraws` per microbatch (a single one when accum_iter is
    1). The params are updated in place. metrics hold 0-d device tensors
    (``loss``, ``grad_norm``, ``acc1``) and the step's ``lr``; nothing in
    the step waits on the device.

    ``freeze_backbone`` (the linear probe) runs the backbone without
    autograd, so no backbone leaf gets a gradient buffer: their gradients
    go to the optimizer as None, which its frozen mask must cover, and the
    gradient norm is that of the head's, the JAX value (where the
    backbone's gradients are zeros).

    ``data_parallel`` (needs a process group): imgs and draws are this
    rank's rows, the BN head's statistics the global batch's, the gradients
    averaged over the ranks before the norm, and the metrics the ranks'
    means."""
    loss_fn = make_classify_loss_fn(cfg, tcfg, augment, freeze_backbone,
                                    global_stats=data_parallel)
    accum = tcfg.accum_iter
    if accum < 1:
        raise ValueError(f"accum_iter must be >= 1, got {accum}")
    flat: Optional[FlatGrads] = None   # data parallel: the gradients' buffers

    def step(state: TrainState, imgs: torch.Tensor, labels: torch.Tensor,
             draws: FinetuneDraws | Sequence[FinetuneDraws]):
        nonlocal flat
        draws = [draws] if isinstance(draws, FinetuneDraws) else list(draws)
        if len(draws) != accum or imgs.shape[0] % accum:
            raise ValueError(
                f"batch of {imgs.shape[0]} with {len(draws)} draws does not split "
                f"into accum_iter={accum} microbatches")
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.grad = None
        micro = imgs.shape[0] // accum
        model_state = state.model_state
        loss, acc1 = 0.0, 0.0
        for i, d in enumerate(draws):
            part = slice(i * micro, (i + 1) * micro)
            mb_loss, (mb_acc, model_state) = loss_fn(
                state.params, model_state, imgs[part], labels[part], d)
            mb_loss.backward()
            loss, acc1 = loss + mb_loss.detach(), acc1 + mb_acc
        # A parameter the objective does not reach gets a zero gradient, as
        # in JAX, but for a frozen backbone's, which stay None.
        grads = [p.grad if p.grad is not None or freeze_backbone else torch.zeros_like(p)
                 for p in leaves]
        reached = [g for g in grads if g is not None]
        specs = [spec_of(p) for p, g in zip(leaves, grads) if g is not None]
        if data_parallel:
            flat, averaged = average_gradients(flat, reached, specs)
            averaged = iter(averaged)
            grads = [None if g is None else next(averaged) for g in grads]
            reached = [g for g in grads if g is not None]
            all_reduce_mean([loss, acc1])
        if accum > 1:
            torch._foreach_mul_(reached, 1.0 / accum)
            loss, acc1 = loss / accum, acc1 / accum
        metrics = dict(loss=loss, grad_norm=global_norm(reached, specs),
                       lr=schedule(state.step), acc1=acc1)
        state.apply_gradients(grads, model_state)
        for p in leaves:
            p.grad = None
        return state, metrics

    return step


def make_eval_step(cfg: ViTClassifierConfig, preprocess: Callable | None = None) -> Callable:
    """``step(params, model_state, imgs, labels, valid=None) -> dict``.

    ``valid`` (B,) bool marks real samples of a batch padded to a fixed size.
    Returns 0-d tensors ``loss``, ``acc1`` and ``acc5`` (means over the
    valid rows, top-k with k = min(5, C)) and ``n`` (the valid count), the
    (C, C) confusion matrix ``cm`` over valid rows (rows true, columns
    predicted), and the fp32 ``logits``."""

    @torch.no_grad()
    def step(params, model_state, imgs, labels, valid=None):
        if preprocess is not None:
            imgs = preprocess(imgs)
        logits, _ = vit_apply(params, model_state, cfg, imgs, train=False)
        v = (torch.ones(labels.shape, device=logits.device) if valid is None
             else valid.to(torch.float32))
        n = torch.clamp(v.sum(), min=1.0)
        per_loss = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None].long())[:, 0]
        top1 = logits.argmax(dim=-1)
        topk = logits.topk(min(5, cfg.num_classes), dim=-1).indices
        correct1 = (top1 == labels).to(torch.float32)
        correctk = (topk == labels[:, None]).any(dim=1).to(torch.float32)
        oh_true = F.one_hot(labels.long(), cfg.num_classes).to(torch.float32)
        oh_pred = F.one_hot(top1, cfg.num_classes).to(torch.float32)
        cm = torch.einsum("bt,bp->tp", oh_true * v[:, None], oh_pred)
        return dict(loss=(per_loss * v).sum() / n, acc1=(correct1 * v).sum() / n,
                    acc5=(correctk * v).sum() / n, n=v.sum(), cm=cm, logits=logits)

    return step
