"""Mixup / CutMix with label smoothing, and the soft-target loss
(counterpart of ``cross_scale_mae_tpu/train/mixup.py``).

The JAX step mixes each (micro)batch with its reversed self inside the
jitted step, in timm's three modes (``--mixup_mode``): ``batch`` (one
lambda and box for the batch), ``pair`` (element i and its partner N-1-i
share the draws of the first half) and ``elem`` (every element its own).
Here the draws are explicit: :class:`MixupDraws` holds them per element,
already broadcast (batch) or mirrored (pair), so :func:`mixup_cutmix` is
one mode-free program over (N,) vectors; :func:`mixup_draws_from` expands
the draws of each mode as JAX draws them (a test hands it the JAX
package's), and :func:`sample_mixup_draws` makes them on a
``torch.Generator``. The partner batch is an argument: the reversed batch
in one process, and under data parallelism the rows that
``parallel/collectives.mirror_rank_rows`` brings from the mirror rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from cross_scale_mae_torch.ops.numerics import at_least_f32

MIXUP_MODES = ("batch", "pair", "elem")
BETA_CANDIDATES = 16


def smooth_one_hot(labels: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    """fp32 targets with the timm convention: on = 1 - smoothing + off,
    off = smoothing / num_classes (each row sums to 1)."""
    off = smoothing / num_classes
    return F.one_hot(labels.long(), num_classes).to(torch.float32) * (1.0 - smoothing) + off


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """timm SoftTargetCrossEntropy: the batch mean of -sum(t * log_softmax)."""
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    return -(targets * logp).sum(dim=-1).mean()


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    """What the mix needs of ``TrainConfig``: the alphas after timm's
    override (an explicit ``cutmix_minmax`` sets the cutmix alpha to 1),
    the apply and switch probabilities, the mode and the min/max range."""

    mixup_alpha: float
    cutmix_alpha: float
    prob: float = 1.0
    switch_prob: float = 0.5
    mode: str = "batch"
    cutmix_minmax: Optional[tuple[float, float]] = None

    @classmethod
    def from_train_config(cls, tcfg) -> Optional["MixupConfig"]:
        """None when the step does not mix (JAX classify.py:47-48 and
        mixup.py:121-127): neither alpha set and no min/max range; with both
        alphas 0 the targets are only smoothed."""
        if not (tcfg.mixup > 0 or tcfg.cutmix > 0 or tcfg.cutmix_minmax is not None):
            return None
        minmax = tuple(tcfg.cutmix_minmax) if tcfg.cutmix_minmax is not None else None
        cutmix = 1.0 if minmax is not None else tcfg.cutmix
        if tcfg.mixup <= 0 and cutmix <= 0:
            return None
        if tcfg.mixup_mode not in MIXUP_MODES:
            raise ValueError(f"mixup mode {tcfg.mixup_mode!r} is not one of {MIXUP_MODES}")
        return cls(tcfg.mixup, cutmix, tcfg.mixup_prob, tcfg.mixup_switch_prob,
                   tcfg.mixup_mode, minmax)


@dataclasses.dataclass
class MixupDraws:
    """One (micro)batch's mix draws, per element (N rows)."""

    apply: torch.Tensor       # (N,) bool: mix this element
    use_cutmix: torch.Tensor  # (N,) bool: CutMix, else Mixup
    lam_mix: torch.Tensor     # (N,) fp32 Mixup lambda
    lam_cut: torch.Tensor     # (N,) fp32 CutMix lambda before the area correction
    box: torch.Tensor         # (N, 4) fp32 box draws (see cutmix_mask)

    def take(self, rows) -> "MixupDraws":
        return MixupDraws(*(getattr(self, f.name)[rows] for f in dataclasses.fields(self)))


def beta_johnk(u: torch.Tensor, v: torch.Tensor, alpha: float) -> torch.Tensor:
    """Beta(alpha, alpha) by Jöhnk's algorithm on (16, *shape) uniforms in
    [1e-7, 1) (JAX mixup.py:29-46): x = u^(1/a), s = x + v^(1/a); the first
    candidate with s <= 1 gives x / s, and 0.5 where none does."""
    x = u ** (1.0 / alpha)
    s = x + v ** (1.0 / alpha)
    valid = s <= 1.0
    idx = valid.to(torch.uint8).argmax(dim=0, keepdim=True)   # the first accepted
    xs = torch.gather(x, 0, idx)[0]
    ss = torch.gather(s, 0, idx)[0]
    lam = xs / torch.clamp(ss, min=1e-12)
    return torch.where(valid.any(dim=0), lam, torch.full_like(lam, 0.5))


def cutmix_mask(box: torch.Tensor, lam: torch.Tensor, h: int, w: int,
                minmax: Optional[tuple[float, float]] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample rectangles (N, H, W) bool and the area-corrected lambda
    (timm correct_lam), JAX mixup.py:49-82. Without ``minmax`` the box has
    side sqrt(1 - lam) of the image around centre (box[:, 0] * h, box[:, 1]
    * w), clipped to the image; with it the height and width fractions are
    box[:, 0] and box[:, 1] (drawn in [min, max]) and the top-left corner
    box[:, 2] * (h - height), box[:, 3] * (w - width), inside the image."""
    if minmax is not None:
        ch, cw = box[:, 0] * h, box[:, 1] * w
        y0 = box[:, 2] * (h - ch)
        x0 = box[:, 3] * (w - cw)
        y1, x1 = y0 + ch, x0 + cw
    else:
        cut = torch.sqrt(1.0 - lam)
        ch, cw = cut * h, cut * w
        cy, cx = box[:, 0] * h, box[:, 1] * w
        y0, y1 = torch.clamp(cy - ch / 2, 0, h), torch.clamp(cy + ch / 2, 0, h)
        x0, x1 = torch.clamp(cx - cw / 2, 0, w), torch.clamp(cx + cw / 2, 0, w)
    ys = torch.arange(h, dtype=torch.float32, device=box.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=box.device)[None, None, :]
    inside = ((ys >= y0[:, None, None]) & (ys < y1[:, None, None])
              & (xs >= x0[:, None, None]) & (xs < x1[:, None, None]))
    lam_adj = 1.0 - (y1 - y0) * (x1 - x0) / (h * w)
    return inside, lam_adj


def mirror_pairs(vals: torch.Tensor) -> torch.Tensor:
    """(N, ...) values where element i and its partner N-1-i share the first
    half's draw (timm's pair mode)."""
    half = vals[: vals.shape[0] // 2]
    return torch.cat([half, half.flip(0)])


def mixup_draws_from(mode: str, n: int, apply: torch.Tensor, use_cutmix: torch.Tensor,
                     lam_mix: torch.Tensor, lam_cut: torch.Tensor,
                     box: torch.Tensor) -> MixupDraws:
    """Per-element draws of a batch of ``n`` from the draws of ``mode`` in
    the JAX shapes (mixup.py:130-170): ``batch`` one scalar each and a (1,
    4) box, broadcast; ``pair`` (n,) vectors of which the first half is
    mirrored, and an (n // 2, 4) box mirrored; ``elem`` (n,) vectors and an
    (n, 4) box. ``pair`` needs an even batch (the reference's
    FixedDeviceMixup asserts it, main_finetune.py:41)."""
    if mode not in MIXUP_MODES:
        raise ValueError(f"mixup mode {mode!r} is not one of {MIXUP_MODES}")
    if mode == "pair" and n % 2:
        raise ValueError(f"pair mode needs an even batch, got {n}")
    if mode == "batch":
        vecs = [v.reshape(1).expand(n) for v in (apply, use_cutmix, lam_mix, lam_cut)]
        box = box.reshape(1, 4).expand(n, 4)
    elif mode == "pair":
        vecs = [mirror_pairs(v) for v in (apply, use_cutmix, lam_mix, lam_cut)]
        box = torch.cat([box, box.flip(0)])
    else:
        vecs = [apply, use_cutmix, lam_mix, lam_cut]
    apply, use_cutmix, lam_mix, lam_cut = (v.contiguous() for v in vecs)
    return MixupDraws(apply.bool(), use_cutmix.bool(), lam_mix.float(), lam_cut.float(),
                      box.float().contiguous())


def sample_mixup_draws(gen: torch.Generator, n: int, mcfg: MixupConfig) -> MixupDraws:
    """The draws of one (micro)batch of ``n`` on ``gen``'s device, with the
    JAX distributions in the JAX shapes of ``mcfg.mode``: Bernoulli switch
    and apply flags, Beta lambdas by Jöhnk's sampler (torch's ``Beta`` takes
    no generator), uniform box draws (in [min, max] for the box sides with a
    min/max range)."""
    dev = gen.device
    shape = () if mcfg.mode == "batch" else (n,)
    boxes = {"batch": 1, "pair": n // 2, "elem": n}[mcfg.mode]

    def uniform(*s, lo=0.0, hi=1.0):
        return torch.rand(s, generator=gen, device=dev) * (hi - lo) + lo

    def beta(alpha):
        if alpha <= 0:
            return torch.ones(shape, device=dev)
        u = uniform(BETA_CANDIDATES, *shape, lo=1e-7)
        v = uniform(BETA_CANDIDATES, *shape, lo=1e-7)
        return beta_johnk(u, v, alpha)

    if mcfg.mixup_alpha > 0 and mcfg.cutmix_alpha > 0:
        use_cutmix = uniform(*shape) < mcfg.switch_prob
    else:
        use_cutmix = torch.full(shape, mcfg.cutmix_alpha > 0, device=dev)
    lam_mix, lam_cut = beta(mcfg.mixup_alpha), beta(mcfg.cutmix_alpha)
    apply = uniform(*shape) < mcfg.prob
    box = uniform(boxes, 4)
    if mcfg.cutmix_minmax is not None:
        lo, hi = mcfg.cutmix_minmax
        box[:, :2] = box[:, :2] * (hi - lo) + lo
    return mixup_draws_from(mcfg.mode, n, apply, use_cutmix, lam_mix, lam_cut, box)


def mixup_cutmix(imgs: torch.Tensor, targets: torch.Tensor, partner_imgs: torch.Tensor,
                 partner_targets: torch.Tensor, draws: MixupDraws,
                 cutmix_minmax: Optional[tuple[float, float]] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mixed images, soft targets), JAX mixup.py:172-192. imgs: NHWC in
    the compute dtype (after the augment's cast); targets: (N, C) fp32
    smoothed one-hot; the partners are the rows each element mixes with
    (the reversed batch). CutMix pastes the partner inside the box; Mixup
    blends in fp32 (lambda is fp32) and casts back to the images' dtype;
    the targets mix in fp32 with the area-corrected lambda for CutMix."""
    h, w = imgs.shape[1], imgs.shape[2]
    inside, lam_cut = cutmix_mask(draws.box, draws.lam_cut, h, w, cutmix_minmax)
    cut_imgs = torch.where(inside[..., None], partner_imgs, imgs)
    lm = draws.lam_mix[:, None, None, None]
    mix_imgs = (lm * imgs + (1 - lm) * partner_imgs).to(imgs.dtype)
    mixed = torch.where(draws.use_cutmix[:, None, None, None], cut_imgs, mix_imgs)
    out_imgs = torch.where(draws.apply[:, None, None, None], mixed, imgs)
    lam = torch.where(draws.use_cutmix, lam_cut, draws.lam_mix)[:, None]
    out_targets = torch.where(draws.apply[:, None],
                              lam * targets + (1 - lam) * partner_targets, targets)
    return out_imgs, out_targets
