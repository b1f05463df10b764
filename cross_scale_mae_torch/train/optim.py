"""The optimizers of the JAX package's ``build_optimizer`` (counterpart of
``cross_scale_mae_tpu/train/optim.py``): AdamW with the weight-decay mask
and layer-wise lr decay, LARS, SGD, each optionally after global-norm
clipping and under a frozen mask, and Adam's moments stored in bf16.

The chain is the JAX one, step for step: clip -> the optimizer -> the
layer-decay scale, inside ``optax.masked`` when a frozen mask is given (the
clip's norm and the state cover the trainable leaves only; frozen leaves
are never read or written, and their gradients may be None). AdamW is
optax's ``adamw``: with t the number of updates already applied and s the
leaf's layer-decay scale (1 without layer decay),

    m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2
    p <- p - s * lr(t) * (m / (1 - b1^(t+1)) / (sqrt(v / (1 - b2^(t+1))) + eps)
                          + wd * mask * p)

so the first update uses ``schedule(0)``, and layer decay scales the whole
update, weight decay included. The moment dtypes (``mu_dtype``,
``nu_dtype``) keep the JAX package's two rounding rules: with ``mu_dtype``
alone it is ``optax.adamw``, whose b1 m is computed in the stored dtype
(bf16, b1 rounded to it as well) before it is added to the fp32 (1 - b1) g;
with ``nu_dtype`` it is ``scale_by_adam_moment_dtypes``, which upcasts each
moment to fp32 first. (These are the ops' semantics, as JAX runs them
eagerly; under jit XLA may keep the bf16 product in fp32, its default
excess precision.)
Either way the update is computed in fp32 and the new moments are rounded
to their dtype for storage. On the card, every leaf that
``ops/adamw.kernel_takes`` (fp32 params and gradients, contiguous) is
updated by one launch of the fused kernel ``csrc/adamw.cu``
(``ops/adamw.fused_adamw``), which reads and writes each element once; the
other leaves, and every leaf on the CPU, run as PyTorch multi-tensor
(``torch._foreach_*``) ops over those leaves at once, the kernel's plain
version. ``AdamW.fused_share``
is the share of the elements the last update gave the kernel.

Under a mesh layout (``parallel/mesh.py``) the leaves are this rank's
parts: the clip's global norm and LARS's per-leaf norms sum a split leaf's
squares over its groups and count a replicated leaf once. With ``zero1``
(AdamW; ZeRO-1) the params and gradients are whole, each rank keeps its
1/dp of the moments of each large leaf (a chunk on the leaf's ZeRO-1 axis),
updates its chunk of the param, and the chunks are all-gathered into the
whole param after the update.

LARS (:class:`Lars`) has MoCo-v3 semantics (util/lars.py:27-57), as the
JAX package's ``lars``; SGD (:class:`Sgd`) is ``optax.sgd`` with momentum
0.9. Each optimizer's state goes to a flat path -> tensor dict and back in
place (``state_dict``, ``load_state_dict``): ``count``, and each moment
under the parameter's JAX path (``mu/<path>``, ``nu/<path>``; none for a
frozen leaf), block leaves stacked on a leading layer axis, in its stored
dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from cross_scale_mae_torch.ops.adamw import fused_adamw
from cross_scale_mae_torch.parallel.collectives import gather_parts
from cross_scale_mae_torch.parallel.dist import data_group, mesh
from cross_scale_mae_torch.parallel.mesh import is_split, moment_spec, reduce_leaf_squares, \
    spec_of, tag
from cross_scale_mae_torch.train.state import (
    flat_state,
    global_norm,
    load_flat_state,
    tree_items,
    tree_leaves,
    tree_like,
)

Params = dict[str, Any]


def wd_mask(params: Params, extra_no_decay: tuple[str, ...] = ()) -> list[bool]:
    """True = apply weight decay, per leaf in ``tree_leaves`` order, by name:
    linear ``kernel``s and the ``cls_token``, ``mask_token`` and
    ``pos_embed`` leaves decay; biases, norm scales and BatchNorm params do
    not. A leaf with a name of ``extra_no_decay`` on its path never decays
    (finetuning passes ``("pos_embed", "cls_token")``, timm's
    ``no_weight_decay``)."""
    return [not any(name in extra_no_decay for name in path)
            and path[-1] in ("kernel", "cls_token", "mask_token", "pos_embed")
            for path, _ in tree_items(params)]


def layer_decay_scales(params: Params, layer_decay: float, depth: int) -> list[float]:
    """Per-leaf lr multipliers of BEiT layer-wise decay (util/lr_decay.py),
    in ``tree_leaves`` order: ``layer_decay ** (depth + 1 - id)`` with layer
    ids patch_embed, cls_token, pos_embed -> 0; ``blocks[i]`` -> i + 1;
    everything else (norms, head) -> depth + 1. The port keeps blocks as a
    list, so each block leaf has one scalar (the JAX package broadcasts a
    per-layer vector over the stacked leaves)."""
    num_layers = depth + 1

    def layer_id(path) -> int:
        if path[0] in ("patch_embed", "cls_token", "pos_embed"):
            return 0
        if path[0] == "blocks":
            return path[1] + 1
        return num_layers

    return [layer_decay ** (num_layers - layer_id(path)) for path, _ in tree_items(params)]


class _Masked:
    """What the three optimizers share: the trainable leaves (optax
    ``masked``), the clip over them, the update with the layer-decay
    scales, and the per-leaf state as a tree with None on frozen leaves.
    ``masked`` says whether a frozen mask was given (the JAX chain is then
    wrapped in ``optax.masked``, which its state's structure shows)."""

    masked = False

    def __init__(self, schedule: Callable[[int], float], trainable: list[bool],
                 clip_grad: Optional[float], scales: Optional[list[float]]):
        self.schedule, self.trainable, self.clip_grad = schedule, trainable, clip_grad
        self.idx = [i for i, t in enumerate(trainable) if t]
        self.scales = None if scales is None else [scales[i] for i in self.idx]

    def _check(self, params: Params) -> list[torch.Tensor]:
        leaves = tree_leaves(params)
        if len(leaves) != len(self.trainable):
            raise ValueError(f"{len(leaves)} params but a mask of {len(self.trainable)}")
        return [leaves[i] for i in self.idx]

    def _select(self, params: list[torch.Tensor], grads: list[Optional[torch.Tensor]]):
        """The trainable params, their gradients (a trainable leaf the
        objective did not reach has a zero gradient) and, when asked, the
        clip factor to scale them by, a 0-d tensor
        (``optax.clip_by_global_norm``: max_norm / norm when above), else None."""
        ps = [params[i] for i in self.idx]
        gs = [torch.zeros_like(params[i]) if grads[i] is None else grads[i] for i in self.idx]
        factor = None
        if self.clip_grad is not None:
            norm = global_norm(gs, [spec_of(p) for p in ps])
            factor = torch.clamp(self.clip_grad / norm, max=1.0)
        return ps, gs, factor

    def _clipped(self, params: list[torch.Tensor], grads: list[Optional[torch.Tensor]]):
        """:meth:`_select`'s params, and the gradients clipped when asked."""
        ps, gs, factor = self._select(params, grads)
        return ps, gs if factor is None else torch._foreach_mul(gs, factor)

    @staticmethod
    def _apply(ps: list[torch.Tensor], upd: list[torch.Tensor], lr: float,
               scales: Optional[list[float]]) -> None:
        if scales is None:
            torch._foreach_add_(ps, upd, alpha=-lr)
        else:
            # optax's order: -lr * u, then the layer scale, then p + u.
            upd = torch._foreach_mul(upd, -lr)
            torch._foreach_mul_(upd, scales)
            torch._foreach_add_(ps, upd)

    def _tree(self, leaves: list[torch.Tensor], params: Params) -> Any:
        """Per-trainable-leaf state as a tree like ``params``, None on frozen leaves."""
        it = iter(leaves)
        return tree_like(params, (next(it) if t else None for t in self.trainable))

    def _state_dict(self, count: int, params: Params, **moments) -> dict[str, torch.Tensor]:
        out = {"count": torch.tensor(count, dtype=torch.int64)}
        for name, leaves in moments.items():
            out.update(flat_state(self._tree(leaves, params), name))
        return out

    def _load(self, flat: dict[str, torch.Tensor], params: Params, **moments) -> set[str]:
        used = {"count"}
        for name, leaves in moments.items():
            used |= load_flat_state(self._tree(leaves, params), name, flat)
        return used


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: list[torch.Tensor]   # one per trainable leaf, in mu_dtype
    nu: list[torch.Tensor]   # one per trainable leaf, in nu_dtype


class AdamW(_Masked):
    """optax ``adamw`` (eps inside the square root's sum: 0) over the
    trainable leaves, updating them in place; ``scales`` (one per leaf)
    multiply each leaf's whole update, as the JAX package's layer-decay
    ``scale_by_tree`` chained after ``adamw`` does. ``mu_dtype`` and
    ``nu_dtype`` (torch dtypes, None: the param's) store the moments
    (module docstring: the two rounding rules). ``fused_share`` is the
    share of the trainable elements the last update gave the fused kernel
    (None before the first)."""

    def __init__(self, schedule: Callable[[int], float], decay: list[bool], *,
                 b1: float, b2: float, eps: float, weight_decay: float,
                 clip_grad: Optional[float], scales: Optional[list[float]],
                 trainable: list[bool], mu_dtype: Optional[torch.dtype],
                 nu_dtype: Optional[torch.dtype], zero1: bool = False):
        super().__init__(schedule, trainable, clip_grad, scales)
        self.zero1 = zero1
        self.decay = [decay[i] for i in self.idx]
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype
        # JAX's scale_by_adam_moment_dtypes (JAX optim.py:131-172) when nu_dtype is
        # set, else optax.adamw's scale_by_adam.
        self.upcast_first = nu_dtype is not None
        self.fused_share: Optional[float] = None

    def _chunk(self, t: torch.Tensor, spec) -> torch.Tensor:
        """ZeRO-1: this rank's chunk (a view) of a whole leaf of ``spec``."""
        if not self.zero1 or spec is None or spec.zero1_axis is None:
            return t
        return t.chunk(mesh().dp, spec.zero1_axis)[mesh().d]

    def init(self, params: Params) -> AdamWState:
        full = self._check(params)
        specs = [spec_of(p) for p in full]
        leaves = [self._chunk(p, s) for p, s in zip(full, specs)]
        mu, nu = ([torch.zeros_like(p, dtype=dtype, memory_format=torch.contiguous_format)
                   for p in leaves] for dtype in (self.mu_dtype, self.nu_dtype))
        for moments in (mu, nu):
            for t, s in zip(moments, specs):
                tag(t, moment_spec(s, self.zero1))
        return AdamWState(0, mu, nu)

    def _moments(self, ps: list[torch.Tensor], gs: list[torch.Tensor],
                 mu: list[torch.Tensor], nu: list[torch.Tensor]):
        """The new moments as fp32 leaves, by the chain's rounding rule, and
        the (stored moments, their new fp32 values) pairs to cast back: a
        moment stored like its param is updated in place."""
        b1, b2 = self.b1, self.b2
        casts = []
        if all(m.dtype == p.dtype for m, p in zip(mu, ps)):
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, gs, alpha=1 - b1)
            mu32 = mu
        else:
            if self.upcast_first:
                mu32 = [m.float() for m in mu]
                torch._foreach_mul_(mu32, b1)
            else:
                # optax tree_update_moment: (1 - b1) g + b1 m, with b1 m in
                # m's dtype; JAX's weak-typed b1 takes that dtype too (0.9 is
                # 0.900390625 in bf16).
                b1_stored = float(torch.tensor(b1, dtype=mu[0].dtype))
                mu32 = [(m * b1_stored).float() for m in mu]
            torch._foreach_add_(mu32, torch._foreach_mul(gs, 1 - b1))
            casts.append((mu, mu32))
        if all(v.dtype == p.dtype for v, p in zip(nu, ps)):
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, gs, gs, value=1 - b2)
            nu32 = nu
        else:
            nu32 = [v.float() for v in nu]
            torch._foreach_mul_(nu32, b2)
            torch._foreach_add_(nu32, torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
            casts.append((nu, nu32))
        return mu32, nu32, casts

    def _foreach_update(self, idx: list[int], ps: list[torch.Tensor], gs: list[torch.Tensor],
                        state: AdamWState, factor: Optional[torch.Tensor], lr: float,
                        t: int) -> None:
        """The update of the leaves ``idx`` (of the trainable ones) by the
        foreach chain."""
        ps, gs = [ps[i] for i in idx], [gs[i] for i in idx]
        if factor is not None:
            gs = torch._foreach_mul(gs, factor)
        mu, nu, casts = self._moments(ps, gs, [state.mu[i] for i in idx],
                                      [state.nu[i] for i in idx])
        denom = torch._foreach_div(nu, 1 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1 - self.b1 ** t)
        torch._foreach_div_(upd, denom)
        decayed = [j for j, i in enumerate(idx) if self.decay[i]]
        if self.wd and decayed:
            torch._foreach_add_([upd[j] for j in decayed], [ps[j] for j in decayed],
                                alpha=self.wd)
        for stored, new in casts:
            torch._foreach_copy_(stored, new)   # the new moment, rounded to its dtype
        self._apply(ps, upd, lr, None if self.scales is None else [self.scales[i] for i in idx])

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[Optional[torch.Tensor]],
               state: AdamWState) -> None:
        ps, gs, factor = self._select(params, grads)
        whole = ps
        if self.zero1:
            specs = [spec_of(p) for p in ps]
            ps = [self._chunk(p, sp) for p, sp in zip(ps, specs)]
            gs = [self._chunk(g, sp) for g, sp in zip(gs, specs)]
        lr = self.schedule(state.count)
        t = state.count + 1
        rest = fused_adamw(ps, gs, state.mu, state.nu, self.decay, self.scales, factor, lr=lr,
                           b1=self.b1, b2=self.b2, eps=self.eps, weight_decay=self.wd,
                           count=t, upcast_first=self.upcast_first)
        if rest:
            self._foreach_update(rest, ps, gs, state, factor, lr, t)
        total = sum(p.numel() for p in ps)
        self.fused_share = 1 - sum(ps[i].numel() for i in rest) / total if total else 1.0
        if self.zero1:
            self._gather_chunks(whole, ps)
        state.count = t

    @staticmethod
    def _gather_chunks(whole: list[torch.Tensor], chunks: list[torch.Tensor]) -> None:
        """ZeRO-1: every rank's updated chunks into the whole params, one
        all-gather a dtype."""
        group = data_group()
        by_dtype: dict[torch.dtype, list[int]] = {}
        for i, (p, c) in enumerate(zip(whole, chunks)):
            if c is not p and group is not None:
                by_dtype.setdefault(c.dtype, []).append(i)
        for idx in by_dtype.values():
            parts = gather_parts([chunks[i] for i in idx], group)
            torch._foreach_copy_([whole[i] for i in idx],
                                 [torch.cat(ps, spec_of(whole[i]).zero1_axis)
                                  for i, ps in zip(idx, parts)])

    def state_dict(self, state: AdamWState, params: Params) -> dict[str, torch.Tensor]:
        return self._state_dict(state.count, params, mu=state.mu, nu=state.nu)

    def load_state_dict(self, state: AdamWState, flat: dict[str, torch.Tensor],
                        params: Params) -> set[str]:
        """Copy the moments into ``state``'s tensors and set its count;
        returns the keys read. A moment of another dtype than the state's
        raises (``load_flat_state``)."""
        used = self._load(flat, params, mu=state.mu, nu=state.nu)
        state.count = int(flat["count"])
        return used


# MoCo-v3's LARS constants (util/lars.py:27-57), the JAX package's defaults.
LARS_MOMENTUM = 0.9
LARS_TRUST_COEFFICIENT = 0.001
SGD_MOMENTUM = 0.9


@dataclasses.dataclass
class LarsState:
    count: int
    mu: list[torch.Tensor]   # one momentum buffer per trainable leaf (SGD's too)


class Lars(_Masked):
    """LARS with MoCo-v3 semantics over the leaves ``trainable`` marks
    (JAX ``lars`` under ``optax.masked``), updating them in place; with t the
    optimizer's own step count, per trainable leaf, after the optional clip:

        dp = g + wd p,  dp <- dp * tc ||p|| / ||dp||   (leaves of more than 1 dim;
                                                       1 where a norm is 0)
        dp = g                                           (1-D leaves)
        mu <- momentum mu + dp,  p <- p - s lr(t) mu

    with s the layer-decay scale (1 without). The norms are taken over each
    of the port's leaves (the JAX package stacks the blocks, so its stacked
    leaves share one norm and count as more than 1-D; where only unstacked
    leaves train, as the linear probe's head, the two agree)."""

    def __init__(self, schedule: Callable[[int], float], trainable: list[bool], *,
                 weight_decay: float, momentum: float = LARS_MOMENTUM,
                 trust_coefficient: float = LARS_TRUST_COEFFICIENT,
                 clip_grad: Optional[float] = None, scales: Optional[list[float]] = None):
        super().__init__(schedule, trainable, clip_grad, scales)
        self.wd, self.momentum, self.tc = weight_decay, momentum, trust_coefficient

    def init(self, params: Params) -> LarsState:
        return LarsState(0, [tag(torch.zeros_like(p, memory_format=torch.contiguous_format),
                                 spec_of(p)) for p in self._check(params)])

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[Optional[torch.Tensor]],
               state: LarsState) -> None:
        ps, dps = self._clipped(params, grads)
        dps = list(dps)
        wide = [j for j, p in enumerate(ps) if p.dim() > 1]
        if wide:
            pw = [ps[j] for j in wide]
            dw = [dps[j] for j in wide]
            if self.wd:
                dw = torch._foreach_add(dw, pw, alpha=self.wd)
            p_norm = torch._foreach_norm(pw)
            u_norm = torch._foreach_norm(dw)
            specs = [spec_of(p) for p in pw]
            if is_split(specs):
                # A split leaf's norms are those of the whole leaf.
                p_norm = list(reduce_leaf_squares(torch.stack(p_norm) ** 2, specs).sqrt())
                u_norm = list(reduce_leaf_squares(torch.stack(u_norm) ** 2, specs).sqrt())
            trust = [torch.where((pn > 0) & (un > 0), self.tc * pn / un, torch.ones_like(pn))
                     for pn, un in zip(p_norm, u_norm)]
            dw = torch._foreach_mul(dw, trust)
            for j, d in zip(wide, dw):
                dps[j] = d
        lr = self.schedule(state.count)
        torch._foreach_mul_(state.mu, self.momentum)
        torch._foreach_add_(state.mu, dps)
        self._apply(ps, state.mu, lr, self.scales)
        state.count += 1

    def state_dict(self, state: LarsState, params: Params) -> dict[str, torch.Tensor]:
        return self._state_dict(state.count, params, mu=state.mu)

    def load_state_dict(self, state: LarsState, flat: dict[str, torch.Tensor],
                        params: Params) -> set[str]:
        """Copy the trainable leaves' momentum into ``state``'s tensors and
        set its count; returns the keys read."""
        used = self._load(flat, params, mu=state.mu)
        state.count = int(flat["count"])
        return used


class Sgd(Lars):
    """``optax.sgd(schedule, momentum=0.9)`` (``trace`` then the lr): per
    trainable leaf, after the optional clip, mu <- 0.9 mu + g and p <- p - s
    lr(t) mu; no weight decay."""

    def __init__(self, schedule: Callable[[int], float], trainable: list[bool], *,
                 clip_grad: Optional[float] = None, scales: Optional[list[float]] = None):
        super().__init__(schedule, trainable, weight_decay=0.0, momentum=SGD_MOMENTUM,
                         clip_grad=clip_grad, scales=scales)

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[Optional[torch.Tensor]],
               state: LarsState) -> None:
        ps, gs = self._clipped(params, grads)
        lr = self.schedule(state.count)
        torch._foreach_mul_(state.mu, self.momentum)
        torch._foreach_add_(state.mu, gs)
        self._apply(ps, state.mu, lr, self.scales)
        state.count += 1


OPTIMIZERS = ("adamw", "lars", "sgd")
MOMENT_DTYPES = ("float32", "bfloat16")   # the CLIs' choices


def _float_dtype(flag: str, name: Optional[str]) -> Optional[torch.dtype]:
    dtype = getattr(torch, name, None) if name else None
    if name and not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        raise ValueError(f"{flag} {name!r} is not a floating-point dtype")
    return dtype


def build_optimizer(
    params: Params,
    schedule: Callable[[int], float],
    *,
    optimizer: str = "adamw",
    weight_decay: float = 0.05,
    b1: float = 0.9,
    b2: float = 0.95,
    clip_grad: Optional[float] = None,
    layer_decay: Optional[float] = None,
    depth: Optional[int] = None,
    no_decay_names: tuple[str, ...] = (),
    lars_momentum: float = LARS_MOMENTUM,
    lars_trust_coefficient: float = LARS_TRUST_COEFFICIENT,
    frozen_mask: Optional[Params] = None,
    mu_dtype: Optional[str] = None,
    nu_dtype: Optional[str] = None,
    zero1: bool = False,
) -> AdamW | Lars | Sgd:
    """The JAX ``build_optimizer``: optional global-norm clipping, then
    ``optimizer`` ("adamw": AdamW, eps 1e-8, with :func:`wd_mask` minus
    ``no_decay_names``; "lars": :class:`Lars`; "sgd": :class:`Sgd`), then
    :func:`layer_decay_scales` when ``layer_decay`` is set and not 1 (it
    needs ``depth``), all over the leaves ``frozen_mask`` (a tree of bools
    like ``params``, True = trainable; every leaf without it) marks: the
    linear probe's freeze-all-but-head (main_linprobe.py:521-525).
    ``mu_dtype`` / ``nu_dtype`` (a float dtype's name: "float32",
    "bfloat16") store AdamW's moments; LARS and SGD ignore them, as the JAX
    package does. ``zero1`` splits AdamW's moments over the data group
    (the params' ``parallel/mesh`` tags say how)."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    dtypes = {name: _float_dtype(name, value)
              for name, value in (("mu_dtype", mu_dtype), ("nu_dtype", nu_dtype))}
    n = len(tree_leaves(params))
    trainable = ([True] * n if frozen_mask is None
                 else [bool(t) for t in tree_leaves(frozen_mask)])
    scales = None
    if layer_decay is not None and layer_decay != 1.0:
        if depth is None:
            raise ValueError("layer_decay needs the model's depth")
        scales = layer_decay_scales(params, layer_decay, depth)
    if optimizer == "lars":
        tx = Lars(schedule, trainable, weight_decay=weight_decay, momentum=lars_momentum,
                  trust_coefficient=lars_trust_coefficient, clip_grad=clip_grad,
                  scales=scales)
    elif optimizer == "sgd":
        tx = Sgd(schedule, trainable, clip_grad=clip_grad, scales=scales)
    else:
        tx = AdamW(schedule, wd_mask(params, no_decay_names), b1=b1, b2=b2, eps=1e-8,
                   weight_decay=weight_decay, clip_grad=clip_grad, scales=scales,
                   trainable=trainable, zero1=zero1, **dtypes)
    tx.masked = frozen_mask is not None
    return tx
