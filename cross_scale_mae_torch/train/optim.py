"""AdamW with the JAX package's weight-decay mask and layer-wise lr decay,
and LARS with a frozen mask for the linear probe (counterpart of
``cross_scale_mae_tpu/train/optim.py``).

The update is optax's ``adamw`` (plus ``clip_by_global_norm`` when asked,
and the layer-decay scale chained after it), step for step: with t the
number of updates already applied and s the leaf's layer-decay scale (1
without layer decay),

    m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2
    p <- p - s * lr(t) * (m / (1 - b1^(t+1)) / (sqrt(v / (1 - b2^(t+1))) + eps)
                          + wd * mask * p)

so the first update uses ``schedule(0)``, and layer decay scales the whole
update, weight decay included. It runs as PyTorch multi-tensor
(``torch._foreach_*``) ops over every parameter at once.

LARS (:class:`Lars`) has MoCo-v3 semantics (util/lars.py:27-57), as the
JAX package's ``lars``; with ``frozen_mask`` only the trainable leaves
have momentum buffers and are touched (optax ``masked`` with
``set_to_zero`` on the complement).

Each optimizer's state goes to a flat path -> tensor dict and back in
place (``state_dict``, ``load_state_dict``): ``count``, and each moment
under the parameter's JAX path (``mu/<path>``, ``nu/<path>``), block
leaves stacked on a leading layer axis.

Not ported yet (ROADMAP.md): SGD, AdamW under a frozen mask (queue 1 item
12), the bf16 moment dtypes (item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

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


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


class AdamW:
    """optax ``adamw`` (eps inside the square root's sum: 0) over a list of
    fp32 leaves, updating them in place; ``scales`` (one per leaf) multiply
    each leaf's whole update, as the JAX package's layer-decay
    ``scale_by_tree`` chained after ``adamw`` does."""

    def __init__(self, schedule: Callable[[int], float], decay: list[bool], *,
                 b1: float, b2: float, eps: float, weight_decay: float,
                 clip_grad: Optional[float], scales: Optional[list[float]] = None):
        self.schedule, self.decay = schedule, decay
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.clip_grad, self.scales = clip_grad, scales

    def init(self, params: Params) -> AdamWState:
        leaves = tree_leaves(params)
        if len(leaves) != len(self.decay):
            raise ValueError(f"{len(leaves)} params but a decay mask of {len(self.decay)}")
        zeros = [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in leaves]
        return AdamWState(0, zeros, [torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: AdamWState) -> None:
        if self.clip_grad is not None:
            # optax.clip_by_global_norm: scale by max_norm / norm when above.
            factor = torch.clamp(self.clip_grad / global_norm(grads), max=1.0)
            grads = torch._foreach_mul(grads, factor)
        lr = self.schedule(state.count)
        t = state.count + 1
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(state.nu, 1 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(state.mu, 1 - self.b1 ** t)
        torch._foreach_div_(upd, denom)
        decayed = [i for i, d in enumerate(self.decay) if d]
        if self.wd and decayed:
            torch._foreach_add_([upd[i] for i in decayed], [params[i] for i in decayed],
                                alpha=self.wd)
        if self.scales is None:
            torch._foreach_add_(params, upd, alpha=-lr)
        else:
            # optax's order: -lr * u, then the layer scale, then p + u.
            torch._foreach_mul_(upd, -lr)
            torch._foreach_mul_(upd, self.scales)
            torch._foreach_add_(params, upd)
        state.count = t

    def state_dict(self, state: AdamWState, params: Params) -> dict[str, torch.Tensor]:
        return {"count": torch.tensor(state.count, dtype=torch.int64),
                **flat_state(tree_like(params, state.mu), "mu"),
                **flat_state(tree_like(params, state.nu), "nu")}

    def load_state_dict(self, state: AdamWState, flat: dict[str, torch.Tensor],
                        params: Params) -> set[str]:
        """Copy the moments into ``state``'s tensors and set its count;
        returns the keys read."""
        used = load_flat_state(tree_like(params, state.mu), "mu", flat)
        used |= load_flat_state(tree_like(params, state.nu), "nu", flat)
        state.count = int(flat["count"])
        return used | {"count"}


# MoCo-v3's LARS constants (util/lars.py:27-57), the JAX package's defaults.
LARS_MOMENTUM = 0.9
LARS_TRUST_COEFFICIENT = 0.001


@dataclasses.dataclass
class LarsState:
    count: int
    mu: list[torch.Tensor]   # one momentum buffer per trainable leaf


class Lars:
    """LARS with MoCo-v3 semantics over the leaves ``trainable`` marks
    (JAX ``lars`` under ``optax.masked``), updating them in place; with t the
    optimizer's own step count, per trainable leaf:

        dp = g + wd p,  dp <- dp * tc ||p|| / ||dp||   (leaves of more than 1 dim;
                                                       1 where a norm is 0)
        dp = g                                           (1-D leaves)
        mu <- momentum mu + dp,  p <- p - lr(t) mu

    The norms are taken over each of the port's leaves (the JAX package
    stacks the blocks, so its stacked leaves share one norm and count as
    more than 1-D; a linear probe trains only the head, where the two
    agree). Frozen leaves are never read or written, and their gradients
    may be None."""

    def __init__(self, schedule: Callable[[int], float], trainable: list[bool], *,
                 weight_decay: float):
        self.schedule, self.trainable, self.wd = schedule, trainable, weight_decay
        self.momentum, self.tc = LARS_MOMENTUM, LARS_TRUST_COEFFICIENT

    def init(self, params: Params) -> LarsState:
        leaves = tree_leaves(params)
        if len(leaves) != len(self.trainable):
            raise ValueError(f"{len(leaves)} params but a frozen mask of {len(self.trainable)}")
        return LarsState(0, [torch.zeros_like(p, memory_format=torch.contiguous_format)
                             for p, t in zip(leaves, self.trainable) if t])

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[Optional[torch.Tensor]],
               state: LarsState) -> None:
        idx = [i for i, t in enumerate(self.trainable) if t]
        ps = [params[i] for i in idx]
        # A trainable leaf the objective did not reach has a zero gradient.
        dps = [torch.zeros_like(params[i]) if grads[i] is None else grads[i] for i in idx]
        wide = [j for j, p in enumerate(ps) if p.dim() > 1]
        if wide:
            pw = [ps[j] for j in wide]
            dw = [dps[j] for j in wide]
            if self.wd:
                dw = torch._foreach_add(dw, pw, alpha=self.wd)
            p_norm = torch._foreach_norm(pw)
            u_norm = torch._foreach_norm(dw)
            trust = [torch.where((pn > 0) & (un > 0), self.tc * pn / un, torch.ones_like(pn))
                     for pn, un in zip(p_norm, u_norm)]
            dw = torch._foreach_mul(dw, trust)
            for j, d in zip(wide, dw):
                dps[j] = d
        lr = self.schedule(state.count)
        torch._foreach_mul_(state.mu, self.momentum)
        torch._foreach_add_(state.mu, dps)
        torch._foreach_add_(ps, state.mu, alpha=-lr)
        state.count += 1

    def _mu_tree(self, state: LarsState, params: Params) -> Any:
        """The momentum buffers as a tree like ``params``, None on frozen leaves."""
        mu = iter(state.mu)
        return tree_like(params, (next(mu) if t else None for t in self.trainable))

    def state_dict(self, state: LarsState, params: Params) -> dict[str, torch.Tensor]:
        return {"count": torch.tensor(state.count, dtype=torch.int64),
                **flat_state(self._mu_tree(state, params), "mu")}

    def load_state_dict(self, state: LarsState, flat: dict[str, torch.Tensor],
                        params: Params) -> set[str]:
        """Copy the trainable leaves' momentum into ``state``'s tensors and
        set its count; returns the keys read."""
        used = load_flat_state(self._mu_tree(state, params), "mu", flat)
        state.count = int(flat["count"])
        return used | {"count"}


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
    frozen_mask: Optional[Params] = None,
    mu_dtype: Optional[str] = None,
    nu_dtype: Optional[str] = None,
) -> AdamW | Lars:
    """``optimizer="adamw"``: AdamW (eps 1e-8) with :func:`wd_mask`
    (``no_decay_names`` excluded), after optional global-norm clipping, and
    with :func:`layer_decay_scales` when ``layer_decay`` is set and not 1
    (it needs ``depth``). ``optimizer="lars"``: :class:`Lars` over the
    leaves ``frozen_mask`` (a tree of bools like ``params``, True =
    trainable; every leaf without it) marks, the linear probe's
    freeze-all-but-head (main_linprobe.py:521-525)."""
    if optimizer == "lars":
        unported = {"clip_grad": clip_grad, "layer_decay": layer_decay,
                    "mu_dtype": mu_dtype, "nu_dtype": nu_dtype}
        for name, value in unported.items():
            if value is not None and not (name == "layer_decay" and value == 1.0):
                raise NotImplementedError(
                    f"LARS with {name} is not ported yet; see ROADMAP.md (queue 1 item 12)")
        n = len(tree_leaves(params))
        trainable = ([True] * n if frozen_mask is None
                     else [bool(t) for t in tree_leaves(frozen_mask)])
        return Lars(schedule, trainable, weight_decay=weight_decay)
    if optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (the port runs "
            "'adamw' and 'lars'); see ROADMAP.md (queue 1 item 12)")
    if frozen_mask is not None:
        raise NotImplementedError(
            "AdamW under a frozen mask is not ported yet (the linear probe runs "
            "LARS); see ROADMAP.md (queue 1 item 12)")
    scales = None
    if layer_decay is not None and layer_decay != 1.0:
        if depth is None:
            raise ValueError("layer_decay needs the model's depth")
        scales = layer_decay_scales(params, layer_decay, depth)
    if mu_dtype is not None or nu_dtype is not None:
        raise NotImplementedError(
            "Adam moment dtypes are not ported yet (the port keeps fp32 "
            "moments); see ROADMAP.md (queue 1 item 7)")
    return AdamW(schedule, wd_mask(params, no_decay_names), b1=b1, b2=b2, eps=1e-8,
                 weight_decay=weight_decay, clip_grad=clip_grad, scales=scales)
