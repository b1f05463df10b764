"""AdamW with the JAX package's weight-decay mask (counterpart of
``cross_scale_mae_tpu/train/optim.py``).

The update is optax's ``adamw`` (plus ``clip_by_global_norm`` when asked),
step for step: with t the number of updates already applied,

    m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2
    p <- p - lr(t) * (m / (1 - b1^(t+1)) / (sqrt(v / (1 - b2^(t+1))) + eps)
                      + wd * mask * p)

so the first update uses ``schedule(0)``. It runs as PyTorch multi-tensor
(``torch._foreach_*``) ops over every parameter at once.

Not ported yet (ROADMAP.md queue 1 item 12): LARS, SGD, layer-wise lr decay,
frozen masks and the bf16 moment dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from cross_scale_mae_torch.train.state import global_norm, tree_items, tree_leaves

Params = dict[str, Any]


def wd_mask(params: Params) -> list[bool]:
    """True = apply weight decay, per leaf in ``tree_leaves`` order, by name:
    linear ``kernel``s and the ``cls_token``, ``mask_token`` and
    ``pos_embed`` leaves decay; biases, norm scales and BatchNorm params do
    not (the pretrain rule of the JAX ``wd_mask``; its finetune exclusions
    come with ROADMAP.md queue 1 item 12)."""
    return [path[-1] in ("kernel", "cls_token", "mask_token", "pos_embed")
            for path, _ in tree_items(params)]


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


class AdamW:
    """optax ``adamw`` (eps inside the square root's sum: 0) over a list of
    fp32 leaves, updating them in place."""

    def __init__(self, schedule: Callable[[int], float], decay: list[bool], *,
                 b1: float, b2: float, eps: float, weight_decay: float,
                 clip_grad: Optional[float]):
        self.schedule, self.decay = schedule, decay
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.clip_grad = clip_grad

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
        torch._foreach_add_(params, upd, alpha=-lr)
        state.count = t


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
    mu_dtype: Optional[str] = None,
    nu_dtype: Optional[str] = None,
) -> AdamW:
    """The pretrain update rule: AdamW (eps 1e-8) with :func:`wd_mask`,
    after optional global-norm clipping."""
    if optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (the port runs "
            "'adamw'); see ROADMAP.md (queue 1 item 12)")
    if layer_decay is not None and layer_decay != 1.0:
        raise NotImplementedError(
            "layer-wise lr decay is not ported yet; see ROADMAP.md (queue 1 item 12)")
    if mu_dtype is not None or nu_dtype is not None:
        raise NotImplementedError(
            "Adam moment dtypes are not ported yet (the port keeps fp32 "
            "moments); see ROADMAP.md (queue 1 item 7)")
    return AdamW(schedule, wd_mask(params), b1=b1, b2=b2, eps=1e-8,
                 weight_decay=weight_decay, clip_grad=clip_grad)
