"""The data axis: what data-parallel training reduces over the ranks
(counterpart of ``cross_scale_mae_tpu/parallel/mesh.py``'s ``data`` axis).

The JAX package lets XLA insert the gradient all-reduce where replicated
params meet a batch sharded over the mesh; here the step calls it: every
parameter starts from rank 0's values (:func:`broadcast_params`), and the
gradients are averaged once per step after the last microbatch
(:class:`FlatGrads`): they are copied into one persistent flat buffer per
dtype, which one all-reduce averages in place, and the optimizer reads
them there; there is no per-step flatten and no copy back. The metrics,
the BatchNorm state and the eval's counts, small tensors, go through a
buffer made for the call and are copied back. The mesh's model axis (TP,
SP), ZeRO-1 and FSDP are not ported; their flags refuse (ROADMAP.md, queue
1 item 11).

Every function here runs its collectives whenever a process group exists,
at world size 1 too, and does nothing without one.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from cross_scale_mae_torch.train.state import tree_leaves


class FlatGrads:
    """One flat buffer per dtype and device, made for gradients of the
    shapes of ``like``. :meth:`all_reduce` copies the gradients in (one
    multi-tensor copy), averages each buffer over the ranks in place (DDP's
    gradient all-reduce; the JAX shard_map step's ``pmean``) and returns the
    averages as views of the buffers, so no gradient is copied back. The
    gradients must have ``like``'s shapes (the copy raises otherwise)."""

    def __init__(self, like: list[torch.Tensor]):
        self.views: list[Optional[torch.Tensor]] = [None] * len(like)
        self.buffers: list[torch.Tensor] = []
        groups: dict[tuple, list[int]] = {}
        for i, g in enumerate(like):
            groups.setdefault((g.dtype, g.device), []).append(i)
        for (dtype, device), idx in groups.items():
            flat = torch.empty(sum(like[i].numel() for i in idx), dtype=dtype, device=device)
            for i, part in zip(idx, flat.split([like[i].numel() for i in idx])):
                self.views[i] = part.view_as(like[i])
            self.buffers.append(flat)

    def all_reduce(self, grads: list[torch.Tensor], op=dist.ReduceOp.AVG
                   ) -> list[torch.Tensor]:
        torch._foreach_copy_(self.views, grads)
        for flat in self.buffers:
            dist.all_reduce(flat, op=op)
        return list(self.views)


def _all_reduce_(tensors: list[torch.Tensor], op) -> None:
    """All-reduce ``tensors`` in place through a buffer made for them."""
    if dist.is_initialized() and tensors:
        torch._foreach_copy_(tensors, FlatGrads(tensors).all_reduce(tensors, op))


def all_reduce_mean(tree: Any) -> None:
    """Average every tensor of ``tree`` over the ranks, in place: the
    step's metrics, and the BatchNorm running state of the shard_map
    semantics."""
    _all_reduce_(tree_leaves(tree), dist.ReduceOp.AVG)


def all_reduce_total(tree: Any) -> None:
    """Sum every tensor of ``tree`` over the ranks, in place: the eval's
    counts and confusion matrix."""
    _all_reduce_(tree_leaves(tree), dist.ReduceOp.SUM)


def broadcast_params(tree: Any) -> None:
    """Rank 0's values of every tensor of ``tree`` on every rank, in place
    (after the seeded init, and after an npz load)."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for t in tree_leaves(tree):
            dist.broadcast(t, src=0)
