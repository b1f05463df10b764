"""Collectives for the global-batch (``gspmd``) semantics, the JAX
package's jit over a batch-sharded array. With gradients: NT-Xent's
negatives (``models/mae.py:369-374`` of the JAX package) and the BatchNorm
statistics of the predictor and of the probe's head. Without: the rows a
rank's samples mix with under Mixup/CutMix (:func:`mirror_rank_rows`).

Every rank computes the same global term from the gathered rows or the
summed statistics; the step then averages the gradients over the ranks.
So a gathered or summed tensor's backward sums its gradient over the ranks
first: the average of W such gradients is d(global loss)/d(params). A
backward that only took this rank's slice would come out W times too small
on those paths.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rank, ctx.rows = dist.get_rank(), x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` (the same row count on each), concatenated
    in rank order; the backward sums the gradient over the ranks and takes
    this rank's rows."""
    return _AllGatherRows.apply(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (SyncBatchNorm's statistics); the
    backward sums the gradient over the ranks."""
    return _AllReduceSum.apply(x)


def mirror_rank_rows(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The same tensors of rank W-1-r (this rank r; same shapes and dtypes
    on every rank): each rank sends its own to the mirror rank and receives
    that rank's. An identity without a process group, at world size 1 and
    for the middle rank of an odd world. No gradient flows through it.

    Mixup mixes global row i with row N-1-i (the reversed global batch).
    Rank r holds rows r::W, so its row j (global jW + r) mixes with global
    (N/W-1-j)W + (W-1-r): row N/W-1-j of rank W-1-r, that rank's rows
    reversed."""
    if not dist.is_available() or not dist.is_initialized():
        return tensors
    rank, world = dist.get_rank(), dist.get_world_size()
    peer = world - 1 - rank
    if peer == rank:
        return tensors
    sent = [t.detach().contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in sent]
    ops = ([dist.P2POp(dist.isend, t, peer) for t in sent]
           + [dist.P2POp(dist.irecv, t, peer) for t in got])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got
