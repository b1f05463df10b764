"""Collectives with gradients, for the losses that see the global batch
in the ``gspmd`` semantics (the JAX package's jit over a batch-sharded
array): NT-Xent's negatives (``models/mae.py:369-374`` of the JAX package)
and the BatchNorm statistics of the predictor and of the probe's head.

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
