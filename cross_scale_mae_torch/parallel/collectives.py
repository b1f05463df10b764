"""Collectives with gradients, over the mesh's groups (``parallel/dist.py``).

The global batch (the ``gspmd`` semantics, the JAX package's jit over a
batch-sharded array), over the data group: NT-Xent's negatives
(``models/mae.py:369-374`` of the JAX package), the BatchNorm statistics of
the predictor and of the probe's head, the [0, 1] rescale's min and max of
the SSIM losses (:func:`global_min`, :func:`global_max`). Without
gradients: the rows a rank's samples mix with under Mixup/CutMix
(:func:`mirror_rank_rows`).

Every rank computes the same global term from the gathered rows or the
summed statistics; the step then averages the gradients over the data
group. So a gathered or summed tensor's backward sums its gradient over the
ranks first: the average of dp such gradients is d(global loss)/d(params).
A backward that only took this rank's slice would come out dp times too
small on those paths.

Tensor parallelism (Megatron's f and g, over the model group):
:func:`copy_to_model` before a column-parallel product (identity forward,
the gradient summed over the model group), :func:`reduce_from_model` after
a row-parallel one (the partial products summed forward, identity
backward). :func:`gather_heads` hands an attention that mixes every
head's features (Fourier mixing) the whole of q: an all-gather of the
head groups, a reduce-scatter backward. Sequence parallelism replaces f
and g at a block's joins by :func:`gather_seq` (all-gather of the token
chunks, reduce-scatter backward) and :func:`reduce_scatter_seq`
(reduce-scatter forward, all-gather backward); :func:`split_seq` and
:func:`gather_seq_full` enter and leave the token-sharded region. The token axis is padded to a multiple
of tp for the collective and the pad dropped after it: a pad row's
gradient is zero, so no pad row enters a reduction.

FSDP (:func:`fsdp_gathered`): the leaves a layout shards over the data
group are all-gathered just before the block (or the model's top level)
that uses them, in the dtype of their use, and their gradient is
reduce-scattered. The gathered tensors are not kept for the backward:
autograd saves a token in their place (``saved_tensors_hooks``) and the
backward gathers again. :data:`FSDP_GATHERS` counts the gathers of each
pass.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.distributed as dist

from cross_scale_mae_torch.parallel.dist import data_group, mesh, model_group


def group_size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def group_rank(group) -> int:
    return dist.get_rank(group) if group is not None else 0


# all_gather_into_tensor's newer name, where the installed torch has it.
_ALL_GATHER_FLAT = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def gather_parts(xs: list[torch.Tensor], group) -> list[list[torch.Tensor]]:
    """Every rank's ``xs`` (one dtype; the same shapes on every rank of
    ``group``) through one all-gather of a flat buffer: ``out[i][r]`` is
    rank r's ``xs[i]``, a view of the gathered buffer."""
    n = group_size(group)
    flat = torch.cat([x.reshape(-1) for x in xs]) if len(xs) > 1 else xs[0].reshape(-1)
    out = flat.new_empty(n * flat.numel())
    _ALL_GATHER_FLAT(out, flat.contiguous(), group=group)
    rows = out.view(n, -1).split([x.numel() for x in xs], dim=1)
    return [[row[r].view(x.shape) for r in range(n)] for row, x in zip(rows, xs)]


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x``s (one shape), concatenated on ``dim`` in group order."""
    return torch.cat(gather_parts([x], group)[0], dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/size chunk on ``dim`` of the group's sum of ``x``."""
    n = group_size(group)
    if dist.get_backend(group) == "nccl":
        lead = x.movedim(dim, 0).contiguous()
        out = lead.new_empty((lead.shape[0] // n,) + lead.shape[1:])
        dist.reduce_scatter_tensor(out, lead, group=group)
        return out.movedim(0, dim)
    total = x.contiguous().clone()
    dist.all_reduce(total, group=group)
    return total.chunk(n, dim)[group_rank(group)].contiguous()


class _AllGatherRows(torch.autograd.Function):
    """Over the data group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        group = data_group()
        ctx.group, ctx.rank, ctx.rows = group, group_rank(group), x.shape[0]
        return _all_gather(x, 0, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``x`` (the same row count on each),
    concatenated in rank order; the backward sums the gradient over those
    ranks and takes this rank's rows."""
    return x if data_group() is None else _AllGatherRows.apply(x)


def all_reduce_sum(x: torch.Tensor, group: Any = "data") -> torch.Tensor:
    """The sum of ``x`` over ``group`` (the data group by default:
    SyncBatchNorm's statistics); the backward sums the gradient over it."""
    group = data_group() if group == "data" else group
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


class _GlobalExtreme(torch.autograd.Function):
    """The data group's max (or min) of every element of ``x``, with JAX's
    gradient of ``max``: the cotangent, summed over the group, split evenly
    among the elements equal to the extreme on every rank."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, largest: bool, group) -> torch.Tensor:
        v = (x.max() if largest else x.min()).clone()
        dist.all_reduce(v, op=dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN,
                        group=group)
        ctx.save_for_backward(x, v)
        ctx.group = group
        return v

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, v = ctx.saved_tensors
        ties = x == v
        both = torch.stack([g.to(torch.float32), ties.sum().to(torch.float32)])
        dist.all_reduce(both, group=ctx.group)
        return (ties.to(x.dtype) * (both[0] / both[1]).to(x.dtype)), None, None


def global_max(x: torch.Tensor) -> torch.Tensor:
    """max over every element on every data rank (the global batch's)."""
    group = data_group()
    return x.max() if group is None else _GlobalExtreme.apply(x, True, group)


def global_min(x: torch.Tensor) -> torch.Tensor:
    """min over every element on every data rank (the global batch's)."""
    group = data_group()
    return x.min() if group is None else _GlobalExtreme.apply(x, False, group)


# ------------------------------------------------ tensor parallelism (f, g)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: ``x`` forward; its gradient summed over the model
    group (each rank's graph holds only its heads' or columns' share). Also
    wraps a replicated parameter that meets sharded activations (the
    predictor's BatchNorm affine under TP; the norms and the row-parallel
    biases under SP)."""
    group = model_group()
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: the model group's sum of the partial products."""
    group = model_group()
    return x if group is None else _ReduceFromModel.apply(x, group)


class _GatherHeads(torch.autograd.Function):
    """Head groups (N, L, H/tp, hd) -> (N, L, H, hd) in rank order; the
    backward sums the ranks' gradients of the whole and keeps this rank's
    heads (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, q, group):
        ctx.group = group
        return _all_gather(q, 2, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, 2, ctx.group), None


def gather_heads(q: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Every model rank's heads of ``q`` (N, L, H/tp, hd), concatenated in
    rank order into the ``num_heads`` of the whole; the identity without a
    model group, where a q of fewer heads is a fault."""
    group = model_group()
    if group is None:
        if q.shape[2] != num_heads:
            raise RuntimeError(f"a q of {q.shape[2]} of {num_heads} heads and no model "
                               "group to gather the rest from")
        return q
    return _GatherHeads.apply(q, group)


# ------------------------------------------------ sequence parallelism


def _pad_tokens(x: torch.Tensor, tp: int) -> torch.Tensor:
    pad = -x.shape[1] % tp
    return x if pad == 0 else torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)


class _GatherSeq(torch.autograd.Function):
    """Token chunks (N, Lp/tp, D) -> the whole (N, L, D), the pad dropped;
    the backward reduce-scatters (``summed``) or takes this rank's chunk."""

    @staticmethod
    def forward(ctx, x, seq_len, summed, group):
        ctx.seq_len, ctx.summed, ctx.group = seq_len, summed, group
        return _all_gather(x, 1, group)[:, :seq_len]

    @staticmethod
    def backward(ctx, g):
        g = _pad_tokens(g, group_size(ctx.group))
        if ctx.summed:
            return _reduce_scatter(g, 1, ctx.group), None, None, None
        return g.chunk(group_size(ctx.group), 1)[group_rank(ctx.group)], None, None, None


class _ScatterSeq(torch.autograd.Function):
    """The whole (N, L, D) -> this rank's chunk of the padded tokens, of
    the model group's sum (``summed``) or of ``x`` itself; the backward
    all-gathers and drops the pad."""

    @staticmethod
    def forward(ctx, x, summed, group):
        ctx.seq_len, ctx.group = x.shape[1], group
        x = _pad_tokens(x, group_size(group))
        if summed:
            return _reduce_scatter(x, 1, group)
        return x.chunk(group_size(group), 1)[group_rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.group)[:, :ctx.seq_len], None, None


def gather_seq(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """SP's all-gather before qkv and fc1 (f merged in: the backward
    reduce-scatters the gradient)."""
    group = model_group()
    return x[:, :seq_len] if group is None else _GatherSeq.apply(x, seq_len, True, group)


def reduce_scatter_seq(x: torch.Tensor) -> torch.Tensor:
    """SP's reduce-scatter after proj and fc2 (g's place)."""
    group = model_group()
    return x if group is None else _ScatterSeq.apply(x, True, group)


def split_seq(x: torch.Tensor) -> torch.Tensor:
    """Enter the token-sharded region: this rank's chunk of a replicated
    (N, L, D)."""
    group = model_group()
    return x if group is None else _ScatterSeq.apply(x, False, group)


def gather_seq_full(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Leave it: the whole (N, L, D) on every model rank."""
    group = model_group()
    return x[:, :seq_len] if group is None else _GatherSeq.apply(x, seq_len, False, group)


# ------------------------------------------------ FSDP


FSDP_GATHERS = {"forward": 0, "backward": 0}
_GATHERED: dict[int, tuple] = {}   # storage address -> (shard, data axis, dtype)


def _gather_shard(shard: torch.Tensor, axis: int, dtype: torch.dtype) -> torch.Tensor:
    return _all_gather(shard.detach().to(dtype), axis, data_group())


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, axis, dtype):
        ctx.axis, ctx.dtype = axis, shard.dtype
        return _gather_shard(shard, axis, dtype)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.to(ctx.dtype), ctx.axis, data_group()), None, None


def _pack(t: torch.Tensor):
    try:
        entry = _GATHERED.get(t.untyped_storage().data_ptr())
    except RuntimeError:
        entry = None
    if entry is None:
        return t
    return (entry, tuple(t.size()), tuple(t.stride()), t.storage_offset())


def _unpack(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    (shard, axis, dtype), size, stride, offset = packed
    FSDP_GATHERS["backward"] += 1
    return _gather_shard(shard, axis, dtype).as_strided(size, stride, offset)


def _use_dtype(path: tuple, leaf: torch.Tensor, compute: torch.dtype) -> torch.dtype:
    """A linear's kernel and bias are used in the compute dtype; anything
    else (norms, tokens, tables) in its own."""
    parent = str(path[-2]) if len(path) > 1 else ""
    if path[-1] == "kernel" or (path[-1] == "bias" and "norm" not in parent
                                and parent != "bn"):
        return compute
    return leaf.dtype


@contextlib.contextmanager
def fsdp_gathered(tree: Any, compute_dtype: torch.dtype):
    """``tree`` with each leaf sharded over the data group (a layout's
    ``data_axis``; ``parallel/mesh.spec_of``) replaced by its all-gathered
    whole, in the dtype of its use; block stacks (lists) are left to their
    blocks. A tree with no such leaf comes back as it is. Under autograd
    the wholes are not saved for the backward, which gathers them again."""
    from cross_scale_mae_torch.parallel.mesh import spec_of

    found: list = []

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, (*path, k)) for k, v in node.items()}
        if isinstance(node, list):
            return node
        spec = spec_of(node) if isinstance(node, torch.Tensor) else None
        if spec is None or spec.data_axis is None:
            return node
        dtype = _use_dtype(path, node, compute_dtype)
        full = (_FsdpGather.apply(node, spec.data_axis, dtype) if torch.is_grad_enabled()
                else _gather_shard(node, spec.data_axis, dtype))
        found.append((full, (node, spec.data_axis, dtype)))
        return full

    out = build(tree, ())
    if not found:
        yield tree
        return
    FSDP_GATHERS["forward"] += 1
    keys = [full.untyped_storage().data_ptr() for full, _ in found]
    _GATHERED.update({k: entry for k, (_, entry) in zip(keys, found)})
    try:
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
            yield out
    finally:
        for k in keys:
            _GATHERED.pop(k, None)


def mirror_rank_rows(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The same tensors of data rank dp-1-d (this rank's data index d; same
    shapes and dtypes on every rank), at this rank's model index: each rank
    sends its own to the mirror rank and receives that rank's. An identity
    without a process group, at dp 1 and for the middle rank of an odd dp.
    No gradient flows through it.

    Mixup mixes global row i with row N-1-i (the reversed global batch).
    Data rank d holds rows d::dp, so its row j (global j dp + d) mixes with
    global (N/dp-1-j) dp + (dp-1-d): row N/dp-1-j of data rank dp-1-d, that
    rank's rows reversed."""
    if not dist.is_available() or not dist.is_initialized():
        return tensors
    mh = mesh()
    peer_d = mh.dp - 1 - mh.d
    if peer_d == mh.d:
        return tensors
    peer = peer_d * mh.tp + mh.m
    sent = [t.detach().contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in sent]
    ops = ([dist.P2POp(dist.isend, t, peer) for t in sent]
           + [dist.P2POp(dist.irecv, t, peer) for t in got])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got

