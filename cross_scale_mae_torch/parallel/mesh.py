"""The mesh's layouts and the data axis's reductions (counterpart of
``cross_scale_mae_tpu/parallel/mesh.py``).

The JAX package lets XLA insert the gradient all-reduce where replicated
params meet a batch sharded over the mesh; here the step calls it: every
parameter starts from rank 0's values (:func:`broadcast_params`), and the
gradients are averaged over the data group once per step after the last
microbatch (:class:`FlatGrads`): they are copied into one persistent flat
buffer per dtype, which one all-reduce averages in place, and the optimizer
reads them there. The metrics, the BatchNorm state and the eval's counts,
small tensors, go through a buffer made for the call and are copied back.

Beyond the data axis, a :class:`Layout` says what each rank holds of each
leaf (:func:`leaf_specs`, the JAX package's ``param_shardings`` and
``_zero1_spec``):

* tensor parallelism (``tp`` > 1, Megatron's split, ``_spec_for``): qkv and
  fc1 split by output columns, proj and fc2 by input rows, the qkv and fc1
  biases with their columns; every other leaf replicated. A qkv leaf is
  split by head groups: rank m holds columns [t D + m D/tp, t D + (m+1)
  D/tp) of each third t (q, k, v), so that the attention kernels run
  unchanged on each rank's H/tp heads (the JAX split is a contiguous slice
  of the 3D columns: the same function, reached through XLA);
* FSDP (``fsdp``): a leaf of more than 1024 elements (counted as the JAX
  package's stacked leaf: every layer of its block stack) split over the
  data group on its largest axis divisible by dp and not taken by TP; the
  optimizer's moments follow the params;
* ZeRO-1 (``zero1``): the params stay whole, Adam's moments of such a leaf
  are split over the data group on that axis (``train/optim.py``).

:func:`shard_params` takes whole leaves (the seeded init on every rank, a
JAX tree, a checkpoint) to this rank's parts and tags each with its
:class:`LeafSpec`; :func:`full_leaf` gathers one back (a collective every
rank of the groups calls), and :func:`local_part` / :func:`join_parts` do
the same on the host without a group.

Every function here runs its collectives whenever a process group exists,
at world size 1 too, and does nothing without one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from cross_scale_mae_torch.parallel.collectives import gather_parts
from cross_scale_mae_torch.parallel.dist import data_group, mesh, model_group
from cross_scale_mae_torch.train.state import tree_items, tree_leaves, tree_like

# Leaves of at most this many elements stay replicated under FSDP and ZeRO-1.
SMALL_LEAF = 1024
_COL_PARALLEL = ("qkv", "fc1")   # split output features
_ROW_PARALLEL = ("proj", "fc2")  # split input features
_SPEC = "_csmae_spec"


@dataclasses.dataclass(frozen=True)
class Layout:
    """What the run shards: tp model ranks by dp data ranks, FSDP's params
    or ZeRO-1's moments over the data group."""

    dp: int = 1
    tp: int = 1
    zero1: bool = False
    fsdp: bool = False

    def __post_init__(self):
        if self.fsdp and self.zero1:
            raise ValueError("--fsdp already shards optimizer moments with the params "
                             "(ZeRO-3 subsumes ZeRO-1); drop --zero1")

    @property
    def trivial(self) -> bool:
        return self.tp == 1 and (self.dp == 1 or not (self.fsdp or self.zero1))


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One leaf's layout: its whole shape, the axis split over the model
    group (``qkv``: by head groups of each third), the axis split over the
    data group (FSDP), and the axis its moments split over the data group
    (ZeRO-1)."""

    full: tuple
    model_axis: Optional[int] = None
    qkv: bool = False
    data_axis: Optional[int] = None
    zero1_axis: Optional[int] = None


def spec_of(t: Any) -> Optional[LeafSpec]:
    return getattr(t, _SPEC, None)


def tag(t: torch.Tensor, spec: Optional[LeafSpec]) -> torch.Tensor:
    if spec is not None:
        setattr(t, _SPEC, spec)
    return t


def _largest_divisible_axis(shape: tuple, n: int, taken=()) -> Optional[int]:
    """Largest axis divisible by ``n`` and not already sharded; None if no
    axis qualifies (the JAX package's rule)."""
    best = None
    for axis, dim in enumerate(shape):
        if axis in taken:
            continue
        if dim % n == 0 and dim >= n and (best is None or dim > shape[best]):
            best = axis
    return best


def model_split(path: tuple) -> Optional[int]:
    """The Megatron split's axis of a leaf (``_spec_for``, by its parent's
    name: every qkv/fc1/proj/fc2 of the tree, the predictors' too)."""
    parent = str(path[-2]) if len(path) >= 2 else ""
    if path[-1] == "kernel" and parent in _COL_PARALLEL:
        return 1
    if path[-1] == "kernel" and parent in _ROW_PARALLEL:
        return 0
    if path[-1] == "bias" and parent in _COL_PARALLEL:
        return 0
    return None


def leaf_specs(params: Any, layout: Layout) -> list[Optional[LeafSpec]]:
    """Each leaf's :class:`LeafSpec` under ``layout``, in ``tree_leaves``
    order, from the whole leaves of ``params``; None for a leaf every rank
    holds whole."""
    specs = []
    for path, leaf in tree_items(params):
        full = tuple(leaf.shape)
        top = params[path[0]] if isinstance(params, dict) else params
        stacked = leaf.numel() * (len(top) if isinstance(top, list) else 1)
        ma = model_split(path) if layout.tp > 1 else None
        big = layout.dp > 1 and stacked > SMALL_LEAF
        axis = _largest_divisible_axis(full, layout.dp, {ma}) if big else None
        da = axis if layout.fsdp else None
        za = axis if layout.zero1 else None
        spec = LeafSpec(full, ma, path[-2] == "qkv" if ma is not None else False, da, za)
        specs.append(None if (ma, da, za) == (None, None, None) else spec)
    return specs


def _take_model(t: torch.Tensor, spec: LeafSpec, tp: int, m: int) -> torch.Tensor:
    axis = spec.model_axis
    if spec.qkv:
        return torch.cat([third.chunk(tp, axis)[m] for third in t.chunk(3, axis)], axis)
    return t.chunk(tp, axis)[m]


def _join_model(parts: list[torch.Tensor], spec: LeafSpec) -> torch.Tensor:
    axis = spec.model_axis
    if spec.qkv:
        thirds = [p.chunk(3, axis) for p in parts]
        return torch.cat([torch.cat([p[t] for p in thirds], axis) for t in range(3)], axis)
    return torch.cat(parts, axis)


def moment_spec(spec: Optional[LeafSpec], zero1: bool) -> Optional[LeafSpec]:
    """The layout of an optimizer moment of a leaf of ``spec``: the
    param's, or under ZeRO-1 split over the data group on its ZeRO-1 axis."""
    if spec is None or not zero1:
        return spec
    return dataclasses.replace(spec, data_axis=spec.zero1_axis)


def local_part(full: torch.Tensor, spec: Optional[LeafSpec], d: int, m: int, dp: int,
               tp: int) -> torch.Tensor:
    """Rank (d, m)'s part of a whole leaf, a contiguous copy; the leaf
    itself when not split."""
    if spec is None:
        return full
    t = full
    if spec.model_axis is not None:
        t = _take_model(t, spec, tp, m)
    if spec.data_axis is not None:
        t = t.chunk(dp, spec.data_axis)[d]
    return t.contiguous()


def join_parts(parts: list[list[torch.Tensor]], spec: Optional[LeafSpec]) -> torch.Tensor:
    """The whole leaf from every rank's part, ``parts[d][m]``."""
    if spec is None:
        return parts[0][0]
    axis = spec.data_axis
    cols = [torch.cat([parts[d][m] for d in range(len(parts))], axis) if axis is not None
            else parts[0][m] for m in range(len(parts[0]))]
    return _join_model(cols, spec) if spec.model_axis is not None else cols[0]


def this_part(full: torch.Tensor, spec: Optional[LeafSpec]) -> torch.Tensor:
    """This rank's part of a whole leaf of ``spec``."""
    mh = mesh()
    return local_part(full, spec, mh.d, mh.m, mh.dp, mh.tp)


def full_leaf(t: torch.Tensor) -> torch.Tensor:
    """The whole of a tagged leaf, gathered over the groups that split it
    (every rank of them calls this); an untagged leaf as it is."""
    spec = spec_of(t)
    if spec is None:
        return t
    axis = spec.data_axis
    out = t.detach()
    if axis is not None and data_group() is not None:
        out = torch.cat(gather_parts([out], data_group())[0], axis)
    if spec.model_axis is not None and model_group() is not None:
        out = _join_model(gather_parts([out], model_group())[0], spec)
    return out


def full_params(tree: Any) -> Any:
    """``tree`` with every tagged leaf gathered whole (the npz, the
    reconstruction figures): a tree of tensors without autograd."""
    return tree_like(tree, [full_leaf(t).detach() for t in tree_leaves(tree)])


def shard_params(params: Any, layout: Layout) -> Any:
    """This rank's parts of the whole ``params`` under ``layout``, each
    tagged with its :class:`LeafSpec` (every leaf under a non-trivial
    layout). ``params`` as it is for a trivial layout."""
    if layout.trivial:
        return params
    mh = mesh()
    specs = leaf_specs(params, layout)
    parts = [tag(local_part(t.detach(), s, mh.d, mh.m, layout.dp, layout.tp).clone(), s)
             for t, s in zip(tree_leaves(params), specs)]
    return tree_like(params, parts)


def _categories(specs: list) -> list[tuple[bool, bool]]:
    """(split over the data group, split over the model group) per leaf."""
    return [(s is not None and s.data_axis is not None,
             s is not None and s.model_axis is not None) for s in specs]


def reduce_leaf_squares(squares: torch.Tensor, specs: list) -> torch.Tensor:
    """Per-leaf sums of squares (a vector) of this rank's parts -> those of
    the whole leaves: a leaf split over a group summed over it, a
    replicated one counted once."""
    cats = _categories(specs)
    out = squares
    for cat, group in (((True, False), data_group()), ((False, True), model_group()),
                       ((True, True), dist.group.WORLD if dist.is_initialized() else None)):
        mask = [c == cat for c in cats]
        if group is None or not any(mask):
            continue
        sel = torch.tensor(mask, device=squares.device)
        part = torch.where(sel, squares, torch.zeros_like(squares))
        dist.all_reduce(part, group=group)
        out = torch.where(sel, part, out)
    return out


def is_split(specs: list) -> bool:
    return any(s is not None and (s.data_axis is not None or s.model_axis is not None)
               for s in specs)


class FlatGrads:
    """One flat buffer per dtype and device, made for gradients of the
    shapes of ``like``. :meth:`all_reduce` copies the gradients in (one
    multi-tensor copy), averages each buffer over the data group in place
    (DDP's gradient all-reduce; the JAX shard_map step's ``pmean``) and
    returns the averages as views of the buffers, so no gradient is copied
    back. The gradients must have ``like``'s shapes (the copy raises
    otherwise)."""

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

    def all_reduce(self, grads: list[torch.Tensor], op=dist.ReduceOp.AVG, group: Any = "data"
                   ) -> list[torch.Tensor]:
        torch._foreach_copy_(self.views, grads)
        for flat in self.buffers:
            dist.all_reduce(flat, op=op, group=data_group() if group == "data" else group)
        return list(self.views)


def average_gradients(flat: Optional[FlatGrads], grads: list[torch.Tensor],
                      specs: list) -> tuple[FlatGrads, list[torch.Tensor]]:
    """The gradients averaged over the data group: FSDP's shards (already
    summed over it by their reduce-scatter) divided by dp, every other one
    through ``flat`` (made on the first call). Returns (flat, averages)."""
    sharded = [s is not None and s.data_axis is not None for s in specs]
    rest = [g for g, sh in zip(grads, sharded) if not sh]
    if flat is None:
        flat = FlatGrads(rest)
    averaged = iter(flat.all_reduce(rest) if rest else [])
    dp = mesh().dp
    out = [g.div_(dp) if sh else next(averaged) for g, sh in zip(grads, sharded)]
    return flat, out


def _all_reduce_(tensors: list[torch.Tensor], op, group: Any = "data") -> None:
    """All-reduce ``tensors`` over ``group`` in place through a buffer made
    for them."""
    if dist.is_initialized() and tensors:
        torch._foreach_copy_(tensors, FlatGrads(tensors).all_reduce(tensors, op, group))


def all_reduce_mean(tree: Any, world: bool = False) -> None:
    """Average every tensor of ``tree`` over the data group (``world``:
    over every rank, so that a stop request reaches the model ranks too),
    in place: the step's metrics, and the BatchNorm running state of the
    shard_map semantics. A metric is the same on the ranks of a model
    group, so either mean is the data ranks' mean."""
    _all_reduce_(tree_leaves(tree), dist.ReduceOp.AVG, None if world else "data")


def all_reduce_total(tree: Any) -> None:
    """Sum every tensor of ``tree`` over the data group, in place: the
    eval's counts and confusion matrix."""
    _all_reduce_(tree_leaves(tree), dist.ReduceOp.SUM)


def broadcast_params(tree: Any) -> None:
    """Rank 0's values of every tensor of ``tree`` on every rank, in place
    (after the seeded init, and after an npz load; before sharding)."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for t in tree_leaves(tree):
            dist.broadcast(t, src=0)
