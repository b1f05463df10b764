"""Train state and parameter-tree helpers (counterpart of
``cross_scale_mae_tpu/train/state.py``).

Params are the nested dict of ``models/mae.py::mae_init`` (block stacks as
lists) with leaf tensors that require grad. The state is updated in place
by the step, where the JAX package returns a new one, and a checkpoint
restores into it in place (:meth:`TrainState.load_state_dict`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, Iterator, Mapping

import torch

Params = dict[str, Any]


def tree_items(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict/list of tensors, dict keys in
    sorted order and list items by index: one fixed order per tree shape."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], (*prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, (*prefix, i))
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_like(tree: Any, leaves: Iterable[Any]) -> Any:
    """A tree of ``tree``'s shape whose leaves are ``leaves``, taken in
    :func:`tree_items` order (an optimizer's per-leaf state as a tree)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(tree)


def jax_paths(tree: Any, prefix: str = "") -> dict[str, Any]:
    """The leaves of ``tree`` under the JAX tree's '/'-joined paths: a leaf,
    or for a block stack (a list of layers) the list of its layers' leaves,
    which the JAX package stacks on a leading layer axis. None leaves (a
    frozen leaf's missing optimizer state) are left out."""
    if isinstance(tree, Mapping):
        out: dict[str, Any] = {}
        for k in sorted(tree):
            out.update(jax_paths(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for layer in tree:
            for k, v in jax_paths(layer, prefix).items():
                out.setdefault(k, []).append(v)
        return out
    return {} if tree is None else {prefix: tree}


def flat_state(tree: Any, prefix: str) -> dict[str, torch.Tensor]:
    """``tree`` as a flat dict in the JAX layout: '/'-joined paths under
    ``prefix``, each block stack's leaves stacked on a leading layer axis."""
    return {k: (torch.stack(v) if isinstance(v, list) else v).detach()
            for k, v in jax_paths(tree, prefix).items()}


@torch.no_grad()
def load_flat_state(tree: Any, prefix: str, flat: Mapping[str, torch.Tensor]) -> set[str]:
    """Copy :func:`flat_state`'s entries back into ``tree``'s tensors in
    place (a block stack's entry into its layers' leaves), so every holder
    of a leaf sees the restored values; returns the keys it read. A missing
    entry, a shape that does not fit or another dtype (``copy_`` would cast:
    bf16 Adam moments into an fp32 state) raises."""
    used = set()
    for key, dst in jax_paths(tree, prefix).items():
        if key not in flat:
            raise KeyError(f"the checkpoint lacks {key}")
        src, stacked = flat[key], isinstance(dst, list)
        layers = dst if stacked else [dst]
        want = (len(layers), *layers[0].shape) if stacked else tuple(dst.shape)
        if tuple(src.shape) != want:
            raise ValueError(f"{key}: shape {tuple(src.shape)} in the checkpoint, "
                             f"{want} in the run")
        if src.dtype != layers[0].dtype:
            raise ValueError(f"{key}: dtype {src.dtype} in the checkpoint, "
                             f"{layers[0].dtype} in the run")
        for d, s in zip(layers, src.unbind(0) if stacked else [src]):
            d.copy_(s)
        used.add(key)
    return used


def finite_loss(loss: torch.Tensor) -> float:
    """The loss as a float; raises FloatingPointError when it is not finite
    (the NaN abort of engine_pretrain.py:57-59)."""
    value = float(loss)
    if not math.isfinite(value):
        raise FloatingPointError(f"Loss is {value}, stopping training")
    return value


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d fp32 tensor."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    model_state: Params       # predictor BatchNorm statistics
    opt_state: Any
    tx: Any                   # train/optim.py AdamW

    @classmethod
    def create(cls, params: Params, model_state: Params, tx) -> "TrainState":
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        return cls(step=0, params=params, model_state=model_state,
                   opt_state=tx.init(params), tx=tx)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The whole state as one flat dict keyed by the JAX TrainState's
        '/'-joined paths (``params/...``, ``model_state/...``,
        ``opt_state/...``, ``step``), block leaves stacked on a leading
        layer axis, on the state's device."""
        out = {**flat_state(self.params, "params"),
               **flat_state(self.model_state, "model_state")}
        out.update({f"opt_state/{k}": v
                    for k, v in self.tx.state_dict(self.opt_state, self.params).items()})
        out["step"] = torch.tensor(self.step, dtype=torch.int64)
        return out

    @torch.no_grad()
    def load_state_dict(self, flat: Mapping[str, torch.Tensor]) -> "TrainState":
        """Restore :meth:`state_dict`'s output in place: its values are
        copied into the existing params, BatchNorm state and optimizer
        moments, and ``step`` and the optimizer's ``count`` are set, so no
        tensor that a step function or its gradient buffers hold goes stale.
        A missing, extra or misshapen entry raises."""
        used = load_flat_state(self.params, "params", flat)
        used |= load_flat_state(self.model_state, "model_state", flat)
        opt = {k[len("opt_state/"):]: v for k, v in flat.items() if k.startswith("opt_state/")}
        used |= {f"opt_state/{k}" for k in self.tx.load_state_dict(self.opt_state, opt,
                                                                     self.params)}
        extra = sorted(set(flat) - used - {"step"})
        if extra:
            raise KeyError(f"unexpected checkpoint entry {extra[0]}")
        self.step = int(flat["step"])
        return self

    def apply_gradients(self, grads: list[torch.Tensor],
                        new_model_state: Params | None = None) -> "TrainState":
        """One optimizer update with ``grads`` in ``tree_leaves(params)``
        order; the params change in place."""
        self.tx.update(tree_leaves(self.params), grads, self.opt_state)
        self.step += 1
        if new_model_state is not None:
            self.model_state = new_model_state
        return self
