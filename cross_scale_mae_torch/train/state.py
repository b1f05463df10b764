"""Train state and parameter-tree helpers (counterpart of
``cross_scale_mae_tpu/train/state.py``).

Params are the nested dict of ``models/mae.py::mae_init`` (block stacks as
lists) with leaf tensors that require grad. The state is updated in place
by the step, where the JAX package returns a new one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

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

    def apply_gradients(self, grads: list[torch.Tensor],
                        new_model_state: Params | None = None) -> "TrainState":
        """One optimizer update with ``grads`` in ``tree_leaves(params)``
        order; the params change in place."""
        self.tx.update(tree_leaves(self.params), grads, self.opt_state)
        self.step += 1
        if new_model_state is not None:
            self.model_state = new_model_state
        return self
