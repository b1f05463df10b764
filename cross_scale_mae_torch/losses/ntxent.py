"""NT-Xent between the two scale views (counterpart of
``cross_scale_mae_tpu/losses/ntxent.py``).

The reference's form (util/contrast_loss.py:44-101): rows normalized first,
a 2B x 2B similarity matrix in fp32, and a denominator of the negatives only
(the positive is not added back), with an ``eps`` guard. With
``global_batch`` the rows of every data rank (the mesh's data group) are
gathered first, so each row's negatives are the whole global batch, as
under the JAX package's jit over a batch-sharded array.
"""

from __future__ import annotations

import torch

from cross_scale_mae_torch.ops.numerics import at_least_f32
from cross_scale_mae_torch.parallel.collectives import all_gather_rows


def ntxent_loss(zi: torch.Tensor, zj: torch.Tensor, tau: float = 0.5,
                eps: float = 1e-8, global_batch: bool = False) -> torch.Tensor:
    """zi, zj: (B, D) features of the two views -> scalar loss. After the
    row normalization the cosine and the dot similarity are the same matrix,
    so the reference's ``cos_sim`` flag changes nothing and is not taken.
    With ``global_batch``, B is the gathered batch (pairs (i, i + B) over
    every rank's rows) and every rank returns the same loss."""
    zi, zj = at_least_f32(zi), at_least_f32(zj)
    if global_batch:
        zi, zj = all_gather_rows(zi), all_gather_rows(zj)
    b = zi.shape[0]
    zi = zi / torch.clamp(torch.linalg.vector_norm(zi, dim=1, keepdim=True), min=1e-12)
    zj = zj / torch.clamp(torch.linalg.vector_norm(zj, dim=1, keepdim=True), min=1e-12)
    z = torch.cat([zi, zj], dim=0)
    sim = torch.exp((z @ z.T) / tau)
    idx = torch.arange(2 * b, device=z.device)
    pos_idx = torch.where(idx < b, idx + b, idx - b)   # row r's positive is r +- B
    pos = sim[idx, pos_idx]
    eye = torch.eye(2 * b, dtype=torch.bool, device=z.device)
    neg_mask = ~(eye | eye[pos_idx])
    neg_sum = torch.where(neg_mask, sim, torch.zeros((), device=z.device)).sum(dim=1)
    return (-torch.log(pos / (neg_sum + eps))).mean()
