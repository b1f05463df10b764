"""Temporal consistency by capture gap (counterpart of
``cross_scale_mae_tpu/viz/temporal.py``).

For each same-site pair of an fMoW temporal CSV: the cosine similarity of
the two captures' embeddings (the unmasked encoder, ``mae_encode``, its
patch tokens mean-pooled and L2-normalized: the NT-Xent feature,
MAE_ViT_MsLdCeCd.py:62-69), reported overall and by the capture gap in
months. The reference parses the timestamps (util/datasets.py:287-292) and
never uses them. CLI: ``cli/evalviz.py --temporal_csv pairs.csv``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cross_scale_mae_torch.models.mae import mae_encode
from cross_scale_mae_torch.ops.image import center_crop_resize, normalize_images
from cross_scale_mae_torch.train.state import tree_leaves


def _bucket_label(edges: Sequence[int], b: int) -> str:
    if b == 0:
        return f"0-{edges[0] - 1}mo"
    if b == len(edges):
        return f"{edges[-1]}+mo"
    return f"{edges[b - 1]}-{edges[b] - 1}mo"


@torch.no_grad()
def _pair_cosines(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """(B, 2, S, S, C) normalized frames -> (B,) cosines of the pooled,
    normalized embeddings of each pair."""
    b = frames.shape[0]
    emb = mae_encode(params, cfg, frames.reshape((b * 2,) + frames.shape[2:]))
    f = emb[:, 1:, :].float().mean(dim=1)
    f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-8)
    f = f.reshape(b, 2, -1)
    return (f[:, 0] * f[:, 1]).sum(dim=-1)


def temporal_consistency_by_gap(params, cfg, dataset, batch_size: int = 32,
                                bucket_edges: Sequence[int] = (6, 12, 24)) -> dict:
    """``{"overall": {mean_cos, n}, "gap_months": {min, median, max},
    "buckets": {label: {mean_cos, n}}}`` of ``dataset``, a
    ``data/datasets.FmowTemporalDataset``, on the params' device. Frames on
    a canvas other than ``input_size`` are center-cropped and resized to it."""
    device = tree_leaves(params)[0].device
    gaps = dataset.time_gaps_months()
    n = len(dataset)
    if n == 0:
        raise ValueError("temporal_consistency_by_gap: the pairs CSV has no rows — "
                         "nothing to evaluate")
    cos = np.empty((n,), np.float32)
    size = cfg.input_size
    for start in range(0, n, batch_size):
        idx = range(start, min(start + batch_size, n))
        stack = np.stack([dataset.load(i)[0] for i in idx])  # (b, 2, S, S, C) uint8
        x = torch.from_numpy(stack).to(device, torch.float32) / 255.0
        x = normalize_images(x, dataset.mean, dataset.std)
        if x.shape[2] != size:
            b = x.shape[0]
            x = center_crop_resize(x.reshape((b * 2,) + x.shape[2:]), size).reshape(
                b, 2, size, size, x.shape[-1])
        cos[start:start + x.shape[0]] = _pair_cosines(params, cfg, x).cpu().numpy()

    edges = list(bucket_edges)
    which = np.digitize(gaps, edges)
    buckets = {}
    for b in range(len(edges) + 1):
        sel = which == b
        if sel.any():
            buckets[_bucket_label(edges, b)] = {"mean_cos": float(cos[sel].mean()),
                                                "n": int(sel.sum())}
    return {"overall": {"mean_cos": float(cos.mean()), "n": int(n)},
            "gap_months": {"min": int(gaps.min()), "median": float(np.median(gaps)),
                           "max": int(gaps.max())},
            "buckets": buckets}
