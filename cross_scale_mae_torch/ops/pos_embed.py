"""Fixed 2-D sine-cosine positional embeddings.

A numpy copy of ``cross_scale_mae_tpu/ops/pos_embed.py``: the same float64
tables as the reference (``util/pos_embed.py:16-63``), handed out as float32.
"""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """pos: (M,) positions -> (M, embed_dim) sin-cos table."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", np.asarray(pos, np.float64).reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    """(grid_size², D) fp32 table, optional zero cls row."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    grid_h = np.arange(grid_size, dtype=np.float64)
    grid_w = np.arange(grid_size, dtype=np.float64)
    # Reference meshgrid(w, h): the w ramp feeds the "h" half of the table.
    ww, hh = np.meshgrid(grid_w, grid_h)
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, ww)
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, hh)
    emb = np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim), np.float32), emb], axis=0)
    return emb
