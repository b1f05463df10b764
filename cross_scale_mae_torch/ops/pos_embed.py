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



def bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float64 weights of torch's 1-D bicubic resize (a = -0.75,
    ``align_corners=False``, border taps clamped onto the edge), the JAX
    package's ``_torch_bicubic_matrix``."""
    a = -0.75

    def w(x: float) -> float:
        x = abs(x)
        if x <= 1.0:
            return (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0
        if x < 2.0:
            return a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a
        return 0.0

    scale = in_size / out_size
    m = np.zeros((out_size, in_size), np.float64)
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        for k, dist in enumerate((1.0 + t, t, 1.0 - t, 2.0 - t)):
            m[o, min(max(i0 - 1 + k, 0), in_size - 1)] += w(dist)
    return m


def interpolate_pos_embed(pos_embed, new_grid_size: int, num_extra_tokens: int = 1):
    """Bicubic-resample the grid tokens of a position table to a new grid
    (util/pos_embed.py:92-125; the JAX package's ``interpolate_pos_embed``):
    ``pos_embed`` (1, T, D) or (T, D), a tensor or a numpy array, with T =
    ``num_extra_tokens`` + old_grid²; the extra tokens pass through. The
    resample is :func:`bicubic_matrix` applied on both grid axes in the
    table's dtype, as the JAX package applies it. Returns the input's type."""
    import torch

    as_numpy = isinstance(pos_embed, np.ndarray)
    t = torch.from_numpy(np.array(pos_embed)) if as_numpy else pos_embed
    squeeze = t.dim() == 2
    if squeeze:
        t = t[None]
    _, n_tok, d = t.shape
    old_grid = int(round((n_tok - num_extra_tokens) ** 0.5))
    if old_grid * old_grid != n_tok - num_extra_tokens:
        raise ValueError(f"{n_tok - num_extra_tokens} grid tokens are not a square grid")
    if old_grid != new_grid_size:
        grid = t[0, num_extra_tokens:].reshape(old_grid, old_grid, d)
        w = torch.from_numpy(bicubic_matrix(old_grid, new_grid_size)).to(grid.device, grid.dtype)
        resized = torch.einsum("oh,hwd,pw->opd", w, grid, w)
        t = torch.cat([t[:, :num_extra_tokens],
                       resized.reshape(1, new_grid_size * new_grid_size, d)], dim=1)
    out = t[0] if squeeze else t
    return out.numpy() if as_numpy else out
