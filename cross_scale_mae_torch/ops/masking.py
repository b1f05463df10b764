"""Per-sample random masking (counterpart of ``cross_scale_mae_tpu/ops/masking.py``).

The same algorithm: argsort of uniform noise per sample, the smallest
``len_keep`` kept. The noise is always an input (``train/pretrain.py``
draws it), so a test can hand both packages the same numbers. The sort is
stable, as ``jnp.argsort`` is, so tied noise values keep the same order.
"""

from __future__ import annotations

import torch


def random_masking(x: torch.Tensor, len_keep: int, noise: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the ``len_keep`` tokens of smallest noise in each sample.

    x: (N, L, D); noise: (N, L). Returns ``(x_masked (N, len_keep, D),
    mask (N, L) with 0 = keep and 1 = masked, ids_restore (N, L))``."""
    n, l, d = x.shape
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(n, len_keep, d))
    mask = torch.ones((n, l), dtype=torch.float32, device=x.device)
    mask[:, :len_keep] = 0.0
    return x_masked, torch.gather(mask, 1, ids_restore), ids_restore


def restore_tokens(visible: torch.Tensor, mask_token: torch.Tensor,
                   ids_restore: torch.Tensor) -> torch.Tensor:
    """Fill the masked slots with ``mask_token`` (D,) and un-shuffle to
    image order. visible: (N, len_keep, D) -> (N, L, D)."""
    n, len_keep, d = visible.shape
    l = ids_restore.shape[1]
    fill = mask_token.to(visible.dtype).expand(n, l - len_keep, d)
    full = torch.cat([visible, fill], dim=1)
    return torch.gather(full, 1, ids_restore[:, :, None].expand(n, l, d))
