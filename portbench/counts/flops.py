"""Model FLOPs of one training image (forward + backward = 3 x forward),
counting only matrix products and attention, as MFU is reported: a frozen
copy of the program's ``utils/flops.py`` arithmetic, on the configuration
file's numbers. FLOPs = 2 x multiply-adds; nothing recomputed is counted."""

from __future__ import annotations


def block_flops(tokens: int, dim: int, ratio: int) -> float:
    """One pre-norm block's forward on ``tokens`` tokens of width ``dim``:
    the qkv projection, q k^T and P v, the output projection, the MLP."""
    return float(2 * tokens * dim * 3 * dim + 2 * 2 * tokens * tokens * dim
                 + 2 * tokens * dim * dim + 2 * 2 * tokens * dim * ratio * dim)


def mae_train_flops(cfg: dict) -> float:
    """Cross-Scale MAE (two scale views, the cross-decoder predictor): patch
    embedding, the encoder on the kept tokens and the cls token, the decoder
    embedding, the decoder on the whole grid and the pixel head, per view."""
    grid = cfg["input_size"] // cfg["patch_size"]
    num = grid * grid
    keep = int(round(num * (1.0 - cfg["mask_ratio"])))
    d, dd, r = cfg["embed_dim"], cfg["decoder_embed_dim"], cfg["mlp_ratio"]
    patch_dim = cfg["patch_size"] ** 2 * cfg["in_chans"]
    per_view = (2 * num * patch_dim * d + cfg["depth"] * block_flops(keep + 1, d, r)
                + 2 * (keep + 1) * d * dd + cfg["decoder_depth"] * block_flops(num + 1, dd, r)
                + 2 * (num + 1) * dd * patch_dim)
    predictor = 2 * 2 * num * dd * cfg["predictor_hidden_size"]
    return 3.0 * (2 * per_view + predictor)


def vit_train_flops(cfg: dict) -> float:
    """The classifier: patch embedding, ``depth`` blocks on the patches and
    the cls token, the head."""
    num = (cfg["input_size"] // cfg["patch_size"]) ** 2
    d = cfg["embed_dim"]
    patch_dim = cfg["patch_size"] ** 2 * cfg["in_chans"]
    forward = (2 * num * patch_dim * d + cfg["depth"] * block_flops(num + 1, d, cfg["mlp_ratio"])
               + 2 * d * cfg["num_classes"])
    return 3.0 * forward
