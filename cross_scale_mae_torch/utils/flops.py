"""Analytic FLOP count of the MAE train step, and MFU on an H100
(a copy of ``cross_scale_mae_tpu/utils/flops.py`` with the GPU's peak).

FLOPs = 2 x MACs; a training step = 3 x forward. Only matmul and attention
FLOPs are counted (LayerNorm, GELU, softmax, gathers, the optimizer and the
NT-Xent similarity are left out), as MFU is conventionally reported.
"""

from __future__ import annotations

# Dense bf16 tensor-core peak of one NVIDIA H100 SXM (NVIDIA data sheet).
H100_PEAK_BF16_FLOPS = 989e12


def _block_flops(n: int, d: int, ffn_ratio: int) -> float:
    """One pre-LN transformer block forward on ``n`` tokens of width ``d``:
    qkv projection, QK^T and PV, output projection, 2-layer MLP."""
    qkv = 2 * n * d * 3 * d
    attn = 2 * 2 * n * n * d
    proj = 2 * n * d * d
    mlp = 2 * 2 * n * d * ffn_ratio * d
    return float(qkv + attn + proj + mlp)


def mae_forward_flops_per_image(cfg) -> float:
    """Forward FLOPs per image for one MAE forward (all views): patch embed,
    masked encoder (kept tokens + cls), decoder embed, decoder on the full
    grid, pixel head; doubled for the two scale views, plus the Ce/Cd
    predictor MLPs."""
    grid = cfg.input_size // cfg.patch_size
    n_patch = grid * grid
    n_keep = int(round(n_patch * (1.0 - cfg.mask_ratio)))
    n_enc = n_keep + 1
    n_dec = n_patch + 1
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.input_channels

    patch_embed = 2 * n_patch * patch_dim * cfg.dim_model
    encoder = cfg.encoder_num_layers * _block_flops(n_enc, cfg.dim_model, cfg.ffn_ratio)
    dec_embed = 2 * n_enc * cfg.dim_model * cfg.decoder_embed_dim
    decoder = cfg.decoder_num_layers * _block_flops(n_dec, cfg.decoder_embed_dim,
                                                    cfg.ffn_ratio)
    pixel_head = 2 * n_dec * cfg.decoder_embed_dim * patch_dim

    per_view = patch_embed + encoder + dec_embed + decoder + pixel_head
    total = (2 if cfg.multi_scale else 1) * per_view
    hidden = cfg.predictor_hidden_size
    if cfg.use_cd_pred:
        total += 2 * 2 * n_patch * cfg.decoder_embed_dim * hidden
    if cfg.use_ce_pred:
        total += 2 * 2 * n_keep * cfg.dim_model * hidden
    return float(total)


def mae_train_flops_per_image(cfg) -> float:
    """Per-image useful FLOPs of one optimizer step (forward + backward)."""
    return 3.0 * mae_forward_flops_per_image(cfg)


def mfu(imgs_per_sec: float, flops_per_image: float) -> float:
    """Model FLOPs utilization of one H100 against its dense bf16 peak."""
    return imgs_per_sec * flops_per_image / H100_PEAK_BF16_FLOPS
