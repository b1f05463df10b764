"""Cross-Scale MAE: one functional model, variants as loss terms
(counterpart of ``cross_scale_mae_tpu/models/mae.py``).

``mae_loss_fn`` computes the whole training objective; ``MAEConfig`` flags
select the terms (MsLd: two scale views; Le, Ce, Cd: latent and predictor
terms; CeCd: NT-Xent). Both scale views run as one forward at batch 2N.
``mae_encode`` is the unmasked encoder that serving runs.

Randomness is an input: the mask noise and the low-GSD view's crop boxes
come from ``train/pretrain.py::sample_pretrain_draws`` (or, in a test, from
the JAX package's keys). Params are the dict that ``mae_init`` or
``utils/params.py::params_from_jax`` returns. The perceptual loss's frozen
VGG16 trunk lives in the state (``state["vgg"]``), not in the params, so it
takes no gradient and no weight decay.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import torch

from cross_scale_mae_torch.configs import MAEConfig
from cross_scale_mae_torch.losses.ntxent import ntxent_loss
from cross_scale_mae_torch.losses.perceptual import init_vgg16_params, perceptual_loss
from cross_scale_mae_torch.losses.recon import process_target, recon_loss
from cross_scale_mae_torch.models import layers
from cross_scale_mae_torch.ops.image import random_resized_crop
from cross_scale_mae_torch.ops.masking import random_masking, restore_tokens
from cross_scale_mae_torch.ops.numerics import at_least_f32
from cross_scale_mae_torch.ops.patchify import patchify, unpatchify
from cross_scale_mae_torch.ops.pos_embed import get_2d_sincos_pos_embed
from cross_scale_mae_torch.parallel.collectives import fsdp_gathered

Params = dict[str, Any]


def compute_dtype(cfg: MAEConfig) -> torch.dtype:
    dtype = getattr(torch, cfg.compute_dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    return dtype


class MAEOutput(NamedTuple):
    loss: torch.Tensor
    losses: dict[str, torch.Tensor]   # per-term scalars (loss_d, loss_ce, ...)
    pred: torch.Tensor                # (N, L, p*p*C) original-view prediction
    mask: torch.Tensor                # (N, L) 0 = visible, 1 = reconstructed
    enc_emb: Optional[tuple] = None   # (orig, crop) encoder embeddings
    dec_emb: Optional[tuple] = None
    state: Optional[Params] = None    # updated predictor BatchNorm statistics


def mae_init(cfg: MAEConfig, gen: torch.Generator) -> tuple[Params, Params]:
    """(params, state) on ``gen``'s device: fp32 leaves (xavier-uniform
    kernels, zero biases, unit norms, normal(0.02) tokens; linformer's E
    and F in every block), and the
    predictors' BatchNorm statistics and, with ``use_perceptual``, a random
    VGG16 trunk (drawn last)."""
    d, dd = cfg.dim_model, cfg.decoder_embed_dim
    dev = gen.device

    def token(dim):
        return 0.02 * torch.randn((1, 1, dim), generator=gen, device=dev)

    params: Params = {
        "patch_embed": layers.linear_init(gen, cfg.patch_dim, d),
        "cls_token": token(d),
        "mask_token": token(dd),
        # seq_len = num_patches + 1 for both stacks (the reference passes one
        # seq_len to the encoder and the decoder, MAE_ViT_Baseline.py:110,143).
        "encoder_blocks": layers.stacked_blocks_init(
            gen, cfg.encoder_num_layers, d, cfg.ffn_ratio, cfg.attention_impl,
            cfg.num_patches + 1),
        "encoder_norm": layers.layer_norm_init(d, dev),
        "decoder_embed": layers.linear_init(gen, d, dd),
        "decoder_blocks": layers.stacked_blocks_init(
            gen, cfg.decoder_num_layers, dd, cfg.ffn_ratio, cfg.attention_impl,
            cfg.num_patches + 1),
        "decoder_norm": layers.layer_norm_init(dd, dev),
        "decoder_pred": layers.linear_init(gen, dd, cfg.patch_dim),
    }
    state: Params = {}
    if cfg.use_cd_pred:
        params["predictor_cd"] = layers.predictor_init(
            gen, dd, cfg.num_patches, cfg.predictor_hidden_size)
        state["predictor_cd"] = layers.predictor_state_init(cfg.num_patches, dev)
    if cfg.use_ce_pred:
        # Sized to the len_keep tokens it receives (the JAX package's fix of
        # the reference's num_patches-sized BatchNorm, MAE_ViT_MsLdCe.py:21).
        params["predictor_ce"] = layers.predictor_init(
            gen, d, cfg.len_keep, cfg.predictor_hidden_size)
        state["predictor_ce"] = layers.predictor_state_init(cfg.len_keep, dev)
    if cfg.use_perceptual:
        state["vgg"] = init_vgg16_params(gen, cfg.input_channels)
    return params, state


def _pos_table(dim: int, grid_size: int, device: torch.device) -> torch.Tensor:
    """A fixed sincos table with its zero cls row, (1+L, D) fp32. Cached per
    device so a step does not copy it to the card again; callers only read
    it. Under ``torch.export`` (or ``torch.compile``) the table is made
    anew, so that the tracer's tensor never enters the cache."""
    if torch.compiler.is_compiling():
        return torch.from_numpy(get_2d_sincos_pos_embed(dim, grid_size, cls_token=True)).to(device)
    return _cached_pos_table(dim, grid_size, device)


@functools.lru_cache(maxsize=16)
def _cached_pos_table(dim: int, grid_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(get_2d_sincos_pos_embed(dim, grid_size, cls_token=True)).to(device)


def _embed_patches(params: Params, cfg: MAEConfig, imgs: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """imgs NHWC -> (patch tokens + pos (N, L, D), enc_pos table)."""
    dtype = compute_dtype(cfg)
    enc_pos = _pos_table(cfg.dim_model, cfg.grid_size, imgs.device)
    x = patchify(imgs, cfg.patch_size).to(dtype)
    x = layers.linear(params["patch_embed"], x)
    return x + enc_pos[None, 1:, :].to(dtype), enc_pos


def _encoder_trunk(params: Params, cfg: MAEConfig, x: torch.Tensor,
                   enc_pos: torch.Tensor) -> torch.Tensor:
    """cls-token cat -> encoder blocks -> (optional) encoder norm."""
    cls = (at_least_f32(params["cls_token"]) + enc_pos[None, :1, :]).to(x.dtype)
    x = torch.cat([cls.expand(x.shape[0], 1, x.shape[2]), x], dim=1)
    x = layers.run_blocks(
        params["encoder_blocks"], x, cfg.encoder_num_heads,
        cfg.attention_impl, cfg.residual_norm_style, cfg.gelu, cfg.sequence_parallel,
    )
    if cfg.apply_encoder_norm:
        # The reference computes and discards this norm (MAE_ViT_Baseline.py:264).
        x = layers.layer_norm(params["encoder_norm"], x)
    return x


def mae_forward_encoder(params: Params, cfg: MAEConfig, imgs: torch.Tensor, *,
                        noise: torch.Tensor, len_keep: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NHWC images and (N, L) mask noise -> (enc_emb (N, 1+len_keep, D),
    mask (N, L), ids_restore) (MAE_ViT_Baseline.py:243-266)."""
    x, enc_pos = _embed_patches(params, cfg, imgs)
    lk = cfg.len_keep if len_keep is None else len_keep
    x, mask, ids_restore = random_masking(x, lk, noise)
    return _encoder_trunk(params, cfg, x, enc_pos), mask, ids_restore


def mae_forward_decoder(params: Params, cfg: MAEConfig, x: torch.Tensor,
                        ids_restore: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (pred (N, L, p*p*C), dec_emb (N, 1+L, Dd)) (MAE_ViT_Baseline.py:268-297)."""
    y = layers.linear(params["decoder_embed"], x)
    y_grid = restore_tokens(y[:, 1:, :], params["mask_token"][0, 0], ids_restore)
    y = torch.cat([y[:, :1, :], y_grid], dim=1)
    dec_pos = _pos_table(cfg.decoder_embed_dim, cfg.grid_size, y.device)
    y = y + dec_pos[None].to(y.dtype)
    y = layers.run_blocks(params["decoder_blocks"], y, cfg.decoder_num_heads,
                          cfg.attention_impl, cfg.residual_norm_style, cfg.gelu,
                          cfg.sequence_parallel)
    y = layers.layer_norm(params["decoder_norm"], y)
    pred = layers.linear(params["decoder_pred"], y)[:, 1:, :]
    return pred, y


def _recon_loss(cfg: MAEConfig, imgs, pred, mask, global_batch: bool = False):
    target = process_target(imgs, cfg.patch_size, cfg.input_channels, cfg.norm_pix_loss)
    return recon_loss(cfg.loss, target, at_least_f32(pred), mask,
                      patch_size=cfg.patch_size, channels=cfg.input_channels,
                      global_batch=global_batch)


def mae_apply(params: Params, cfg: MAEConfig, imgs: torch.Tensor, *,
              noise: torch.Tensor, global_batch: bool = False) -> MAEOutput:
    """Single-view forward: loss, prediction, mask and embeddings
    (MAE_ViT_Baseline.py:299-320)."""
    with fsdp_gathered(params, compute_dtype(cfg)) as params:
        enc, mask, ids_restore = mae_forward_encoder(params, cfg, imgs, noise=noise)
        pred, dec = mae_forward_decoder(params, cfg, enc, ids_restore)
        loss = _recon_loss(cfg, imgs, pred, mask, global_batch)
    return MAEOutput(loss=loss, losses={"loss_d": loss}, pred=pred, mask=mask,
                     enc_emb=(enc,), dec_emb=(dec,))


def mae_encode(params: Params, cfg: MAEConfig, imgs: torch.Tensor) -> torch.Tensor:
    """Unmasked encoder features (N, 1+L, D) of NHWC images."""
    with fsdp_gathered(params, compute_dtype(cfg)) as params:
        x, enc_pos = _embed_patches(params, cfg, imgs)
        return _encoder_trunk(params, cfg, x, enc_pos)


def _split_predictor(p: Params, cfg: MAEConfig) -> bool:
    """Whether a predictor's fc1 holds a part of its hidden columns (TP)."""
    return p["fc1"]["kernel"].shape[-1] != cfg.predictor_hidden_size


def mae_loss_fn(params: Params, state: Params, cfg: MAEConfig, imgs: torch.Tensor, *,
                noise: torch.Tensor, ms_boxes: torch.Tensor | None = None,
                train: bool = True, global_batch: bool = False) -> MAEOutput:
    """The training objective of any variant (mae.py:253-396).

    imgs: (N, H, W, C) normalized, or a temporal pair (N, 2, H, W, C)
    (``data/datasets.FmowTemporalDataset``), whose frame 1 takes the place
    of the low-GSD crop as the second view (a multi-scale config only; the
    Le/Ce/Cd/NT-Xent terms then hold the frames together). noise: (N, L)
    mask noise, or (2N, L) for a multi-scale config (the original view's
    rows first; equal halves give the consistent mask). ms_boxes: (N, 4)
    crop boxes of the low-GSD view (equal rows give the batch-shared crop),
    unused for a pair. ``global_batch`` (the gspmd data-parallel semantics)
    takes NT-Xent's negatives, the predictors' BatchNorm statistics and the
    SSIM losses' rescale over every data rank's rows; the per-sample terms
    stay means over this rank's N, which the step averages over the data
    ranks. Under a mesh layout ``params`` are this rank's parts
    (``parallel/mesh.py``): FSDP's are gathered here (the top level) and in
    each block."""
    with fsdp_gathered(params, compute_dtype(cfg)) as params:
        return _mae_loss(params, state, cfg, imgs, noise, ms_boxes, train, global_batch)


def _mae_loss(params, state, cfg, imgs, noise, ms_boxes, train, global_batch) -> MAEOutput:
    view2 = None
    if imgs.dim() == 5:
        if not cfg.multi_scale:
            raise ValueError(
                "temporal (N, T, H, W, C) batches need a multi-scale variant "
                "(MsLd*): single-view MAE has no slot for the second frame")
        imgs, view2 = imgs[:, 0], imgs[:, 1]
    if not cfg.multi_scale:
        # As in the JAX package, a single-view config returns before the
        # perceptual term (cli/pretrain.py refuses that combination).
        return mae_apply(params, cfg, imgs, noise=noise,
                         global_batch=global_batch)._replace(state=state)

    n = imgs.shape[0]
    # The second view: the pair's later frame, or the low-GSD per-sample
    # RandomResizedCrop (MAE_ViT_MsLd.py:29-35,52).
    imgs_crop = (view2 if view2 is not None
                 else random_resized_crop(imgs, ms_boxes, cfg.input_size, "linear"))
    both = torch.cat([imgs, imgs_crop], dim=0)
    enc, mask, ids_restore = mae_forward_encoder(params, cfg, both, noise=noise)
    pred, dec = mae_forward_decoder(params, cfg, enc, ids_restore)

    losses: dict[str, torch.Tensor] = {}
    loss_d = (_recon_loss(cfg, imgs, pred[:n], mask[:n], global_batch)
              + _recon_loss(cfg, imgs_crop, pred[n:], mask[n:], global_batch))
    if cfg.ms_decoder_loss_reduction == "mean":
        loss_d = loss_d / 2
    losses["loss_d"] = loss_d
    total = loss_d

    enc_o, enc_c = enc[:n], enc[n:]
    dec_o, dec_c = dec[:n], dec[n:]
    new_state = dict(state)
    if cfg.use_le:
        # Latent distance between full encoder embeddings (MAE_ViT_MsLdLe.py:44).
        losses["loss_e"] = recon_loss(cfg.loss_name("e"), at_least_f32(enc_o),
                                      at_least_f32(enc_c), global_batch=global_batch)
        total = total + losses["loss_e"]
    if cfg.use_ce_pred:
        # Crop encoder tokens -> original encoder tokens (MAE_ViT_MsLdCe.py:46-48).
        pred_ce, new_state["predictor_ce"] = layers.predictor_apply(
            params["predictor_ce"], state["predictor_ce"], enc_c[:, 1:, :], train,
            global_stats=global_batch, split=_split_predictor(params["predictor_ce"], cfg))
        losses["loss_ce_pred"] = recon_loss(
            cfg.loss_name("ce"), at_least_f32(enc_o[:, 1:, :]), at_least_f32(pred_ce),
            global_batch=global_batch)
        total = total + losses["loss_ce_pred"]
    if cfg.use_cd_pred:
        # The same on decoder embeddings (MAE_ViT_MsLdCd.py:49-51).
        pred_cd, new_state["predictor_cd"] = layers.predictor_apply(
            params["predictor_cd"], state["predictor_cd"], dec_c[:, 1:, :], train,
            global_stats=global_batch, split=_split_predictor(params["predictor_cd"], cfg))
        losses["loss_cd"] = recon_loss(
            cfg.loss_name("cd"), at_least_f32(dec_o[:, 1:, :]), at_least_f32(pred_cd),
            global_batch=global_batch)
        total = total + losses["loss_cd"]
    if cfg.use_ce_ntxent:
        # NT-Xent between mean-pooled patch tokens (MAE_ViT_MsLdCeCd.py:62-69).
        f1 = at_least_f32(enc_o[:, 1:, :]).mean(dim=1)
        f2 = at_least_f32(enc_c[:, 1:, :]).mean(dim=1)
        losses["loss_ce"] = ntxent_loss(f1, f2, tau=cfg.ntxent_tau, global_batch=global_batch)
        total = total + losses["loss_ce"]
    if cfg.use_perceptual:
        # The original view's prediction against its normalized input
        # (JAX models/mae.py:381-391).
        pred_img = unpatchify(at_least_f32(pred[:n]), cfg.patch_size, cfg.input_channels)
        losses["loss_perceptual"] = perceptual_loss(state["vgg"], pred_img,
                                                    at_least_f32(imgs), resize_to=None)
        total = total + cfg.perceptual_weight * losses["loss_perceptual"]
    return MAEOutput(loss=total, losses=losses, pred=pred[:n], mask=mask[:n],
                     enc_emb=(enc_o, enc_c), dec_emb=(dec_o, dec_c), state=new_state)
