"""Plain reference of Cross-Scale MAE pretraining, the MsLdCeCd variant
(aicip/Cross-Scale-MAE ``models_mae/MAE_ViT_MsLdCeCd.py`` and its bases):
the train augment, the low-GSD crop as the second view, per-sample random
masking, the encoder on the kept tokens, the decoder on the whole grid, the
masked pixel MSE of both views (summed), the cross-decoder predictor's MSE
(Linear -> BatchNorm1d over token positions -> ReLU -> Linear) and NT-Xent
between the views' mean-pooled encoder tokens.

The parameters are a nested dict in the layout of :func:`param_specs`
(linear kernels stored (in, out)). ``cfg`` is the configuration file's dict,
``mix`` the traffic mix's, ``draws`` the inputs of one step as the benchmark
made them.
"""

from __future__ import annotations

import torch

from portbench.reference.common import (
    Arith,
    block,
    checkpointed,
    crop_resize,
    flips,
    layer_norm,
    linear,
    normalize,
    patchify,
    sincos_table,
)


def _linear_spec(prefix: tuple, d_in: int, d_out: int) -> list:
    return [(prefix + ("kernel",), (d_in, d_out), "kernel"),
            (prefix + ("bias",), (d_out,), "bias")]


def _norm_spec(prefix: tuple, dim: int) -> list:
    return [(prefix + ("scale",), (dim,), "scale"), (prefix + ("bias",), (dim,), "bias")]


def block_specs(prefix: tuple, dim: int, ratio: int) -> list:
    return (_norm_spec(prefix + ("norm1",), dim)
            + _linear_spec(prefix + ("attn", "qkv"), dim, 3 * dim)
            + _linear_spec(prefix + ("attn", "proj"), dim, dim)
            + _norm_spec(prefix + ("norm2",), dim)
            + _linear_spec(prefix + ("mlp", "fc1"), dim, ratio * dim)
            + _linear_spec(prefix + ("mlp", "fc2"), ratio * dim, dim))


def param_specs(cfg: dict) -> list[tuple[tuple, tuple, str]]:
    """(path, shape, kind) of every trained parameter."""
    d, dd, r = cfg["embed_dim"], cfg["decoder_embed_dim"], cfg["mlp_ratio"]
    patch_dim = cfg["patch_size"] ** 2 * cfg["in_chans"]
    grid = cfg["input_size"] // cfg["patch_size"]
    specs = _linear_spec(("patch_embed",), patch_dim, d)
    specs += [(("cls_token",), (1, 1, d), "token"), (("mask_token",), (1, 1, dd), "token")]
    for i in range(cfg["depth"]):
        specs += block_specs(("encoder_blocks", i), d, r)
    specs += _norm_spec(("encoder_norm",), d)
    specs += _linear_spec(("decoder_embed",), d, dd)
    for i in range(cfg["decoder_depth"]):
        specs += block_specs(("decoder_blocks", i), dd, r)
    specs += _norm_spec(("decoder_norm",), dd)
    specs += _linear_spec(("decoder_pred",), dd, patch_dim)
    hidden = cfg["predictor_hidden_size"]
    specs += (_linear_spec(("predictor_cd", "fc1"), dd, hidden)
              + _norm_spec(("predictor_cd", "bn"), grid * grid)
              + _linear_spec(("predictor_cd", "fc2"), hidden, dd))
    return specs


def decay_mask(specs: list) -> list[bool]:
    """Weight decay on kernels and on the cls and mask tokens."""
    return [kind in ("kernel", "token") for _, _, kind in specs]


def _masked_mse(target: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    per_patch = ((pred - target) ** 2).mean(dim=-1)
    return (per_patch * mask).sum() / mask.sum()


def _predictor(ar: Arith, p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Linear -> BatchNorm1d(T) on (N, T, hidden) with batch statistics over
    (N, hidden), biased variance -> ReLU -> Linear."""
    h = linear(ar, p["fc1"], x)
    mean = h.mean(dim=(0, 2), keepdim=True)
    var = ((h - mean) ** 2).mean(dim=(0, 2), keepdim=True)
    h = (h - mean) * torch.rsqrt(var + eps)
    h = h * p["bn"]["scale"][None, :, None] + p["bn"]["bias"][None, :, None]
    return linear(ar, p["fc2"], torch.relu(h))


def _ntxent(zi: torch.Tensor, zj: torch.Tensor, tau: float, eps: float = 1e-8) -> torch.Tensor:
    """NT-Xent over the 2B rows: row r's positive is r +- B, its negatives
    every other row but itself and its positive."""
    b = zi.shape[0]
    z = torch.cat([zi / zi.norm(dim=1, keepdim=True).clamp(min=1e-12),
                   zj / zj.norm(dim=1, keepdim=True).clamp(min=1e-12)])
    sim = torch.exp(z @ z.T / tau)
    idx = torch.arange(2 * b, device=z.device)
    partner = torch.where(idx < b, idx + b, idx - b)
    pos = sim[idx, partner]
    keep = torch.ones_like(sim, dtype=torch.bool)
    keep[idx, idx] = False
    keep[idx, partner] = False
    neg = torch.where(keep, sim, torch.zeros_like(sim)).sum(dim=1)
    return (-torch.log(pos / (neg + eps))).mean()


def loss(ar: Arith, params: dict, cfg: dict, mix: dict, imgs: torch.Tensor,
         draws: dict) -> torch.Tensor:
    """The training objective of one step on uint8 NHWC ``imgs``."""
    size, p, eps = cfg["input_size"], cfg["patch_size"], cfg["layer_norm_eps"]
    x = normalize(imgs.float() / 255.0, mix["mean"], mix["std"])
    x = crop_resize(flips(x, draws["hflip"], draws["vflip"]), draws["crop_boxes"], size, "cubic")
    crop = crop_resize(x, draws["ms_boxes"], size, "linear")
    n = x.shape[0]
    both = torch.cat([x, crop])
    grid = size // p
    enc_pos = torch.from_numpy(sincos_table(cfg["embed_dim"], grid)).to(x.device)
    dec_pos = torch.from_numpy(sincos_table(cfg["decoder_embed_dim"], grid)).to(x.device)
    tokens = linear(ar, params["patch_embed"], patchify(both, p)) + enc_pos[1:]
    num = grid * grid
    keep = int(num * (1 - cfg["mask_ratio"]))
    shuffle = torch.argsort(draws["noise"], dim=1, stable=True)
    restore = torch.argsort(shuffle, dim=1, stable=True)
    kept = torch.gather(tokens, 1, shuffle[:, :keep, None].expand(-1, -1, tokens.shape[2]))
    mask = torch.ones((2 * n, num), device=x.device)
    mask[:, :keep] = 0.0
    mask = torch.gather(mask, 1, restore)
    cls = (params["cls_token"] + enc_pos[None, :1]).expand(2 * n, 1, -1)
    h = torch.cat([cls, kept], dim=1)
    for bp in params["encoder_blocks"]:
        h = checkpointed(lambda t, bp=bp: block(ar, bp, t, cfg["num_heads"], eps), h)
    enc = h
    y = linear(ar, params["decoder_embed"], enc)
    filler = params["mask_token"].expand(2 * n, num - keep, -1)
    grid_tokens = torch.cat([y[:, 1:], filler], dim=1)
    grid_tokens = torch.gather(grid_tokens, 1, restore[:, :, None].expand(-1, -1, y.shape[2]))
    y = torch.cat([y[:, :1], grid_tokens], dim=1) + dec_pos
    for bp in params["decoder_blocks"]:
        y = checkpointed(lambda t, bp=bp: block(ar, bp, t, cfg["decoder_num_heads"], eps), y)
    dec = layer_norm(params["decoder_norm"], y, eps)
    pred = linear(ar, params["decoder_pred"], dec)[:, 1:]
    loss_d = (_masked_mse(patchify(x, p), pred[:n], mask[:n])
              + _masked_mse(patchify(crop, p), pred[n:], mask[n:]))
    pred_cd = _predictor(ar, params["predictor_cd"], dec[n:, 1:], cfg["batch_norm_eps"])
    loss_cd = ((pred_cd - dec[:n, 1:]) ** 2).mean()
    loss_ce = _ntxent(enc[:n, 1:].mean(dim=1), enc[n:, 1:].mean(dim=1), cfg["ntxent_tau"])
    return loss_d + loss_cd + loss_ce


def keep_rows(draws: dict, rows: int) -> dict:
    """The draws of the first ``rows`` samples (a batch with the rest left out)."""
    n = draws["hflip"].shape[0]
    out = {k: draws[k][:rows] for k in ("hflip", "vflip", "crop_boxes", "ms_boxes")}
    out["noise"] = torch.cat([draws["noise"][:rows], draws["noise"][n:n + rows]])
    return out
