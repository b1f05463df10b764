"""Plain reference of the downstream ViT classifier's finetuning step
(aicip/Cross-Scale-MAE ``models_vit.py``, ``main_finetune.py``,
``engine_finetune.py``): the train augment (flips, bicubic
RandomResizedCrop, normalization), label smoothing, Mixup/CutMix with the
reversed batch as partners, the patch embedding with a trained position
table, blocks with stochastic depth (x + (block(x) - x) * keep_mask /
keep_rate per sample), global average pooling into ``fc_norm``, the head,
and the soft-target cross entropy. The optimizer is AdamW with layer-wise
lr decay (:func:`layer_scales`) and no decay on biases, norms, the cls
token and the position table.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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
)
from portbench.reference.mae import _linear_spec, _norm_spec, block_specs


def param_specs(cfg: dict) -> list[tuple[tuple, tuple, str]]:
    d = cfg["embed_dim"]
    patch_dim = cfg["patch_size"] ** 2 * cfg["in_chans"]
    tokens = (cfg["input_size"] // cfg["patch_size"]) ** 2 + 1
    specs = _linear_spec(("patch_embed",), patch_dim, d)
    specs += [(("cls_token",), (1, 1, d), "token"), (("pos_embed",), (1, tokens, d), "pos")]
    for i in range(cfg["depth"]):
        specs += block_specs(("blocks", i), d, cfg["mlp_ratio"])
    specs += _norm_spec(("fc_norm",), d)
    specs += _linear_spec(("head",), d, cfg["num_classes"])
    return specs


def decay_mask(specs: list) -> list[bool]:
    """Weight decay on the linear kernels only."""
    return [kind == "kernel" for _, _, kind in specs]


def layer_scales(specs: list, layer_decay: float, depth: int) -> list[float]:
    """BEiT's layer-wise decay: layer_decay ** (depth + 1 - layer id), the
    embedding (patch_embed, cls_token, pos_embed) layer 0, block i layer i + 1,
    the rest depth + 1."""

    def layer(path) -> int:
        if path[0] in ("patch_embed", "cls_token", "pos_embed"):
            return 0
        if path[0] == "blocks":
            return path[1] + 1
        return depth + 1

    return [layer_decay ** (depth + 1 - layer(path)) for path, _, _ in specs]


def drop_rates(cfg: dict) -> np.ndarray:
    return np.linspace(0.0, cfg["drop_path_rate"], cfg["depth"]).astype(np.float32)


def _cutmix_box(box: torch.Tensor, lam: torch.Tensor, h: int, w: int):
    """The pasted rectangle (N, H, W) and the lambda corrected to its area:
    side sqrt(1 - lam) of the image around centre (box0 h, box1 w), clipped."""
    cut = torch.sqrt(1.0 - lam)
    ch, cw = cut * h, cut * w
    cy, cx = box[:, 0] * h, box[:, 1] * w
    y0, y1 = (cy - ch / 2).clamp(0, h), (cy + ch / 2).clamp(0, h)
    x0, x1 = (cx - cw / 2).clamp(0, w), (cx + cw / 2).clamp(0, w)
    ys = torch.arange(h, dtype=torch.float32, device=box.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=box.device)[None, None, :]
    inside = ((ys >= y0[:, None, None]) & (ys < y1[:, None, None])
              & (xs >= x0[:, None, None]) & (xs < x1[:, None, None]))
    return inside, 1.0 - (y1 - y0) * (x1 - x0) / (h * w)


def mix(x: torch.Tensor, targets: torch.Tensor, d: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Mixup or CutMix of each row with its mirror in the reversed batch."""
    px, pt = x.flip(0), targets.flip(0)
    inside, lam_cut = _cutmix_box(d["box"], d["lam_cut"], x.shape[1], x.shape[2])
    cut = torch.where(inside[..., None], px, x)
    lm = d["lam_mix"][:, None, None, None]
    blended = lm * x + (1 - lm) * px
    use_cut = d["use_cutmix"][:, None, None, None]
    out = torch.where(d["apply"][:, None, None, None], torch.where(use_cut, cut, blended), x)
    lam = torch.where(d["use_cutmix"], lam_cut, d["lam_mix"])[:, None]
    return out, torch.where(d["apply"][:, None], lam * targets + (1 - lam) * pt, targets)


def loss(ar: Arith, params: dict, cfg: dict, mix_cfg: dict, imgs: torch.Tensor,
         labels: torch.Tensor, draws: dict) -> torch.Tensor:
    size, p, eps = cfg["input_size"], cfg["patch_size"], cfg["layer_norm_eps"]
    x = flips(imgs.float() / 255.0, draws["hflip"], draws["vflip"])
    x = normalize(crop_resize(x, draws["crop_boxes"], size, "cubic"), mix_cfg["mean"],
                  mix_cfg["std"])
    c = cfg["num_classes"]
    smooth = mix_cfg["smoothing"]
    targets = F.one_hot(labels, c).float() * (1.0 - smooth) + smooth / c
    x, targets = mix(x, targets, draws["mixup"])
    h = linear(ar, params["patch_embed"], patchify(x, p))
    h = torch.cat([params["cls_token"].expand(h.shape[0], 1, -1), h], dim=1) + params["pos_embed"]
    keeps = 1.0 - torch.from_numpy(drop_rates(cfg)).to(x.device)
    for bp, mask, keep in zip(params["blocks"], draws["drop_masks"], keeps):
        out = checkpointed(lambda t, bp=bp: block(ar, bp, t, cfg["num_heads"], eps), h)
        h = h + (out - h) * (mask.float() / keep)[:, None, None]
    pooled = layer_norm(params["fc_norm"], h[:, 1:].mean(dim=1), eps)
    logits = linear(ar, params["head"], pooled)
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def keep_rows(draws: dict, rows: int) -> dict:
    """The draws of the first ``rows`` samples (a batch with the rest left out)."""
    out = {k: draws[k][:rows] for k in ("hflip", "vflip", "crop_boxes")}
    out["drop_masks"] = draws["drop_masks"][:, :rows]
    out["mixup"] = {k: v[:rows] for k, v in draws["mixup"].items()}
    return out
