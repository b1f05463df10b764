"""Masked-reconstruction figures and metric sweeps (counterpart of
``cross_scale_mae_tpu/viz/recon.py``; the reference's ``util/viz.py``).

A checkpoint rebuilds its model from the config it carries
(:func:`prepare_model`), one image or a batch is reconstructed from given
mask noise (:func:`run_one_image`), drawn as four panels
(:func:`plot_reconstruction`), and several models are scored over metrics
and input noise (:func:`run_eval`). Randomness is an input: the mask noise
and the injected noise are tensors; :func:`run_eval` takes them from a
``draws`` hook, by default from a ``torch.Generator`` per image.

The figure is drawn with PIL, not matplotlib: the four panels side by side
at the image's resolution, each ``round(clip(x * std + mean, 0, 1) * 255)``
in uint8, the title in a PNG text chunk. It has no axes or captions.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cross_scale_mae_torch.configs import MAEConfig
from cross_scale_mae_torch.models.mae import mae_apply
from cross_scale_mae_torch.ops.image import normalize_images
from cross_scale_mae_torch.ops.patchify import unpatchify
from cross_scale_mae_torch.utils.checkpoint import (
    checkpoint_kind,
    checkpoint_meta,
    restore_arrays_host,
)
from cross_scale_mae_torch.utils.metrics import calc_metric
from cross_scale_mae_torch.utils.params import params_from_jax, state_from_jax

PANELS = ("original", "masked", "recon", "paste")
PANEL_TITLES = ("original", "masked", "reconstruction", "recon + visible")


def prepare_model(ckpt_dir: str, step: Optional[int] = None,
                  device: torch.device | str = "cpu") -> tuple[dict, dict, MAEConfig]:
    """(params, model_state, cfg) of a pretrain checkpoint directory, the
    port's or a JAX run's Orbax one (the newest step, or ``step``), rebuilt from the config its sidecar
    carries (util/viz.py:27-89), on ``device``. Only the params and the
    model state are read, as host arrays: the optimizer's layout does not
    matter."""
    restored, step = restore_arrays_host(ckpt_dir, step)
    meta = checkpoint_meta(ckpt_dir, step)
    if "config" not in meta:
        raise ValueError(f"{ckpt_dir} has no config sidecar meta-{step}.json")
    if checkpoint_kind(meta) != "mae":
        raise SystemExit(
            f"{ckpt_dir} is a finetune/linprobe (classifier) checkpoint; "
            "this surface rebuilds MAE pretrain runs — use cli/export or "
            "cli/serve for classifier checkpoints")
    cfg = MAEConfig.from_json(json.dumps(meta["config"]))
    params = params_from_jax(restored["params"], cfg, device, full=True)
    model_state = state_from_jax(restored.get("model_state", {}), cfg, device)
    return params, model_state, cfg


def prepare_image(path_or_array, cfg: MAEConfig, mean: Sequence[float],
                  std: Sequence[float]) -> torch.Tensor:
    """An image file (converted to RGB, bicubic to ``input_size``) or a
    uint8 (H, W, C) array -> a normalized (1, H, W, C) fp32 CPU batch
    (util/viz.py:92-121)."""
    if isinstance(path_or_array, (str, os.PathLike)):
        from PIL import Image

        with Image.open(path_or_array) as im:
            arr = np.asarray(im.convert("RGB").resize(
                (cfg.input_size, cfg.input_size), Image.BICUBIC))
    else:
        arr = np.asarray(path_or_array)
    x = torch.from_numpy(arr.astype(np.float32) / 255.0)
    return normalize_images(x, mean, std)[None]


def add_noise(img: torch.Tensor, draw: torch.Tensor, kind: str = "gaussian",
              amount: float = 0.1) -> torch.Tensor:
    """Input noise for the robustness sweeps (util/viz.py:123-137), from a
    given draw: standard normal of ``img``'s shape for ``gaussian``, uniform
    [0, 1) of its shape without the channel axis for ``salt_pepper`` (a
    pixel below amount / 2 becomes the image's min, above 1 - amount / 2
    its max, every channel)."""
    if kind == "gaussian":
        return img + amount * draw.to(img.dtype)
    if kind == "salt_pepper":
        u = draw[..., None]
        img = torch.where(u < amount / 2, img.min(), img)
        return torch.where(u > 1 - amount / 2, img.max(), img)
    raise ValueError(f"unknown noise kind {kind!r}")


@torch.no_grad()
def run_one_image(params: dict, cfg: MAEConfig, img: torch.Tensor, noise: torch.Tensor,
                  mask_ratio: Optional[float] = None) -> dict:
    """Masked reconstruction of a normalized (N, H, W, C) batch with the
    (N, L) mask ``noise`` (util/viz.py:141-206): the original, the mask
    (1 = reconstructed), the masked input, the reconstruction and the
    reconstruction pasted into the visible patches, as fp32 NHWC numpy
    arrays in normalized space, and the loss."""
    if mask_ratio is not None:
        cfg = cfg.replace(mask_ratio=mask_ratio)
    out = mae_apply(params, cfg, img, noise=noise)
    recon = unpatchify(out.pred.float(), cfg.patch_size, cfg.input_channels).cpu().numpy()
    mask = unpatchify(out.mask[:, :, None].expand(*out.mask.shape, cfg.patch_dim).float(),
                      cfg.patch_size, cfg.input_channels).cpu().numpy()
    img_np = img.float().cpu().numpy()
    return {"original": img_np, "mask": mask, "masked": img_np * (1 - mask),
            "recon": recon, "paste": img_np * (1 - mask) + recon * mask,
            "loss": float(out.loss)}


def panel_uint8(x: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """One (H, W, C) panel as the figure stores it."""
    x = np.clip(x * np.asarray(std) + np.asarray(mean), 0, 1)
    return np.round(x * 255).astype(np.uint8)


def plot_reconstruction(result: dict, save_path: str, mean: Sequence[float],
                        std: Sequence[float], title: str = "") -> None:
    """The four panels of the first image of ``result`` left to right
    (original, masked, reconstruction, recon + visible; util/viz.py:231-316)
    as one PNG, the title in its ``Title`` text chunk. A 1-channel image is
    grey; of more than 3 channels the first three are drawn."""
    from PIL import Image
    from PIL.PngImagePlugin import PngInfo

    strip = np.concatenate([panel_uint8(result[k][0], mean, std) for k in PANELS], axis=1)
    if strip.shape[-1] == 1:
        image = Image.fromarray(strip[..., 0], "L")
    else:
        image = Image.fromarray(np.ascontiguousarray(strip[..., :3]), "RGB")
    info = PngInfo()
    info.add_text("Title", title)
    info.add_text("Panels", ", ".join(PANEL_TITLES))
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    image.save(save_path, pnginfo=info)


def torch_draws(seed: int, device: torch.device | str = "cpu") -> Callable:
    """The default ``draws`` of :func:`run_eval`: for image i, a generator
    seeded ``seed * 7919 + i`` gives the mask noise first (so every noise
    kind of one image sees the same mask), then the noise draw."""
    def draws(i: int, kind: Optional[str], img: torch.Tensor, cfg: MAEConfig):
        gen = torch.Generator(device=device).manual_seed(seed * 7919 + i)
        mask_noise = torch.rand((img.shape[0], cfg.num_patches), generator=gen, device=device)
        if kind is None:
            return None, mask_noise
        shape = img.shape if kind == "gaussian" else img.shape[:-1]
        draw = (torch.randn if kind == "gaussian" else torch.rand)(
            shape, generator=gen, device=device)
        return draw, mask_noise

    return draws


def run_eval(models: dict, images: Sequence[torch.Tensor], mean: Sequence[float],
             std: Sequence[float], metrics: Sequence[str] = ("mse", "ssim"),
             noise_kinds: Sequence[Optional[str]] = (None,), noise_amount: float = 0.1,
             mask_ratio: float = 0.75, seed: int = 0,
             draws: Optional[Callable] = None) -> dict[str, dict[str, float]]:
    """The model x metric x noise sweep (util/viz.py:319-498). ``models``:
    name -> (params, cfg). ``draws(i, kind, img, cfg)`` gives image i's
    noise draw for ``kind`` (None without noise) and its (N, L) mask noise
    (default :func:`torch_draws` of ``seed`` on the images' device).
    Returns name -> {metric or metric_kind: mean over the images}, computed
    on the [0, 1] original and paste."""
    mean_a, std_a = np.asarray(mean), np.asarray(std)
    results = {}
    for name, (params, cfg) in models.items():
        scores: dict[str, list[float]] = {}
        for i, img in enumerate(images):
            hook = draws or torch_draws(seed, img.device)
            for kind in noise_kinds:
                draw, mask_noise = hook(i, kind, img, cfg)
                x = img if kind is None else add_noise(img, draw, kind, noise_amount)
                out = run_one_image(params, cfg, x, mask_noise, mask_ratio)
                orig01 = np.clip(out["original"] * std_a + mean_a, 0, 1)
                paste01 = np.clip(out["paste"] * std_a + mean_a, 0, 1)
                for m in metrics:
                    key = m if kind is None else f"{m}_{kind}"
                    scores.setdefault(key, []).append(calc_metric(orig01, paste01, m))
        results[name] = {k: float(np.mean(v)) for k, v in scores.items()}
    return results
