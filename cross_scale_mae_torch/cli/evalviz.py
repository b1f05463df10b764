"""Masked-reconstruction figures, metric sweeps and the temporal-consistency
report of pretrain checkpoints, on the GPU.

Counterpart of ``cross_scale_mae_tpu/cli/evalviz.py``, with its flags and
output files: ``<name>_img<i>.png`` per model and image (PIL-drawn, see
``viz/recon.py``), ``metrics.json`` (the sweep) and, with
``--temporal_csv``, ``temporal_gaps.json``, under ``--out``. A model's name
is its run directory's (the parent of ``checkpoints``). The mask noise and
the injected noise come from ``torch.Generator`` draws seeded from
``--seed`` (``viz/recon.torch_draws``), so the sweep's numbers differ from
the JAX CLI's for the same seed. The checkpoint's ``attention_impl``
(``pallas_v3``: the K1f kernel; a variant attention its stock PyTorch ops)
runs the encoder and the decoder. ``--jax_platforms cpu`` runs as
``--device cpu``.

Usage:
    python -m cross_scale_mae_torch.cli.evalviz --ckpt <run>/checkpoints \\
        --images a.jpg b.jpg --metrics mse ssim --noise gaussian --out viz/
    python -m cross_scale_mae_torch.cli.evalviz --ckpt <run>/checkpoints \\
        --device cpu --out viz/                                       # CPU
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from cross_scale_mae_torch.cli.common import apply_jax_platforms
from cross_scale_mae_torch.data.datasets import DATASET_STATS, FmowTemporalDataset
from cross_scale_mae_torch.utils.logging import rank0_print
from cross_scale_mae_torch.viz import (
    plot_reconstruction,
    prepare_image,
    prepare_model,
    run_eval,
    run_one_image,
    temporal_consistency_by_gap,
)


def get_args_parser():
    p = argparse.ArgumentParser("Cross-Scale MAE eval/viz (PyTorch)", add_help=False)
    p.add_argument("--ckpt", required=True, nargs="+",
                   help="checkpoint dir(s); multiple = comparison sweep")
    p.add_argument("--step", default=None, type=int)
    p.add_argument("--images", default=[], nargs="+",
                   help="image files (omit for a synthetic probe image)")
    p.add_argument("--dataset_type", default="fmow_rgb", choices=list(DATASET_STATS))
    p.add_argument("--mask_ratio", default=0.75, type=float)
    p.add_argument("--metrics", default=["mse", "ssim"], nargs="+")
    p.add_argument("--noise", default=[], nargs="+",
                   help="noise kinds: gaussian salt_pepper")
    p.add_argument("--noise_amount", default=0.1, type=float)
    p.add_argument("--out", default="./viz_out")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--temporal_csv", default=None,
                   help="fmow_temporal pairs CSV: adds a time-gap-stratified "
                        "temporal-consistency report (viz/temporal.py) per model")
    p.add_argument("--temporal_batch", default=32, type=int)
    p.add_argument("--temporal_gap_buckets", default=[6, 12, 24], type=int, nargs="+",
                   help="month edges for the gap buckets")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--jax_platforms", default=None,
                   help="the JAX package's platform pin: 'cpu' runs as --device cpu")
    return p


def main(args) -> dict:
    apply_jax_platforms(args)
    device = torch.device(args.device)
    mean, std = DATASET_STATS[args.dataset_type]
    models = {}
    for ckpt in args.ckpt:
        params, _, cfg = prepare_model(ckpt, args.step, device)
        models[os.path.basename(os.path.dirname(ckpt.rstrip("/"))) or ckpt] = (params, cfg)
    any_cfg = next(iter(models.values()))[1]

    # The pairs are read first: a bad or empty CSV fails before any
    # reconstruction, and each distinct input size gets its own decode.
    tds_by_size = {}
    if args.temporal_csv:
        for _, cfg in models.values():
            if cfg.input_size not in tds_by_size:
                tds = FmowTemporalDataset(args.temporal_csv, canvas_size=cfg.input_size)
                if len(tds) == 0:
                    raise SystemExit(f"--temporal_csv {args.temporal_csv}: no pair rows")
                tds_by_size[cfg.input_size] = tds

    if args.images:
        images = [prepare_image(p, any_cfg, mean, std) for p in args.images]
    else:
        rng = np.random.default_rng(args.seed)
        arr = rng.integers(0, 256, (any_cfg.input_size, any_cfg.input_size,
                                    any_cfg.input_channels), np.uint8)
        images = [prepare_image(arr, any_cfg, mean, std)]
    images = [img.to(device) for img in images]

    os.makedirs(args.out, exist_ok=True)
    for name, (params, cfg) in models.items():
        for i, img in enumerate(images):
            gen = torch.Generator(device=device).manual_seed(args.seed)
            noise = torch.rand((img.shape[0], cfg.num_patches), generator=gen, device=device)
            result = run_one_image(params, cfg, img, noise, args.mask_ratio)
            plot_reconstruction(result, os.path.join(args.out, f"{name}_img{i}.png"),
                                mean, std, title=f"{name} loss={result['loss']:.4f}")

    sweep = run_eval(models, images, mean, std, metrics=args.metrics,
                     noise_kinds=[None] + list(args.noise), noise_amount=args.noise_amount,
                     mask_ratio=args.mask_ratio, seed=args.seed)
    if args.temporal_csv:
        sweep["temporal_consistency"] = {
            name: temporal_consistency_by_gap(
                params, cfg, tds_by_size[cfg.input_size], batch_size=args.temporal_batch,
                bucket_edges=tuple(args.temporal_gap_buckets))
            for name, (params, cfg) in models.items()}
        with open(os.path.join(args.out, "temporal_gaps.json"), "w") as f:
            json.dump(sweep["temporal_consistency"], f, indent=2)

    rank0_print(json.dumps(sweep, indent=2))
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(sweep, f, indent=2)
    return sweep


if __name__ == "__main__":
    main(argparse.ArgumentParser(parents=[get_args_parser()]).parse_args())
