"""Serving-artifact export: checkpoint -> ``torch.export`` program.

Counterpart of ``cross_scale_mae_tpu/cli/export.py``, whose StableHLO module
becomes a ``torch.export.save`` archive of the same serving forward: raw
uint8 canvas -> eval preprocess (normalize + center-crop resize) -> the
unmasked encoder and its pooling (a pretrain run) or the classifier's
logits with the BN head's running statistics in eval mode (a finetune or
linprobe run), auto-detected from the checkpoint's config.
``cli/serve.py --artifact`` serves it through ``serving.load_artifact``.

* ``--dataset_type`` picks the normalization stats baked into the program;
  the loader-normalized families skip the on-device normalize.
* The input is the eval canvas (input_size/0.875 for inputs <= 224);
  ``--canvas_scale`` overrides it.
* The attention is the plain version (``attention_impl="xla"``) in place
  of the K1 or K2 kernels, so the program holds no call into a CUDA kernel
  library; a variant attention (linformer, nystrom, orthoformer, local,
  fourier_mix) is exported as itself, its stock PyTorch ops (fourier_mix's
  complex FFT included) traced by ``torch.export``.
* Weights are baked into the program, cast once to the compute dtype, by
  default. ``--no_bake_weights`` exports ``fn(params, imgs)`` and writes the
  fp32 params to ``<output>.params.npz``; ``--quantize int8`` exports
  ``fn(qparams, imgs)`` with the int8 codes and scales in
  ``<output>.q8.npz`` (the dequantize is in the program). Both sidecars
  hold the JAX package's keys and arrays: the JAX layout, block leaves
  stacked, flattened by '/'-joined paths.
* ``--symbolic_batch`` exports with a symbolic batch dimension
  (``torch.export.Dim``): one artifact serves any batch size.
* ``--platforms`` names the device the program is exported for, ``cuda``
  (the default) or ``cpu``; the JAX package's other platforms have no
  counterpart here and are refused. ``serving.load_artifact`` moves a
  program onto another serving device.
* The CLI checks its own artifact: reload, run, and compare with the
  in-process forward (1e-4 in fp32, 3e-2 in bf16); the ``.json`` sidecar
  records the outcome and, for int8, the least cosine similarity of the
  quantized outputs to the full-precision ones on a seeded batch.

Usage:
    python -m cross_scale_mae_torch.cli.export --ckpt <run>/checkpoints \\
        --pool mean --batch_size 64 --output /tmp/encoder.pt2
    python -m cross_scale_mae_torch.cli.export --ckpt params.npz \\
        --platforms cpu --output /tmp/encoder.pt2          # on a CPU host
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

PLATFORMS = ("cuda", "cpu")


def get_args_parser():
    p = argparse.ArgumentParser("Cross-Scale MAE serving export (PyTorch)",
                                add_help=False)
    p.add_argument("--ckpt", required=True,
                   help="npz of save_params_npz or a run's checkpoint directory; "
                        "MAE pretrain -> pooled-feature artifact, finetune/"
                        "linprobe -> class-logits artifact (auto-detected)")
    p.add_argument("--step", default=None, type=int)
    p.add_argument("--output", required=True,
                   help="artifact path (e.g. encoder.pt2)")
    p.add_argument("--pool", default="cls", choices=["cls", "mean", "tokens"])
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--dataset_type", default="fmow_rgb",
                   help="normalization stats baked into the program "
                        "(data/datasets.py DATASET_STATS)")
    p.add_argument("--canvas_scale", default=None, type=float,
                   help="input canvas = input_size * canvas_scale; default "
                        "1/0.875 for input <= 224 (the eval pipeline's "
                        "Resize + CenterCrop), else 1.0")
    p.add_argument("--symbolic_batch", action="store_true",
                   help="symbolic batch dim (serve any batch size)")
    p.add_argument("--no_bake_weights", action="store_true",
                   help="export fn(params, imgs) + params sidecar .npz "
                        "instead of a self-contained program")
    p.add_argument("--platforms", nargs="+", default=None,
                   help="the device the program is exported for: cuda "
                        "(default) or cpu")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="weight-only int8 (quant.py): the codes ship as "
                        "<output>.q8.npz; baked weights only")
    return p


class BakedForward(torch.nn.Module):
    """``forward(imgs)`` with the params held as constants of the program."""

    def __init__(self, forward, params):
        super().__init__()
        self._forward = forward
        self._params = params

    def forward(self, imgs):
        return self._forward(self._params, imgs)


class ParamsForward(torch.nn.Module):
    """``forward(params, imgs)``: the params are the program's argument."""

    def __init__(self, forward):
        super().__init__()
        self._forward = forward

    def forward(self, params, imgs):
        return self._forward(params, imgs)


def _none_like(tree):
    if isinstance(tree, dict):
        return {k: _none_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_none_like(v) for v in tree]
    return None


def export_device(platforms) -> torch.device:
    """--platforms -> the one device the program is exported for."""
    from cross_scale_mae_torch.serving import concrete_device

    platforms = list(platforms or ["cuda"])
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise SystemExit(
            f"--platforms {' '.join(unknown)}: the port exports a torch program for "
            f"one of {PLATFORMS}; the JAX package's other platforms have no "
            "counterpart here")
    if len(platforms) != 1:
        raise SystemExit(
            f"--platforms {' '.join(platforms)}: a torch program is exported for "
            "one device; serving.load_artifact moves it onto another")
    return concrete_device(platforms[0])


def main(args) -> dict:
    from cross_scale_mae_torch.models.mae import compute_dtype
    from cross_scale_mae_torch.quant import quantize_params_int8
    from cross_scale_mae_torch.serving import cast_linears, prepare_serving
    from cross_scale_mae_torch.utils.checkpoint import save_params_npz
    from cross_scale_mae_torch.utils.params import params_to_jax

    if args.quantize == "int8" and args.no_bake_weights:
        raise SystemExit("--quantize already implies sidecar weights "
                         "(the int8 codes ship as <output>.q8.npz); "
                         "drop --no_bake_weights")
    dev = export_device(args.platforms)
    forward, params, cfg, kind, canvas, c = prepare_serving(
        args.ckpt, args.step, pool=args.pool, dataset_type=args.dataset_type,
        canvas_scale=args.canvas_scale, device=dev, portable=True)
    nb = 2 if args.symbolic_batch else args.batch_size
    example = torch.zeros((nb, canvas, canvas, c), dtype=torch.uint8, device=dev)
    batch_dims = {0: torch.export.Dim("batch", min=1)} if args.symbolic_batch else None

    qparams = quant_drift = None
    if args.quantize == "int8":
        qparams = quantize_params_int8(params)
        module, inputs, weights = ParamsForward(forward), (qparams, example), qparams
    elif args.no_bake_weights:
        module, inputs, weights = ParamsForward(forward), (params, example), params
    else:
        module = BakedForward(forward, cast_linears(params, compute_dtype(cfg)))
        inputs, weights = (example,), None
    dynamic = None
    if batch_dims is not None:
        dynamic = ({"imgs": batch_dims} if weights is None
                   else {"params": _none_like(weights), "imgs": batch_dims})
    with torch.no_grad():
        exported = torch.export.export(module, inputs, dynamic_shapes=dynamic)
        if qparams is not None:
            # How far weight-only int8 moved the outputs from full precision
            # (cosine similarity over a seeded batch).
            rng = np.random.default_rng(7)
            probe = torch.from_numpy(rng.integers(0, 256, (nb, canvas, canvas, c),
                                                  np.uint8)).to(dev)
            a = forward(qparams, probe).reshape(nb, -1).double().cpu().numpy()
            b = forward(params, probe).reshape(nb, -1).double().cpu().numpy()
            cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1) + 1e-12)
            quant_drift = {"scheme": "int8_weight_only",
                           "cosine_vs_fp_min": round(float(cos.min()), 6)}

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.export.save(exported, args.output)
    sidecar = None
    if weights is not None:
        sidecar = args.output + (".q8.npz" if qparams is not None else ".params.npz")
        # The JAX layout flattened by '/'-joined paths: the JAX export's keys.
        save_params_npz(sidecar, params_to_jax(weights))

    # Self-check: reload and run against the in-process forward.
    reloaded = torch.export.load(args.output).module()
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (nb, canvas, canvas, c), np.uint8)).to(dev)
    with torch.no_grad():
        got = reloaded(imgs) if weights is None else reloaded(weights, imgs)
        want = forward(weights if weights is not None else params, imgs)
    tol = 1e-4 if cfg.compute_dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)
    out_dim = int(got.shape[-1])

    nbytes = os.path.getsize(args.output)
    meta = {
        "ckpt": args.ckpt,
        "kind": kind,
        "pool": args.pool if kind == "mae" else "n/a (classifier head)",
        "dataset_type": args.dataset_type,
        "input": [None if args.symbolic_batch else args.batch_size, canvas, canvas, c],
        "output_dim": out_dim,
        "bytes": nbytes,
        "platforms": [dev.type],
        "weights": "baked" if sidecar is None else sidecar,
        "quantize": quant_drift,
        "verified": "roundtrip",
        "device": str(dev),
        "model_config": json.loads(cfg.to_json()),
    }
    with open(args.output + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    print(f"exported {args.output} ({nbytes / 1e6:.1f} MB, device={dev}, "
          f"verified=roundtrip)")
    return meta


if __name__ == "__main__":
    main(get_args_parser().parse_args())
