"""Embedding extraction: the encoder's features for a whole dataset, on the
GPU.

Counterpart of ``cross_scale_mae_tpu/cli/embed.py``: the unmasked encoder
(``models/mae.mae_encode``, with the checkpoint's ``attention_impl``:
``pallas_v3`` runs the K1f kernel, a variant its stock PyTorch ops;
``--attention_impl`` swaps only among the exact attention's impls) over one split of any dataset family,
read in dataset order through ``data/loader.DataLoader`` (the native core
where it applies). The ragged last batch is padded to the static batch and
its padded rows dropped. Writes ``features.npy`` (count x dim float32, or
count x tokens x dim with ``--pool tokens``), ``labels.npy`` and
``meta.json`` into ``--output_dir``. ``--data_parallel`` runs one replica of
the encoder per visible card, each batch's rows split evenly over them
(the JAX package's batch sharding over its mesh). Every process of a
process group featurizes the whole split and rank 0 writes, as in the JAX
package.

Usage:
    python -m cross_scale_mae_torch.cli.embed --ckpt <run>/checkpoints \\
        --dataset_type fmow_rgb --test_path val.csv --pool cls \\
        --output_dir feats/
    python -m cross_scale_mae_torch.cli.embed --ckpt params.npz \\
        --dataset_type synthetic --synthetic_len 50 --batch_size 32 \\
        --device cpu --output_dir feats/                          # CPU
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from cross_scale_mae_torch.cli.common import (
    add_data_args,
    add_runtime_args,
    apply_jax_platforms,
)
from cross_scale_mae_torch.models.layers import VARIANTS
from cross_scale_mae_torch.utils.logging import rank0_print

# Flags of the shared runtime group that embedding has no use for: the
# checkpoint's config fixes the model, nothing trains, resumes or logs.
NOT_APPLICABLE = ("resume", "log_interval", "attention", "gelu", "compute_dtype",
                  "log_dir", "device_batch_dtype", "remat", "use_tensorboard", "use_wandb",
                  "wandb_project", "wandb_entity", "profile_dir")


def get_args_parser():
    p = argparse.ArgumentParser("Cross-Scale MAE embeddings (PyTorch)", add_help=False)
    p.add_argument("--ckpt", required=True,
                   help="pretrain checkpoint: an npz of save_params_npz or a run's "
                        "checkpoint directory (config travels with it)")
    p.add_argument("--step", default=None, type=int)
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--pool", default="cls", choices=["cls", "mean", "tokens"],
                   help="cls token | mean of patch tokens | all tokens")
    p.add_argument("--split", default="test", choices=["train", "test"],
                   help="which split path to featurize (dataset order)")
    p.add_argument("--data_parallel", action="store_true",
                   help="one replica of the encoder per visible card, each batch's "
                        "rows split evenly over them")
    add_runtime_args(p)
    add_data_args(p, pretrain=True)
    # None = not given, so that a given one is reported as not applicable.
    p.set_defaults(gelu=None, compute_dtype=None, attention=None, log_interval=None,
                   wandb_project=None)
    return p


def check_attention_swap(trained: str, asked: str) -> None:
    """SystemExit unless --attention_impl swaps one way of computing exact
    attention for another (xla, the K1 or the K2 kernels): a variant
    attention is another model, so a variant checkpoint cannot run exact
    attention, nor an exact one a variant, nor one variant another."""
    if trained != asked and (trained in VARIANTS or asked in VARIANTS):
        raise SystemExit(
            f"--attention_impl {asked}: the checkpoint was trained with attention_impl "
            f"{trained}; only the exact attention's impls (xla, pallas, pallas_t, "
            "pallas_v3) swap for one another")


def main(args) -> dict:
    import torch

    from cross_scale_mae_torch.configs import MAEConfig
    from cross_scale_mae_torch.data import DataLoader, build_dataset
    from cross_scale_mae_torch.models.mae import compute_dtype, mae_encode
    from cross_scale_mae_torch.ops.augment import make_eval_preprocess
    from cross_scale_mae_torch.parallel.dist import (
        init_mesh,
        initialize_distributed,
        is_main_process,
    )
    from cross_scale_mae_torch.serving import (
        cast_linears,
        pool_features,
        replicated_fn,
        serving_devices,
        to_device,
    )
    from cross_scale_mae_torch.utils.checkpoint import checkpoint_kind, read_host_checkpoint
    from cross_scale_mae_torch.utils.params import params_from_jax

    apply_jax_platforms(args)
    ignored = [f for f in NOT_APPLICABLE if getattr(args, f, None) not in (None, False, "")]
    if ignored:
        rank0_print("flags accepted but not applicable here: "
                    + ", ".join(f"--{f}" for f in ignored)
                    + " (the checkpoint's config fixes the model)")
    initialize_distributed(args.coordinator_address, args.num_processes,
                           args.process_id, args.device)
    # The JAX CLI's mesh: its check, and nothing else (the encoder's params
    # are replicated there, each process featurizing the whole split).
    init_mesh(args.model_parallel, args.num_slices)
    config, tree, _state, _ = read_host_checkpoint(args.ckpt, args.step)
    if checkpoint_kind({"config": config}) != "mae":
        raise SystemExit(
            f"{args.ckpt} is a finetune/linprobe (classifier) checkpoint; embed "
            "featurizes with a pretrain run's encoder: serve a classifier with cli/serve")
    cfg = MAEConfig.from_json(json.dumps(config))
    if args.attention_impl is not None:
        check_attention_swap(cfg.attention_impl, args.attention_impl)
        cfg = cfg.replace(attention_impl=args.attention_impl)
    ds = build_dataset(
        args.dataset_type, args.split == "train",
        train_path=args.train_path, test_path=args.test_path,
        input_size=cfg.input_size, canvas_scale=args.canvas_scale,
        masked_bands=args.masked_bands, dropped_bands=args.dropped_bands,
        synthetic_len=args.synthetic_len,
    )
    if ds.in_c != cfg.input_channels:
        raise SystemExit(f"dataset has {ds.in_c} channels but the checkpointed model "
                         f"expects {cfg.input_channels}")
    devs = serving_devices(args.device, args.data_parallel)
    bs = args.batch_size
    if bs % len(devs):
        raise SystemExit(f"--batch_size {bs} must be divisible by the device count "
                         f"{len(devs)} for data-parallel embedding")
    params = cast_linears(params_from_jax(tree, cfg, "cpu"), compute_dtype(cfg))
    replicas = [to_device(params, d) for d in devs]
    del params, tree
    preprocess = make_eval_preprocess(ds.mean, ds.std, cfg.input_size,
                                      normalize=ds.normalize_on_device,
                                      dtype=cfg.compute_dtype)

    def embed(p, imgs: torch.Tensor) -> torch.Tensor:
        return pool_features(mae_encode(p, cfg, preprocess(imgs)), args.pool)

    step = replicated_fn(embed, replicas, devs)
    # Every process featurizes the whole split in dataset order and rank 0
    # writes (the JAX CLI's num_shards=1).
    loader = DataLoader(ds, bs, shuffle=False, drop_last=False,
                        num_threads=max(2, args.num_workers), seed=args.seed,
                        shard_id=0, num_shards=1)
    chunks, label_chunks, total, batches = [], [], 0, 0
    t0 = time.perf_counter()
    for imgs, labels in loader.epoch(0):
        n = len(labels)
        if n < bs:  # pad the ragged tail to the static batch
            imgs = np.concatenate([imgs, np.zeros((bs - n,) + imgs.shape[1:], imgs.dtype)])
        chunks.append(step(imgs)[:n])
        label_chunks.append(labels[:n])
        total += n
        batches += 1
    feats = np.concatenate(chunks) if chunks else np.zeros((0,))
    labels = np.concatenate(label_chunks) if label_chunks else np.zeros((0,))
    dt = time.perf_counter() - t0
    rate = round(total / max(dt, 1e-9), 1)
    if is_main_process():
        os.makedirs(args.output_dir, exist_ok=True)
        np.save(os.path.join(args.output_dir, "features.npy"), feats)
        np.save(os.path.join(args.output_dir, "labels.npy"), labels)
        with open(os.path.join(args.output_dir, "meta.json"), "w") as f:
            json.dump({"ckpt": args.ckpt, "pool": args.pool, "count": int(total),
                       "shape": list(feats.shape), "imgs_per_sec": rate}, f, indent=2)
    rank0_print(f"embedded {total} images -> {feats.shape} in {dt:.1f}s "
                f"({total / max(dt, 1e-9):.0f} imgs/s; loader {loader.backend})")
    return {"count": total, "shape": feats.shape, "batches": batches,
            "imgs_per_sec": rate, "devices": [str(d) for d in devs]}


if __name__ == "__main__":
    from cross_scale_mae_torch.parallel.dist import shutdown

    try:
        main(get_args_parser().parse_args())
    finally:
        shutdown()
