"""What the port's CLIs share (counterpart of
``cross_scale_mae_tpu/cli/common.py``): the data and runtime flags, the
reference-compat flags and their resolution, the attention choice, the
loader factory, run names, and the refusal of flags not ported yet."""

from __future__ import annotations

import argparse
import os
from typing import Any

import torch

from cross_scale_mae_torch.data.datasets import UNPORTED_DATASETS, Dataset
from cross_scale_mae_torch.data.loader import DataLoader

# Runtime flags of the JAX CLIs that the port parses but does not run yet:
# flag -> ROADMAP.md queue 1 item (9 checkpoints and resume, 11 DDP/TP/SP,
# 16 logging and profiling).
UNPORTED_RUNTIME = {
    "resume": 9, "model_parallel": 11, "sequence_parallel": 11, "fsdp": 11,
    "coordinator_address": 11, "num_processes": 11, "process_id": 11,
    "use_tensorboard": 16, "use_wandb": 16, "profile_dir": 16,
}


def add_runtime_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("runtime")
    g.add_argument("--seed", default=0, type=int)
    g.add_argument("--output_dir", default="./output_dir")
    g.add_argument("--num_workers", default=os.cpu_count() or 4, type=int,
                   help="decode threads of the loader (at least 2)")
    g.add_argument("--log_interval", default=20, type=int)
    g.add_argument("--attention_impl", default=None,
                   choices=["xla", "pallas", "pallas_t", "pallas_v3"],
                   help="overrides --attention; pallas_v3 runs the K1 kernels, "
                        "pallas and pallas_t the K2 kernels, xla the plain attention")
    g.add_argument("--attention", default="scaled_dot_product",
                   choices=["scaled_dot_product"],
                   help="reference-style attention name (main_pretrain.py:101-119); "
                        "the variants are not ported yet (ROADMAP.md, queue 1 item 13)")
    g.add_argument("--gelu", default="tanh", choices=["tanh", "exact", "exact_tanhbwd"])
    g.add_argument("--compute_dtype", default="bfloat16")
    g.add_argument("--device", default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu)")
    u = p.add_argument_group("runtime, not ported yet (ROADMAP.md)")
    for flag in ("resume", "coordinator_address", "profile_dir"):
        u.add_argument(f"--{flag}", default=None)
    for flag in ("model_parallel", "num_processes", "process_id"):
        u.add_argument(f"--{flag}", default=None, type=int)
    for flag in ("sequence_parallel", "fsdp", "use_tensorboard", "use_wandb"):
        u.add_argument(f"--{flag}", action="store_true")


def add_data_args(p: argparse.ArgumentParser, pretrain: bool,
                  default: str = "fmow_rgb") -> None:
    """The JAX package's data flags. Every family of its choices parses;
    ``build_dataset`` refuses those the port does not read yet."""
    g = p.add_argument_group("data")
    choices = ["fmow_rgb", "coco", "euro_sat", "fmow_sentinel", "naip", "synthetic"]
    if pretrain:
        choices += ["fmow_temporal"]
    else:
        # The reference classifier parsers' short names, resolved in
        # apply_reference_compat, and its declared-but-loaderless types.
        choices += ["rgb", "sentinel", "smart", "spacenetv1", "resisc45"]
    g.add_argument("--dataset_type", default=default, choices=choices)
    g.add_argument("--train_path", default="", help="csv/txt/dir per dataset type")
    g.add_argument("--test_path", default="")
    g.add_argument("--masked_bands", default=None, type=int, nargs="+")
    g.add_argument("--dropped_bands", default=None, type=int, nargs="+")
    g.add_argument("--synthetic_len", default=4096, type=int)
    g.add_argument("--canvas_scale", default=1.0, type=float,
                   help="host decode canvas / input_size")
    if not pretrain:
        g.add_argument("--nb_classes", default=62, type=int)


def add_reference_compat_args(p: argparse.ArgumentParser, role: str) -> None:
    """The reference launcher flags of the classifier CLIs that the JAX
    package accepts (docs/MIGRATION.md): --output_dir_base and the linear
    probe's --loss carry meaning; the rest are accepted and reported as not
    applicable. (--device is a runtime flag of the port.)"""
    g = p.add_argument_group("reference compat")
    g.add_argument("--output_dir_base", default=None,
                   help="prepended to --output_dir (main_pretrain.py:467)")
    g.add_argument("--start_epoch", default=None, type=int)
    g.add_argument("--wandb_id", default=None)
    g.add_argument("--pin_mem", action="store_true", dest="_compat_pin_mem")
    g.add_argument("--no_pin_mem", action="store_true", dest="_compat_no_pin_mem")
    g.add_argument("--world_size", default=None, type=int)
    g.add_argument("--local_rank", default=None, type=int)
    g.add_argument("--dist_url", default=None)
    g.add_argument("--dist_on_itp", action="store_true")
    g.add_argument("--model_type", default=None)
    g.add_argument("--transform_checkpoint_keys", action="store_true")
    g.add_argument("--dist_eval", action="store_true")
    g.add_argument("--use_psa", action="store_true")
    if role == "linprobe":
        g.add_argument("--loss", default="classification_cross",
                       help="must be classification_cross (main_linprobe.py:562-565)")
        g.add_argument("--use_xformers", action="store_true")
        g.add_argument("--norm_pix_loss", action="store_true")
        g.add_argument("--print_level", default=None, type=int)
        g.add_argument("--spatial_mask", action="store_true")


def apply_reference_compat(args, role: str) -> None:
    """Resolve the compat flags in place (cli/common.py:293-362 of the JAX
    package): --output_dir_base, the short dataset names, the loaderless
    dataset types, and the linear probe's --loss."""
    if getattr(args, "output_dir_base", None):
        args.output_dir = os.path.join(args.output_dir_base, args.output_dir)
    aliases = {"rgb": "fmow_rgb", "sentinel": "fmow_sentinel"}
    if args.dataset_type in aliases:
        print(f"--dataset_type {args.dataset_type}: reference classifier-CLI short name, "
              f"resolved to {aliases[args.dataset_type]}", flush=True)
        args.dataset_type = aliases[args.dataset_type]
    elif args.dataset_type in ("smart", "spacenetv1", "resisc45"):
        raise ValueError(
            f"--dataset_type {args.dataset_type} is declared by the reference's "
            "classifier parsers but has no loader there either (build_fmow_dataset "
            "raises 'Invalid dataset type'); no data format to be compatible with")
    if role == "linprobe" and args.loss != "classification_cross":
        raise ValueError("Only classification_cross is supported (main_linprobe.py:562-565)")
    flags = {"pin_mem": "_compat_pin_mem", "no_pin_mem": "_compat_no_pin_mem",
             "world_size": "world_size", "local_rank": "local_rank", "dist_url": "dist_url",
             "dist_on_itp": "dist_on_itp", "model_type": "model_type",
             "transform_checkpoint_keys": "transform_checkpoint_keys",
             "dist_eval": "dist_eval", "use_psa": "use_psa", "use_xformers": "use_xformers",
             "norm_pix_loss": "norm_pix_loss", "print_level": "print_level",
             "spatial_mask": "spatial_mask"}
    ignored = [f for f, attr in flags.items() if getattr(args, attr, None) not in (None, False)]
    if ignored:
        print("reference-compat flags accepted but not applicable here: "
              + ", ".join(f"--{n}" for n in ignored) + " (see docs/MIGRATION.md)", flush=True)


def refuse_unported(args, flags: dict[str, int]) -> None:
    """SystemExit naming the ROADMAP.md item for the first flag of ``flags``
    (flag -> queue 1 item) that is set, or for a dataset family the port
    does not read yet."""
    for flag, item in flags.items():
        if getattr(args, flag, None) not in (None, False):
            raise SystemExit(f"--{flag} is not ported yet; see ROADMAP.md (queue 1 item {item})")
    if args.dataset_type in UNPORTED_DATASETS:
        raise SystemExit(
            f"--dataset_type {args.dataset_type}: the TIFF datasets and the temporal pairs "
            "are not ported yet; see ROADMAP.md (queue 1 item "
            f"{UNPORTED_DATASETS[args.dataset_type]})")


def resolve_attention(args, device: torch.device) -> str:
    """--attention_impl wins; else the reference name ``scaled_dot_product``
    maps to the K1 kernels on the GPU (``pallas_v3``, as the JAX package
    picks its v3 kernel on its accelerator) and to the plain attention on
    the CPU."""
    if args.attention_impl is None:
        args.attention_impl = "pallas_v3" if device.type == "cuda" else "xla"
    return args.attention_impl


def make_loader(args, dataset: Dataset, batch_size: int, *, is_train: bool = True,
                seed: int = 0) -> DataLoader:
    """Shuffled with drop_last for training, in order and whole for eval;
    one shard of one until DDP lands (ROADMAP.md, queue 1 item 11)."""
    return DataLoader(dataset, batch_size, shuffle=is_train, seed=seed, drop_last=is_train,
                      num_threads=max(2, args.num_workers), shard_id=0, num_shards=1)


def encode_run_name(**config: Any) -> str:
    """Config-encoded run identity (main_pretrain.py:450-463)."""
    return "-".join(f"{k}_{v}" for k, v in config.items() if v is not None)
