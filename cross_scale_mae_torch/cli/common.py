"""What the port's CLIs share (counterpart of
``cross_scale_mae_tpu/cli/common.py``): the data and runtime flags, the
reference-compat flags and their resolution, the process runtime (one
process per GPU, ``parallel/dist.py``) and its mesh (``--model_parallel``,
``--sequence_parallel``, ``--fsdp``, ``--num_slices``; ``parallel/mesh.py``)
with the JAX package's guards, the attention choice, the loader factory,
run names and the classifier CLIs' ``--resume``."""

from __future__ import annotations

import argparse
import os
from typing import Any, Optional

import numpy as np
import torch

from cross_scale_mae_torch.data.datasets import Dataset
from cross_scale_mae_torch.data.loader import DataLoader
from cross_scale_mae_torch.models.layers import ATTENTION_IMPLS, VARIANTS
from cross_scale_mae_torch.parallel.dist import (
    Runtime,
    broadcast_object,
    init_mesh,
    initialize_distributed,
    is_main_process,
    mesh,
)
from cross_scale_mae_torch.parallel.mesh import Layout
from cross_scale_mae_torch.utils.checkpoint import latest_step, restore_checkpoint
from cross_scale_mae_torch.utils.logging import WANDB_PROJECT, auto_output_dir, rank0_print

# The reference's name for exact attention (main_pretrain.py:101-119).
EXACT_ATTENTION = "scaled_dot_product"


def add_runtime_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("runtime")
    g.add_argument("--seed", default=0, type=int)
    g.add_argument("--output_dir", default="./output_dir")
    g.add_argument("--resume", default="", help="checkpoint directory to resume from (the "
                   "port's, or a JAX run's Orbax one)")
    g.add_argument("--num_workers", default=os.cpu_count() or 4, type=int,
                   help="decode threads of the loader (at least 2)")
    g.add_argument("--log_interval", default=20, type=int)
    g.add_argument("--attention_impl", default=None, choices=list(ATTENTION_IMPLS),
                   help="overrides --attention; pallas_v3 runs the K1 kernels, "
                        "pallas and pallas_t the K2 kernels, xla the plain attention; "
                        "linformer, nystrom, orthoformer, local and fourier_mix the "
                        "variant attentions")
    g.add_argument("--attention", default=EXACT_ATTENTION,
                   choices=[EXACT_ATTENTION, *VARIANTS],
                   help="reference-style attention name (main_pretrain.py:101-119); "
                        "'shunted' maps to modules missing from the reference and is "
                        "not carried")
    g.add_argument("--gelu", default="tanh", choices=["tanh", "exact", "exact_tanhbwd"])
    g.add_argument("--compute_dtype", default="bfloat16")
    g.add_argument("--device", default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu); with a process "
                        "group a bare cuda is this rank's card, cuda:LOCAL_RANK")
    g.add_argument("--remat", action="store_true",
                   help="a layout knob of the JAX package (jax.checkpoint); the port "
                        "runs the same loop for every setting")
    d = p.add_argument_group("data parallel: one process per GPU (parallel/dist.py); "
                             "or launch with torchrun")
    d.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0's rendezvous (tcp://)")
    d.add_argument("--num_processes", default=None, type=int, help="the world size")
    d.add_argument("--process_id", default=None, type=int, help="this process's rank")
    o = p.add_argument_group("logging and profiling (rank 0)")
    o.add_argument("--use_tensorboard", action="store_true",
                   help="TensorBoard scalars under <output_dir>/tb, where tensorboard imports")
    o.add_argument("--use_wandb", action="store_true",
                   help="log to wandb, where wandb imports")
    o.add_argument("--wandb_project", default=WANDB_PROJECT)
    o.add_argument("--wandb_entity", default=None,
                   help="wandb team/entity (main_pretrain.py wandb flags)")
    o.add_argument("--profile_dir", default=None,
                   help="pretraining: a torch.profiler Chrome trace of steps 10-30 of the "
                        "first epoch here, with the step's spans (step, augment, forward, "
                        "backward, exchange, optimizer) on the kernels' timeline")
    o.add_argument("--jax_platforms", default=None,
                   help="the JAX package's platform pin: 'cpu' runs as --device cpu")
    n = p.add_argument_group("runtime, JAX-only and accepted as not applicable")
    n.add_argument("--log_dir", default=None)
    n.add_argument("--device_batch_dtype", default=None)
    m = p.add_argument_group("the mesh: world = (data, model), rank = d * tp + m "
                             "(parallel/dist.py)")
    m.add_argument("--model_parallel", default=1, type=int,
                   help="tensor-parallel mesh axis size (1 = pure DP): Megatron's split, "
                        "each rank running H/tp heads through the attention kernels")
    m.add_argument("--sequence_parallel", action="store_true",
                   help="the residual stream (LayerNorms, adds) sharded over the model "
                        "group between blocks: reduce-scatter and all-gather at the joins; "
                        "needs --model_parallel > 1 and the gspmd step")
    m.add_argument("--fsdp", action="store_true",
                   help="params and optimizer state sharded over the data group, each "
                        "block's gathered just before it runs, gradients reduce-scattered")
    m.add_argument("--num_slices", default=1, type=int,
                   help="the JAX package's multi-slice count: the world must split into "
                        "model_parallel x num_slices; nothing else changes off a TPU")


def add_data_args(p: argparse.ArgumentParser, pretrain: bool,
                  default: str = "fmow_rgb") -> None:
    """The JAX package's data flags: every dataset family, the band flags
    of the multi-band ones (``--masked_bands``, ``--dropped_bands``: raw
    band indices), and pretraining's temporal pairs."""
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
    """The reference launcher flags that the JAX package accepts
    (docs/MIGRATION.md): --output_dir_base, --start_epoch, pretraining's
    --attn_name and --ffn_name and the linear probe's --loss carry meaning;
    the rest are accepted and reported as not applicable, as the JAX
    package reports them. (--device is a runtime flag of the port.)"""
    g = p.add_argument_group("reference compat")
    g.add_argument("--output_dir_base", default=None,
                   help="prepended to --output_dir (main_pretrain.py:467)")
    g.add_argument("--start_epoch", default=None, type=int)
    g.add_argument("--wandb_id", default=None)
    g.add_argument("--pin_mem", action="store_true", dest="_compat_pin_mem")
    g.add_argument("--no_pin_mem", action="store_true", dest="_compat_no_pin_mem")
    g.add_argument("--world_size", default=None, type=int,
                   help="not applicable: use --num_processes or torchrun")
    g.add_argument("--local_rank", default=None, type=int)
    g.add_argument("--dist_url", default=None)
    g.add_argument("--dist_on_itp", action="store_true")
    if role == "pretrain":
        g.add_argument("--attn_name", default=None, help="alias of --attention (train.sh:41)")
        g.add_argument("--ffn_name", default="MLP",
                       help="only MLP is supported (MAE_ViT_Baseline.py:69)")
    else:
        g.add_argument("--model_type", default=None)
        g.add_argument("--transform_checkpoint_keys", action="store_true")
        g.add_argument("--dist_eval", action="store_true")
        g.add_argument("--use_psa", action="store_true")
    if role == "finetune":
        g.add_argument("--resplit", action="store_true", help="dead in the reference (never read)")
    if role == "linprobe":
        g.add_argument("--loss", default="classification_cross",
                       help="must be classification_cross (main_linprobe.py:562-565)")
        g.add_argument("--norm_pix_loss", action="store_true")
    if role in ("pretrain", "linprobe"):
        g.add_argument("--use_xformers", action="store_true")
        g.add_argument("--print_level", default=None, type=int)
        g.add_argument("--spatial_mask", action="store_true")


def apply_reference_compat(args, role: str) -> None:
    """Resolve the compat flags in place (cli/common.py:293-362 of the JAX
    package): --output_dir_base, --jax_platforms, the short dataset names,
    the loaderless dataset types, pretraining's --attn_name and --ffn_name,
    and the linear probe's --loss; report the flags that do not apply
    (the classifier CLIs' --profile_dir among them: they trace nothing, as
    in the JAX package)."""
    if getattr(args, "output_dir_base", None):
        args.output_dir = os.path.join(args.output_dir_base, args.output_dir)
    aliases = {"rgb": "fmow_rgb", "sentinel": "fmow_sentinel"}
    if args.dataset_type in aliases:
        rank0_print(f"--dataset_type {args.dataset_type}: reference classifier-CLI short "
                    f"name, resolved to {aliases[args.dataset_type]}")
        args.dataset_type = aliases[args.dataset_type]
    elif args.dataset_type in ("smart", "spacenetv1", "resisc45"):
        raise ValueError(
            f"--dataset_type {args.dataset_type} is declared by the reference's "
            "classifier parsers but has no loader there either (build_fmow_dataset "
            "raises 'Invalid dataset type'); no data format to be compatible with")
    apply_jax_platforms(args)
    attn_name = getattr(args, "attn_name", None)
    if attn_name is not None:
        # JAX cli/common.py:315-331.
        if attn_name == "shunted":
            raise ValueError("--attn_name shunted maps to modules missing from the reference "
                             "(its defect #1) and is not carried")
        valid = (EXACT_ATTENTION, *VARIANTS)
        if attn_name not in valid:
            raise ValueError(f"--attn_name {attn_name!r}: invalid choice "
                             f"(choose from {', '.join(valid)})")
        args.attention = attn_name
    if getattr(args, "ffn_name", "MLP") != "MLP":
        # The reference's own assert (MAE_ViT_Baseline.py:69-70).
        raise ValueError(f"Feedforward {args.ffn_name} not supported: only MLP")
    if role == "linprobe" and args.loss != "classification_cross":
        raise ValueError("Only classification_cross is supported (main_linprobe.py:562-565)")
    flags = {"pin_mem": "_compat_pin_mem", "no_pin_mem": "_compat_no_pin_mem",
             "world_size": "world_size", "local_rank": "local_rank", "dist_url": "dist_url",
             "dist_on_itp": "dist_on_itp", "model_type": "model_type",
             "transform_checkpoint_keys": "transform_checkpoint_keys",
             "dist_eval": "dist_eval", "use_psa": "use_psa", "use_xformers": "use_xformers",
             "resplit": "resplit",
             "norm_pix_loss": "norm_pix_loss", "print_level": "print_level",
             "spatial_mask": "spatial_mask", "log_dir": "log_dir",
             "device_batch_dtype": "device_batch_dtype", "profile_dir": "profile_dir"}
    if role != "linprobe":
        flags.pop("norm_pix_loss")   # a loss flag of pretraining
    if role == "pretrain":
        flags.pop("profile_dir")     # the classifier CLIs parse it and trace nothing
    ignored = [f for f, attr in flags.items()
               if getattr(args, attr, None) is not None and getattr(args, attr) is not False]
    if ignored:
        rank0_print("reference-compat flags accepted but not applicable here: "
                    + ", ".join(f"--{n}" for n in ignored) + " (see docs/MIGRATION.md)")


def validate_parallel_args(args) -> None:
    """The JAX package's cross-flag checks, before any device work:
    --sequence_parallel needs --model_parallel > 1, and --fsdp and --zero1
    do not go together (:class:`Layout`'s check)."""
    if getattr(args, "sequence_parallel", False) and args.model_parallel <= 1:
        raise SystemExit("--sequence_parallel shards the token axis over the model mesh "
                         "axis — it needs --model_parallel > 1")
    try:
        Layout(zero1=bool(getattr(args, "zero1", False)), fsdp=bool(getattr(args, "fsdp", False)))
    except ValueError as e:
        raise SystemExit(str(e)) from None


def check_model_parallel(tp: int, widths: dict[str, int]) -> None:
    """SystemExit when tensor parallelism cannot split the model: ``tp``
    must divide each attention's heads and each MLP's hidden width
    (``widths``: name -> size)."""
    if tp <= 1:
        return
    for name, size in widths.items():
        if size % tp:
            raise SystemExit(f"--model_parallel {tp} does not divide the {name} ({size}): "
                             "each rank holds a whole 1/tp of the heads and MLP columns")


def run_layout(args) -> Layout:
    """The params' layout the flags ask for, on this run's mesh."""
    mh = mesh()
    return Layout(mh.dp, mh.tp, bool(getattr(args, "zero1", False)),
                  bool(getattr(args, "fsdp", False)))


def run_output_dir(args, run_name: str) -> str:
    """The run directory ``<output_dir>/run_<name>``, ``+N`` when it
    exists (the JAX CLIs' ``auto_output_dir``), chosen by rank 0 and the
    same on every rank."""
    return broadcast_object(auto_output_dir(args.output_dir, run=run_name)
                            if is_main_process() else None)


def apply_jax_platforms(args) -> None:
    """--jax_platforms, the JAX package's platform pin: ``cpu`` runs as
    --device cpu; any other value refuses, naming --device."""
    value = getattr(args, "jax_platforms", None)
    if value is None:
        return
    if value != "cpu":
        raise SystemExit(f"--jax_platforms {value}: this package picks its device with "
                         "--device (cuda, cuda:N or cpu)")
    rank0_print("--jax_platforms cpu: running as --device cpu")
    args.device = "cpu"


def resolve_attention(args, device: torch.device, exact: Optional[str] = None) -> str:
    """--attention_impl wins; else a variant name of --attention is its own
    impl, and the reference name ``scaled_dot_product`` maps to ``exact``
    when given (the CLI's kernels), else to the K1 kernels on the GPU
    (``pallas_v3``, as the JAX package picks its v3 kernel on its
    accelerator) and to the plain attention on the CPU."""
    if args.attention_impl is None:
        if args.attention != EXACT_ATTENTION:
            args.attention_impl = args.attention
        elif exact is not None:
            args.attention_impl = exact
        else:
            args.attention_impl = "pallas_v3" if device.type == "cuda" else "xla"
    return args.attention_impl


def setup_runtime(args) -> Runtime:
    """This process's runtime (counterpart of the JAX package's
    ``setup_runtime``): the process group that --coordinator_address,
    --num_processes and --process_id or the torchrun environment name, on
    NCCL for --device cuda (this rank's card) and gloo for --device cpu;
    without them one process and no group. Then the (data, model) mesh of
    --model_parallel and --num_slices (``parallel/dist.init_mesh``). numpy
    is seeded per rank (JAX cli/common.py:162), and --batch_size, the
    global batch, must split evenly over the data ranks."""
    rt = initialize_distributed(args.coordinator_address, args.num_processes,
                                args.process_id, args.device)
    mh = init_mesh(getattr(args, "model_parallel", 1), getattr(args, "num_slices", 1), rt)
    if args.batch_size % mh.dp:
        raise SystemExit(f"--batch_size {args.batch_size} does not split over "
                         f"{mh.dp} data rank(s)")
    np.random.seed(args.seed + rt.rank)
    return rt


def make_loader(args, dataset: Dataset, batch_size: int, rt: Runtime, *,
                is_train: bool = True, seed: int = 0) -> DataLoader:
    """``batch_size`` rows per rank from its data index's strided shard of
    the epoch order (the JAX loader's ``shard_id``/``num_shards``; the ranks
    of one model group read the same rows); shuffled with drop_last for
    training, in order and whole for eval; decoded by the native core where
    it applies (``DataLoader.backend``)."""
    tp = mesh().tp   # rank = d * tp + m
    return DataLoader(dataset, batch_size, shuffle=is_train, seed=seed, drop_last=is_train,
                      num_threads=max(2, args.num_workers), shard_id=rt.rank // tp,
                      num_shards=rt.world_size // tp)


def restore_classifier_run(args, state) -> tuple[Any, int, float]:
    """--resume of the classifier CLIs (cli/common.py:183-203 of the JAX
    package; util/misc.py:382-411): the newest checkpoint of the
    directory (the port's ``state.pt`` or a JAX run's Orbax step, whose
    AdamW or LARS state must have the structure of this run's optimizer
    options) restored into ``state`` in place, the epoch after its
    ``epoch`` to start from, and its ``max_acc``; --start_epoch, where the
    CLI has it, wins when given. Returns (state, start_epoch, max_acc),
    (state, 0, 0.0) without either flag; a --resume directory with no
    checkpoint raises FileNotFoundError."""
    start_epoch, max_acc = 0, 0.0
    if args.resume:
        if latest_step(args.resume) is None:
            raise FileNotFoundError(f"--resume: no checkpoints in {args.resume}")
        state, meta = restore_checkpoint(args.resume, state)
        start_epoch = int(meta.get("epoch", 0)) + 1
        max_acc = float(meta.get("max_acc", 0.0))
        rank0_print(f"resumed from {args.resume}: epoch {start_epoch}, "
                    f"max_acc {max_acc:.2f}%")
    if getattr(args, "start_epoch", None) is not None:
        start_epoch = args.start_epoch   # the reference's flag wins when given
    return state, start_epoch, max_acc


def encode_run_name(**config: Any) -> str:
    """Config-encoded run identity (main_pretrain.py:450-463)."""
    return "-".join(f"{k}_{v}" for k, v in config.items() if v is not None)
