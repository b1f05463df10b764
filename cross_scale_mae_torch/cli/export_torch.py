"""Checkpoint interchange: a run of the port -> the reference's ``.pth``.

Counterpart of ``cross_scale_mae_tpu/cli/export_torch.py``: a pretrain run
exports as an MAE ``.pth`` that the reference's ``main_finetune.py`` /
``main_linprobe.py`` key-remap like their own pretrain checkpoints, and
``util/viz.py:prepare_model`` rebuilds from the stored ``args``; a finetune
or linprobe run exports as a ``models_vit`` classifier ``.pth``
(auto-detected from the config). Format in ``utils/torch_export.py``. Runs
on the CPU: nothing is computed.

Usage:
    python -m cross_scale_mae_torch.cli.export_torch \\
        --ckpt <run>/checkpoints --output /tmp/checkpoint-399.pth
    python -m cross_scale_mae_torch.cli.export_torch \\
        --ckpt pretrain/params.npz --output /tmp/checkpoint.pth
"""

from __future__ import annotations

import argparse
import json
import os


def get_args_parser():
    p = argparse.ArgumentParser("Cross-Scale MAE torch-checkpoint export", add_help=False)
    p.add_argument("--ckpt", required=True,
                   help="a run's checkpoint directory or an npz of save_params_npz "
                        "(config travels with it); pretrain runs export as MAE .pth, "
                        "finetune/linprobe runs as models_vit classifier .pth "
                        "(auto-detected)")
    p.add_argument("--step", default=None, type=int,
                   help="checkpoint step (default: newest)")
    p.add_argument("--output", required=True, help="output .pth path")
    p.add_argument("--epoch", default=None, type=int,
                   help="epoch number stored in the .pth (reference resume "
                        "semantics); default: the checkpoint's epoch if "
                        "recorded, else 0")
    p.add_argument("--model_name", default=None,
                   help="override the reference factory name stored in "
                        "args (required for off-registry custom sizes)")
    return p


def main(args) -> dict:
    from cross_scale_mae_torch.configs import MAEConfig
    from cross_scale_mae_torch.utils.checkpoint import (
        checkpoint_kind,
        checkpoint_meta,
        classifier_from_host,
        read_host_checkpoint,
    )
    from cross_scale_mae_torch.utils.params import params_from_jax, state_from_jax
    from cross_scale_mae_torch.utils.torch_export import (
        classifier_args,
        classifier_state_dict,
        mae_state_dict,
        reference_args,
        save_torch_checkpoint,
    )

    config, tree, state, step = read_host_checkpoint(args.ckpt, args.step)
    if checkpoint_kind({"config": config}) == "classifier":
        params, model_state, cfg = classifier_from_host(config, tree, state)
        sd = classifier_state_dict(params, cfg, model_state)
        ref_args = classifier_args(cfg, args.model_name)
    else:
        cfg = MAEConfig.from_json(json.dumps(config))
        params = params_from_jax(tree, cfg, full=True)
        model_state = state_from_jax(state, cfg) if state else None
        sd = mae_state_dict(params, cfg, model_state)
        ref_args = reference_args(cfg, args.model_name)
    meta = checkpoint_meta(args.ckpt, step) if step is not None else {}
    epoch = args.epoch if args.epoch is not None else int(meta.get("epoch", 0))
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    save_torch_checkpoint(args.output, sd, ref_args, epoch=epoch)
    result = {"output": args.output, "model": ref_args["model"], "epoch": epoch,
              "n_tensors": len(sd), "size_bytes": os.path.getsize(args.output)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(get_args_parser().parse_args())
