#!/usr/bin/env python3
"""The flagship pretrain step over data parallelism at world size 1 and N:
one process per card through ``cli/pretrain.main``, in both ``--ddp_mode``
semantics, each rank a subprocess joined by ``--coordinator_address``.

    python3 tools/ddp_scaling.py --nproc 4            # one host, 4 GPUs
    python3 tools/ddp_scaling.py --nproc 4 --device cpu --model \\
        mae_vit_tiny_MsLdCeCd --input_size 32 --patch_size 8 \\
        --per_rank_batch 4                            # 4 gloo ranks, CPU

The mesh flags (``--model_parallel``, ``--sequence_parallel``, ``--fsdp``,
``--zero1``, ``--num_slices``) pass through to the runs of world size N.
A layout beyond the data axis (any of them but ``--num_slices``) runs the
gspmd step only: the shard_map step is pure data parallelism and refuses
them. One layout a call:

    python3 tools/ddp_scaling.py --nproc 4 --model_parallel 2 --sequence_parallel

Every run holds ``--per_rank_batch`` images a data rank (the global batch
grows with the data axis, world size / model_parallel) on one repeated
synthetic batch at a constant lr. It fails unless every rank of a run
returns the same losses, finite and falling, and K1's 20 + 20 launches a
step on each card (under tensor parallelism each launch runs the rank's
heads). It prints one line a run (ms per step on rank 0, the steps after
the first; images/s per process and in total; the scaling over world size
1; each rank's peak allocated memory on the GPU and bytes of Adam's
moments) and, on the GPU, the cards' names and power limits.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 900

_RANK = r"""
import json, sys
import torch
from cross_scale_mae_torch.cli import pretrain
from cross_scale_mae_torch.ops.attention import mha_v3
from cross_scale_mae_torch.parallel import dist
runs, build = [], pretrain.build_run
pretrain.build_run = lambda args: runs.append(build(args)) or runs[-1]
res = pretrain.main(pretrain.get_args_parser().parse_args(sys.argv[1:]))
peak = torch.cuda.max_memory_allocated() / 2**20 if torch.cuda.is_available() else None
opt = runs[-1].state.opt_state
print("RESULT " + json.dumps({k: res[k] for k in (
    "rank", "world_size", "steps", "losses", "steady_ms_per_step", "imgs_per_s")}
    | {"launches": [mha_v3.launches, mha_v3.bwd_launches], "peak_mib": peak,
       "moment_bytes": sum(t.numel() * t.element_size() for t in (*opt.mu, *opt.nu))}),
    flush=True)
dist.shutdown()
"""


def _port() -> str:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return str(sock.getsockname()[1])


def mesh_flags(args) -> list[str]:
    """The mesh flags given to the tool, passed through to the runs of
    world size N."""
    flags = ["--num_slices", str(args.num_slices)] if args.num_slices != 1 else []
    if args.model_parallel > 1:
        flags += ["--model_parallel", str(args.model_parallel)]
    return flags + [f"--{f}" for f in ("sequence_parallel", "fsdp", "zero1")
                    if getattr(args, f)]


def beyond_data_axis(args) -> bool:
    """A layout the shard_map step refuses (``cli/pretrain.check_args``)."""
    return args.model_parallel > 1 or args.sequence_parallel or args.fsdp or args.zero1


def run_world(args, world: int, mode: str, out: str, flags: list[str] = ()) -> list[dict]:
    """One run of ``world`` rank processes with the mesh ``flags``; every
    rank's result."""
    tp = int(flags[flags.index("--model_parallel") + 1]) if "--model_parallel" in flags else 1
    batch = args.per_rank_batch * (world // tp)
    argv = ["--model", args.model, "--input_size", str(args.input_size),
            "--patch_size", str(args.patch_size), "--batch_size", str(batch),
            "--synthetic_len", str(batch), "--warmup_epochs", "0", "--epochs", "100000",
            "--max_steps", str(args.steps), "--log_interval", str(args.steps),
            "--ddp_mode", mode, "--device", args.device, "--output_dir", out,
            "--coordinator_address", f"localhost:{_port()}", "--num_processes", str(world),
            *flags]
    if args.device == "cpu":
        argv += ["--compute_dtype", "float32"]
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, *argv, "--process_id", str(r)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise SystemExit(f"world {world} {mode} rank {r} failed:\n{text[-4000:]}")
        results.append(json.loads(
            [ln for ln in text.splitlines() if ln.startswith("RESULT ")][-1][7:]))
    return results


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", default="mae_vit_base_MsLdCeCd")
    p.add_argument("--input_size", type=int, default=128)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--per_rank_batch", type=int, default=384)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--sequence_parallel", action="store_true")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--num_slices", type=int, default=1)
    args = p.parse_args()
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip(), flush=True)
    base: dict[str, float] = {}
    modes = ("gspmd",) if beyond_data_axis(args) else ("gspmd", "shard_map")
    with tempfile.TemporaryDirectory() as tmp:
        for world in (1, args.nproc):
            for mode in modes:
                flags = mesh_flags(args) if world > 1 else []
                res = run_world(args, world, mode, os.path.join(tmp, f"{world}_{mode}"), flags)
                losses = res[0]["losses"]
                if any(r["losses"] != losses for r in res):
                    raise SystemExit(f"world {world} {mode}: the ranks' losses differ")
                if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
                    raise SystemExit(f"world {world} {mode}: losses {losses}")
                if args.device == "cuda" and any(
                        r["launches"] != [20 * args.steps] * 2 for r in res):
                    raise SystemExit(f"world {world} {mode}: K1 launches "
                                     f"{[r['launches'] for r in res]}")
                line = {"world_size": world, "ddp_mode": mode, "flags": flags,
                        "steps": res[0]["steps"], "loss_first": losses[0],
                        "loss_last": losses[-1],
                        "moment_bytes_by_rank": [r["moment_bytes"] for r in res]}
                total = res[0]["imgs_per_s"]
                if total is not None:
                    base.setdefault(mode, total)
                    line |= {"ms_per_step": res[0]["steady_ms_per_step"],
                             "imgs_per_s_total": total, "imgs_per_s_per_process": total / world,
                             "scaling_over_world_1": total / (world * base[mode]),
                             "peak_mib_by_rank": [r["peak_mib"] for r in res]}
                print("[ddp_scaling] " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
