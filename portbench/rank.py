"""One rank of a cell on several cards, started by ``portbench/run.py``
(never by hand): the run of ``run.measure`` as rank ``--rank`` of
``--world`` on card ``--rank``, joined at ``localhost:--port``. Rank 0
prints the result's JSON as its last line; a rank that fails exits
non-zero, and the launcher stops the others."""

from __future__ import annotations

import argparse
import json
import sys

from portbench import cell as cells
from portbench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.rank")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int)
    p.add_argument("--rank", required=True, type=int)
    p.add_argument("--world", required=True, type=int)
    p.add_argument("--port", required=True, type=int)
    p.add_argument("--started", required=True, type=float)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    cell = cells.load(run.ROOT, args.workload)
    run.cache_dirs(run.ROOT)
    import torch

    torch.set_num_threads(max(1, run.THREADS // args.world) if args.device == "cpu"
                          else run.THREADS)
    device = (torch.device("cuda", args.rank) if args.device == "cuda"
              else torch.device("cpu"))
    out = run.measure(cell, args.seed, args.seconds, bool(args.trace), device, args.rank,
                      args.world, f"localhost:{args.port}", args.started)
    if run.refuse_forbidden():
        return 3
    if args.rank == 0:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
