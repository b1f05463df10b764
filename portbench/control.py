"""The readings that a cell's limits are set from, at the cell's own size:
for each seed the program's three numbers (a sound run of the first three
steps, through the same call and feed as ``portbench/run.py``), the
control's (the reference computed with float8 products in the program's
place), and the faults' (half of each batch left out, the mean taken over
the rest, planted in the reference put in the program's place; a state
left unchanged, which reads 1 by the measure and needs no run). One JSON
line a seed, then the largest program reading and the smallest of the
others, number by number.

    python -m portbench.control --workload <name> --seeds 11 12 13 ...

The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from portbench import cell as cells
from portbench import compare
from portbench.run import READINGS, ROOT, THREADS, cache_dirs, warm_up


def readings(cell, seed: int, device) -> dict[str, dict]:
    """One seed's numbers. A cell on several cards gets the reference-side
    ones only, on this one card: its program's readings, and those of the
    program with its gradient exchange left out (the task of
    ``tests/test_portbench_gang.py``), are those its own runs print."""
    import torch

    from portbench.reference.common import Arith

    task = cell.task().Task(cell, seed, device)
    prog = warm_up(task, READINGS) if cell.chips == 1 else None
    task.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = task.reference(Arith(fp8=False))
    sides = {"program": prog, "control": task.reference(Arith(fp8=True)),
             "half_batch": task.reference(Arith(fp8=False), rows=task.batch // 2),
             "unchanged": compare.unchanged(ref)}
    sides = {k: v for k, v in sides.items() if v is not None}
    out = {}
    for name, side in sides.items():
        where = {}
        out[name] = compare.gaps(side, ref, where)
        out[name]["worst_leaf"] = {k: "/".join(map(str, v)) for k, v in where.items()}
    out["unchanged"]["loss_gap"] = None   # its losses were not run
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = cells.load(ROOT, args.workload)
    cache_dirs(ROOT)
    import torch

    torch.set_num_threads(THREADS)
    device = torch.device(args.device)
    rows = []
    for seed in args.seeds:
        r = readings(cell, seed, device)
        rows.append(r)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    summary = {}
    if "program" in rows[0]:
        summary["program_max"] = {k: max(r["program"][k] for r in rows) for k in compare.NUMBERS}
    for side in (s for s in rows[0] if s != "program"):
        summary[f"{side}_min"] = {k: min((r[side][k] for r in rows if r[side][k] is not None),
                                         default=None) for k in compare.NUMBERS}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
