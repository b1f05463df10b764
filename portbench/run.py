"""One run of one cell of ``BENCHMARK.json`` on this machine's cards.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the program's run for the cell (its configuration and
traffic mix, ``portbench/cell.py``), puts the benchmark's weights into it,
and drives its first steps through the same call and feed as the window:
the losses of the first three, the gradient its optimizer got at the
first and the change of every parameter after the third are kept. Then the
window runs the step for ``--seconds`` (``--trace 1``: then a few more
steps under ``torch.profiler``, read by the cell's per-layer readers). Once
the window has closed and its peak memory is read, the program is freed
and the plain reference (``portbench/reference/``) follows the same three
steps from the same weights and inputs; ``portbench/compare.py`` decides
``correct``. The last line of standard output is the result, as JSON; the
last lines of standard error are each number compared beside its limit.

A cell on several cards runs one process a card (``portbench/rank.py``),
joined over NCCL at a free local port; this process builds the program's
CUDA libraries first, waits for every rank, stops the others when one
fails, and prints rank 0's result.

Exit codes: 0 with a result; 1 when the run fails; 2 without the cards the
cell asks for; 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import cell as cells  # noqa: E402
from portbench import compare  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cross_scale_mae_tpu")
READINGS = 3   # the steps the reference follows
THREADS = 4
RANK_TIMEOUT_S = 340


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    return p.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (the program's CUDA libraries already build into ``build/cuda``)."""
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions"),
                     ("CUDA_CACHE_PATH", "nv_cache")):
        os.environ[var] = str(base / sub)


def loaded_forbidden() -> list[str]:
    """The top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def refuse_forbidden() -> bool:
    """True, with the names on standard error, when JAX or the JAX package
    is loaded in this process."""
    leaked = loaded_forbidden()
    if leaked:
        print(f"the run loaded {', '.join(leaked)}: the benchmark measures the PyTorch port "
              "alone", file=sys.stderr)
    return bool(leaked)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Gang:
    """The ``world`` ranks of a run: the harness's own reductions over them,
    outside the measured window, on the program's process group."""

    def __init__(self, world: int = 1):
        self.world = world

    def largest(self, value: float, device) -> float:
        if self.world == 1:
            return value
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(value)], dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def warm_up(task, steps: int) -> dict:
    """The first ``steps`` steps; the readings of the first three."""
    if steps < READINGS:
        raise ValueError(f"a cell warms up for at least {READINGS} steps, not {steps}")
    losses, first, delta = [], None, None
    for k in range(steps):
        loss = task.step(k)
        if k < READINGS:
            losses.append(loss)
        if k == 0:
            first = task.first_grads()
        if k == READINGS - 1:
            delta = task.deltas()
    return {"loss": [float(v) for v in losses], "g1": first, "delta": delta}


def window_steps(task, first: int, seconds: float, device, gang: Gang) -> int:
    """How many steps fill ``seconds`` on every rank, from two timed steps:
    the ranks of a gang run the same count, so that their collectives pair."""
    sync(device)
    t0 = time.perf_counter()
    for k in range(first, first + 2):
        task.step(k)
    sync(device)
    return max(10, math.ceil(seconds / gang.largest((time.perf_counter() - t0) / 2, device)))


def window(task, first: int, seconds: float, device, steps: int | None = None) -> dict:
    """Steps from ``first`` until ``seconds`` have passed on the host clock
    (or exactly ``steps`` of them), then a wait for the device. Each step's
    time is the interval between events recorded on the compute stream
    after consecutive steps, so a host stall counts."""
    import torch

    cuda = device.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    sync(device)
    marks, losses = [], []
    t0 = time.perf_counter()
    marks.append(mark())
    k = first
    while (len(losses) < steps) if steps is not None else (time.perf_counter() - t0 < seconds):
        losses.append(task.step(k))
        marks.append(mark())
        k += 1
    sync(device)
    elapsed = time.perf_counter() - t0
    step_ms = [(marks[i].elapsed_time(marks[i + 1]) if cuda else
                (marks[i + 1] - marks[i]) * 1e3) for i in range(len(marks) - 1)]
    finite = int(torch.isfinite(torch.stack(losses)).sum())
    return {"steps": len(losses), "seconds": elapsed, "step_ms": step_ms,
            "failed": len(losses) - finite, "next": k}


def traced(task, first: int, steps: int, device):
    """``steps`` more steps under ``torch.profiler``, the device traced
    alone; their trace."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import from_profiler

    cuda = device.type == "cuda"
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        for k in range(first, first + steps):
            task.step(k)
        sync(device)
    return from_profiler(prof)


def end_to_end(cell, task, win: dict, setup_s: float, peak: int) -> dict:
    values = {"images_per_s": win["steps"] * task.images_per_step / win["seconds"],
              "step_ms_p90": statistics.quantiles(win["step_ms"], n=10)[-1],
              "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def per_layer(cell, task, tr, images_per_s: float, world: int) -> dict:
    """The cell's per-layer readers on one card's trace; a reader that
    finds nothing to read is left out."""
    from portbench.trace import Traced

    ctx = Traced([tr], cell.mix["trace_steps"], world, images_per_s, task.flops_per_image,
                 task.attention)
    values = {}
    for name, (_, reader) in cell.readers().items():
        value = reader.read(ctx)
        if value is not None:
            values[name] = value
    return values


def measure(cell, seed: int, seconds: float, trace: bool, device, rank: int = 0,
            world: int = 1, coordinator: str | None = None, started: float = T0) -> dict:
    """One run of ``cell`` as ``rank`` of ``world`` on ``device``: the
    result's fields and the checks (rank 0's; the other ranks' are None).
    ``started`` is the wall time the run began at."""
    import torch

    from portbench.reference.common import Arith
    from portbench.trace import covered, device_ops

    gang = Gang(world)
    marks = [("start", started), ("imports", time.time())]
    task = cell.task().Task(cell, seed, device, **(
        {"rank": rank, "world": world, "coordinator": coordinator} if world > 1 else {}))
    marks.append(("program built", time.time()))
    first = cell.mix["warmup_steps"]
    prog = warm_up(task, first)
    steps = None
    if world > 1:
        steps = window_steps(task, first, seconds, device, gang)
        first += 2
    sync(device)
    marks.append(("warm-up", time.time()))
    setup_s = marks[-1][1] - started
    if rank == 0:
        print("setup_s " + ", ".join(f"{name} {t - marks[i][1]:.3f}"
                                     for i, (name, t) in enumerate(marks[1:])),
              f"(of which build_run {task.build_s:.3f})", file=sys.stderr, flush=True)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    win = window(task, first, seconds, device, steps)
    win["seconds"] = gang.largest(win["seconds"], device)
    peak = int(gang.largest(torch.cuda.max_memory_allocated(device) if cuda else 0, device))
    out = {"attempted": win["steps"], "failed": win["failed"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": world, "memory_peak_bytes": peak}
    if trace:
        tr = traced(task, win["next"], cell.mix["trace_steps"], device)
        mine = (per_layer(cell, task, tr, win["steps"] * task.images_per_step / win["seconds"],
                          world),
                covered((a.start, a.end) for a in tr.device) / 1e6, tr.window_us / 1e6)
        ranks = gang.gather(mine)
        metrics = {}
        for name, (entry, _) in cell.readers().items():
            values = [r[0][name] for r in ranks if name in r[0]]
            if values:
                metrics[name] = {"value": sum(values) / len(values), "unit": entry["unit"]}
        dev["busy_s"] = sum(r[1] for r in ranks) / world
        dev["window_s"] = sum(r[2] for r in ranks) / world
        out["breakdown"] = {"device_ops": device_ops(tr)}
    else:
        metrics = end_to_end(cell, task, win, setup_s, peak)
    task.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        return {}
    ref = task.reference(Arith(fp8=False), steps=READINGS)
    correct, checks = compare.judge(compare.gaps(prog, ref), cell.limits)
    out.update(correct=correct and win["failed"] == 0, metrics=metrics, device=dev,
               checks=checks)
    return out


def emit(out: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, its checks under the last key."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    keys = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
    print(json.dumps({k: out[k] for k in keys if k in out}), flush=True)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(cell, args, device_type: str = "cuda") -> dict | None:
    """Run ``cell`` as one process a card (``portbench/rank.py``); rank 0's
    result. When a rank fails, the others are stopped, its last lines of
    standard error are printed, and None is returned."""
    if device_type == "cuda":
        from cross_scale_mae_torch.ops.cuda_build import KERNELS, build_libraries

        build_libraries(list(KERNELS))   # once, before the ranks load them
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="portbench-ranks-") as tmp:
        logs = [(Path(tmp) / f"rank{r}.out", Path(tmp) / f"rank{r}.err")
                for r in range(cell.chips)]
        procs = []
        for r, (out, err) in enumerate(logs):
            cmd = [sys.executable, "-m", "portbench.rank", "--workload", cell.name,
                   "--seed", str(args.seed), "--seconds", str(args.seconds),
                   "--trace", str(args.trace), "--rank", str(r), "--world", str(cell.chips),
                   "--port", str(port), "--started", repr(T0), "--device", device_type]
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(cmd, cwd=cell.base.parent, stdout=fo, stderr=fe))
        failed = wait_all(procs, time.time() + RANK_TIMEOUT_S)
        if failed is not None:
            tail = logs[failed][1].read_text().splitlines()[-40:]
            print(f"rank {failed} of {cell.chips} failed (exit {procs[failed].returncode}):",
                  *tail, sep="\n", file=sys.stderr)
            return None
        return json.loads(logs[0][0].read_text().strip().splitlines()[-1])


def wait_all(procs: list, deadline: float) -> int | None:
    """Wait for every process; the index of the first that failed (or ran
    past ``deadline``), after stopping the rest, else None."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
        late = time.time() > deadline
        if bad or late:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            return bad[0] if bad else next(i for i, c in enumerate(codes) if c is None)
        if all(c == 0 for c in codes):
            return None
        time.sleep(0.2)


def main(argv=None) -> int:
    args = parse(argv)
    cell = cells.load(ROOT, args.workload)
    cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        out = launch(cell, args)
        if out is None:
            return 1
    else:
        torch.set_num_threads(THREADS)
        out = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    if refuse_forbidden():
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
