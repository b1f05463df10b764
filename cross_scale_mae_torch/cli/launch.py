"""Elastic multi-process launcher: supervise, restart, shrink (counterpart of
``cross_scale_mae_tpu/cli/launch.py``, with its flags and behaviour).

* Spawns ``--nprocs`` worker processes of any of the port's training CLIs
  and appends ``--coordinator_address host:port --num_processes W
  --process_id r`` to each, so rank r joins a ``tcp://`` rendezvous
  (``parallel/dist.py``) and runs on card r (or ``cuda:LOCAL_RANK``).
* On a worker failure it tears the survivors down: SIGTERM first (the
  pretrain CLI checkpoints and exits on it), SIGKILL after ``--grace_s``
  for workers wedged in a collective with the dead peer, which would
  otherwise wait out the process group's timeout
  (``parallel/dist.TIMEOUT_S``). Then it relaunches the whole gang with
  ``--resume <the newest */checkpoints under --workdir>``.
* With ``--elastic`` each failed worker counts as a lost host: the relaunch
  shrinks the world size by that many, never below ``--min_procs``. In
  the default ``gspmd`` semantics the port's step computes the same global
  step at any world size (each rank takes rows rank::W of the global
  batch, and accumulation's microbatch k holds the same rows at any W), so
  the shrunk gang carries on the same run. A checkpoint holds whole leaves
  whatever the mesh layout (``--fsdp``, ``--zero1``, ``--model_parallel``),
  so the shrunk gang restores it into its own layout; its world must still
  split into ``--model_parallel`` x ``--num_slices``.

``<workdir>/launcher/state.json`` holds the current attempt, world size,
coordinator address, worker pids and command (rewritten atomically per
attempt); each worker's output goes to
``<workdir>/launcher/attempt{K}.worker{I}.log``. Workers see
``CSM_LAUNCH_ATTEMPT`` (K) and ``CSM_WORKER_ID`` (I). The launcher itself
touches no card.

Usage (everything after ``--`` is the worker command):

    python -m cross_scale_mae_torch.cli.launch \\
        --nprocs 4 --elastic --min_procs 2 --workdir runs/exp1 -- \\
        python -m cross_scale_mae_torch.cli.pretrain \\
            --model mae_vit_base_MsLdCeCd --output_dir runs/exp1 ...
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

from cross_scale_mae_torch.utils.checkpoint import latest_step


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Cross-Scale MAE elastic launcher (PyTorch)", add_help=False)
    p.add_argument("--nprocs", type=int, required=True,
                   help="initial world size (one process per GPU)")
    p.add_argument("--min_procs", type=int, default=1,
                   help="--elastic never shrinks the world below this")
    p.add_argument("--elastic", action="store_true",
                   help="on failure, relaunch with the world shrunk by the number of "
                        "failed workers (lost-host semantics) instead of at the same size")
    p.add_argument("--max_restarts", type=int, default=3,
                   help="give up after this many relaunches")
    p.add_argument("--workdir", required=True,
                   help="where launcher state and logs live, and where restarts look for "
                        "the newest */checkpoints (point the worker's --output_dir inside it)")
    p.add_argument("--grace_s", type=float, default=60.0,
                   help="SIGTERM -> SIGKILL window for the survivors of a failure (they "
                        "may be wedged in a collective with the dead peer)")
    p.add_argument("--coordinator_host", default="127.0.0.1",
                   help="host part of the rendezvous address the workers are given")
    p.add_argument("--resume_flag", default="--resume",
                   help="flag that passes the discovered checkpoint directory on "
                        "restarts ('none' disables auto-resume)")
    p.add_argument("--poll_s", type=float, default=0.2)
    p.add_argument("cmd", nargs=argparse.REMAINDER, help="worker command (after --)")
    return p


def _free_port(host: str) -> int:
    with socket.socket() as sock:
        sock.bind((host, 0))
        return sock.getsockname()[1]


def _write_state(workdir: str, state: dict) -> None:
    """Atomic rewrite, so an observer never reads a torn file."""
    path = os.path.join(workdir, "launcher", "state.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1)
    os.replace(tmp, path)


def find_latest_checkpoints(workdir: str):
    """The ``*/checkpoints`` directory under ``workdir`` with the newest
    complete step (then the newest mtime), or None. Every training CLI
    keeps them at ``<output_dir>/<run name>/checkpoints`` (a fresh ``+N``
    directory each attempt), so the newest step anywhere under the workdir
    is the one to resume from."""
    best = None   # (step, mtime, path)
    for root, dirs, _files in os.walk(workdir):
        if "launcher" in dirs:
            dirs.remove("launcher")
        if "checkpoints" not in dirs:
            continue
        dirs.remove("checkpoints")   # no checkpoints nested under checkpoints
        path = os.path.join(root, "checkpoints")
        step = latest_step(path)
        if step is None:
            continue
        key = (step, os.path.getmtime(path))
        if best is None or key > best[:2]:
            best = (*key, path)
    return None if best is None else best[2]


def _spawn(cmd: list[str], nprocs: int, coordinator: str, attempt: int, logdir: str) -> dict:
    procs = {}
    for i in range(nprocs):
        log = open(os.path.join(logdir, f"attempt{attempt}.worker{i}.log"), "w")
        env = dict(os.environ, CSM_LAUNCH_ATTEMPT=str(attempt), CSM_WORKER_ID=str(i))
        full = [*cmd, "--coordinator_address", coordinator, "--num_processes", str(nprocs),
                "--process_id", str(i)]
        procs[i] = (subprocess.Popen(full, stdout=log, stderr=subprocess.STDOUT, env=env), log)
    return procs


def main(args) -> dict:
    """Run the gang until it succeeds, is stopped, or has failed more than
    ``--max_restarts`` times (SystemExit). Returns ``success``, the
    ``attempts``, the ``final_nprocs`` and the ``restarts``."""
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        raise SystemExit("no worker command given (put it after --)")
    if args.min_procs < 1 or args.nprocs < args.min_procs:
        raise SystemExit("need nprocs >= min_procs >= 1")
    logdir = os.path.join(args.workdir, "launcher")
    os.makedirs(logdir, exist_ok=True)

    # SIGTERM/SIGINT to the launcher go on to the gang (the workers
    # checkpoint and exit), and the launcher reports a stop.
    gang: dict = {}
    shutdown = {"flag": False}

    def forward(signum, frame):
        shutdown["flag"] = True
        for proc, _log in gang.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, forward)
        except ValueError:
            pass   # not the main thread: no handler

    nprocs, attempt, restarts = args.nprocs, 0, 0
    try:
        while True:
            attempt += 1
            coordinator = f"{args.coordinator_host}:{_free_port(args.coordinator_host)}"
            attempt_cmd = list(cmd)
            if attempt > 1 and args.resume_flag != "none":
                ckpts = find_latest_checkpoints(args.workdir)
                if ckpts is not None:
                    # After the user's command: argparse takes the last one.
                    attempt_cmd += [args.resume_flag, ckpts]
            gang.clear()
            gang.update(_spawn(attempt_cmd, nprocs, coordinator, attempt, logdir))
            _write_state(args.workdir, {
                "attempt": attempt, "nprocs": nprocs, "coordinator": coordinator,
                "pids": {str(i): p.pid for i, (p, _) in gang.items()}, "cmd": attempt_cmd})

            rcs: dict[int, int] = {}
            failed: set[int] = set()
            deadline = None
            while gang:
                time.sleep(args.poll_s)
                for i in list(gang):
                    proc, log = gang[i]
                    rc = proc.poll()
                    if rc is None:
                        continue
                    log.close()
                    del gang[i]
                    rcs[i] = rc
                    # Exits after the teardown began (or during a stop) are
                    # consequences, not causes.
                    if rc != 0 and deadline is None and not shutdown["flag"]:
                        failed.add(i)
                if failed and gang and deadline is None:
                    for proc, _log in gang.values():
                        proc.send_signal(signal.SIGTERM)
                    deadline = time.monotonic() + args.grace_s
                if deadline is not None and gang and time.monotonic() > deadline:
                    for proc, _log in gang.values():
                        proc.kill()
                    deadline = float("inf")   # kill once

            if shutdown["flag"]:
                return {"success": False, "stopped": True, "attempts": attempt,
                        "final_nprocs": nprocs}
            if not failed and all(rc == 0 for rc in rcs.values()):
                return {"success": True, "attempts": attempt, "final_nprocs": nprocs,
                        "restarts": restarts}
            restarts += 1
            if restarts > args.max_restarts:
                raise SystemExit(f"giving up after {args.max_restarts} restarts "
                                 f"(failed workers {sorted(failed)}, rcs {rcs})")
            if args.elastic:
                nprocs = max(args.min_procs, nprocs - max(1, len(failed)))
            print(f"[launch] attempt {attempt} failed (workers {sorted(failed)}, rcs {rcs}); "
                  f"relaunching with nprocs={nprocs}", flush=True)
    finally:
        for proc, log in gang.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)


if __name__ == "__main__":
    result = main(get_args_parser().parse_args())
    sys.exit(0 if result.get("success") else 1)
