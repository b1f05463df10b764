"""Recovery of a pretraining run on the CPU: a process ended by the fault
drill (``CSM_FAULT_STEP``) and the run resumed from its newest checkpoint,
in one process and over 2 gloo ranks in both DDP modes, through
``cli/launch.main``; the elastic relaunch that shrinks 2 ranks to 1; and a
SIGTERM that checkpoints and exits 0.

Every run is the tiny MsLdCeCd config for 5 epochs of 2 steps (8 synthetic
images, global batch 4) with a checkpoint per epoch; the fault ends rank
``CSM_FAULT_PROCESS`` after its 3rd step, in epoch 1, so the relaunch
resumes from the step-2 checkpoint at epoch 1. Each process is a
subprocess that imports only torch and the port, waited for with a time
limit.

A resume at the same world size repeats the same arithmetic on the same
draws and batches, so its final state (params, moments, BatchNorm state,
count, step) must equal the unbroken run's bit for bit. The elastic run
finishes its last 4 epochs at world size 1: held to the unbroken 2-rank
run with the 2-rank-against-one-process tolerances of
``tests/test_torch_port_parallel.py`` (params atol 1e-4, BatchNorm state
atol 1e-6: the same arithmetic but for the order of fp32 sums; the
elastic run reads about 1e-7 and 6e-8). At the CLI's own lr (blr 5e-5 x
4 / 256) the params move little, so the BatchNorm running statistics,
which move by about 6e-2 an epoch, are what would show a lost epoch.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import pytest
import torch

from cross_scale_mae_torch.utils import checkpoint as pckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
EPOCHS, STEPS_PER_EPOCH, FAULT_STEP = 5, 2, 3
PRETRAIN = ["-m", "cross_scale_mae_torch.cli.pretrain", "--model", "mae_vit_tiny_MsLdCeCd",
            "--input_size", "32", "--patch_size", "8", "--batch_size", "4",
            "--synthetic_len", "8", "--epochs", str(EPOCHS), "--warmup_epochs", "1",
            "--ckpt_interval", "1", "--compute_dtype", "float32", "--device", "cpu",
            "--log_interval", "1"]


def _env(**extra: str) -> list[str]:
    """An ``env`` prefix for a worker: the repo on the path, one thread, and
    ``extra``."""
    pairs = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", **extra}
    return ["env", *(f"{k}={v}" for k, v in pairs.items())]


def _free_port() -> str:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return str(sock.getsockname()[1])


def _run(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Start every command at once, wait for each with a time limit, and
    return their outputs; a timeout fails the test."""
    procs = [subprocess.Popen(c, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _ok(results):
    for rc, out in results:
        assert rc == 0, out[-4000:]


FAULT = {"CSM_FAULT_STEP": str(FAULT_STEP), "CSM_FAULT_PROCESS": "1", "CSM_FAULT_ATTEMPT": "1"}


def _launch(workdir: str, mode: str, *extra: str) -> dict:
    """``cli/launch.main`` over 2 gloo ranks of the pretrain CLI in
    ``--ddp_mode mode``, writing under ``workdir``, rank 1 faulted in the
    first attempt; returns the launcher's result, or the error it raised."""
    from cross_scale_mae_torch.cli import launch

    os.makedirs(workdir)
    args = launch.get_args_parser().parse_args([
        "--nprocs", "2", "--workdir", workdir, "--grace_s", "2", "--poll_s", "0.1",
        "--max_restarts", "1", *extra, "--", *_env(**FAULT), sys.executable, *PRETRAIN,
        "--ddp_mode", mode, "--output_dir", os.path.join(workdir, "out")])
    try:
        return launch.main(args)
    except SystemExit as e:   # read by the test
        return {"error": str(e)}


def _ckpts(out_dir) -> str:
    """The checkpoint directory with the newest step of the runs under
    ``out_dir`` (each run writes into ``<out_dir>/run_<name>[+N]``)."""
    from cross_scale_mae_torch.cli.launch import find_latest_checkpoints

    return find_latest_checkpoints(str(out_dir))


def _run_dirs(out_dir) -> list[str]:
    """The run directories under ``out_dir``, oldest first (``+N`` order)."""
    names = os.listdir(out_dir)
    return [os.path.join(str(out_dir), n) for n in sorted(names, key=lambda n: (len(n), n))]


def _final_state(out_dir: str) -> dict:
    ckpt = _ckpts(out_dir)
    step = pckpt.latest_step(ckpt)
    assert step == EPOCHS * STEPS_PER_EPOCH, (ckpt, step)
    return torch.load(os.path.join(ckpt, str(step), pckpt.STATE_FILE), weights_only=True)


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """Every run at once: the unbroken references (one process, and 2
    ranks in each DDP mode) and the faulted one-process run as plain
    subprocesses, and three launcher drills in threads (2 ranks in each
    mode relaunched at 2, and the elastic gspmd one relaunched at 1); then
    the one-process run's resume."""
    root = tmp_path_factory.mktemp("drills")
    # The unbroken references write only their last checkpoint, the one compared.
    last_only = ("--ckpt_interval", str(EPOCHS))
    cmds = [[*_env(), sys.executable, *PRETRAIN, *last_only, "--output_dir", str(root / "one")],
            [*_env(CSM_FAULT_STEP=str(FAULT_STEP)), sys.executable, *PRETRAIN,
             "--output_dir", str(root / "one_fault")]]
    for mode in ("gspmd", "shard_map"):
        address = "127.0.0.1:" + _free_port()
        cmds += [[*_env(), sys.executable, *PRETRAIN, *last_only, "--ddp_mode", mode,
                  "--output_dir", str(root / f"two_{mode}"), "--coordinator_address", address,
                  "--num_processes", "2", "--process_id", str(r)] for r in range(2)]
    launched: dict = {}
    drills = {"gspmd": ("gspmd",), "shard_map": ("shard_map",),
              "elastic": ("gspmd", "--elastic", "--min_procs", "1")}
    threads = [threading.Thread(target=lambda n=name, a=argv: launched.__setitem__(
        n, _launch(str(root / f"drill_{n}"), *a))) for name, argv in drills.items()]
    for t in threads:
        t.start()
    plain = _run(cmds)
    for t in threads:
        t.join(timeout=2 * TIMEOUT_S)
        assert not t.is_alive(), "a launcher drill did not end"
    resumed = _run([[*_env(), sys.executable, *PRETRAIN, "--output_dir", str(root / "one_fault"),
                     "--resume", _ckpts(root / "one_fault")]])
    return {"root": root, "plain": plain, "resumed": resumed[0], "launched": launched}


def _bit_equal(a: dict, b: dict) -> list[str]:
    """The keys on which two flat states differ (every one, when the key
    sets differ)."""
    if sorted(a) != sorted(b):
        return sorted(set(a) ^ set(b))
    return [k for k in a if not torch.equal(a[k], b[k])]


def test_pretrain_resumed_after_a_fault_is_bit_equal_in_one_process(drills):
    root = drills["root"]
    rc, out = drills["plain"][1]
    assert rc == 13 and "[fault-injection] killing process 0 at step 3" in out, out[-2000:]
    rc, out = drills["resumed"]
    assert rc == 0 and "at epoch 1 (step 2" in out, out[-2000:]
    _ok(drills["plain"][:1])
    assert _bit_equal(_final_state(str(root / "one_fault")), _final_state(str(root / "one"))) == []


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
def test_pretrain_resumed_after_a_fault_is_bit_equal_over_two_ranks(drills, mode):
    """Rank 1 ends after its 3rd step; the launcher kills rank 0, wedged in
    the next step's collective, and relaunches both from the step-2
    checkpoint: the final state equals the unbroken 2-rank run's."""
    root, res = drills["root"], drills["launched"][mode]
    assert res == {"success": True, "attempts": 2, "final_nprocs": 2, "restarts": 1}, res
    _ok(drills["plain"][2:])
    work = root / f"drill_{mode}"
    log = (work / "launcher" / "attempt1.worker1.log").read_text()
    assert "[fault-injection] killing process 1 at step 3" in log
    state = json.loads((work / "launcher" / "state.json").read_text())
    assert state["attempt"] == 2 and state["nprocs"] == 2
    first_run = _run_dirs(work / "out")[0]
    assert state["cmd"][-2:] == ["--resume", os.path.join(first_run, "checkpoints")]
    assert "at epoch 1 (step 2" in (work / "launcher" / "attempt2.worker0.log").read_text()
    assert _bit_equal(_final_state(str(work / "out")),
                      _final_state(str(root / f"two_{mode}"))) == []


def test_elastic_launcher_shrinks_to_one_process_and_resumes(drills):
    """The elastic drill (JAX tests/test_multiprocess.py:551): rank 1 lost,
    the gang relaunched at 1 process with --resume, the 5-epoch step count
    reached, and the state within the 2-rank-vs-one-process tolerances of
    the unbroken 2-rank run."""
    root, res = drills["root"], drills["launched"]["elastic"]
    assert res == {"success": True, "attempts": 2, "final_nprocs": 1, "restarts": 1}, res
    work = root / "drill_elastic"
    state = json.loads((work / "launcher" / "state.json").read_text())
    assert state["attempt"] == 2 and state["nprocs"] == 1 and state["cmd"][-2] == "--resume"
    log = (work / "launcher" / "attempt2.worker0.log").read_text()
    assert "at epoch 1 (step 2" in log and "1 process(es)" in log
    from cross_scale_mae_torch.cli.launch import find_latest_checkpoints

    assert find_latest_checkpoints(str(work)) == os.path.join(_run_dirs(work / "out")[1],
                                                              "checkpoints")
    got, want = _final_state(str(work / "out")), _final_state(str(root / "two_gspmd"))
    assert sorted(got) == sorted(want) and int(got["step"]) == EPOCHS * STEPS_PER_EPOCH
    assert torch.equal(got["opt_state/count"], want["opt_state/count"])

    def worst(a, b, prefix):
        return max(float((a[k].double() - b[k].double()).abs().max())
                   for k in a if k.startswith(prefix))

    assert worst(got, want, "params/") <= 1e-4
    assert worst(got, want, "model_state/") <= 1e-6
    # The control: the run one epoch short misses the BatchNorm state's
    # limit by far, so a lost or doubled epoch would show.
    short = torch.load(os.path.join(_run_dirs(work / "out")[1], "checkpoints",
                                    str((EPOCHS - 1) * STEPS_PER_EPOCH), pckpt.STATE_FILE),
                       weights_only=True)
    assert worst(short, want, "model_state/") > 1e3 * 1e-6


def _until(proc: subprocess.Popen, prefix: str) -> list[str]:
    """``proc``'s output lines up to the first that starts with ``prefix``."""
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith(prefix):
            return lines
    raise AssertionError("".join(lines)[-3000:])


def _finish(procs: list[subprocess.Popen]) -> list[str]:
    """Each process's remaining output, waited for with a time limit."""
    try:
        return [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _popen(*argv: str) -> subprocess.Popen:
    return subprocess.Popen([*_env(), sys.executable, *PRETRAIN, *argv], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_sigterm_checkpoints_and_exits_zero(tmp_path):
    """SIGTERM to a running pretrain: the current step finishes, a
    checkpoint of its epoch is written, and the process exits 0. A stop in
    the middle of an epoch resumes at the next epoch, the rest of that
    epoch left out, as the JAX package does (its cli/pretrain.py:285)."""
    out = tmp_path / "run"
    proc = _popen("--epochs", "100000", "--ckpt_interval", "1000", "--output_dir", str(out))
    lines = _until(proc, "epoch 2 ")
    proc.send_signal(signal.SIGTERM)
    text = "".join(lines) + _finish([proc])[0]
    assert proc.returncode == 0, text[-3000:]
    assert "checkpoint-and-exit" in text and "preemption checkpoint written" in text
    ckpt = _ckpts(out)
    step = pckpt.latest_step(ckpt)
    epoch = pckpt.checkpoint_meta(ckpt, step)["epoch"]
    assert step >= 5 and epoch == (step - 1) // STEPS_PER_EPOCH
    again = _popen("--epochs", str(epoch + 2), "--resume", ckpt, "--output_dir", str(out))
    text = _finish([again])[0]
    assert again.returncode == 0, text[-3000:]
    assert f"at epoch {epoch + 1} (step {step}," in text
    assert f"training done: {STEPS_PER_EPOCH} steps" in text


def test_ranks_agree_on_the_step_to_stop_after(tmp_path):
    """SIGTERM to rank 1 alone of a 2-rank run: the request rides the
    step's reduction, so both ranks stop after the same step, checkpoint
    and exit 0; a rank that stopped on its own would leave the other in the
    next step's collective until the time limit."""
    address = "127.0.0.1:" + _free_port()
    procs = [_popen("--epochs", "100000", "--ckpt_interval", "1000", "--output_dir",
                    str(tmp_path / "run"), "--coordinator_address", address,
                    "--num_processes", "2", "--process_id", str(r)) for r in range(2)]
    try:
        lines = _until(procs[0], "epoch 2 ")
    except AssertionError:
        _finish(procs)
        raise
    procs[1].send_signal(signal.SIGTERM)
    outs = _finish(procs)
    outs[0] = "".join(lines) + outs[0]
    assert [p.returncode for p in procs] == [0, 0], [o[-2000:] for o in outs]
    assert "preemption checkpoint written" in outs[0]
    assert pckpt.latest_step(_ckpts(tmp_path / "run")) >= 5


_WEDGED_WORKER = r"""
import os, signal, sys, time
ready = READY
rank = int(sys.argv[sys.argv.index("--process_id") + 1])
if rank == 1:
    # Fail only once rank 0 is deaf to SIGTERM, so the launcher's SIGTERM
    # cannot end it first.
    deadline = time.monotonic() + 20
    while not os.path.exists(ready) and time.monotonic() < deadline:
        time.sleep(0.01)
    sys.exit(3)
signal.signal(signal.SIGTERM, signal.SIG_IGN)   # wedged: deaf to the teardown
open(ready, "w").close()
time.sleep(60)
"""


def test_launcher_kills_a_worker_wedged_past_the_grace_period(tmp_path):
    """Rank 1 fails; rank 0 ignores SIGTERM (as one stuck in a collective
    with the dead peer would): the launcher SIGKILLs it after --grace_s and,
    out of restarts, gives up naming the failed worker."""
    import time

    from cross_scale_mae_torch.cli import launch

    args = launch.get_args_parser().parse_args([
        "--nprocs", "2", "--workdir", str(tmp_path), "--grace_s", "1", "--poll_s", "0.05",
        "--max_restarts", "0", "--", sys.executable, "-c",
        _WEDGED_WORKER.replace("READY", repr(str(tmp_path / "rank0_deaf")))])
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match=r"failed workers \[1\], rcs \{1: 3, 0: -9\}"):
        launch.main(args)
    assert time.monotonic() - t0 < 30
    state = json.loads((tmp_path / "launcher" / "state.json").read_text())
    assert state["attempt"] == 1 and state["nprocs"] == 2
