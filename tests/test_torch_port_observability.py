"""The run's observability in the PyTorch port, held against the JAX package
on the CPU: ``utils/logging.RunLogger`` (log.jsonl, TensorBoard, wandb)
against the JAX ``RunLogger`` with the same stand-in ``wandb`` module, the
TensorBoard scalars read back from the event files; ``utils/profiling``
(the trace, the pretrain CLI's ``--profile_dir`` window, the memory
statistics, the step's spans); the three training CLIs' logging flags; and
``--jax_platforms cpu``. One test, marked ``cuda``, holds the spans' clock
to the kernels' on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_observability.py

No tolerance: the scalars are the same fp32 values on both sides, read back
exactly.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from cross_scale_mae_torch.utils.profiling import device_memory_stats, recorded, span

TINY_PRETRAIN = ["--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "16", "--patch_size", "8",
                 "--batch_size", "2", "--warmup_epochs", "0", "--device", "cpu"]
TINY_CLASSIFIER = ["--model", "vit_base_patch16", "--embed_dim", "32", "--depth", "2",
                   "--num_heads", "4", "--input_size", "16", "--patch_size", "8",
                   "--batch_size", "4", "--dataset_type", "synthetic", "--synthetic_len", "8",
                   "--nb_classes", "3", "--epochs", "1", "--warmup_epochs", "0",
                   "--device", "cpu"]


class FakeWandb(types.ModuleType):
    """A stand-in ``wandb`` module that records every call."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))

    def log(self, payload):
        self.calls.append(("log", payload))

    def finish(self):
        self.calls.append(("finish",))


@pytest.fixture
def fake_wandb(monkeypatch):
    mod = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def _scalars(tb_dir: str) -> dict:
    """{tag: [(step, value), ...]} of the event files under ``tb_dir``."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(tb_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def _drive(logger_cls, out: str, wandb_id=None):
    logger = logger_cls(out, use_tensorboard=True, use_wandb=True, wandb_project="proj",
                        run_name="run", config={"lr": 0.5, "model": "m"},
                        wandb_entity="team", wandb_id=wandb_id)
    logger.log_step(0, {"loss": 2.5, "lr": np.float32(1e-3)})
    logger.log_step(1500, {"loss": torch.tensor(1.25), "gnorm/encoder": 3.0})
    logger.log_epoch({"epoch": 0, "train_loss": 1.25})
    logger.close()
    return logger


@pytest.mark.parametrize("wandb_id", [None, "abc123"])
def test_run_logger_matches_jax(tmp_path, monkeypatch, wandb_id):
    """The same calls through both loggers give the same wandb calls (init
    arguments, payloads, finish), the same log.jsonl and config.json, and
    the same TensorBoard scalars."""
    from cross_scale_mae_tpu.utils.logging import RunLogger as JaxLogger
    from cross_scale_mae_torch.utils.logging import RunLogger

    calls = {}
    for name, cls in (("jax", JaxLogger), ("port", RunLogger)):
        mod = FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", mod)
        _drive(cls, str(tmp_path / name), wandb_id)
        calls[name] = mod.calls
    assert calls["port"] == calls["jax"]
    init = calls["port"][0][1]
    assert init["resume"] == ("allow" if wandb_id else None) and init["entity"] == "team"
    assert calls["port"][-1] == ("finish",)
    for f in ("log.jsonl", "config.json"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
    got, want = _scalars(str(tmp_path / "port" / "tb")), _scalars(str(tmp_path / "jax" / "tb"))
    assert got == want == {"loss": [(0, 2.5), (1500, 1.25)], "lr": [(0, np.float32(1e-3))],
                           "gnorm/encoder": [(1500, 3.0)]}


def test_run_logger_prints_the_jax_skip_lines(tmp_path, monkeypatch, capsys):
    """Where tensorboard or wandb does not import, both loggers say so and
    log on without it."""
    from cross_scale_mae_tpu.utils.logging import RunLogger as JaxLogger
    from cross_scale_mae_torch.utils.logging import RunLogger

    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    outs = {}
    for name, cls in (("jax", JaxLogger), ("port", RunLogger)):
        logger = cls(str(tmp_path / name), use_tensorboard=True, use_wandb=True)
        logger.log_step(0, {"loss": 1.0})
        logger.log_epoch({"epoch": 0})
        logger.close()
        outs[name] = capsys.readouterr().out
        assert not (tmp_path / name / "tb").exists()
        assert (tmp_path / name / "log.jsonl").read_text() == '{"epoch": 0}\n'
    for line in ("tensorboard unavailable; skipping TB logging",
                 "wandb unavailable; skipping wandb logging"):
        assert line in outs["jax"] and line in outs["port"]


def test_run_logger_does_nothing_off_rank_zero(tmp_path, monkeypatch, fake_wandb):
    from cross_scale_mae_torch.utils import logging as plog

    monkeypatch.setattr(plog, "is_main_process", lambda: False)
    logger = plog.RunLogger(str(tmp_path / "r1"), use_tensorboard=True, use_wandb=True,
                            config={"a": 1})
    logger.log_step(0, {"loss": 1.0})
    logger.log_epoch({"epoch": 0})
    logger.close()
    assert not (tmp_path / "r1").exists() and fake_wandb.calls == []


def test_epoch_1000x_matches_jax():
    from cross_scale_mae_tpu.utils.logging import epoch_1000x as jx
    from cross_scale_mae_torch.utils.logging import epoch_1000x

    for e in (0.0, 0.5, 1.25, 3 + 7 / 9, 399.999):
        assert epoch_1000x(e) == jx(e)


# ---------------------------------------------------------------- profiling


def _events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_parseable_chrome_trace(tmp_path):
    from cross_scale_mae_torch.utils.profiling import trace, trace_files

    with trace(None) as prof:
        assert prof is None
    with trace(str(tmp_path / "t")) as prof:
        with torch.profiler.record_function("probe_range"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = trace_files(str(tmp_path / "t"))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    names = {e.get("name") for e in _events(files[0])}
    assert "probe_range" in names and any("mm" in str(n) for n in names)
    assert not torch.autograd.profiler._is_profiler_enabled


def _pretrain(tmp_path, *extra):
    from cross_scale_mae_torch.cli.pretrain import get_args_parser, main

    return main(get_args_parser().parse_args(
        TINY_PRETRAIN + ["--output_dir", str(tmp_path / "out"), *extra]))


@pytest.mark.parametrize("rows,steps,traced", [
    (10, 5, 0),     # a 5-step run: the window never opens
    (24, 12, 2),    # the run ends inside the window: closed at its end
    (64, 32, 20),   # steps 10-30, closed before step 30
    (8, 14, 0),     # the first epoch (4 steps) ends before step 10
])
def test_profile_window_traces_steps_10_to_30_of_the_first_epoch(tmp_path, rows, steps,
                                                                 traced):
    """--profile_dir opens its window before step 10 of the first epoch and
    closes it before step 30 or when the run ends (the JAX CLI left it open
    when the first epoch ended sooner); the trace holds the traced steps."""
    res = _pretrain(tmp_path, "--synthetic_len", str(rows), "--max_steps", str(steps),
                    "--epochs", "100", "--profile_dir", str(tmp_path / "prof"))
    assert res["steps"] == steps and res["trace"]["steps"] == traced
    assert not torch.autograd.profiler._is_profiler_enabled
    files = res["trace"]["files"]
    assert len(files) == (1 if traced else 0)
    if traced:
        events = _events(files[0])
        # One AdamW second-moment update per traced step.
        assert sum(e.get("name") == "aten::_foreach_addcmul_" for e in events) == traced


def test_jax_cli_leaves_a_short_first_epochs_trace_open_and_the_port_does_not(tmp_path):
    """The JAX fault this port does not carry (cli/pretrain.py:387-390
    there): a 12-step first epoch starts the trace at step 10 and never
    stops it, so the next start_trace fails; the port's window is closed."""
    import jax

    from cross_scale_mae_tpu.cli import pretrain as jpretrain

    argv = ["--model", "mae_vit_tiny_MsLd", "--dataset_type", "synthetic",
            "--synthetic_len", "96", "--input_size", "16", "--patch_size", "8",
            "--batch_size", "8", "--epochs", "1", "--warmup_epochs", "0",
            "--compute_dtype", "float32", "--output_dir", str(tmp_path / "jax"),
            "--profile_dir", str(tmp_path / "jprof")]
    try:
        assert jpretrain.main(jpretrain.get_args_parser().parse_args(argv))["steps"] == 12
        with pytest.raises(RuntimeError, match="already"):
            jax.profiler.start_trace(str(tmp_path / "again"))
    finally:
        jax.profiler.stop_trace()
    res = _pretrain(tmp_path, "--synthetic_len", "24", "--epochs", "1",
                    "--profile_dir", str(tmp_path / "prof"))
    assert res["steps"] == 12 and res["trace"]["steps"] == 2
    assert not torch.autograd.profiler._is_profiler_enabled


def test_device_memory_stats():
    assert device_memory_stats() == {}   # no CUDA device, as JAX's stat-less devices


# ---------------------------------------------------------------- spans

STEP_PHASES = ["augment", "forward", "backward", "optimizer"]


def _window(activities=(torch.profiler.ProfilerActivity.CPU,)):
    """A profiler window after a span outside one, as a training loop runs
    steps between windows: its spans are recorded anew."""
    with span("outside"):
        pass
    return torch.profiler.profile(activities=list(activities))


def _tree(spans) -> list:
    """(name, parent's name) of each span, in entry order."""
    return [(s.name, None if s.parent is None else spans[s.parent].name) for s in spans]


def test_span_off_is_one_shared_no_op():
    """Outside a profiler window every span is the same no-op object and
    the record keeps the last window's spans."""
    with _window():
        with span("kept"):
            pass
    before = recorded()
    first, second = span("step"), span("optimizer", torch.device("cpu"))
    assert first is second
    with first as entered:
        assert entered is None
    assert recorded() == before and [s.name for s in before] == ["kept"]


def test_spans_nest_and_reset_at_the_next_window():
    with _window():
        with span("step"):
            with span("augment"):
                with span("randaug"):
                    pass
            with span("forward"):
                pass
        with span("step"):
            pass
    spans = recorded()
    assert _tree(spans) == [("step", None), ("augment", "step"), ("randaug", "augment"),
                            ("forward", "step"), ("step", None)]
    assert all(s.start_ns <= s.end_ns and s.device_ms is None for s in spans)
    assert spans[0].start_ns <= spans[1].start_ns and spans[3].end_ns <= spans[0].end_ns
    with _window():
        with span("next"):
            pass
    assert _tree(recorded()) == [("next", None)]


def test_span_ranges_lie_inside_the_host_interval():
    """Each span's record_function event in the same profile lies inside
    the span's host interval (1 ms of slack): the recorder's clock is the
    profiler's."""
    with _window() as prof:
        with span("step"):
            with span("forward"):
                (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
            with span("optimizer"):
                torch.ones(8).mul_(2)
    spans = recorded()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in {s.name for s in spans}]
    assert sorted(e.name() for e in events) == sorted(s.name for s in spans)
    slack = 1_000_000
    for s in spans:
        e = next(e for e in events if e.name() == s.name)
        assert s.start_ns - slack <= e.start_ns() <= e.start_ns() + e.duration_ns() \
            <= s.end_ns + slack, s.name


def _classify_run():
    from cross_scale_mae_torch.cli.finetune import build_run, get_args_parser

    args = get_args_parser().parse_args(
        TINY_CLASSIFIER + ["--mixup", "0.8", "--cutmix", "1.0", "--aa", "rand-m9-mstd0.5-inc1",
                           "--reprob", "0.25"])
    run = build_run(args)
    return lambda: run.step_fn(run.state, run.images[:4], run.labels[:4],
                               run.draws(run.state.step))


def _pretrain_run(accum: int):
    from cross_scale_mae_torch.cli.pretrain import build_run, get_args_parser

    run = build_run(get_args_parser().parse_args(
        TINY_PRETRAIN + ["--synthetic_len", "8", "--accum_iter", str(accum)]))
    return lambda: run.step_fn(run.state, run.images[:2 * accum], run.draws(run.state.step))


@pytest.mark.parametrize("which,children", [
    ("pretrain", STEP_PHASES),
    ("pretrain_accum2", STEP_PHASES[:3] * 2 + STEP_PHASES[3:]),
    ("classify", STEP_PHASES),
])
def test_training_steps_record_their_phases(which, children):
    """A tiny pretrain step (one microbatch and two) and a tiny classify
    step with RandAugment, RandomErasing and Mixup/CutMix record ``step``
    with its phases under it, in order; the augment's extras and the mix
    are the augment's children."""
    step = _classify_run() if which == "classify" else _pretrain_run(2 if "accum" in which
                                                                      else 1)
    step()   # outside the window: nothing recorded, the next window starts anew
    with _window():
        step()
    spans = recorded()
    tree = _tree(spans)
    assert tree[0] == ("step", None)
    assert [name for name, parent in tree if parent == "step"] == children
    inner = [name for name, parent in tree if parent not in (None, "step")]
    assert inner == (["randaug", "random_erasing", "mixup_cutmix"] if which == "classify"
                     else [])
    assert all(parent == "augment" for _, parent in tree[2:] if _ in inner)


@pytest.mark.cuda
def test_span_clock_matches_the_cards_kernels():
    """On the card: a sleep kernel inside a span lies inside the span's host
    interval within 50 us on the profiler's clock (a CUDA-only window, as
    the benchmark traces), the span's event pair reads the kernel's
    duration within 5%, and the device trace holds no activity named after
    a span (a GPU annotation there would count as device work)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench.trace import from_profiler

    dev = torch.device("cuda")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with _window([torch.profiler.ProfilerActivity.CUDA]) as prof:
        with span("step", dev):
            with span("augment", dev):
                torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    spans = recorded()
    device = from_profiler(prof).device
    assert not [a for a in device if a.name in ("step", "augment")]
    (kernel,), (outer, inner) = [a for a in device if a.kind == "kernel"], spans
    assert outer.start_ns / 1e3 - 50 <= kernel.start and kernel.end <= outer.end_ns / 1e3 + 50
    assert inner.device_ms == pytest.approx((kernel.end - kernel.start) / 1e3, rel=0.05)


# ---------------------------------------------------------------- the CLIs


# The logged run of both CLIs: 2 epochs of 3 steps (24 images in batches of
# 8, one a device of the JAX CPU mesh), logged every 2nd step of an epoch.
LOGGED = ["--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "16", "--patch_size", "8",
          "--batch_size", "8", "--warmup_epochs", "0", "--dataset_type", "synthetic",
          "--synthetic_len", "24", "--epochs", "2", "--log_interval", "2", "--num_workers", "2",
          "--watch_gradients", "--use_tensorboard", "--use_wandb", "--wandb_project", "p",
          "--wandb_entity", "e", "--wandb_id", "i"]
# A second, shorter run into the same --output_dir.
AGAIN = ["--model", "mae_vit_tiny_MsLdCeCd", "--input_size", "16", "--patch_size", "8",
         "--batch_size", "8", "--warmup_epochs", "0", "--dataset_type", "synthetic",
         "--synthetic_len", "24", "--epochs", "1", "--max_steps", "1", "--num_workers", "2"]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX pretrain CLI's logged run under the stand-in wandb, then a
    second run into the same --output_dir: (the first run's result, the
    wandb calls, the --output_dir)."""
    from cross_scale_mae_tpu.cli import pretrain as jcli

    out = str(tmp_path_factory.mktemp("jax_out"))
    saved, fake = sys.modules.get("wandb"), FakeWandb()
    sys.modules["wandb"] = fake
    try:
        first = jcli.main(jcli.get_args_parser().parse_args(LOGGED + ["--output_dir", out]))
    finally:
        if saved is None:
            sys.modules.pop("wandb", None)
        else:
            sys.modules["wandb"] = saved
    jcli.main(jcli.get_args_parser().parse_args(AGAIN + ["--output_dir", out]))
    return first, list(fake.calls), out


def test_pretrain_cli_logs_steps_to_tensorboard_and_wandb(tmp_path, fake_wandb, jax_runs):
    """At every --log_interval-th step of an epoch the metrics (with
    --watch_gradients the subtree norms) reach TensorBoard and wandb on the
    epoch_1000x axis at the JAX CLI's x positions (its cli/pretrain.py:400-
    407, run here with the same stand-in wandb); wandb gets the config and
    the run name and is finished; log.jsonl gets one record an epoch with
    the JAX CLI's keys."""
    jres, jcalls, _ = jax_runs
    res = _pretrain(tmp_path, *LOGGED[LOGGED.index("--synthetic_len"):], "--batch_size", "8")
    assert res["steps"] == 6
    # Epoch 0 at it 0 and 2, epoch 1 at it 0 and 2, as the JAX CLI logs.
    want_x = [p["step_1000x"] for kind, *rest in jcalls if kind == "log" for p in rest]
    assert want_x == [0, 666, 1000, 1666]
    scalars = _scalars(res["tensorboard_dir"])
    assert [s for s, _ in scalars["loss"]] == want_x
    assert sorted(scalars) == sorted(_scalars(os.path.join(jres["output_dir"], "tb")))
    assert "gnorm/encoder_blocks" in scalars and "grad_norm" in scalars
    np.testing.assert_allclose(scalars["loss"][-1][1], res["last_metrics"]["loss"], rtol=1e-6)
    init, *logs, finish = fake_wandb.calls
    assert init[0] == "init" and finish == ("finish",)
    assert init[1]["project"] == "p" and init[1]["entity"] == "e" and init[1]["id"] == "i"
    assert init[1]["resume"] == "allow" and init[1]["config"]["attention_impl"] == "pallas_v3"
    assert init[1]["name"] == jcalls[0][1]["name"]
    assert [p["step_1000x"] for _, p in logs] == want_x
    assert [sorted(p) for _, p in logs] == [sorted(p) for kind, *rest in jcalls
                                            if kind == "log" for p in rest]
    lines = open(os.path.join(res["output_dir"], "log.jsonl")).read().splitlines()
    jlines = open(os.path.join(jres["output_dir"], "log.jsonl")).read().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [0, 1]
    assert [sorted(json.loads(x)) for x in lines] == [sorted(json.loads(x)) for x in jlines]


def test_two_runs_into_one_output_dir_make_the_jax_clis_tree(tmp_path, jax_runs):
    """Two pretrain runs into one --output_dir: each in its own run
    directory, the second with the +1 suffix, named as the JAX CLI names
    its two (auto_output_dir); a resume finds the newest checkpoint of
    either through cli/launch.find_latest_checkpoints. The finetune CLI
    names its runs the same way."""
    from cross_scale_mae_torch.cli import finetune
    from cross_scale_mae_torch.cli.pretrain import get_args_parser, main

    _, _, jax_out = jax_runs
    out = tmp_path / "out"
    first = main(get_args_parser().parse_args(
        AGAIN + ["--ckpt_interval", "1", "--device", "cpu", "--output_dir", str(out)]))
    second = main(get_args_parser().parse_args(AGAIN + ["--device", "cpu",
                                                        "--output_dir", str(out)]))
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_out))
    assert second["output_dir"] == first["output_dir"] + "+1"
    for res in (first, second):
        assert os.path.dirname(res["npz"]) == res["output_dir"]
        assert {"log.jsonl", "config.json"} <= set(os.listdir(res["output_dir"]))
    ft = [finetune.main(finetune.get_args_parser().parse_args(
        TINY_CLASSIFIER + ["--max_steps", "1", "--output_dir", str(tmp_path / "ft")]))
        for _ in range(2)]
    assert ft[1]["output_dir"] == ft[0]["output_dir"] + "+1"
    assert os.path.basename(ft[0]["output_dir"]).startswith("run_ft_vit_base_patch16-in_sz_16")
    assert sorted(os.listdir(tmp_path / "ft")) == sorted(
        os.path.basename(r["output_dir"]) for r in ft)


@pytest.mark.parametrize("cli", ["finetune", "linprobe"])
def test_classifier_clis_set_up_and_close_tensorboard_and_wandb(tmp_path, fake_wandb, cli,
                                                                capsys):
    """As in the JAX CLIs (cli/finetune.py:389-392, cli/linprobe.py:216-219):
    the loggers are opened with the run and closed at its end, log.jsonl
    gets the evaluation; --profile_dir is reported as not applicable."""
    import importlib

    mod = importlib.import_module(f"cross_scale_mae_torch.cli.{cli}")
    res = mod.main(mod.get_args_parser().parse_args(
        TINY_CLASSIFIER + ["--output_dir", str(tmp_path / cli), "--use_tensorboard",
                           "--use_wandb", "--wandb_project", "p", "--profile_dir", "prof"]))
    assert "not applicable here: --profile_dir" in capsys.readouterr().out
    assert not os.path.exists("prof") and not (tmp_path / cli / "prof").exists()
    assert [c[0] for c in fake_wandb.calls] == ["init", "finish"]
    init = fake_wandb.calls[0][1]
    assert init["project"] == "p" and init["name"].startswith("ft_" if cli == "finetune"
                                                              else "lin_")
    tb = res["tensorboard_dir"]
    assert tb.endswith("tb") and any(f.startswith("events.out.tfevents")
                                     for f in os.listdir(tb))
    run_dir = os.path.dirname(tb)
    records = [json.loads(x) for x in open(os.path.join(run_dir, "log.jsonl"))]
    assert len(records) == 1 and records[0]["epoch"] == 0 and "acc1" in records[0]


@pytest.mark.parametrize("cli", ["pretrain", "finetune", "linprobe"])
def test_jax_platforms_cpu_runs_on_the_cpu(tmp_path, cli, capsys):
    """--jax_platforms cpu, the JAX package's pin, runs the CLI as --device
    cpu (given after --device cuda here, so that the pin decides); any
    other platform refuses, naming --device."""
    import importlib

    mod = importlib.import_module(f"cross_scale_mae_torch.cli.{cli}")
    base = (TINY_PRETRAIN + ["--synthetic_len", "2", "--epochs", "1"] if cli == "pretrain"
            else TINY_CLASSIFIER)
    argv = base + ["--output_dir", str(tmp_path / cli), "--device", "cuda"]
    res = mod.main(mod.get_args_parser().parse_args(argv + ["--jax_platforms", "cpu"]))
    assert res["steps"] >= 1
    assert "--jax_platforms cpu: running as --device cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--device"):
        mod.main(mod.get_args_parser().parse_args(argv + ["--jax_platforms", "tpu"]))
