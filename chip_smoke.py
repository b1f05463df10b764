#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cross_scale_mae_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase raises and the script exits non-zero):

1. device: the card's name and power limit (nvidia-smi).
2. build: compile every CUDA kernel (``csrc/mha3_fwd.cu``, ``csrc/mha3_bwd.cu``),
   one nvcc each, all at once.
3. kernel: each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the serving and training paths give it, with its
   time, the plain version's, one PyTorch library call's as a yardstick
   (``scaled_dot_product_attention``, forward or backward), and the least
   time the card could take (``bound_ms``).
4. serving: a seeded random ``mae_vit_base_MsLdCeCd`` checkpoint (ViT-B
   width and depth, 128 px, bf16, ``attention_impl="pallas_v3"``) served by
   ``cli/serve.build_app`` over HTTP; concurrent ``/predict`` requests of 1,
   7, 64 and 100 rows are checked against the same weights run through the
   plain attention, and the kernel's launch count against the dispatches.
5. dispatch: one 64-image forward timed end to end through the kernel and
   through the plain attention, and a torch.profiler window of it (device
   time by kernel kind, device idle share).
6. train: ``cli/pretrain.main`` trains the flagship step (ViT-B MsLdCeCd,
   128 px, batch 384, bf16, ``pallas_v3``, tanh GELU, AdamW) on one
   repeated synthetic batch at a constant lr: every loss finite, the loss
   falling, 20 forward and 20 backward kernel launches per step. Then one
   step from the same weights and draws through the kernels and through
   the plain attention (loss and gradient norm within a bf16 budget); every
   parameter's gradient through K1b against the same step with K1b's plain
   version, leaf by leaf, with two controls (dS left in fp32; one head's dV
   zeroed) that the gates must catch; the step's ms, images/s and MFU, and
   a torch.profiler window (device time by kind, idle share).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits with code 1 and prints no result.
"""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# The serving checkpoint: ViT-B encoder, 12 blocks, 12 heads of 64.
SERVE_BATCH = 64
REQUEST_ROWS = (1, 7, 64, 100)
ROUNDS = 4
# The flagship pretrain step (bench.py:39-84): batch 384, so 2N = 768 rows
# through 12 encoder blocks (17 tokens, 12 heads of 64) and 8 decoder
# blocks (65 tokens, 16 heads of 32).
TRAIN_BATCH = 384
TRAIN_STEPS = 16
ATTN_PER_STEP = 20
# The kernels' shapes: (N, L, H, hd). The JSON line reports the forward at
# the serving shape and the backward at the decoder's training shape, the
# one that costs the step most; each entry names its case and shape.
SHAPES = {"serving": (64, 65, 12, 64), "train_enc": (768, 17, 12, 64),
          "train_dec": (768, 65, 16, 32), "long_seq": (8, 257, 12, 64)}
BWD_SHAPES = ("train_enc", "train_dec", "long_seq")
REPORTED = {"mha3_fwd": "serving", "mha3_bwd": "train_dec"}
# Relative gaps ||g_kernel - g_plain|| / ||g_plain|| of the parameters'
# gradients of one step, K1b against its plain version (same forward
# kernel, weights and draws), each limit set between the sound reading and
# a control's (PERF.md section 6). DIRECT_TOL holds the last decoder
# block's qkv kernel, whose gradient passes through one K1b launch and no
# other attention backward; LEAF_TOL holds every leaf, where bf16 rounding
# that differs anywhere grows through the depth to about 2**-9.
DIRECT_TOL = 2.0 ** -17
LEAF_TOL = 2.0 ** -6


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, inputs, reps: int = 30) -> float:
    """Mean device ms per call, cycling through ``inputs`` (enough buffers
    to exceed the 50 MB L2, so each call reads its input from HBM)."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    return max(byte_ms, flop_ms), ("bytes" if byte_ms >= flop_ms else "operations")


def mha3_bound_ms(n: int, l: int, h: int, hd: int, item: int) -> tuple[float, str]:
    """Least time for the attention forward: qkv read once, out written once,
    4*N*H*L*L*hd flops at the bf16 tensor-core peak."""
    d = h * hd
    return _bound((n * l * 3 * d + n * l * d) * item, 4 * n * h * l * l * hd)


def mha3_bwd_bound_ms(n: int, l: int, h: int, hd: int, item: int) -> tuple[float, str]:
    """Least time for the attention backward (the Pallas CostEstimate,
    attention.py:474-478): qkv and dO read once, dqkv written once
    (7*N*L*D elements), 10*N*H*L*L*hd flops at the bf16 tensor-core peak."""
    return _bound(7 * n * l * h * hd * item, 10 * n * h * l * l * hd)


def phase_device() -> str:
    """Returns the card's nvidia-smi "name, power limit" line, which every
    measured line carries as ``card``."""
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    log("device", kind=json.dumps(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return card


def phase_build() -> None:
    from cross_scale_mae_torch.ops.cuda_build import build_libraries

    t0 = time.perf_counter()
    logs = build_libraries(["mha3_fwd", "mha3_bwd"])
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(time.perf_counter() - t0, 2), ptxas=json.dumps(ptxas))


def _buffers(gen, nbytes_each: int, make) -> list:
    """Enough input sets to exceed the 50 MB L2 (so each timed call reads
    its inputs from HBM), at least two."""
    return [make(gen) for _ in range(min(16, max(2, math.ceil(120e6 / nbytes_each))))]


def phase_kernel(card: str) -> dict:
    """Each kernel against its plain version, bf16: mha3_fwd at four shapes,
    mha3_bwd at the three training and long-sequence shapes."""
    import torch.nn.functional as F

    from cross_scale_mae_torch.ops.attention import (
        _mha3_bwd_cuda,
        _mha3_fwd_cuda,
        mha3_bwd_reference,
        mha_v3_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"mha3_fwd": {}, "mha3_bwd": {}}

    def heads(x, n, l, h, hd):
        r = x.view(n, l, 3, h, hd).permute(2, 0, 3, 1, 4)
        return r[0], r[1], r[2]

    def report(name, label, row):
        rows[name][label] = row
        log("kernel", name=name, case=label, card=json.dumps(card),
            **{k: json.dumps(v) for k, v in row.items()})

    for label, (n, l, h, hd) in SHAPES.items():
        d = h * hd
        bufs = _buffers(gen, n * l * 3 * d * 2, lambda g: torch.randn(
            n, l, 3 * d, device="cuda", generator=g).bfloat16())
        got = _mha3_fwd_cuda(bufs[0], h)
        torch.cuda.synchronize()
        ref = mha_v3_reference(bufs[0], h).float()
        err = (got.float() - ref).abs().max().item()
        # One bf16 ulp at the largest output: both round P and the output to
        # bf16 from fp32 sums taken in another order.
        tol = 2.0 ** -7 * max(1.0, ref.abs().max().item())
        check(math.isfinite(err) and err <= tol,
              f"mha3_fwd {label}: max abs err {err} above {tol}")
        bound, bound_by = mha3_bound_ms(n, l, h, hd, 2)
        report("mha3_fwd", label, {
            "shape": [n, l, h, hd], "max_abs_err": err, "tol": tol,
            "kernel_ms": time_ms(lambda x: _mha3_fwd_cuda(x, h), bufs),
            "plain_ms": time_ms(lambda x: mha_v3_reference(x, h), bufs),
            "library_ms": time_ms(
                lambda x: F.scaled_dot_product_attention(*heads(x, n, l, h, hd)), bufs),
            "bound_ms": bound, "bound_by": bound_by,
        })
        del bufs, got, ref

    for label in BWD_SHAPES:
        n, l, h, hd = SHAPES[label]
        d = h * hd
        bufs = _buffers(gen, n * l * 4 * d * 2, lambda g: (
            torch.randn(n, l, 3 * d, device="cuda", generator=g).bfloat16(),
            torch.randn(n, l, d, device="cuda", generator=g).bfloat16()))
        got = _mha3_bwd_cuda(*bufs[0], h)
        torch.cuda.synchronize()
        ref = mha3_bwd_reference(*bufs[0], h).float()
        err = (got.float() - ref).abs().max().item()
        # One bf16 ulp at the largest gradient: both round P, dS and dqkv to
        # bf16 from fp32 values taken in another order.
        tol = 2.0 ** -7 * max(1.0, ref.abs().max().item())
        check(math.isfinite(err) and err <= tol,
              f"mha3_bwd {label}: max abs err {err} above {tol}")
        check(torch.equal(_mha3_bwd_cuda(*bufs[0], h), got),
              f"mha3_bwd {label}: a second launch gave other bits")

        # The library yardstick: scaled_dot_product_attention's backward
        # through autograd, on graphs built before the timing.
        graphs = []
        for qkv, do in bufs:
            leaf = qkv.detach().requires_grad_(True)
            out = F.scaled_dot_product_attention(*heads(leaf, n, l, h, hd))
            graphs.append((out, leaf, do.view(n, l, h, hd).transpose(1, 2)))
        bound, bound_by = mha3_bwd_bound_ms(n, l, h, hd, 2)
        report("mha3_bwd", label, {
            "shape": [n, l, h, hd], "max_abs_err": err, "tol": tol,
            "kernel_ms": time_ms(lambda x: _mha3_bwd_cuda(x[0], x[1], h), bufs),
            "plain_ms": time_ms(lambda x: mha3_bwd_reference(x[0], x[1], h), bufs),
            "library_ms": time_ms(lambda g: torch.autograd.grad(
                g[0], g[1], g[2], retain_graph=True), graphs),
            "bound_ms": bound, "bound_by": bound_by,
        })
        del bufs, graphs, got, ref
    return rows


def _post_npy(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        check(r.status == 200, f"/predict answered {r.status}")
        return np.load(io.BytesIO(r.read()))


def _get_json(url: str, path: str) -> dict:
    with urllib.request.urlopen(url + path, timeout=60) as r:
        check(r.status == 200, f"{path} answered {r.status}")
        return json.load(r)


def phase_serving(card: str) -> int:
    """Serve a seeded ViT-B checkpoint over HTTP; the forward kernel must
    launch 12 times per dispatch. Returns the served run's launches."""
    from cross_scale_mae_torch.cli.serve import build_app, get_args_parser
    from cross_scale_mae_torch.configs import get_mae_config
    from cross_scale_mae_torch.ops.attention import mha_v3
    from cross_scale_mae_torch.serving import build_serving_model
    from cross_scale_mae_torch.utils.checkpoint import save_params_npz
    from cross_scale_mae_torch.utils.params import random_mae_tree

    cfg = get_mae_config("mae_vit_base_MsLdCeCd", input_size=128, patch_size=16,
                         compute_dtype="bfloat16", attention_impl="pallas_v3",
                         gelu="tanh")
    tree = random_mae_tree(cfg, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        served_npz, plain_npz = f"{tmp}/served.npz", f"{tmp}/plain.npz"
        save_params_npz(served_npz, tree, cfg.to_json())
        # The same weights with the plain attention ('xla' runs
        # mha_v3_reference): the reference the served answers are held to.
        save_params_npz(plain_npz, tree, cfg.replace(attention_impl="xla").to_json())
        del tree
        args = get_args_parser().parse_args(
            ["--ckpt", served_npz, "--port", "0", "--batch_size", str(SERVE_BATCH),
             "--pool", "mean", "--device", "cuda", "--max_delay_ms", "5"])

        mha_v3.launches = mha_v3.bwd_launches = 0
        server, batcher = build_app(args)  # includes one warm-up dispatch
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            check(_get_json(url, "/healthz")["warm"], "/healthz: not warm")
            info = _get_json(url, "/info")
            canvas = info["input"][1]
            check(info["input"] == [SERVE_BATCH, 146, 146, 3], f"/info input {info['input']}")
            rng = np.random.default_rng(0)
            sent, answers = [], {}

            def post(key, arr):
                answers[key] = _post_npy(url, arr)

            t0 = time.perf_counter()
            for rnd in range(ROUNDS):
                threads = []
                for n in REQUEST_ROWS:
                    arr = rng.integers(0, 256, (n, canvas, canvas, 3), np.uint8)
                    sent.append(((rnd, n), arr))
                    threads.append(threading.Thread(target=post, args=((rnd, n), arr)))
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(600)
                    check(not t.is_alive(), "a /predict request hung")
            wall = time.perf_counter() - t0
            stats = _get_json(url, "/stats")
        finally:
            server.shutdown()
            batcher.close()
            server.server_close()
            thread.join(30)
        launches = mha_v3.launches
        check(mha_v3.bwd_launches == 0, "serving launched the backward kernel")
        expected = cfg.encoder_num_layers * (stats["dispatches"] + 1)
        check(launches == expected,
              f"kernel launches {launches} != 12 x (dispatches "
              f"{stats['dispatches']} + 1 warm-up) = {expected}")
        check(len(answers) == len(sent), "missing answers")

        plain = build_serving_model(plain_npz, pool="mean", batch_size=SERVE_BATCH,
                                    device="cuda")
        worst = 0.0
        for key, arr in sent:
            got = answers[key]
            check(got.shape == (len(arr), cfg.dim_model), f"{key}: shape {got.shape}")
            check(bool(np.isfinite(got).all()), f"{key}: non-finite features")
            ref = plain.fn(arr)
            err = np.abs(got - ref)
            # bf16 budget of the CPU tests (tests/test_torch_port_serving.py):
            # kernel and plain attention may round one ulp apart per block.
            max_tol = 2.0 ** -4 * max(1.0, float(np.abs(ref).max()))
            mean_tol = 2.0 ** -7 * max(1.0, float(np.abs(ref).mean()))
            check(err.max() <= max_tol and err.mean() <= mean_tol,
                  f"{key}: served vs plain max {err.max()} (tol {max_tol}), "
                  f"mean {err.mean()} (tol {mean_tol})")
            worst = max(worst, float(err.max()))
        check(mha_v3.launches == launches, "the plain reference launched the kernel")

        served = build_serving_model(served_npz, pool="mean", batch_size=SERVE_BATCH,
                                     device="cuda")
        phase_dispatch(card, served.fn, plain.fn, sent[-1][1][:SERVE_BATCH])

    rows = sum(len(a) for _, a in sent)
    p50 = stats["dispatch_ms_p50"]
    log("serving", card=json.dumps(card), requests=len(sent), rows=rows,
        dispatches=stats["dispatches"], launches=launches,
        dispatch_ms_p50=p50, dispatch_ms_p99=stats["dispatch_ms_p99"],
        imgs_per_s_at_p50=round(SERVE_BATCH / (p50 / 1e3), 1),
        http_rows_per_s=round(rows / wall, 1),
        mean_batch_fill=stats["mean_batch_fill"], max_abs_vs_plain=worst)
    return launches


def _kernel_ms_by_kind(prof) -> dict:
    """Device ms by kernel kind from a torch.profiler run."""
    kinds = {"mha3_fwd": 0.0, "mha3_bwd": 0.0, "matmul": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        if "mha3_fwd" in name or "mha3_bwd" in name:
            kind = "mha3_fwd" if "mha3_fwd" in name else "mha3_bwd"
        elif any(t in name for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
            kind = "matmul"
        else:
            kind = "other"
        kinds[kind] += e.self_device_time_total / 1e3
    return kinds


def phase_dispatch(card: str, served_fn, plain_fn, batch: np.ndarray, reps: int = 10) -> None:
    """One 64-image dispatch end to end (host clock, numpy in and out),
    through the kernel and through the plain attention, in turns (plain,
    kernel, kernel, plain); then a profiled window of the kernel path:
    device time by kernel kind. The device's idle share is taken against
    the unprofiled dispatch time, since the profiler slows the host."""
    from torch.profiler import ProfilerActivity, profile

    def wall_ms(fn):
        fn(batch)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(batch)  # ends in a device-to-host copy: synchronous
        return (time.perf_counter() - t0) / reps * 1e3

    p1, k1, k2, p2 = wall_ms(plain_fn), wall_ms(served_fn), wall_ms(served_fn), wall_ms(plain_fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            served_fn(batch)
        window_ms = (time.perf_counter() - t0) * 1e3
    kinds = _kernel_ms_by_kind(prof)
    busy = sum(kinds.values())
    log("dispatch", card=json.dumps(card), batch=len(batch),
        kernel_path_ms=json.dumps([k1, k2]), plain_path_ms=json.dumps([p1, p2]),
        profiled_ms_per_dispatch=window_ms / reps,
        device_ms_per_dispatch=json.dumps({k: v / reps for k, v in kinds.items()}),
        device_idle_share=(1 - busy / reps / ((k1 + k2) / 2)) if busy else "not measured")


def _bwd_reference_ds_fp32(qkv: torch.Tensor, do: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """The control of the direct-leaf gate: ``mha3_bwd_reference`` with dS
    left in fp32, the one rounding K1b must mirror, skipped."""
    from cross_scale_mae_torch.ops.attention import _softmax_fp32, _split_dims

    n, l, d, hd = _split_dims(qkv, num_heads)
    scale = hd ** -0.5
    r = qkv.reshape(n, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4).float()
    q, k, v = r[0], r[1], r[2]
    g = do.reshape(n, l, num_heads, hd).transpose(1, 2).float()
    p = _softmax_fp32(torch.matmul(q, k.transpose(-1, -2)) * scale)
    dv = torch.matmul(p.to(qkv.dtype).float().transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    out = torch.stack([torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv], dim=2)
    return out.permute(0, 3, 2, 1, 4).reshape(n, l, 3 * d).to(qkv.dtype)


def _leaf_grads(run, draws, bwd=None) -> tuple[float, dict]:
    """One batch's loss and every parameter's gradient by tree path, with no
    optimizer update; ``bwd`` stands in for the backward kernel's wrapper."""
    from cross_scale_mae_torch.data.datasets import DATASET_STATS
    from cross_scale_mae_torch.ops import attention
    from cross_scale_mae_torch.ops.augment import make_pretrain_augment
    from cross_scale_mae_torch.train.pretrain import make_pretrain_loss_fn
    from cross_scale_mae_torch.train.state import tree_items

    augment = make_pretrain_augment(*DATASET_STATS["synthetic"], run.cfg.input_size,
                                    dtype=run.cfg.compute_dtype)
    loss_fn = make_pretrain_loss_fn(run.cfg, augment)
    kernel_bwd = attention._mha3_bwd_cuda
    attention._mha3_bwd_cuda = bwd or kernel_bwd
    try:
        loss, _ = loss_fn(run.state.params, run.state.model_state, run.images, draws)
        loss.backward()
    finally:
        attention._mha3_bwd_cuda = kernel_bwd
    grads = {}
    for path, p in tree_items(run.state.params):
        grads["/".join(map(str, path))] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    return float(loss.detach()), grads


def _rel_gaps(got: dict, ref: dict) -> dict:
    """||got - ref|| / ||ref|| per leaf, over the leaves where ref is not 0."""
    gaps = {}
    for name, r in ref.items():
        norm = torch.linalg.vector_norm(r.float()).item()
        gap = torch.linalg.vector_norm((got[name] - r).float()).item()
        if norm == 0.0:
            check(gap == 0.0, f"{name}: gradient {gap} where the reference's is 0")
            continue
        gaps[name] = gap / norm
    return gaps


def _dv_head0_zeroed(kernel_bwd):
    """The control of the every-leaf gate: K1b (``kernel_bwd``) with head
    0's dV zeroed, a fault confined to one head's columns of every block's
    qkv gradient."""
    def bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int) -> torch.Tensor:
        out = kernel_bwd(qkv, do, num_heads)
        d = qkv.shape[-1] // 3
        out[..., 2 * d:2 * d + d // num_heads] = 0
        return out
    return bwd


def phase_train(card: str) -> tuple[int, int]:
    """Train the flagship step through ``cli/pretrain.main``; returns the
    kernels' (forward, backward) launches during that run."""
    from torch.profiler import ProfilerActivity, profile

    from cross_scale_mae_torch.cli.pretrain import build_run, get_args_parser
    from cross_scale_mae_torch.cli.pretrain import main as pretrain_main
    from cross_scale_mae_torch.ops.attention import mha_v3
    from cross_scale_mae_torch.train.state import tree_leaves
    from cross_scale_mae_torch.utils.flops import mae_train_flops_per_image, mfu

    with tempfile.TemporaryDirectory() as tmp:
        def argv(impl):
            return get_args_parser().parse_args([
                "--model", "mae_vit_base_MsLdCeCd", "--input_size", "128",
                "--patch_size", "16", "--mask_ratio", "0.75",
                "--batch_size", str(TRAIN_BATCH), "--synthetic_len", str(TRAIN_BATCH),
                # A constant lr: no warmup, and a cosine far longer than the run.
                "--warmup_epochs", "0", "--epochs", "100000",
                "--compute_dtype", "bfloat16", "--attention_impl", impl, "--gelu", "tanh",
                "--max_steps", str(TRAIN_STEPS), "--log_interval", "5", "--seed", "0",
                "--device", "cuda", "--output_dir", tmp])

        mha_v3.launches = mha_v3.bwd_launches = 0
        result = pretrain_main(argv("pallas_v3"))
        fwd, bwd = mha_v3.launches, mha_v3.bwd_launches
        losses, steps = result["losses"], result["steps"]
        check(steps == TRAIN_STEPS and len(losses) == steps, f"{steps} steps, {len(losses)} losses")
        check(all(math.isfinite(v) for v in losses), f"non-finite loss in {losses}")
        check(fwd == bwd == ATTN_PER_STEP * steps,
              f"kernel launches fwd {fwd}, bwd {bwd} != {ATTN_PER_STEP} x {steps} steps")
        check(losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}")
        check(os.path.getsize(result["npz"]) > 0, "no params.npz written")
        torch.cuda.empty_cache()

        # One step from the same weights and draws through the kernels and
        # through the plain attention ('xla' runs mha_v3_reference forward and
        # its autograd backward).
        runs = {impl: build_run(argv(impl)) for impl in ("pallas_v3", "xla")}
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(runs["pallas_v3"].state.params), tree_leaves(runs["xla"].state.params))),
            "the two runs did not start from the same weights")
        draws = runs["pallas_v3"].draws(0)
        # Every parameter's gradient through K1b, through its plain version
        # (same forward kernel), through the control (plain, dS in fp32) and
        # through the plain attention path, from the same weights and draws.
        from cross_scale_mae_torch.ops.attention import _mha3_bwd_cuda, mha3_bwd_reference

        kernel_run = runs["pallas_v3"]
        plain = _leaf_grads(kernel_run, draws[0], mha3_bwd_reference)[1]
        gaps = {name: _rel_gaps(_leaf_grads(run, draws[0], bwd)[1], plain) for name, run, bwd in (
            ("kernel", kernel_run, None), ("control_ds_fp32", kernel_run, _bwd_reference_ds_fp32),
            ("control_dv_head0_zeroed", kernel_run, _dv_head0_zeroed(_mha3_bwd_cuda)),
            ("xla_path", runs["xla"], None))}
        del plain
        direct = f"decoder_blocks/{kernel_run.cfg.decoder_num_layers - 1}/attn/qkv/kernel"
        readings = {name: {"direct": g[direct], "worst": max((v, k) for k, v in g.items()),
                           "least_qkv": min((v, k) for k, v in g.items()
                                            if k.endswith("attn/qkv/kernel"))}
                    for name, g in gaps.items()}
        log("train_grads", card=json.dumps(card), leaves=len(gaps["kernel"]),
            direct_leaf=direct, direct_tol=DIRECT_TOL, leaf_tol=LEAF_TOL,
            **{name: json.dumps(r) for name, r in readings.items()})
        sound = readings["kernel"]
        check(sound["direct"] <= DIRECT_TOL and sound["worst"][0] <= LEAF_TOL,
              f"K1b vs its plain version in the step: {sound}, limits {DIRECT_TOL} "
              f"({direct}) and {LEAF_TOL} (every leaf)")
        # Each control must trip its gate, or the gate could not see that fault.
        check(readings["control_ds_fp32"]["direct"] > DIRECT_TOL,
              f"dS left in fp32 stays within {DIRECT_TOL} at {direct}")
        check(readings["control_dv_head0_zeroed"]["least_qkv"][0] > LEAF_TOL,
              f"head 0's dV zeroed leaves a block's qkv kernel within {LEAF_TOL}")
        first = {}
        for impl, run in runs.items():
            f0, b0 = mha_v3.launches, mha_v3.bwd_launches
            _, m = run.step_fn(run.state, run.images, draws)
            first[impl] = (float(m["loss"]), float(m["grad_norm"]))
            launched = (mha_v3.launches - f0, mha_v3.bwd_launches - b0)
            check(launched == ((ATTN_PER_STEP,) * 2 if impl == "pallas_v3" else (0, 0)),
                  f"{impl} step launched {launched}")
        (kl, kg), (pl, pg) = first["pallas_v3"], first["xla"]
        # bf16 budget: the two paths round attention's P, dP and dS at other
        # places in 20 blocks; the loss (a mean over ~10^7 terms) is held to
        # one bf16 ulp relative, 2**-7, and the gradient norm to 2**-5.
        dl, dg = abs(kl - pl) / abs(pl), abs(kg - pg) / abs(pg)
        check(dl <= 2.0 ** -7 and dg <= 2.0 ** -5,
              f"kernel vs plain step: loss {kl} vs {pl} (rel {dl}), "
              f"grad norm {kg} vs {pg} (rel {dg})")

        def step_ms(run, reps=3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                run.step_fn(run.state, run.images, run.draws(run.state.step))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        kernel, plain = runs["pallas_v3"], runs["xla"]
        p1, k1, k2, p2 = step_ms(plain), step_ms(kernel), step_ms(kernel), step_ms(plain)
        reps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                kernel.step_fn(kernel.state, kernel.images, kernel.draws(kernel.state.step))
            torch.cuda.synchronize()
        kinds = _kernel_ms_by_kind(prof)
        busy = sum(kinds.values())
        cfg = kernel.cfg
        del runs, kernel, plain

    ms = result["steady_ms_per_step"]
    imgs_per_s = TRAIN_BATCH / (ms / 1e3)
    flops = mae_train_flops_per_image(cfg)
    log("train", card=json.dumps(card), steps=steps, batch=TRAIN_BATCH,
        loss_first=losses[0], loss_last=losses[-1], launches_fwd=fwd, launches_bwd=bwd,
        ms_per_step=ms, imgs_per_s=imgs_per_s, train_flops_per_image=flops,
        mfu=mfu(imgs_per_s, flops),
        kernel_vs_plain_loss=json.dumps([kl, pl]), kernel_vs_plain_grad_norm=json.dumps([kg, pg]),
        kernel_step_ms=json.dumps([k1, k2]), plain_step_ms=json.dumps([p1, p2]))
    log("train_profile", card=json.dumps(card),
        device_ms_per_step=json.dumps({k: v / reps for k, v in kinds.items()}),
        device_idle_share=(1 - busy / reps / ((k1 + k2) / 2)) if busy else "not measured")
    return fwd, bwd


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    rows = phase_kernel(card)
    # Each path is driven with the counts set to 0 just before it and read
    # just after it: serving (forward only), then training.
    served = phase_serving(card)
    train_fwd, train_bwd = phase_train(card)
    by_path = {"mha3_fwd": {"serving": served, "train": train_fwd},
               "mha3_bwd": {"serving": 0, "train": train_bwd}}
    replaces = {"mha3_fwd": "cross_scale_mae_tpu/ops/attention.py:326",
                "mha3_bwd": "cross_scale_mae_tpu/ops/attention.py:355"}
    kernels = []
    for name, line in replaces.items():
        case = REPORTED[name]
        row = rows[name][case]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cross_scale_mae_torch/csrc/{name}.cu", "replaces": line,
            "case": case, "shape": row["shape"],
            "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
