#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cross_scale_mae_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase raises and the script exits non-zero):

1. device: the card's name and power limit (nvidia-smi).
2. build: compile every CUDA kernel of the serving path from ``csrc/``.
3. kernel: each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the serving and training paths give it, with its
   time, the plain version's, one PyTorch library call's as a yardstick, and
   the least time the card could take (``bound_ms``).
4. serving: a seeded random ``mae_vit_base_MsLdCeCd`` checkpoint (ViT-B
   width and depth, 128 px, bf16, ``attention_impl="pallas_v3"``) served by
   ``cli/serve.build_app`` over HTTP; concurrent ``/predict`` requests of 1,
   7, 64 and 100 rows are checked against the same weights run through the
   plain attention, and the kernel's launch count against the dispatches.
5. dispatch: one 64-image forward timed end to end through the kernel and
   through the plain attention, and a torch.profiler window of it (device
   time by kernel kind, device idle share).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits with code 1 and prints no result.
"""

from __future__ import annotations

import io
import json
import math
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


def mha3_bound_ms(n: int, l: int, h: int, hd: int, item: int) -> tuple[float, str]:
    """Least time for the attention forward: qkv read once, out written once,
    4*N*H*L*L*hd flops at the bf16 tensor-core peak."""
    d = h * hd
    byte_ms = (n * l * 3 * d + n * l * d) * item / PEAK_BYTES_PER_S * 1e3
    flop_ms = 4 * n * h * l * l * hd / PEAK_BF16_FLOPS * 1e3
    return max(byte_ms, flop_ms), ("bytes" if byte_ms >= flop_ms else "operations")


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log("device", kind=json.dumps(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name


def phase_build() -> None:
    from cross_scale_mae_torch.ops.cuda_build import build_libraries

    t0 = time.perf_counter()
    logs = build_libraries(["mha3_fwd"])
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(time.perf_counter() - t0, 2), ptxas=json.dumps(ptxas))


def phase_kernel(card: str) -> dict:
    """mha_v3's kernel against mha_v3_reference, bf16, four shapes."""
    import torch.nn.functional as F

    from cross_scale_mae_torch.ops.attention import _mha3_fwd_cuda, mha_v3_reference

    shapes = [("serving", 64, 65, 12, 64), ("train_enc", 768, 17, 12, 64),
              ("train_dec", 768, 65, 16, 32), ("long_seq", 8, 257, 12, 64)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for label, n, l, h, hd in shapes:
        d = h * hd
        nbytes = n * l * 3 * d * 2
        nbuf = min(16, max(2, math.ceil(120e6 / nbytes)))
        bufs = [torch.randn(n, l, 3 * d, device="cuda", generator=gen).bfloat16()
                for _ in range(nbuf)]
        got = _mha3_fwd_cuda(bufs[0], h)
        torch.cuda.synchronize()
        ref = mha_v3_reference(bufs[0], h).float()
        err = (got.float() - ref).abs().max().item()
        # One bf16 ulp at the largest output: both round P and the output to
        # bf16 from fp32 sums taken in another order.
        tol = 2.0 ** -7 * max(1.0, ref.abs().max().item())
        check(math.isfinite(err) and err <= tol,
              f"mha3_fwd {label}: max abs err {err} above {tol}")

        def sdpa(x, n=n, l=l, h=h, hd=hd):
            r = x.view(n, l, 3, h, hd).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(r[0], r[1], r[2])

        bound, bound_by = mha3_bound_ms(n, l, h, hd, 2)
        row = {
            "shape": [n, l, h, hd], "max_abs_err": err, "tol": tol,
            "kernel_ms": time_ms(lambda x: _mha3_fwd_cuda(x, h), bufs),
            "plain_ms": time_ms(lambda x: mha_v3_reference(x, h), bufs),
            "library_ms": time_ms(sdpa, bufs),
            "bound_ms": bound, "bound_by": bound_by,
        }
        rows[label] = row
        log("kernel", name="mha3_fwd", case=label, card=json.dumps(card),
            **{k: json.dumps(v) for k, v in row.items()})
        del bufs, got, ref
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
    """Serve a seeded ViT-B checkpoint over HTTP; returns the kernel's
    launches during the served run."""
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

        mha_v3.launches = 0
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
    kinds = {"mha3_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        if "mha3_fwd" in name:
            kind = "mha3_fwd"
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    rows = phase_kernel(card)
    launches = phase_serving(card)
    serving = rows["serving"]
    print(json.dumps({"kernels": [{
        "name": "mha3_fwd", "route": "cuda",
        "source": "cross_scale_mae_torch/csrc/mha3_fwd.cu",
        "replaces": "cross_scale_mae_tpu/ops/attention.py:326",
        "launches": launches, "max_abs_err": serving["max_abs_err"],
        "ms": serving["kernel_ms"], "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
