#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cross_scale_mae_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase raises and the script exits non-zero):

1. device: the card's name and power limit (nvidia-smi).
2. build: compile every CUDA kernel (``ops/cuda_build.KERNELS``: K1
   ``csrc/mha3_fwd.cu`` and ``csrc/mha3_bwd.cu``, K2 ``csrc/mha_fwd.cu`` and
   ``csrc/mha_bwd.cu``, K3 ``csrc/mha2_fwd.cu`` and ``csrc/mha2_bwd.cu``),
   one nvcc each, all at once; the phase fails unless ptxas reports every
   tensor-core instantiation (the bodies of ``csrc/mha_tc.cuh``,
   ``TC_KERNELS``) and none of them spills.
3. kernel: each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the serving, pretraining, finetuning and linear
   probing paths give it (K3, which no path dispatches, at ViT-B's, the decoder's and the
   longest shape), with its time, the plain version's, one PyTorch library
   call's as a yardstick (``scaled_dot_product_attention`` on (N, H, L, hd)
   head views, forward or backward), and the least time the card could
   take (``bound_ms``). The outputs of K1b, K2 and K3 are gated one by
   one, with the other family's rounding order on the same inputs (K2's
   for K1b, K1's for K2 and K3) as the control the gate must catch; the
   rows of each tensor-core kernel (K1f, K1b, K2f, K2b, K3f, K3b) name its
   design; K1f, K1b, K2b, K3f and K3b must give the same bits on a second
   launch, and K1b's, K2b's and K3b's bf16 outputs must be their fp32
   outputs rounded. K3b's fp32 outputs are read against K2's arithmetic
   in float64 on the same bytes (``k3b_fp64_gaps``), output by output,
   beside the plain version in fp32 and K1's order: the kernel within
   ``FP64_LEAF_TOL``, K1's order above it (``k3b_fp64_gate``).
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
   version, leaf by leaf, gated with one head's dV zeroed as the control
   the gate must catch; the last decoder block's qkv kernel (the direct
   leaf, one K1b launch) printed beside ``DIRECT_TOL`` and a dS-fp32
   control, no longer gating (phase 7 holds it); the step's ms, images/s
   and MFU, and a torch.profiler window (device time by kind, idle share).
7. train_grads_fp64: the same weights and draws; the last decoder block's
   K1b inputs (qkv, dO) and that block's qkv-projection input X captured
   in one step. The direct leaf, g = X^T dqkv, in float64 from fp32
   gradients left unrounded: the kernel's (its fp32-output entry), the
   plain version's arithmetic in fp32 (``k1_bwd_math``), dS left in fp32
   and P left in fp32, each against K1's arithmetic in float64 with P and
   dS rounded to bf16 (``k1_fp64_gaps``), on the whole leaf and on its q,
   k and v columns. Gate: the kernel within ``K1_C_SOUND`` x the plain
   version's reading everywhere; each control above ``K1_C_CONTROL`` x it
   on the columns it breaks (q and k for dS, v for P). On the same inputs,
   the bf16 kernel against its plain version (the ``[kernel]`` gate, K2's
   order as the control) and its bf16 outputs equal to its fp32 outputs
   rounded.
8. ddp: the data-parallel path (``parallel/``) at world size 1: a
   one-rank NCCL group joined through ``parallel/dist.py``, then
   ``cli/pretrain.main`` trains the flagship step in ``--ddp_mode gspmd``
   and in ``shard_map`` (every loss finite and falling, 20 forward and 20
   backward K1 launches per step); one step from the same weights and
   draws through each mode and twice through the single-process step, the
   DP params held to the single step's (no farther from it than its own
   repeat: bit-equal when the step is deterministic, since at world size 1
   every collective is an identity); the steps timed in turns (the gspmd
   step within 2% of the single one, medians of ``DDP_ROUNDS`` rounds), and
   the NCCL kernels' device ms from a torch.profiler window.
9. finetune: ``cli/finetune.main`` finetunes ViT-L (``vit_large_patch16``,
   64 px, patch 8, 62 classes, batch 512, bf16, ``attention_impl="pallas"``,
   tanh GELU, drop_path 0.1, smoothing 0.1, layer decay 0.75) for 10 steps
   over five synthetic batches and evaluates (the last eval batch ragged),
   then 12 steps on one repeated batch: every loss finite, the loss falling
   on the repeated batch at a constant lr, 24 K2 forward and backward
   launches per step and 24 forward per eval batch, eval stats finite with
   the confusion matrix summing to the eval count. Then the step from the
   same weights and draws through the kernels and the plain attention
   (timed in turns; loss and gradient norm within the bf16 budget), a
   torch.profiler window, and every parameter's gradient through K2b
   against K2b's plain version, every leaf gated with head 0's dV zeroed as
   the control the gate must catch; the last block's qkv kernel (the
   direct leaf, one K2b launch) printed beside ``FT_DIRECT_TOL`` and a
   dS-rounded control, no longer gating (phase 10 holds it).
10. finetune_grads_fp64: the same weights and draws; the last block's K2b
   inputs (q, k, v, dO) and that block's qkv-projection input X captured in
   one step. The direct leaf, g = X^T (dq | dk | dv), in float64 from
   fp32 gradients left unrounded: the kernel's (its fp32-output entry), the
   plain version's arithmetic in fp32, K1's order (P and dS rounded to
   bf16) and dS alone rounded, each against the same arithmetic in float64
   (``fp64_gaps``), on the whole leaf and on its q, k and v columns. Gate:
   the kernel within ``FP64_LEAF_TOL`` everywhere, K1's order above it on
   the whole leaf. On the same inputs, the bf16 kernel against its plain
   version (the ``[kernel]`` gate, K1's order as the control) and its bf16
   outputs equal to its fp32 outputs rounded.
11. linprobe: ``cli/linprobe.main`` at the linprobe.sh settings (ViT-B/16 at
   full width and depth, 128 px, the cls-token head behind the BN head,
   batch 1024, LARS with blr 0.1, bf16, ``attention_impl`` resolved to
   ``pallas_v3``) from the ``[train]`` phase's params.npz, over NAIP
   ``.npy`` tiles written from a seed (4 batches of train tiles on the 128
   canvas, 1.5 batches of eval tiles on the 146 canvas, each class's tiles
   offset in brightness) through the loader and ``device_prefetch``: 2
   epochs with an eval after each, then 12 steps on one repeated batch at
   a constant lr. Every loss finite, the loss falling on the repeated
   batch, every backbone leaf bit-identical, the head and the BN
   statistics moved, K1f launches = 12 x (steps + eval batches) and no
   backward launch, the confusion matrix summing to the eval count, peak
   device memory under a forward-only estimate, one epoch through
   ``device_prefetch`` equal to the host batches byte for byte on the
   card; ms per step (the second epoch, from its loader's start to its
   last step's end), images/s end to end and of the loader alone, MFU, a
   torch.profiler window over one epoch (device time by kind, idle share),
   and the eval logits and one train step from the same weights, batch and
   draws through K1f and through the plain attention (logits, loss and
   gradient norm within a bf16 budget).
12. native: host decode of the loader's two backends on the same seeded
    files, one epoch each: 128 px JPEGs (an fMoW-RGB CSV) and 13-band
    uint16 TIFFs (an fMoW-Sentinel CSV, bands 0, 9 and 10 dropped), through
    the native C++ core (``data/native``, built with g++ into
    ``build/native/`` with the codec libraries whose headers the host has;
    uncompressed TIFFs need none) and through the Python path; images/s of
    each, the core's codecs, the host's CPU. The TIFF batches of the two
    backends must be equal byte for byte; a source whose codec the core
    lacks reads "not measured" on the native side.
13. temporal: ``cli/pretrain.main --dataset_type fmow_temporal`` trains
    the flagship step (ViT-B MsLdCeCd, 128 px, mask 0.75, bf16,
    ``pallas_v3``) on seeded JPEG pairs through the loader, 384 pairs (768
    frames) a step: 6 steps over 3 batches an epoch, then 12 on one repeated
    batch of pairs at a constant lr. Every loss finite, the loss falling on
    the repeated batch, 20 + 20 K1 launches a step, the draws 2 x 384 rows;
    the step's ms, pairs/s, MFU, and the loader's own pairs/s and backend.
14. sentinel: ``cli/finetune.main --dataset_type fmow_sentinel`` finetunes
    ViT-L (64 px, patch 8, batch 512, bf16, ``pallas``) on seeded 13-band
    TIFFs with ``--dropped_bands 0 9 10`` (10 channels in), 6 steps over 2
    batches an epoch, then the eval pass (one full and one ragged batch on
    the 73 px canvas). Both loaders on the native core, every loss finite,
    24 + 24 K2 launches a step and 24 per eval batch, the confusion matrix
    summing to the eval count; the step's ms, images/s, MFU, the loader's
    own images/s and backend.
15. resume: the flagship step (ViT-B MsLdCeCd, 128 px, batch 384, bf16,
    ``pallas_v3``) for 4 epochs of 2 steps over 768 synthetic images, one
    warmup epoch, a checkpoint per epoch, each run ``cli/pretrain.main`` in
    a process of its own. Run A unbroken, twice (A and A': their gap is the
    control); run B through ``cli/launch.main`` with one rank over NCCL,
    ended by the fault drill (``CSM_FAULT_STEP=5``) after step 5 in attempt
    1, relaunched with ``--resume`` from its step-4 checkpoint. Gates: B's
    params no farther from A's than A''s are; B's losses at steps 5-8
    within the A-A' spread; the launcher's state shows attempt 2 given
    ``--resume``; 20 + 20 K1 launches a step in every process and attempt;
    a truncated copy of a checkpoint refused by ``restore_checkpoint``.
    Printed: the checkpoint's bytes, the save and restore ms of the full
    state on one rank, the restore ms in the CLI, the recovery seconds (from
    attempt 1's exit to attempt 2's first step done on the card) and the
    steps redone.
    It runs last, so that its checkpoint writes (15 of 1.37 GB) touch no
    other phase's timing.
16. finetune_recipe (runs after phase 10): ``cli/finetune.main`` on the
    finetuning cell's ViT-L (64 px, patch 8, 62 classes, batch 512, bf16,
    ``pallas``) with the repo's finetuning recipe (``RECIPE_FLAGS``:
    scripts/finetune.sh's ``--mixup 0.8 --cutmix 1.0`` with its smoothing,
    layer decay and drop path, plus RandAugment ``rand-m9-mstd0.5-inc1`` and
    RandomErasing 0.25): 10 steps over five synthetic batches and the eval
    pass, then 2 steps each in ``--mixup_mode pair``, ``elem`` and with
    ``--cutmix_minmax 0.2 0.8``. Gates: every loss finite; 24 + 24 K2
    launches a step and 24 per eval batch; each confusion matrix summing to
    its eval count; the recipe step from the same weights and draws through
    the kernels and the plain attention within [finetune]'s bf16 budget;
    the recipe's batch on the card finite and its mixed targets' rows
    summing to 1. Printed: ms per step, images/s and MFU; the recipe step
    and [finetune]'s plain-augment step from the same weights timed in
    turns; device ms by kind, idle share, and the device ms of the
    ``randaug``, ``random_erasing`` and ``mixup_cutmix`` profiler ranges
    in one profiled window.
17. moments (runs after phase 16): ``cli/pretrain.main`` trains the
    flagship step (ViT-B MsLdCeCd, 128 px, batch 384, bf16, ``pallas_v3``)
    for 8 steps with ``--adam_mu_dtype bfloat16 --adam_nu_dtype bfloat16``,
    writing a checkpoint at step 8. Gates: the losses finite and falling;
    20 + 20 K1 launches a step; the checkpoint's moments bf16; restoring
    it into an fp32-moment state raises (and into a bf16 one does not).
    Printed: the optimizer state's bytes beside the fp32 state's, the
    checkpoint's bytes, and the bf16 and fp32 steps timed in turns (each
    run's first step left out; the CLI's own ms per step covers the
    checkpoint write).
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits with code 1 and prints no result.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
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
# The [ddp] phase: steps of each cli/pretrain.main run at world size 1, and
# rounds of the step timing in turns.
DDP_STEPS = 8
DDP_ROUNDS = 4
# The [resume] drill: the flagship step for 4 epochs of 2 steps (768
# synthetic images), one warmup epoch so the lr moves every step, a
# checkpoint per epoch; the fault ends attempt 1 after step 5, in epoch 2,
# so attempt 2 resumes from step 4 and redoes step 5.
RESUME_EPOCHS = 4
RESUME_LEN = 2 * TRAIN_BATCH
RESUME_FAULT = 5
RESUME_TIMEOUT_S = 600
# The kernels' shapes: (N, L, H, hd); "linprobe" is the ViT-B probe's batch
# of 1024, train steps and padded eval batches alike. The JSON line reports the forward at
# the serving shape and the backward at the decoder's training shape, the
# one that costs the step most; each entry names its case and shape.
SHAPES = {"serving": (64, 65, 12, 64), "train_enc": (768, 17, 12, 64),
          "train_dec": (768, 65, 16, 32), "long_seq": (8, 257, 12, 64),
          "linprobe": (1024, 65, 12, 64)}
BWD_SHAPES = ("train_enc", "train_dec", "long_seq")
# The K2 kernels' shapes, (N, L, H, hd) folded to (N*H, L, hd): the ViT-L
# finetune step, ViT-B's 65 tokens, and ViT-H at 224 px, the longest.
K2_SHAPES = {"finetune": (512, 65, 16, 64), "vit_b": (64, 65, 12, 64),
             "long_seq": (8, 257, 16, 80)}
# The K3 kernels' shapes, (N, L, H, hd) on the (N, L, 3H, hd) layout: ViT-B,
# the decoder, and ViT-H at 224 px, the longest. No path dispatches K3.
K3_SHAPES = {"vit_b": (64, 65, 12, 64), "decoder": (768, 65, 16, 32),
             "long_seq": (8, 257, 16, 80)}
REPORTED = {"mha3_fwd": "serving", "mha3_bwd": "train_dec", "mha_fwd": "finetune",
            "mha_bwd": "finetune", "mha2_fwd": "vit_b", "mha2_bwd": "vit_b"}
# The K2 kernels' gate on each output beside one bf16 ulp at its largest
# magnitude: mean |kernel - plain| / mean |plain|, set between the kernels'
# reading and that of K1's order on the same inputs, which rounds P (out,
# dv) or dS (dq, dk) to bf16 and so flips the rounding of a large share of
# the outputs (PERF.md section 6).
K2_MEAN_TOL = 2.0 ** -15
# Relative gaps ||g_kernel - g_plain|| / ||g_plain|| of the parameters'
# gradients of one step, K1b against its plain version (same forward
# kernel, weights and draws), each limit set between the sound reading and
# a control's (PERF.md section 6). DIRECT_TOL holds the last decoder
# block's qkv kernel, whose gradient passes through one K1b launch and no
# other attention backward; LEAF_TOL holds every leaf, where bf16 rounding
# that differs anywhere grows through the depth to about 2**-9.
DIRECT_TOL = 2.0 ** -17
LEAF_TOL = 2.0 ** -6
# The [train_grads_fp64] gate: ||g - g64|| / ||g64|| of the last decoder
# block's qkv kernel gradient from K1b's unrounded fp32 outputs, against
# K1's arithmetic in float64 (P and dS rounded to bf16 from their float64
# values), on the whole leaf and on its q, k and v columns. Any fp32 order
# flips some of those bf16 roundings, so what a sound version reads there
# depends on the inputs, and a fixed limit does not sit between it and the
# controls (on the step's own inputs dS left in fp32 reads under 2**-17 on
# the q columns); so the limit is relative: the kernel within K1_C_SOUND x
# the plain version's reading, and each control (dS or P left in fp32)
# above K1_C_CONTROL x it on the columns it breaks (PERF.md section 6).
K1_C_SOUND = 4.0
K1_C_CONTROL = 16.0
# The ViT-L finetune step (cli/finetune.py defaults, finetune.py:54-56):
# batch 512 of 64 px images, patch 8: 65 tokens through 24 blocks of 16
# heads of 64. Five batches make an epoch; the eval set is a quarter of
# that, 640 images, so its second batch is ragged.
FT_BATCH = 512
FT_STEPS = 10
FT_REPEAT_STEPS = 12
FT_ATTN = 24
FT_SYNTHETIC = 5 * FT_BATCH
FT_LR = 5e-4  # constant: no warmup, and a cosine far longer than the run
# Limits of the finetune step's leaf-wise gradient readings, K2b against its
# plain version: the last block's qkv kernel (one K2b launch; printed, no
# longer a gate, see FP64_LEAF_TOL) and every leaf (a gate), each set
# between the sound reading and its control's (PERF.md, section 6).
FT_DIRECT_TOL = 2.0 ** -17
FT_LEAF_TOL = 2.0 ** -6
# The [finetune_grads_fp64] gate: ||g - g64|| / ||g64|| of the last block's
# qkv kernel gradient from K2b's unrounded fp32 outputs, against the same
# arithmetic in float64, on the whole leaf and on each of its q, k and v
# columns. FT_DIRECT_TOL's number, held against the exact function rather
# than one fp32 summation order; K1's rounding order must read above it.
FP64_LEAF_TOL = 2.0 ** -17
# The linear probe (linprobe.sh): batch 1024 of 128 px NAIP tiles through
# ViT-B/16's 12 blocks (65 tokens, 12 heads of 64). Four batches make an
# epoch; the eval set is 1.5 batches on the 146 px canvas, so its second
# batch is ragged.
LP_BATCH = 1024
LP_TRAIN = 4 * LP_BATCH
LP_EVAL = LP_BATCH + LP_BATCH // 2
LP_CLASSES = 10
LP_STEPS = 8            # 2 epochs
LP_REPEAT_STEPS = 12
LP_ATTN = 12


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


def mha_bound_ms(n: int, l: int, h: int, hd: int, item: int) -> tuple[float, str]:
    """K2f's least time (the Pallas CostEstimate, attention.py:118-122):
    q, k, v read and out written once, 4*BH*L*hd elements, and 4*BH*L*L*hd
    flops at the bf16 tensor-core peak."""
    return _bound(4 * n * h * l * hd * item, 4 * n * h * l * l * hd)


def mha_bwd_bound_ms(n: int, l: int, h: int, hd: int, item: int) -> tuple[float, str]:
    """K2b's least time (attention.py:149-153): q, k, v, dO read and dq, dk,
    dv written once, 7*BH*L*hd elements, and 10*BH*L*L*hd flops."""
    return _bound(7 * n * h * l * hd * item, 10 * n * h * l * l * hd)


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


# The tensor-core instantiations (the csrc/mha_tc.cuh bodies) by kernel
# name, each over 4 head widths and one sweep or several: the build phase
# fails unless ptxas reports each of them, none spilling.
TC_KERNELS = {"mha3_fwd_tc_kernel": 8, "mha_fwd_tc_kernel": 8, "mha2_fwd_tc_kernel": 8,
              # bf16 and fp32 outputs
              "mha3_bwd_tc_kernel": 16, "mha_bwd_tc_kernel": 16, "mha2_bwd_tc_kernel": 16}
# Each bf16 tensor-core kernel's design, with the header constant that gives
# its bf16 terms of P (and dS).
TC_DESIGNS = {"mha3_fwd": ("kK1SplitTerms", "plain-order fp32 FMA logits, mma.sync P V x{}"),
              "mha3_bwd": ("kK1SplitTerms", "mma.sync, P and dS in bf16 x{}, rounded slice adds"),
              "mha_fwd": ("kSplitTerms", "mma.sync split-bf16 x{}"),
              "mha_bwd": ("kSplitTerms", "mma.sync split-bf16 x{}, rounded slice adds"),
              "mha2_fwd": ("kSplitTerms", "mma.sync split-bf16 x{}"),
              "mha2_bwd": ("kSplitTerms", "mma.sync split-bf16 x{}, rounded slice adds")}


def tc_design(name: str) -> str:
    """A bf16 tensor-core kernel's design as the [kernel] rows name it, with
    its split's term count read from csrc/mha_tc.cuh."""
    import re

    from cross_scale_mae_torch.ops.cuda_build import CSRC

    constant, design = TC_DESIGNS[name]
    terms = re.search(rf"constexpr int {constant} = (\d+);", (CSRC / "mha_tc.cuh").read_text())
    return design.format(terms.group(1))


def tc_instance(symbol: str) -> str | None:
    """The TC_KERNELS name of a mangled kernel symbol, or None."""
    import re

    found = re.search(r"\d(mha\w*?_tc_kernel)I", symbol)
    return found.group(1) if found and found.group(1) in TC_KERNELS else None


def ptxas_spills(text: str) -> dict:
    """{kernel: (spill store bytes, spill load bytes, registers)} from
    ``-Xptxas -v`` output: the "N bytes spill stores, N bytes spill loads"
    and "Used N registers" lines belong to the function of the "Function
    properties for" line above them."""
    found, name = {}, None
    for ln in text.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for", 1)[1].strip()
        elif "spill stores" in ln and name is not None:
            words = ln.replace(",", " ").split()
            found[name] = (int(words[words.index("spill") - 2]),
                           int(words[words.index("loads") - 3]))
        elif "Used" in ln and "registers" in ln and name in found:
            words = ln.split()
            found[name] += (int(words[words.index("registers,") - 1]),)
    return found


def tc_label(symbol: str) -> str:
    """A tensor-core instantiation's short name from its mangled symbol:
    kernel<head width, one sweep, output type>."""
    import re

    hd, single, out = re.search(r"_tc_kernelILi(\d+)ELb(\d)E(f|13__nv_bfloat16)?", symbol).groups()
    out = {"f": ",f32", "13__nv_bfloat16": ",bf16", None: ""}[out]
    return f"{tc_instance(symbol)}<{hd},{single}{out}>"


def phase_build() -> None:
    from cross_scale_mae_torch.ops.cuda_build import KERNELS, build_libraries

    t0 = time.perf_counter()
    logs = build_libraries(list(KERNELS))
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "registers" in ln or "spill" in ln]
    props = {tc_label(name): s for text in logs.values() for name, s in ptxas_spills(text).items()
             if tc_instance(name)}
    log("build", seconds=round(time.perf_counter() - t0, 2), ptxas=json.dumps(ptxas),
        tc_spills_registers=json.dumps(props))
    found = {k: sum(name.startswith(k + "<") for name in props) for k in TC_KERNELS}
    check(found == TC_KERNELS, f"tensor-core instantiations in ptxas output {found}, "
          f"expected {TC_KERNELS}")
    check(all(s[:2] == (0, 0) for s in props.values()),
          f"a tensor-core instantiation spills registers: {props}")


def _buffers(gen, nbytes_each: int, make) -> list:
    """Enough input sets to exceed the 50 MB L2 (so each timed call reads
    its inputs from HBM), at least two."""
    return [make(gen) for _ in range(min(16, max(2, math.ceil(120e6 / nbytes_each))))]


def phase_kernel(card: str) -> dict:
    """Each kernel against its plain version, bf16: mha3_fwd at the five
    shapes of SHAPES, mha3_bwd at the three training and long-sequence
    shapes."""
    import torch.nn.functional as F

    from cross_scale_mae_torch.ops.attention import (
        _mha3_bwd_cuda,
        _mha3_fwd_cuda,
        mha3_bwd_reference,
        mha_v3_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: {} for name in REPORTED}

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
        check(torch.equal(_mha3_fwd_cuda(bufs[0], h), got),
              f"mha3_fwd {label}: a second launch gave other bits")
        bound, bound_by = mha3_bound_ms(n, l, h, hd, 2)
        report("mha3_fwd", label, {
            "shape": [n, l, h, hd], "design": tc_design("mha3_fwd"), "max_abs_err": err,
            "tol": tol,
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
        qkv, do = bufs[0]
        got = _mha3_bwd_cuda(qkv, do, h)
        torch.cuda.synchronize()
        bwd = k1b_output_errors(got, qkv, do, h)
        _gate_outputs("mha3_bwd", label, bwd)
        check(torch.equal(_mha3_bwd_cuda(qkv, do, h), got),
              f"mha3_bwd {label}: a second launch gave other bits")
        check_rounded_tie(got.chunk(3, dim=-1), _mha3_bwd_cuda(
            qkv, do, h, out_dtype=torch.float32).chunk(3, dim=-1), f"mha3_bwd {label}")
        del qkv, do

        # The library yardstick: scaled_dot_product_attention's backward
        # through autograd, on graphs built before the timing.
        graphs = []
        for qkv, do in bufs:
            leaf = qkv.detach().requires_grad_(True)
            out = F.scaled_dot_product_attention(*heads(leaf, n, l, h, hd))
            graphs.append((out, leaf, do.view(n, l, h, hd).transpose(1, 2)))
        bound, bound_by = mha3_bwd_bound_ms(n, l, h, hd, 2)
        report("mha3_bwd", label, {
            "shape": [n, l, h, hd], "design": tc_design("mha3_bwd"),
            "max_abs_err": max(r["max_abs_err"] for r in bwd.values()), "outputs": bwd,
            "kernel_ms": time_ms(lambda x: _mha3_bwd_cuda(x[0], x[1], h), bufs),
            "plain_ms": time_ms(lambda x: mha3_bwd_reference(x[0], x[1], h), bufs),
            "library_ms": time_ms(lambda g: torch.autograd.grad(
                g[0], g[1], g[2], retain_graph=True), graphs),
            "bound_ms": bound, "bound_by": bound_by,
        })
        del bufs, graphs, got
    phase_kernel_k2(gen, report)
    phase_kernel_k3(gen, report)
    return rows


def _k1_order(q, k, v, do, h):
    """The control of the K2 kernel gates: K1's plain versions
    (``mha_v3_reference``, ``mha3_bwd_reference``) on the same folded
    (N*H, L, hd) inputs, which round P to the input dtype before PV and dV,
    and dS before dQ and dK, where K2 keeps both in fp32. Returns out and
    (dq, dk, dv), folded."""
    from cross_scale_mae_torch.ops.attention import (
        _fold,
        _unfold,
        mha3_bwd_reference,
        mha_v3_reference,
    )

    bh, l, hd = q.shape
    n = bh // h
    qkv = torch.stack([_unfold(t, n, h) for t in (q, k, v)], dim=2).reshape(n, l, 3 * h * hd)
    out = _fold(mha_v3_reference(qkv, h).view(n, l, h, hd))
    dqkv = mha3_bwd_reference(qkv, _unfold(do, n, h).reshape(n, l, h * hd), h)
    return out, tuple(_fold(t) for t in dqkv.view(n, l, 3, h, hd).unbind(2))


def _output_errors(got, ref, control) -> dict:
    """One output's readings: max abs error against the plain version, its
    limit (one bf16 ulp at the largest magnitude), and mean abs error over
    mean |ref| for the kernel and for the control (K1's rounding order for
    K2 and K3, K2's for K1b)."""
    ref = ref.float()
    mean_ref = ref.abs().mean().item()
    return {"max_abs_err": (got.float() - ref).abs().max().item(),
            "tol": 2.0 ** -7 * max(1.0, ref.abs().max().item()),
            "rel_mean_err": (got.float() - ref).abs().mean().item() / mean_ref,
            "control_rel_mean_err": (control.float() - ref).abs().mean().item() / mean_ref}


def _gate_outputs(name: str, label: str, readings: dict) -> None:
    """Each output within its own limits, and the control (the other
    kernel family's rounding order) outside the mean-error limit, or the
    gate could not see that fault."""
    for out, r in readings.items():
        where = f"{name} {label} {out}"
        check(math.isfinite(r["max_abs_err"]) and r["max_abs_err"] <= r["tol"],
              f"{where}: max abs err {r['max_abs_err']} above {r['tol']}")
        check(r["rel_mean_err"] <= K2_MEAN_TOL,
              f"{where}: mean abs err / mean |ref| {r['rel_mean_err']} above {K2_MEAN_TOL}")
        check(r["control_rel_mean_err"] > K2_MEAN_TOL,
              f"{where}: the control {r['control_rel_mean_err']} stays within "
              f"{K2_MEAN_TOL}")


def k1b_output_errors(got, qkv, do, num_heads: int) -> dict:
    """K1b's bf16 dqkv against ``mha3_bwd_reference``, output by output (dq,
    dk, dv: ``_output_errors``), with K2's order on the same inputs (P and
    dS left in fp32, ``k1_bwd_math``) as the control: each output within
    one bf16 ulp at its largest magnitude (both round P, dS and dqkv to bf16
    from fp32 values taken in another order) and within K2_MEAN_TOL in
    mean, which the control must exceed."""
    from cross_scale_mae_torch.ops.attention import mha3_bwd_reference

    control = k1_bwd_math(qkv, do, num_heads, round_p=False, round_ds=False).to(got.dtype)
    return {name: _output_errors(a, r, c) for name, a, r, c in zip(
        ("dq", "dk", "dv"), *(t.chunk(3, dim=-1) for t in (
            got, mha3_bwd_reference(qkv, do, num_heads), control)))}


def check_rounded_tie(bf16_grads, f32_grads, where: str) -> None:
    """A backward kernel's bf16 outputs (dq, dk, dv) must be its fp32
    outputs rounded to bf16, bit for bit: what lets a gate on the fp32
    outputs speak for the bf16 kernel."""
    for name, a, b in zip(("dq", "dk", "dv"), bf16_grads, f32_grads):
        check(b.dtype == torch.float32 and torch.equal(a, b.to(a.dtype)),
              f"{where} {name}: the bf16 output is not the fp32 output rounded")


def phase_kernel_k2(gen, report) -> None:
    """K2f and K2b against their plain versions on folded (N*H, L, hd)
    q, k, v (and dO), bf16, at every K2 shape, each output gated on its own
    with K1's order as the control."""
    import torch.nn.functional as F

    from cross_scale_mae_torch.ops.attention import (
        _mha_bwd_cuda,
        _mha_fwd_cuda,
        mha_folded_bwd_reference,
        mha_folded_reference,
    )

    for label, (n, l, h, hd) in K2_SHAPES.items():
        bh = n * h
        bufs = _buffers(gen, 4 * bh * l * hd * 2, lambda g: tuple(
            torch.randn(bh, l, hd, device="cuda", generator=g).bfloat16() for _ in range(4)))
        q, k, v, do = bufs[0]

        def heads(x):
            # The folded buffers seen as (N, H, L, hd), a free view: the
            # layout SDPA's fused kernels take.
            return [t.view(n, h, l, hd) for t in x]

        got, grads = _mha_fwd_cuda(q, k, v), _mha_bwd_cuda(q, k, v, do)
        torch.cuda.synchronize()
        control, control_grads = _k1_order(q, k, v, do, h)
        fwd = {"out": _output_errors(got, mha_folded_reference(q, k, v), control)}
        bwd = {name: _output_errors(a, r, c) for name, a, r, c in zip(
            ("dq", "dk", "dv"), grads, mha_folded_bwd_reference(q, k, v, do), control_grads)}
        _gate_outputs("mha_fwd", label, fwd)
        _gate_outputs("mha_bwd", label, bwd)
        check(all(torch.equal(a, b) for a, b in zip(_mha_bwd_cuda(q, k, v, do), grads)),
              f"mha_bwd {label}: a second launch gave other bits")
        check_rounded_tie(grads, _mha_bwd_cuda(q, k, v, do, out_dtype=torch.float32),
                          f"mha_bwd {label}")
        del got, grads, control, control_grads

        bound, bound_by = mha_bound_ms(n, l, h, hd, 2)
        report("mha_fwd", label, {
            "shape": [n, l, h, hd], "design": tc_design("mha_fwd"),
            "max_abs_err": fwd["out"]["max_abs_err"],
            "outputs": fwd,
            "kernel_ms": time_ms(lambda x: _mha_fwd_cuda(*x[:3]), bufs),
            "plain_ms": time_ms(lambda x: mha_folded_reference(*x[:3]), bufs),
            "library_ms": time_ms(lambda x: F.scaled_dot_product_attention(*heads(x[:3])), bufs),
            "bound_ms": bound, "bound_by": bound_by,
        })
        # The library yardstick: scaled_dot_product_attention's backward
        # through autograd, on graphs built before the timing.
        graphs = []
        for x in bufs:
            leaves = [t.detach().requires_grad_(True) for t in x[:3]]
            graphs.append((F.scaled_dot_product_attention(*heads(leaves)), leaves,
                           heads(x[3:])[0]))
        bound, bound_by = mha_bwd_bound_ms(n, l, h, hd, 2)
        report("mha_bwd", label, {
            "shape": [n, l, h, hd], "design": tc_design("mha_bwd"),
            "max_abs_err": max(r["max_abs_err"] for r in bwd.values()),
            "outputs": bwd,
            "kernel_ms": time_ms(lambda x: _mha_bwd_cuda(*x), bufs),
            "plain_ms": time_ms(lambda x: mha_folded_bwd_reference(*x), bufs),
            "library_ms": time_ms(lambda g: torch.autograd.grad(
                g[0], g[1], g[2], retain_graph=True), graphs),
            "bound_ms": bound, "bound_by": bound_by,
        })
        del bufs, graphs


def phase_kernel_k3(gen, report) -> None:
    """K3f and K3b against their plain versions on (N, L, 3H, hd) qkv (and
    (N, L, H, hd) dO), bf16, at every K3 shape, each output gated on its
    own with K1's order on the same bytes, seen as (N, L, 3D), as the
    control; K3b's bf16 outputs its fp32 outputs rounded, and those fp32
    outputs against float64 (``k3b_fp64_gate``). The bound counts K1's
    bytes and flops: the same tensors."""
    import torch.nn.functional as F

    from cross_scale_mae_torch.ops.attention import (
        _mha2_bwd_cuda,
        _mha2_fwd_cuda,
        mha_qkv_bwd_reference,
        mha_qkv_reference,
        mha_v3_reference,
    )

    for label, (n, l, h, hd) in K3_SHAPES.items():
        d = h * hd
        bufs = _buffers(gen, n * l * 4 * d * 2, lambda g: (
            torch.randn(n, l, 3 * h, hd, device="cuda", generator=g).bfloat16(),
            torch.randn(n, l, h, hd, device="cuda", generator=g).bfloat16()))
        qkv, do = bufs[0]

        def heads(qkv4):
            # q, k and v as (N, H, L, hd) views, the layout SDPA takes.
            return [t.transpose(1, 2) for t in qkv4.split(h, dim=2)]

        got = _mha2_fwd_cuda(qkv, h)
        torch.cuda.synchronize()
        control = mha_v3_reference(qkv.view(n, l, 3 * d), h).view(n, l, h, hd)
        fwd = {"out": _output_errors(got, mha_qkv_reference(qkv, h), control)}
        _gate_outputs("mha2_fwd", label, fwd)
        check(torch.equal(_mha2_fwd_cuda(qkv, h), got),
              f"mha2_fwd {label}: a second launch gave other bits")
        _, bwd, fp64 = k3b_gates(label, qkv, do, h)
        del got, control

        bound, bound_by = mha3_bound_ms(n, l, h, hd, 2)
        report("mha2_fwd", label, {
            "shape": [n, l, h, hd], "design": tc_design("mha2_fwd"),
            "max_abs_err": fwd["out"]["max_abs_err"], "outputs": fwd,
            "kernel_ms": time_ms(lambda x: _mha2_fwd_cuda(x[0], h), bufs),
            "plain_ms": time_ms(lambda x: mha_qkv_reference(x[0], h), bufs),
            "library_ms": time_ms(lambda x: F.scaled_dot_product_attention(*heads(x[0])), bufs),
            "bound_ms": bound, "bound_by": bound_by,
        })
        # The library yardstick: scaled_dot_product_attention's backward
        # through autograd, on graphs built before the timing.
        graphs = []
        for x, g in bufs:
            leaf = x.detach().requires_grad_(True)
            graphs.append((F.scaled_dot_product_attention(*heads(leaf)), leaf, g.transpose(1, 2)))
        bound, bound_by = mha3_bwd_bound_ms(n, l, h, hd, 2)
        report("mha2_bwd", label, {
            "shape": [n, l, h, hd], "design": tc_design("mha2_bwd"),
            "max_abs_err": max(r["max_abs_err"] for r in bwd.values()),
            "outputs": bwd, "fp64": fp64, "fp64_tol": FP64_LEAF_TOL,
            "kernel_ms": time_ms(lambda x: _mha2_bwd_cuda(*x, h), bufs),
            "plain_ms": time_ms(lambda x: mha_qkv_bwd_reference(*x, h), bufs),
            "library_ms": time_ms(lambda g: torch.autograd.grad(
                g[0], g[1], g[2], retain_graph=True), graphs),
            "bound_ms": bound, "bound_by": bound_by,
        })
        del bufs, graphs


def k3b_gates(label: str, qkv, do, num_heads: int) -> tuple:
    """K3b's [kernel] gates on bf16 qkv (N, L, 3H, hd) and dO (N, L, H,
    hd): each output against ``mha_qkv_bwd_reference`` (``_gate_outputs``,
    K1's order on the same bytes, seen as (N, L, 3D), the control), a
    second launch's bits, the bf16 outputs the fp32 outputs rounded, and
    the fp32 outputs against float64 (``k3b_fp64_gate``). Returns dqkv and
    the per-output and float64 readings."""
    from cross_scale_mae_torch.ops.attention import (
        _mha2_bwd_cuda,
        _qkv_heads,
        mha3_bwd_reference,
        mha_qkv_bwd_reference,
    )

    n, l, three_h, hd = qkv.shape
    h = num_heads
    dqkv = _mha2_bwd_cuda(qkv, do, h)
    torch.cuda.synchronize()
    control = mha3_bwd_reference(qkv.view(n, l, three_h * hd), do.view(n, l, h * hd), h)
    bwd = {name: _output_errors(a, r, c) for name, a, r, c in zip(
        ("dq", "dk", "dv"), dqkv.split(h, dim=2),
        mha_qkv_bwd_reference(qkv, do, h).split(h, dim=2),
        control.view(qkv.shape).split(h, dim=2))}
    _gate_outputs("mha2_bwd", label, bwd)
    check(torch.equal(_mha2_bwd_cuda(qkv, do, h), dqkv),
          f"mha2_bwd {label}: a second launch gave other bits")
    check_rounded_tie(dqkv.split(h, dim=2), _mha2_bwd_cuda(
        qkv, do, h, out_dtype=torch.float32).split(h, dim=2), f"mha2_bwd {label}")
    fp64 = k3b_fp64_gaps(qkv, do, h, {"kernel": lambda *t: _qkv_heads(
        _mha2_bwd_cuda(*t, out_dtype=torch.float32), h), **K3_FP64_VERSIONS})
    k3b_fp64_gate(label, fp64)
    return dqkv, bwd, fp64


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


MATMUL_NAMES = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
K1_KINDS = (("mha3_fwd", ("mha3_fwd",)), ("mha3_bwd", ("mha3_bwd",)),
            ("matmul", MATMUL_NAMES))
# The finetune step's: copy kernels (strided copies and stacks) hold the K2
# layout's fold/unfold transposes and the dtype casts.
K2_KINDS = (("mha_fwd", ("mha_fwd_kernel", "mha_fwd_tc_kernel")),
            ("mha_bwd", ("mha_bwd_kernel", "mha_bwd_tc_kernel")),
            ("matmul", MATMUL_NAMES), ("copies", ("copy", "catarray")))
# The linear probe's: the forward kernel, the matmuls, and the copies (dtype
# casts, the augment's and the prefetch's device copies).
LP_KINDS = (("mha3_fwd", ("mha3_fwd",)), ("matmul", MATMUL_NAMES),
            ("copies", ("copy", "catarray")))


# The port's torch.profiler ranges (ops/augment.py, train/classify.py): their
# device-side spans are ranges, not kernels, and are left out of the kinds.
RANGES = ("randaug", "color_jitter", "random_erasing", "mixup_cutmix")


def _kernel_ms_by_kind(prof, rules=K1_KINDS) -> dict:
    """Device ms by kernel kind from a torch.profiler run: the first rule
    whose name fragments a kernel's name holds, else "other"."""
    kinds = {name: 0.0 for name, _ in rules}
    kinds["other"] = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in RANGES:
            continue
        name = e.key.lower()
        kind = next((k for k, frags in rules if any(f in name for f in frags)), "other")
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


def k1_bwd_math(qkv, do, num_heads: int, dtype=torch.float32, round_p=True, round_ds=True):
    """``mha3_bwd_reference``'s arithmetic in ``dtype``, its output dqkv
    (N, L, 3D) left unrounded. ``round_p`` rounds P to the input dtype
    before dV and ``round_ds`` dS before dQ and dK: K1's two roundings, each
    from P's or dS's value in ``dtype``. Both off is K2's order."""
    from cross_scale_mae_torch.ops.attention import _softmax_fp32, _split_dims

    n, l, d, hd = _split_dims(qkv, num_heads)
    scale = hd ** -0.5
    r = qkv.reshape(n, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4).to(dtype)
    q, k, v = r[0], r[1], r[2]
    g = do.reshape(n, l, num_heads, hd).transpose(1, 2).to(dtype)
    p = _softmax_fp32(torch.matmul(q, k.transpose(-1, -2)) * scale)
    dv = torch.matmul((p.to(qkv.dtype).to(dtype) if round_p else p).transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    if round_ds:
        ds = ds.to(qkv.dtype).to(dtype)
    out = torch.stack([torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv], dim=2)
    return out.permute(0, 3, 2, 1, 4).reshape(n, l, 3 * d)


def _bwd_reference_ds_fp32(qkv: torch.Tensor, do: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """The control of the direct-leaf reading: ``mha3_bwd_reference`` with
    dS left in fp32, the one rounding K1b must mirror, skipped."""
    return k1_bwd_math(qkv, do, num_heads, round_ds=False).to(qkv.dtype)


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


# The versions [train_grads_fp64] holds against float64, besides the
# kernel: (qkv, dO, num_heads) -> dqkv in fp32, unrounded.
K1_FP64_VERSIONS = {
    "plain": k1_bwd_math,
    "control_ds_fp32": lambda *t: k1_bwd_math(*t, round_ds=False),
    "control_p_fp32": lambda *t: k1_bwd_math(*t, round_p=False),
}


def k1b_step_inputs(run, draws, bwd_name: str = "_mha3_bwd_cuda"):
    """The last decoder block's K1b inputs in one pretrain step
    (``_leaf_grads`` from ``run``'s weights with ``draws``): X, the input
    of that block's qkv projection, and the qkv and dO of its attention
    backward, caught by wrapping ``layers.attention`` and
    ``ops.attention.<bwd_name>`` (the kernel's wrapper on the card,
    ``mha3_bwd_reference`` on the CPU). The backward runs the last decoder
    block first."""
    from cross_scale_mae_torch.models import layers
    from cross_scale_mae_torch.ops import attention

    last = run.state.params["decoder_blocks"][-1]["attn"]
    attend, bwd = layers.attention, getattr(attention, bwd_name)
    seen = {}

    def attention_spy(p, x, *args, **kwargs):
        if p is last:
            seen["x"] = x.detach()
        return attend(p, x, *args, **kwargs)

    def bwd_spy(qkv, do, num_heads, *args, **kwargs):
        seen.setdefault("inputs", (qkv.detach(), do.detach().contiguous()))
        return bwd(qkv, do, num_heads, *args, **kwargs)

    layers.attention = attention_spy
    setattr(attention, bwd_name, bwd_spy)
    try:
        _leaf_grads(run, draws)
    finally:
        layers.attention = attend
        setattr(attention, bwd_name, bwd)
    x, inputs = seen["x"], seen["inputs"]
    # X and qkv belong to one block: qkv is X's projection.
    with torch.no_grad():
        qkv = layers.linear(last["qkv"], x).float()
    check(qkv.shape == inputs[0].shape and bool(
        (qkv - inputs[0].float()).abs().max() <= 2.0 ** -7 * qkv.abs().max()),
        "the captured X and qkv are not of one block")
    return x, inputs


def k1_direct_leaf(x, dqkv) -> torch.Tensor:
    """The last decoder block's qkv kernel gradient, g = X^T dqkv, in
    float64: X (N, L, D_in) and dqkv (N, L, 3D), which K1 writes in the qkv
    layout, so nothing is unfolded. Shape (D_in, 3D)."""
    return (x.reshape(-1, x.shape[-1]).double().T
            @ dqkv.reshape(-1, dqkv.shape[-1]).double())


def k1_fp64_gaps(x, inputs, num_heads: int, versions: dict) -> dict:
    """For each version ((qkv, dO, num_heads) -> unrounded dqkv): the direct
    leaf's and each output's gaps (``_gap_readings``) against
    ``k1_bwd_math`` in float64."""
    ref = k1_bwd_math(*inputs, num_heads, torch.float64)
    g64 = k1_direct_leaf(x, ref)
    readings = {}
    for name, fn in versions.items():
        dqkv = fn(*inputs, num_heads)
        readings[name] = _gap_readings(k1_direct_leaf(x, dqkv), g64, dqkv.chunk(3, dim=-1),
                                       ref.chunk(3, dim=-1))
    return readings


def k1_fp64_gate(readings: dict) -> None:
    """The [train_grads_fp64] gate on ``k1_fp64_gaps``' readings: the kernel
    within K1_C_SOUND x the plain version's on the whole leaf and on each
    column block; dS left in fp32 above K1_C_CONTROL x plain's on the q and
    k columns, P left in fp32 on the v columns, or the gate could not see
    those faults."""
    plain, sound = readings["plain"], readings["kernel"]
    check(all(sound[c] <= K1_C_SOUND * plain[c] for c in ("leaf", "q", "k", "v")),
          f"K1b's direct leaf against float64: {sound}, above {K1_C_SOUND} x the plain "
          f"version's {plain}")
    for name, cols in (("control_ds_fp32", "qk"), ("control_p_fp32", "v")):
        check(all(readings[name][c] > K1_C_CONTROL * plain[c] for c in cols),
              f"{name} stays within {K1_C_CONTROL} x the plain version on the {cols} "
              f"columns: {readings[name]}, plain {plain}")


def phase_train_grads_fp64(card: str) -> None:
    """K1b's direct-leaf accuracy against float64 on the pretrain step's own
    inputs ([train_grads]' weights and draws), with dS and P left in fp32
    as the controls the gate must catch; then, on the same inputs, the bf16
    kernel against its plain version (the [kernel] gate, K2's order as the
    control) and its bf16 outputs against its fp32 outputs rounded."""
    from cross_scale_mae_torch.cli.pretrain import build_run
    from cross_scale_mae_torch.ops.attention import _mha3_bwd_cuda

    # The plain version and the controls in full fp32: no TF32 in the matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        run = build_run(_train_argv(tmp, "pallas_v3"))
        x, inputs = k1b_step_inputs(run, run.draws(0)[0])
        h = run.cfg.decoder_num_heads
        del run
    torch.cuda.empty_cache()
    versions = {"kernel": lambda *t: _mha3_bwd_cuda(*t, out_dtype=torch.float32),
                **K1_FP64_VERSIONS}
    readings = k1_fp64_gaps(x, inputs, h, versions)
    dqkv = _mha3_bwd_cuda(*inputs, h)
    check_rounded_tie(dqkv.chunk(3, dim=-1), versions["kernel"](*inputs, h).chunk(3, dim=-1),
                      "mha3_bwd step inputs")
    step = k1b_output_errors(dqkv, *inputs, h)
    log("train_grads_fp64", card=json.dumps(card), shape=json.dumps(list(inputs[0].shape)),
        x_shape=json.dumps(list(x.shape)), c_sound=K1_C_SOUND, c_control=K1_C_CONTROL,
        tf32=torch.backends.cuda.matmul.allow_tf32,
        **{name: json.dumps(r) for name, r in readings.items()},
        step_inputs_vs_plain=json.dumps(step))
    k1_fp64_gate(readings)
    _gate_outputs("mha3_bwd", "step_inputs", step)


def _train_argv(tmp: str, impl: str, *extra: str):
    from cross_scale_mae_torch.cli.pretrain import get_args_parser

    return get_args_parser().parse_args([
        "--model", "mae_vit_base_MsLdCeCd", "--input_size", "128",
        "--patch_size", "16", "--mask_ratio", "0.75",
        "--batch_size", str(TRAIN_BATCH), "--synthetic_len", str(TRAIN_BATCH),
        # A constant lr: no warmup, and a cosine far longer than the run.
        "--warmup_epochs", "0", "--epochs", "100000",
        "--compute_dtype", "bfloat16", "--attention_impl", impl, "--gelu", "tanh",
        "--max_steps", str(TRAIN_STEPS), "--log_interval", "5", "--seed", "0",
        "--device", "cuda", "--output_dir", tmp, *extra])


def phase_train(card: str, keep_npz: str) -> tuple[int, int]:
    """Train the flagship step through ``cli/pretrain.main``, keeping its
    params.npz at ``keep_npz``; returns the kernels' (forward, backward)
    launches during that run."""
    from torch.profiler import ProfilerActivity, profile

    from cross_scale_mae_torch.cli.pretrain import build_run
    from cross_scale_mae_torch.cli.pretrain import main as pretrain_main
    from cross_scale_mae_torch.ops.attention import mha_v3
    from cross_scale_mae_torch.train.state import tree_leaves
    from cross_scale_mae_torch.utils.flops import mae_train_flops_per_image, mfu

    with tempfile.TemporaryDirectory() as tmp:
        def argv(impl):
            return _train_argv(tmp, impl)

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
        shutil.copy(result["npz"], keep_npz)
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
        # The direct leaf against the plain version (DIRECT_TOL, its dS-fp32
        # control) is printed and no longer gates: it holds K1b to the plain
        # version's fp32 summation order. [train_grads_fp64] holds that leaf
        # against float64 instead.
        check(sound["worst"][0] <= LEAF_TOL,
              f"K1b vs its plain version in the step: {sound}, limit {LEAF_TOL} (every leaf)")
        # The control must trip the gate, or the gate could not see that fault.
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


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _param_gap(a, b) -> float:
    """The largest |a - b| over every parameter of two runs' states."""
    from cross_scale_mae_torch.train.state import tree_leaves

    with torch.no_grad():
        return max(float((x - y).abs().max()) for x, y in zip(
            tree_leaves(a.state.params), tree_leaves(b.state.params)))


def phase_ddp(card: str) -> tuple[int, int]:
    """The flagship pretrain step through the data-parallel path at world
    size 1 over NCCL; returns the K1 kernels' (forward, backward) launches
    of its two ``cli/pretrain.main`` runs."""
    from torch.profiler import ProfilerActivity, profile

    from cross_scale_mae_torch.cli.pretrain import build_run
    from cross_scale_mae_torch.cli.pretrain import main as pretrain_main
    from cross_scale_mae_torch.ops.attention import mha_v3
    from cross_scale_mae_torch.parallel import dist

    with tempfile.TemporaryDirectory() as tmp:
        # The single-process runs first: no flags, no group.
        singles = [build_run(_train_argv(tmp, "pallas_v3")) for _ in range(2)]
        address = f"localhost:{_free_port()}"
        group = ("--coordinator_address", address, "--num_processes", "1", "--process_id", "0")
        rt = dist.initialize_distributed(address, 1, 0, "cuda")
        backend = torch.distributed.get_backend()
        check(rt.distributed and rt.world_size == 1 and rt.device == torch.device("cuda", 0)
              and backend == "nccl", f"runtime {rt}, backend {backend}")
        runs, launches = {}, {}
        try:
            for mode in ("gspmd", "shard_map"):
                argv = _train_argv(tmp, "pallas_v3", "--ddp_mode", mode, *group,
                                   "--max_steps", str(DDP_STEPS))
                mha_v3.launches = mha_v3.bwd_launches = 0
                result = pretrain_main(argv)
                launches[mode] = (mha_v3.launches, mha_v3.bwd_launches)
                losses = result["losses"]
                check(result["steps"] == DDP_STEPS and result["world_size"] == 1,
                      f"{mode}: {result['steps']} steps at world size {result['world_size']}")
                check(all(math.isfinite(v) for v in losses), f"{mode}: non-finite loss {losses}")
                check(losses[-1] < losses[0], f"{mode}: loss did not fall: {losses}")
                check(launches[mode] == (ATTN_PER_STEP * DDP_STEPS,) * 2,
                      f"{mode}: K1 launches {launches[mode]} != {ATTN_PER_STEP} x {DDP_STEPS}")
                log("ddp_run", card=json.dumps(card), ddp_mode=mode, steps=DDP_STEPS,
                    loss_first=losses[0], loss_last=losses[-1],
                    launches_fwd=launches[mode][0], launches_bwd=launches[mode][1],
                    ms_per_step=result["steady_ms_per_step"], imgs_per_s=result["imgs_per_s"])
                torch.cuda.empty_cache()
                runs[mode] = build_run(_train_argv(tmp, "pallas_v3", "--ddp_mode", mode, *group))
                check(runs[mode].ddp_mode == mode, f"{mode} run has ddp_mode {runs[mode].ddp_mode}")

            # One step from the same weights and draws: the single-process
            # step twice (its run-to-run spread), and each DP mode. At world
            # size 1 every collective is an identity, so the DP step is the
            # single step's arithmetic: its params must be as close to the
            # single step's as the single step's repeat is (bit-equal when
            # the step is deterministic).
            everyone = [*singles, *runs.values()]
            check(all(_param_gap(r, singles[0]) == 0.0 for r in everyone),
                  "the runs did not start from the same weights")
            draws = singles[0].draws(0)
            for r in everyone:
                r.step_fn(r.state, r.images, draws)
            spread = _param_gap(singles[1], singles[0])
            gaps = {mode: _param_gap(r, singles[0]) for mode, r in runs.items()}
            check(all(g <= spread for g in gaps.values()),
                  f"DP params vs the single step: {gaps}, the single step's repeat {spread}")

            def step_ms(run, reps=3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    run.step_fn(run.state, run.images, run.draws(run.state.step))
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / reps * 1e3

            # In turns: single, gspmd, shard_map, shard_map, gspmd, single,
            # DDP_ROUNDS times; the medians compared.
            times = {"single": [], "gspmd": [], "shard_map": []}
            order = [("single", singles[0]), ("gspmd", runs["gspmd"]),
                     ("shard_map", runs["shard_map"])]
            for _ in range(DDP_ROUNDS):
                for name, run in order + order[::-1]:
                    times[name].append(step_ms(run))
            med = {k: float(np.median(v)) for k, v in times.items()}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step_ms(runs["gspmd"], reps=1)
            nccl = {}
            busy = 0.0
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    busy += e.self_device_time_total / 1e3 / 3
                    if "nccl" in e.key.lower():
                        nccl[e.key] = e.self_device_time_total / 1e3 / 3
        finally:
            dist.shutdown()
        del singles, runs, everyone
        torch.cuda.empty_cache()
    ratio = med["gspmd"] / med["single"]
    log("ddp", card=json.dumps(card), world_size=1, backend=backend,
        params_gap_to_single=json.dumps(gaps), single_repeat_gap=spread,
        bit_equal=json.dumps({m: g == 0.0 for m, g in gaps.items()}),
        step_ms_median=json.dumps(med), step_ms=json.dumps(times),
        gspmd_over_single=ratio, shard_map_over_single=med["shard_map"] / med["single"],
        nccl_device_ms_per_step=json.dumps(nccl), device_busy_ms_per_step=busy)
    check(ratio <= 1.02, f"the DP step {med['gspmd']} ms against the single {med['single']} ms")
    return tuple(sum(v[i] for v in launches.values()) for i in (0, 1))


# The [resume] worker: cli/pretrain.main in a process of its own, which
# prints its K1 launch counts and the time when it ends (also when the fault
# drill ends it through os._exit), the time its first step finished on the
# card, and its losses. argv: the repo root, then the pretrain flags (and
# the launcher's).
_RESUME_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from cross_scale_mae_torch.cli import pretrain
from cross_scale_mae_torch.ops.attention import mha_v3
from cross_scale_mae_torch.parallel import dist

def report(tag):
    print(tag + " " + json.dumps({"fwd": mha_v3.launches, "bwd": mha_v3.bwd_launches,
                                   "t": time.time()}), flush=True)

make_step = pretrain.make_pretrain_step
def first_step_timed(*args, **kwargs):
    step, done = make_step(*args, **kwargs), []
    def run(*a, **k):
        out = step(*a, **k)
        if not done:
            torch.cuda.synchronize()
            done.append(time.time())
            print("FIRST_STEP %.6f" % done[0], flush=True)
        return out
    return run
pretrain.make_pretrain_step = first_step_timed
exit_now = os._exit
def exit_reported(code):
    report("EXIT")
    exit_now(code)
os._exit = exit_reported
try:
    res = pretrain.main(pretrain.get_args_parser().parse_args(sys.argv[2:]))
    report("DONE")
    print("RESULT " + json.dumps({"steps": res["steps"], "losses": res["losses"],
                                  "npz": res["npz"]}), flush=True)
finally:
    dist.shutdown()
"""


def _resume_argv(out: str) -> list[str]:
    return ["--model", "mae_vit_base_MsLdCeCd", "--input_size", "128", "--patch_size", "16",
            "--mask_ratio", "0.75", "--batch_size", str(TRAIN_BATCH),
            "--synthetic_len", str(RESUME_LEN), "--epochs", str(RESUME_EPOCHS),
            "--warmup_epochs", "1", "--ckpt_interval", "1", "--compute_dtype", "bfloat16",
            "--attention_impl", "pallas_v3", "--gelu", "tanh", "--log_interval", "1",
            "--seed", "0", "--device", "cuda", "--output_dir", out]


def _tagged(text: str, tag: str) -> list:
    """The JSON (or number) after each line that starts with ``tag``."""
    return [json.loads(ln[len(tag) + 1:]) for ln in text.splitlines() if ln.startswith(tag + " ")]


def _npz_gap(a: str, b: str) -> float:
    """The largest |a - b| over every parameter of two params.npz files."""
    with np.load(a) as x, np.load(b) as y:
        check(sorted(x.files) == sorted(y.files), f"{a} and {b} hold other parameters")
        return max(float(np.abs(x[k].astype(np.float64) - y[k]).max())
                   for k in x.files if k != "__config__")


def phase_resume(card: str) -> tuple[int, int]:
    """The flagship pretrain run through a lost process and a relaunch:
    run A unbroken (twice, A and A': their gap is the control), run B
    through ``cli/launch.main`` with one rank over NCCL, ended by the fault
    drill after step 5 and resumed from its step-4 checkpoint; then the
    save and restore times of the full state, and a truncated checkpoint
    refused. Returns the K1 (forward, backward) launches of B's two
    attempts."""
    from cross_scale_mae_torch.cli import launch
    from cross_scale_mae_torch.cli.pretrain import build_run
    from cross_scale_mae_torch.utils.checkpoint import (
        STATE_FILE,
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    repo = os.path.dirname(os.path.abspath(__file__))
    steps = RESUME_EPOCHS * RESUME_LEN // TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for name in ("A", "A_prime"):
            out = os.path.join(tmp, name)
            proc = subprocess.run([sys.executable, "-c", _RESUME_WORKER, repo,
                                   *_resume_argv(out)], cwd=repo, capture_output=True,
                                  text=True, timeout=RESUME_TIMEOUT_S)
            check(proc.returncode == 0, f"run {name} failed:\n{proc.stdout[-3000:]}"
                  f"{proc.stderr[-3000:]}")
            runs[name] = {"result": _tagged(proc.stdout, "RESULT")[-1],
                          "done": _tagged(proc.stdout, "DONE")[-1]}
            shutil.rmtree(os.path.join(out, "checkpoints"))
        work = os.path.join(tmp, "B")
        fault = {"CSM_FAULT_STEP": str(RESUME_FAULT), "CSM_FAULT_ATTEMPT": "1"}
        saved = {k: os.environ.get(k) for k in fault}
        os.environ.update(fault)
        try:
            res = launch.main(launch.get_args_parser().parse_args([
                "--nprocs", "1", "--workdir", work, "--grace_s", "30", "--max_restarts", "1",
                "--", sys.executable, "-c", _RESUME_WORKER, repo,
                *_resume_argv(os.path.join(work, "out"))]))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        logs = [open(os.path.join(work, "launcher", f"attempt{k}.worker0.log")).read()
                for k in (1, 2)]
        check(res == {"success": True, "attempts": 2, "final_nprocs": 1, "restarts": 1},
              f"launcher {res}:\n{logs[0][-2000:]}\n{logs[1][-3000:]}")
        with open(os.path.join(work, "launcher", "state.json")) as f:
            state = json.load(f)
        ckpt = os.path.join(work, "out", "checkpoints")
        check(state["attempt"] == 2 and state["cmd"][-2:] == ["--resume", ckpt],
              f"attempt 2 was not given --resume: {state}")
        check(f"[fault-injection] killing process 0 at step {RESUME_FAULT}" in logs[0],
              "attempt 1 was not ended by the fault drill")
        resumed = [ln for ln in logs[1].splitlines() if ln.startswith("resumed from")]
        check(len(resumed) == 1 and " at epoch 2 (step 4, " in resumed[0],
              f"attempt 2 did not resume from step 4: {resumed}")
        restore_cli_ms = float(resumed[0].rsplit(", ", 1)[1].split(" ms")[0])
        exit1, done2 = _tagged(logs[0], "EXIT")[-1], _tagged(logs[1], "DONE")[-1]
        first2 = float(_tagged(logs[1], "FIRST_STEP")[-1])
        b = _tagged(logs[1], "RESULT")[-1]
        a, a2 = runs["A"]["result"], runs["A_prime"]["result"]
        redone = RESUME_FAULT + b["steps"] - steps
        check(a["steps"] == a2["steps"] == steps and b["steps"] == steps - 4,
              f"steps A {a['steps']}, A' {a2['steps']}, B's attempt 2 {b['steps']}")
        # K1: 20 forward and 20 backward launches a step, in each process.
        for name, counts, n in (("A", runs["A"]["done"], steps),
                                ("A'", runs["A_prime"]["done"], steps),
                                ("B attempt 1", exit1, RESUME_FAULT),
                                ("B attempt 2", done2, b["steps"])):
            check(counts["fwd"] == counts["bwd"] == ATTN_PER_STEP * n,
                  f"{name}: K1 launches {counts['fwd']}, {counts['bwd']} != "
                  f"{ATTN_PER_STEP} x {n} steps")
        control = _npz_gap(a2["npz"], a["npz"])
        gap = _npz_gap(b["npz"], a["npz"])
        loss_spread = max(abs(x - y) for x, y in zip(a2["losses"], a["losses"]))
        loss_gap = max(abs(x - y) for x, y in zip(b["losses"], a["losses"][4:]))
        ckpt_bytes = os.path.getsize(os.path.join(ckpt, str(latest_step(ckpt)), STATE_FILE))

        # A truncated copy of the newest checkpoint is refused, never loaded as zeros.
        bad = os.path.join(tmp, "bad")
        os.makedirs(os.path.join(bad, str(steps)))
        with open(os.path.join(ckpt, str(steps), STATE_FILE), "rb") as f:
            blob = f.read(ckpt_bytes // 2)
        with open(os.path.join(bad, str(steps), STATE_FILE), "wb") as f:
            f.write(blob)
        run = build_run(_train_argv(tmp, "pallas_v3"))
        try:
            restore_checkpoint(bad, run.state)
            refused = None
        except (RuntimeError, EOFError, OSError) as e:
            refused = type(e).__name__
        check(refused is not None, "a truncated checkpoint restored")
        # Save and restore of the full-size state on one rank, in turns.
        save_ms, restore_ms = [], []
        timed = os.path.join(tmp, "timed")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(timed, run.state.step, run.state)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            restore_checkpoint(timed, run.state)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        del run
        torch.cuda.empty_cache()
    log("resume", card=json.dumps(card), steps=steps, fault_after_step=RESUME_FAULT,
        params_gap_b_to_a=gap, params_gap_a_prime_to_a=control, bit_equal=gap == 0.0,
        loss_gap_redone_steps=loss_gap, loss_spread_a_prime=loss_spread,
        losses_a=json.dumps(a["losses"]), losses_b_attempt2=json.dumps(b["losses"]),
        launches_attempt1=json.dumps([exit1["fwd"], exit1["bwd"]]),
        launches_attempt2=json.dumps([done2["fwd"], done2["bwd"]]),
        checkpoint_bytes=ckpt_bytes, save_ms_rank0=json.dumps(save_ms),
        restore_ms=json.dumps(restore_ms), restore_ms_in_cli=restore_cli_ms,
        recovery_s=first2 - exit1["t"], steps_redone=redone, corrupt_refused=refused)
    check(gap <= control, f"B's params {gap} from A's, farther than A' ({control})")
    check(loss_gap <= loss_spread, f"B's losses at steps 5-{steps} {b['losses']} against "
          f"A's {a['losses'][4:]} (A' spread {loss_spread})")
    return exit1["fwd"] + done2["fwd"], exit1["bwd"] + done2["bwd"]


def _ft_argv(tmp: str, impl: str, images: int, steps: int, *extra: str):
    from cross_scale_mae_torch.cli.finetune import get_args_parser

    return get_args_parser().parse_args([
        "--model", "vit_large_patch16", "--input_size", "64", "--patch_size", "8",
        "--nb_classes", "62", "--batch_size", str(FT_BATCH), "--synthetic_len", str(images),
        "--compute_dtype", "bfloat16", "--attention_impl", impl, "--gelu", "tanh",
        "--drop_path", "0.1", "--smoothing", "0.1", "--layer_decay", "0.75",
        "--lr", str(FT_LR), "--warmup_epochs", "0", "--epochs", "100000",
        "--eval_interval", "100000", "--max_steps", str(steps), "--log_interval", "5",
        "--seed", "0", "--device", "cuda", "--output_dir", tmp, *extra])


def _ft_leaf_grads(run, draws, bwd=None) -> tuple[float, dict]:
    """One finetune batch's loss and every parameter's gradient by tree
    path, with no optimizer update; ``bwd`` stands in for K2b's wrapper."""
    from cross_scale_mae_torch.data.datasets import DATASET_STATS
    from cross_scale_mae_torch.ops import attention
    from cross_scale_mae_torch.ops.augment import make_finetune_augment
    from cross_scale_mae_torch.train.classify import make_classify_loss_fn
    from cross_scale_mae_torch.train.state import tree_items

    augment = make_finetune_augment(*DATASET_STATS["synthetic"], run.cfg.input_size,
                                    dtype=run.cfg.compute_dtype)
    loss_fn = make_classify_loss_fn(run.cfg, run.tcfg, augment)
    kernel_bwd = attention._mha_bwd_cuda
    attention._mha_bwd_cuda = bwd or kernel_bwd
    try:
        loss, _ = loss_fn(run.state.params, run.state.model_state, run.images[:FT_BATCH],
                          run.labels[:FT_BATCH], draws)
        loss.backward()
    finally:
        attention._mha_bwd_cuda = kernel_bwd
    grads = {}
    for path, p in tree_items(run.state.params):
        grads["/".join(map(str, path))] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    return float(loss.detach()), grads


def k2_bwd_math(q, k, v, do, dtype=torch.float32, round_p=False, round_ds=False):
    """``mha_folded_bwd_reference``'s arithmetic in ``dtype``, its outputs
    (dq, dk, dv) left unrounded. ``round_p`` rounds P to the input dtype
    before dV and ``round_ds`` dS before dQ and dK: K1's two roundings,
    which K2 must not have."""
    from cross_scale_mae_torch.ops.attention import _folded_probs

    qa, ka, va, g = (t.to(dtype) for t in (q, k, v, do))
    p = _folded_probs(qa, ka)
    dv = torch.matmul((p.to(q.dtype).to(dtype) if round_p else p).transpose(-1, -2), g)
    dp = torch.matmul(g, va.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * (q.shape[-1] ** -0.5)
    if round_ds:
        ds = ds.to(q.dtype).to(dtype)
    return torch.matmul(ds, ka), torch.matmul(ds.transpose(-1, -2), qa), dv


def _k2_bwd_ds_rounded(q, k, v, do):
    """The control of the direct-leaf gate: ``mha_folded_bwd_reference``
    with dS rounded to the input dtype before dQ and dK, K1's rounding."""
    return tuple(t.to(q.dtype) for t in k2_bwd_math(q, k, v, do, round_ds=True))


# The versions [finetune_grads_fp64] holds against float64, besides the
# kernel: fp32 outputs, unrounded.
FP64_VERSIONS = {
    "plain": k2_bwd_math,
    "control_k1_order": lambda *t: k2_bwd_math(*t, round_p=True, round_ds=True),
    "control_ds_bf16": lambda *t: k2_bwd_math(*t, round_ds=True),
}


def k2b_step_inputs(run, draws, bwd_name: str = "_mha_bwd_cuda"):
    """The last block's K2b inputs in one finetune step (``_ft_leaf_grads``
    from ``run``'s weights with ``draws``): X, the input of that block's qkv
    projection, and the folded q, k, v and dO of its attention backward,
    caught by wrapping ``layers.attention`` and ``ops.attention.<bwd_name>``
    (the kernel's wrapper on the card, ``mha_folded_bwd_reference`` on the
    CPU). The backward runs the last block first."""
    from cross_scale_mae_torch.models import layers
    from cross_scale_mae_torch.ops import attention

    last = run.state.params["blocks"][-1]["attn"]
    attend, bwd = layers.attention, getattr(attention, bwd_name)
    seen = {}

    def attention_spy(p, x, *args, **kwargs):
        if p is last:
            seen["x"] = x.detach()
        return attend(p, x, *args, **kwargs)

    def bwd_spy(q, k, v, do):
        seen.setdefault("inputs", tuple(t.detach() for t in (q, k, v, do)))
        return bwd(q, k, v, do)

    layers.attention = attention_spy
    setattr(attention, bwd_name, bwd_spy)
    try:
        _ft_leaf_grads(run, draws)
    finally:
        layers.attention = attend
        setattr(attention, bwd_name, bwd)
    x, inputs = seen["x"], seen["inputs"]
    # X and q belong to one block: q is X's projection, folded.
    n, l, d = x.shape
    h = run.cfg.num_heads
    with torch.no_grad():
        q = layers.linear(last["qkv"], x).reshape(n, l, 3, h, d // h)[:, :, 0]
    q = q.transpose(1, 2).reshape(n * h, l, d // h).float()
    check(q.shape == inputs[0].shape and bool(
        (q - inputs[0].float()).abs().max() <= 2.0 ** -7 * q.abs().max()),
        "the captured X and q are not of one block")
    return x, inputs


def direct_leaf(x, grads, num_heads: int) -> torch.Tensor:
    """The last block's qkv kernel gradient, g = X^T (dq | dk | dv), in
    float64: X (N, L, D_in), each gradient folded (N*H, L, hd) and unfolded
    into its D columns of the qkv layout. Shape (D_in, 3D)."""
    n, l, d_in = x.shape
    cols = [t.reshape(n, num_heads, l, -1).transpose(1, 2).reshape(n * l, -1) for t in grads]
    return x.reshape(n * l, d_in).double().T @ torch.cat(cols, dim=1).double()


def _gap_readings(g, g64, grads, ref) -> dict:
    """||g - g64|| / ||g64|| of a direct leaf (D_in, 3D) on the whole and on
    its q, k and v column thirds, and each output's (dq, dk, dv) relative L2
    gap to its float64 counterpart."""
    d = g64.shape[1] // 3
    return {"leaf": _rel_l2(g, g64),
            **{c: _rel_l2(g[:, i * d:(i + 1) * d], g64[:, i * d:(i + 1) * d])
               for i, c in enumerate("qkv")},
            **{o: _rel_l2(t, r) for o, t, r in zip(("dq", "dk", "dv"), grads, ref)}}


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b||, with b in float64."""
    return (torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b)).item()


def fp64_gaps(x, inputs, num_heads: int, versions: dict) -> dict:
    """For each version (inputs -> unrounded (dq, dk, dv)): the direct
    leaf's and each output's gaps (``_gap_readings``) against
    ``k2_bwd_math`` in float64."""
    ref = k2_bwd_math(*inputs, dtype=torch.float64)
    g64 = direct_leaf(x, ref, num_heads)
    readings = {}
    for name, fn in versions.items():
        grads = fn(*inputs)
        readings[name] = _gap_readings(direct_leaf(x, grads, num_heads), g64, grads, ref)
    return readings


def _k3_heads(qkv, do, num_heads: int) -> tuple:
    """K3's (N, L, 3H, hd) qkv and (N, L, H, hd) dO as q, k, v and dO
    (N, H, L, hd) views, the operands of ``k2_bwd_math``."""
    from cross_scale_mae_torch.ops.attention import _qkv_heads

    return (*_qkv_heads(qkv, num_heads), do.transpose(1, 2))


# The versions the K3b [kernel] rows hold against float64, besides the
# kernel: (qkv, dO, num_heads) -> (dq, dk, dv) as (N, H, L, hd), in fp32
# and unrounded.
K3_FP64_VERSIONS = {
    "plain": lambda qkv, do, h: k2_bwd_math(*_k3_heads(qkv, do, h)),
    "control_k1_order": lambda qkv, do, h: k2_bwd_math(*_k3_heads(qkv, do, h),
                                                       round_p=True, round_ds=True),
}


def k3b_fp64_gaps(qkv, do, num_heads: int, versions: dict) -> dict:
    """For each version: ||x - x64|| / ||x64|| of each output (dq, dk, dv)
    against ``k2_bwd_math`` in float64 on the same bytes, K3b's own
    arithmetic with nothing rounded before the outputs."""
    ref = k2_bwd_math(*_k3_heads(qkv, do, num_heads), dtype=torch.float64)
    return {name: {o: _rel_l2(t, r) for o, t, r in zip(("dq", "dk", "dv"),
                                                       fn(qkv, do, num_heads), ref)}
            for name, fn in versions.items()}


def k3b_fp64_gate(label: str, readings: dict) -> None:
    """The K3b [kernel] rows' float64 gate on ``k3b_fp64_gaps``' readings:
    each of the kernel's fp32 outputs within FP64_LEAF_TOL, the limit
    [finetune_grads_fp64] holds K2b's gradient to, and K1's rounding order
    above it on each output, or the gate could not see that fault."""
    for o in ("dq", "dk", "dv"):
        check(readings["kernel"][o] <= FP64_LEAF_TOL,
              f"mha2_bwd {label} {o} against float64: {readings['kernel'][o]}, "
              f"limit {FP64_LEAF_TOL}")
        check(readings["control_k1_order"][o] > FP64_LEAF_TOL,
              f"mha2_bwd {label} {o}: K1's order stays within {FP64_LEAF_TOL} of "
              f"float64: {readings['control_k1_order'][o]}")


def phase_finetune_grads_fp64(card: str) -> None:
    """K2b's direct-leaf accuracy against float64 on the finetune step's own
    inputs ([finetune_grads]' weights and draws), with K1's rounding order
    as the control the gate must catch; then, on the same inputs, the bf16
    kernel against its plain version and its bf16 outputs against its fp32
    outputs rounded."""
    from cross_scale_mae_torch.cli.finetune import build_run
    from cross_scale_mae_torch.ops.attention import _mha_bwd_cuda, mha_folded_bwd_reference

    with tempfile.TemporaryDirectory() as tmp:
        run = build_run(_ft_argv(tmp, "pallas", FT_BATCH, 1))
        x, inputs = k2b_step_inputs(run, run.draws(0)[0])
        h = run.cfg.num_heads
        del run
    torch.cuda.empty_cache()
    versions = {"kernel": lambda *t: _mha_bwd_cuda(*t, out_dtype=torch.float32),
                **FP64_VERSIONS}
    readings = fp64_gaps(x, inputs, h, versions)
    grads = _mha_bwd_cuda(*inputs)
    check_rounded_tie(grads, versions["kernel"](*inputs), "mha_bwd step inputs")
    control = tuple(t.to(inputs[0].dtype) for t in FP64_VERSIONS["control_k1_order"](*inputs))
    step = {name: _output_errors(a, r, c) for name, a, r, c in zip(
        ("dq", "dk", "dv"), grads, mha_folded_bwd_reference(*inputs), control)}
    log("finetune_grads_fp64", card=json.dumps(card), shape=json.dumps(list(inputs[0].shape)),
        x_shape=json.dumps(list(x.shape)), tol=FP64_LEAF_TOL,
        **{name: json.dumps(r) for name, r in readings.items()},
        step_inputs_vs_plain=json.dumps(step))
    sound = readings["kernel"]
    check(all(sound[c] <= FP64_LEAF_TOL for c in ("leaf", "q", "k", "v")),
          f"K2b's direct leaf against float64: {sound}, limit {FP64_LEAF_TOL}")
    check(readings["control_k1_order"]["leaf"] > FP64_LEAF_TOL,
          f"K1's order stays within {FP64_LEAF_TOL} of float64: "
          f"{readings['control_k1_order']}")
    _gate_outputs("mha_bwd", "step_inputs", step)


def _k2_dv_head0_zeroed(kernel_bwd, num_heads: int):
    """The control of the every-leaf gate: K2b with head 0's dV zeroed, a
    fault confined to one head's columns of every block's qkv gradient."""
    def bwd(q, k, v, do):
        dq, dk, dv = kernel_bwd(q, k, v, do)
        dv.view(-1, num_heads, *dv.shape[1:])[:, 0] = 0
        return dq, dk, dv
    return bwd


def _fold_unfold_ms(n: int, l: int, h: int, hd: int, reps: int = 20) -> float:
    """Device ms of one block's K2 layout copies at the finetune shape,
    timed alone: the forward folds of q, k, v and the unfold of the output,
    and the backward's dO fold and the stack of dq, dk, dv into the qkv
    layout (the unbind's backward)."""
    from cross_scale_mae_torch.ops.attention import _fold, _unfold

    gen = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn(n, l, 3 * h * hd, device="cuda", generator=gen).bfloat16()
    out = torch.randn(n * h, l, hd, device="cuda", generator=gen).bfloat16()
    do = torch.randn(n, l, h * hd, device="cuda", generator=gen).bfloat16()

    def copies(_):
        folded = [_fold(t) for t in qkv.reshape(n, l, 3, h, hd).unbind(2)]
        _unfold(out, n, h).reshape(n, l, h * hd)
        do.reshape(n, l, h, hd).transpose(1, 2).reshape(n * h, l, hd)
        torch.stack([_unfold(t, n, h) for t in folded], dim=2)

    return time_ms(copies, [None], reps)


def phase_finetune(card: str) -> tuple[int, int]:
    """Finetune ViT-L through ``cli/finetune.main`` and evaluate; returns
    the K2 kernels' (forward, backward) launches during those runs."""
    from torch.profiler import ProfilerActivity, profile

    from cross_scale_mae_torch.cli.finetune import build_run
    from cross_scale_mae_torch.cli.finetune import main as finetune_main
    from cross_scale_mae_torch.ops.attention import _mha_bwd_cuda, mha, mha_folded_bwd_reference, mha_v3
    from cross_scale_mae_torch.train.state import tree_leaves
    from cross_scale_mae_torch.utils.flops import mfu, vit_train_flops_per_image

    with tempfile.TemporaryDirectory() as tmp:
        mha.launches = mha.bwd_launches = mha_v3.launches = mha_v3.bwd_launches = 0
        result = finetune_main(_ft_argv(tmp, "pallas", FT_SYNTHETIC, FT_STEPS))
        repeated = finetune_main(_ft_argv(tmp, "pallas", FT_BATCH, FT_REPEAT_STEPS))
        fwd, bwd = mha.launches, mha.bwd_launches
        check(mha_v3.launches == mha_v3.bwd_launches == 0, "finetuning launched the K1 kernels")
        steps = result["steps"] + repeated["steps"]
        eval_batches = result["eval_batches"] + repeated["eval_batches"]
        check(result["steps"] == FT_STEPS and repeated["steps"] == FT_REPEAT_STEPS,
              f"steps {result['steps']}, {repeated['steps']}")
        check(result["eval_batches"] == 2 and repeated["eval_batches"] == 1,
              f"eval batches {result['eval_batches']}, {repeated['eval_batches']}")
        check(fwd == FT_ATTN * (steps + eval_batches) and bwd == FT_ATTN * steps,
              f"K2 launches fwd {fwd}, bwd {bwd}: expected {FT_ATTN} x ({steps} steps + "
              f"{eval_batches} eval batches) and {FT_ATTN} x {steps} steps")
        losses = result["losses"] + repeated["losses"]
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"non-finite loss in {losses}")
        rep = repeated["losses"]
        check(rep[-1] < rep[0], f"loss did not fall on the repeated batch: {rep}")
        # The eval set is a quarter of the train set, at least 64 images.
        for stats, n_eval in ((result["eval"], FT_SYNTHETIC // 4),
                              (repeated["eval"], max(FT_BATCH // 4, 64))):
            check(stats["n"] == n_eval == int(stats["cm"].sum()),
                  f"confusion matrix sums to {stats['cm'].sum()}, eval count {n_eval}")
            check(all(math.isfinite(stats[k]) for k in ("loss", "acc1", "acc5", "macro_f1",
                                                         "micro_f1", "miou")),
                  f"non-finite eval stats {stats}")
        torch.cuda.empty_cache()

        # The step from the same weights and draws through the kernels and
        # through the plain attention ('xla' runs mha_v3_reference forward
        # and its autograd backward).
        runs = {impl: build_run(_ft_argv(tmp, impl, FT_BATCH, 1)) for impl in ("pallas", "xla")}
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(runs["pallas"].state.params), tree_leaves(runs["xla"].state.params))),
            "the two runs did not start from the same weights")
        kernel, plain = runs["pallas"], runs["xla"]
        draws = kernel.draws(0)

        def one_step(run, d):
            return run.step_fn(run.state, run.images[:FT_BATCH], run.labels[:FT_BATCH], d)[1]

        first = {}
        for impl, run in runs.items():
            f0, b0 = mha.launches, mha.bwd_launches
            m = one_step(run, draws)
            first[impl] = (float(m["loss"]), float(m["grad_norm"]))
            launched = (mha.launches - f0, mha.bwd_launches - b0)
            check(launched == ((FT_ATTN,) * 2 if impl == "pallas" else (0, 0)),
                  f"{impl} step launched {launched}")
        (kl, kg), (pl, pg) = first["pallas"], first["xla"]
        # bf16 budget of [train]: the two paths round attention's P, dP and
        # dS at other places in 24 blocks.
        dl, dg = abs(kl - pl) / abs(pl), abs(kg - pg) / abs(pg)
        check(dl <= 2.0 ** -7 and dg <= 2.0 ** -5,
              f"kernel vs plain step: loss {kl} vs {pl} (rel {dl}), "
              f"grad norm {kg} vs {pg} (rel {dg})")

        def step_ms(run, reps=3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                one_step(run, run.draws(run.state.step))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        p1, k1, k2, p2 = step_ms(plain), step_ms(kernel), step_ms(kernel), step_ms(plain)
        del plain, runs["xla"]
        reps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                one_step(kernel, kernel.draws(kernel.state.step))
            torch.cuda.synchronize()
        kinds = _kernel_ms_by_kind(prof, K2_KINDS)
        busy = sum(kinds.values())
        fold_ms = FT_ATTN * _fold_unfold_ms(*K2_SHAPES["finetune"])
        cfg = kernel.cfg
        log("finetune_profile", card=json.dumps(card),
            device_ms_per_step=json.dumps({k: v / reps for k, v in kinds.items()}),
            fold_unfold_ms_per_step_timed_alone=fold_ms,
            device_idle_share=(1 - busy / reps / ((k1 + k2) / 2)) if busy else "not measured")

        del kernel, runs
        torch.cuda.empty_cache()
        # Every parameter's gradient of one batch through K2b, through its
        # plain version (same forward kernel), through the two controls and
        # through the plain attention path, from the same weights and draws.
        fresh = {impl: build_run(_ft_argv(tmp, impl, FT_BATCH, 1)) for impl in ("pallas", "xla")}
        d0 = fresh["pallas"].draws(0)[0]
        ref = _ft_leaf_grads(fresh["pallas"], d0, mha_folded_bwd_reference)[1]
        gaps = {name: _rel_gaps(_ft_leaf_grads(fresh[impl], d0, bwd)[1], ref)
                for name, impl, bwd in (
                    ("kernel", "pallas", None),
                    ("control_ds_bf16", "pallas", _k2_bwd_ds_rounded),
                    ("control_dv_head0_zeroed", "pallas",
                     _k2_dv_head0_zeroed(_mha_bwd_cuda, cfg.num_heads)),
                    ("xla_path", "xla", None))}
        del ref, fresh
        direct = f"blocks/{cfg.depth - 1}/attn/qkv/kernel"
        readings = {name: {"direct": g[direct], "worst": max((v, k) for k, v in g.items()),
                           "least_qkv": min((v, k) for k, v in g.items()
                                            if k.endswith("attn/qkv/kernel"))}
                    for name, g in gaps.items()}
        log("finetune_grads", card=json.dumps(card), leaves=len(gaps["kernel"]),
            direct_leaf=direct, direct_tol=FT_DIRECT_TOL, leaf_tol=FT_LEAF_TOL,
            **{name: json.dumps(r) for name, r in readings.items()})

    ms = result["steady_ms_per_step"]
    imgs_per_s = FT_BATCH / (ms / 1e3)
    flops = vit_train_flops_per_image(cfg)
    log("finetune", card=json.dumps(card), steps=result["steps"], batch=FT_BATCH,
        losses=json.dumps(result["losses"]), repeated_batch_losses=json.dumps(rep),
        eval=json.dumps({k: v for k, v in result["eval"].items() if k != "cm"}),
        launches_fwd=fwd, launches_bwd=bwd, ms_per_step=ms, imgs_per_s=imgs_per_s,
        train_flops_per_image=flops, mfu=mfu(imgs_per_s, flops),
        kernel_vs_plain_loss=json.dumps([kl, pl]), kernel_vs_plain_grad_norm=json.dumps([kg, pg]),
        kernel_step_ms=json.dumps([k1, k2]), plain_step_ms=json.dumps([p1, p2]))
    sound = readings["kernel"]
    # The direct leaf against the plain version (FT_DIRECT_TOL, its dS-rounded
    # control) is printed and no longer gates: it holds K2b to the plain
    # version's fp32 summation order, which the tensor-core K2b does not
    # keep. [finetune_grads_fp64] holds that leaf against float64 instead.
    check(sound["worst"][0] <= FT_LEAF_TOL,
          f"K2b vs its plain version in the step: {sound}, limit {FT_LEAF_TOL} (every leaf)")
    # The control must trip the gate, or the gate could not see that fault.
    check(readings["control_dv_head0_zeroed"]["least_qkv"][0] > FT_LEAF_TOL,
          f"head 0's dV zeroed leaves a block's qkv kernel within {FT_LEAF_TOL}")
    return fwd, bwd


def _write_naip(root: str, name: str, n: int, canvas: int, seed: int) -> str:
    """``n`` NAIP .npy tiles on a ``canvas`` square and their index CSV.
    Tile i has class i % LP_CLASSES and uniform noise in [0, 128) plus 12
    times its class in every channel, so the classes differ in brightness
    and a probe has something to learn. Returns the CSV's path."""
    rng = np.random.default_rng(seed)
    rows = []
    for start in range(0, n, 512):
        m = min(512, n - start)
        tiles = rng.integers(0, 128, (m, canvas, canvas, 3), np.uint8)
        for j in range(m):
            i = start + j
            np.save(f"{root}/{name}_{i:05d}.npy", tiles[j] + np.uint8(12 * (i % LP_CLASSES)))
            rows.append(f"{name}_{i:05d}.npy,{i % LP_CLASSES}")
    path = f"{root}/{name}.csv"
    with open(path, "w") as f:
        f.write("path,label\n" + "\n".join(rows) + "\n")
    return path


def _lp_argv(npz: str, train: str, test: str, out: str, *extra: str):
    from cross_scale_mae_torch.cli.linprobe import get_args_parser

    return get_args_parser().parse_args([
        "--model", "vit_base_patch16", "--input_size", "128", "--patch_size", "16",
        "--finetune", npz, "--dataset_type", "naip", "--train_path", train,
        "--test_path", test, "--nb_classes", str(LP_CLASSES), "--batch_size", str(LP_BATCH),
        "--compute_dtype", "bfloat16", "--gelu", "tanh", "--seed", "0", "--log_interval", "4",
        "--device", "cuda", "--output_dir", out,
        *extra])


def _mha_v3_fp64(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``mha_v3_reference``'s arithmetic in float64 (P still rounded to the
    input dtype before P V, the output rounded once): the exact function
    beside which [linprobe] prints both paths' logits."""
    from cross_scale_mae_torch.ops.attention import _softmax_fp32, _split_dims

    n, l, d, hd = _split_dims(qkv, num_heads)
    r = qkv.reshape(n, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4).double()
    p = _softmax_fp32(torch.matmul(r[0], r[1].transpose(-1, -2)) * hd ** -0.5)
    out = torch.matmul(p.to(qkv.dtype).double(), r[2]).to(qkv.dtype)
    return out.transpose(1, 2).reshape(n, l, d)


def _backbone(params: dict) -> dict:
    from cross_scale_mae_torch.train.state import tree_items

    return {"/".join(map(str, path)): t for path, t in tree_items(params) if path[0] != "head"}


def phase_linprobe(card: str, npz: str) -> int:
    """Linear-probe ViT-B through ``cli/linprobe.main`` from the pretrain
    phase's npz over seeded NAIP tiles; returns K1f's launches in those
    runs."""
    from torch.profiler import ProfilerActivity, profile

    from cross_scale_mae_torch.cli.linprobe import build_run
    from cross_scale_mae_torch.cli.linprobe import main as linprobe_main
    from cross_scale_mae_torch.data.loader import device_prefetch
    from cross_scale_mae_torch.ops.attention import mha, mha_qkv, mha_v3
    from cross_scale_mae_torch.train.state import tree_leaves
    from cross_scale_mae_torch.utils.flops import linprobe_train_flops_per_image, mfu

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train = _write_naip(tmp, "train", LP_TRAIN, 128, 1)
        test = _write_naip(tmp, "val", LP_EVAL, 146, 2)
        repeat = f"{tmp}/repeat.csv"
        with open(train) as f, open(repeat, "w") as g:
            g.writelines(f.readlines()[:LP_BATCH + 1])
        data_s = time.perf_counter() - t0
        # The linprobe.sh schedule (50 epochs, 10 of warmup) cut to 2 epochs,
        # then one repeated batch at a constant lr (no warmup, a cosine far
        # longer than the run).
        main_argv = _lp_argv(npz, train, test, f"{tmp}/lp", "--max_steps", str(LP_STEPS))
        repeat_argv = _lp_argv(npz, repeat, test, f"{tmp}/lp", "--warmup_epochs", "0",
                               "--epochs", "100000", "--eval_interval", "100000",
                               "--ckpt_interval", "100000", "--max_steps",
                               str(LP_REPEAT_STEPS))
        init = build_run(main_argv).state.params
        fresh, head0 = _backbone(init), init["head"]["kernel"]

        counts = (mha_v3, mha, mha_qkv)
        for c in counts:
            c.launches = c.bwd_launches = 0
        result = linprobe_main(main_argv)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        repeated = linprobe_main(repeat_argv)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        fwd, bwd = mha_v3.launches, mha_v3.bwd_launches
        others = [c.launches + c.bwd_launches for c in counts[1:]]
        run = result["run"]
        check(run.cfg.attention_impl == "pallas_v3", f"attention {run.cfg.attention_impl}")
        check(result["steps"] == LP_STEPS and repeated["steps"] == LP_REPEAT_STEPS,
              f"steps {result['steps']}, {repeated['steps']}")
        steps = result["steps"] + repeated["steps"]
        eval_batches = result["eval_batches"] + repeated["eval_batches"]
        check(result["eval_batches"] == 4 and repeated["eval_batches"] == 2,
              f"eval batches {result['eval_batches']}, {repeated['eval_batches']}")
        check(fwd == LP_ATTN * (steps + eval_batches) and bwd == 0 and others == [0, 0],
              f"launches K1f {fwd}, K1b {bwd}, K2 and K3 {others}: expected {LP_ATTN} x "
              f"({steps} steps + {eval_batches} eval batches), 0 and 0")
        losses = result["losses"] + repeated["losses"]
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"non-finite loss in {losses}")
        rep = repeated["losses"]
        check(rep[-1] < rep[0], f"loss did not fall on the repeated batch: {rep}")
        for r in (result, repeated):
            stats = r["eval"]
            check(stats["n"] == LP_EVAL == int(stats["cm"].sum()),
                  f"confusion matrix sums to {stats['cm'].sum()}, eval count {LP_EVAL}")
            check(all(math.isfinite(stats[k]) for k in ("loss", "acc1", "acc5", "macro_f1",
                                                         "micro_f1", "miou")),
                  f"non-finite eval stats {stats}")
            after = _backbone(r["run"].state.params)
            check(after.keys() == fresh.keys() and all(
                torch.equal(after[k], fresh[k]) for k in fresh), "a backbone leaf moved")
            check(not torch.equal(r["run"].state.params["head"]["kernel"], head0),
                  "the head did not move")
            bn = r["run"].state.model_state["head_bn"]
            check(bool((bn["mean"] != 0).any()) and bool((bn["var"] != 1).any()),
                  "the BN head's running statistics did not move")
        torch.cuda.empty_cache()

        # Forward-only memory: the frozen backbone must not keep a block's
        # activations for a backward. A forward that built the graph would
        # keep at least each block's qkv and MLP hidden state.
        cfg = run.cfg
        n_tok, d = cfg.num_patches + 1, cfg.embed_dim
        act = LP_BATCH * n_tok * 4 * d * 2               # one (N, L, 4D) bf16 tensor
        param_bytes = sum(p.numel() * 4 for p in tree_leaves(run.state.params))
        estimate = param_bytes + 8 * act
        graph = cfg.depth * (LP_BATCH * n_tok * 3 * d * 2 + 2 * act)
        check(peak <= estimate, f"peak {peak} B above the forward-only estimate {estimate} B "
              f"(a graph-building forward keeps {graph} B more)")

        # One epoch through device_prefetch against the host batches, on the
        # card, with work on the consumer's stream between batches.
        loader = run.train_loader
        host = list(loader.epoch(0))
        sums = []
        for imgs, labels in device_prefetch(loader.epoch(0), "cuda"):
            sums.append((imgs, labels, imgs.sum(dtype=torch.int64)))
        check(len(sums) == len(host) == LP_TRAIN // LP_BATCH, f"{len(sums)} batches")
        for (imgs, labels, total), (h_imgs, h_labels) in zip(sums, host):
            ref = torch.from_numpy(h_imgs).cuda()
            check(torch.equal(imgs, ref) and int(total) == int(h_imgs.sum(dtype=np.int64))
                  and torch.equal(labels, torch.from_numpy(h_labels).cuda()),
                  "a prefetched batch differs from its host batch")
        del host, sums, ref
        # The loader alone: decode on the host, then with the prefetch's
        # pinned copies to the card.
        t0 = time.perf_counter()
        for _ in loader.epoch(1):
            pass
        loader_host_imgs_per_s = LP_TRAIN / (time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in device_prefetch(loader.epoch(1), "cuda"):
            pass
        torch.cuda.synchronize()
        loader_imgs_per_s = LP_TRAIN / (time.perf_counter() - t0)

        # One epoch of steps through the loader under the profiler: device
        # time by kind against the window's wall time.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for imgs, labels in run.train_batches(2):
                run.step_fn(run.state, imgs, labels, run.draws(run.state.step))
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        kinds = _kernel_ms_by_kind(prof, LP_KINDS)
        busy = sum(kinds.values())
        prof_steps = LP_TRAIN // LP_BATCH
        # The idle share against the unprofiled steady step of the 2-epoch
        # run (the profiler slows the host), and against the window itself.
        ms = result["steady_ms_per_step"]
        log("linprobe_profile", card=json.dumps(card), steps=prof_steps,
            profiled_wall_ms_per_step=window_ms / prof_steps,
            device_ms_per_step=json.dumps({k: v / prof_steps for k, v in kinds.items()}),
            device_idle_share=(1 - busy / prof_steps / ms) if busy else "not measured",
            device_idle_share_of_window=(1 - busy / window_ms) if busy else "not measured")

        # The eval logits of one batch and one train step, from the same
        # weights, batch and draws, through K1f and through the plain
        # attention ('xla' runs mha_v3_reference).
        runs = {impl: build_run(_lp_argv(npz, train, test, f"{tmp}/cmp", "--attention_impl",
                                         impl)) for impl in ("pallas_v3", "xla")}
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(runs["pallas_v3"].state.params), tree_leaves(runs["xla"].state.params))),
            "the two runs did not start from the same weights")
        imgs, labels = (torch.from_numpy(a).cuda() for a in next(iter(loader.epoch(0))))
        e_imgs, e_labels = (torch.from_numpy(a).cuda()
                            for a in next(iter(run.eval_loader.epoch(0))))
        draws = run.draws(0)
        # The same eval batch through the exact function, mha_v3_reference's
        # arithmetic in float64, before a step moves the head: how far each
        # path's logits sit from it.
        from cross_scale_mae_torch.models import layers

        plain_attn, layers.mha_v3_reference = layers.mha_v3_reference, _mha_v3_fp64
        try:
            r = runs["xla"]
            x_logits = r.eval_fn(r.state.params, r.state.model_state, e_imgs,
                                 e_labels.long())["logits"].float()
        finally:
            layers.mha_v3_reference = plain_attn
        outs = {}
        for impl, r in runs.items():
            f0 = mha_v3.launches
            logits = r.eval_fn(r.state.params, r.state.model_state, e_imgs,
                               e_labels.long())["logits"].float()
            m = r.step_fn(r.state, imgs, labels.long(), draws)[1]
            outs[impl] = (logits, float(m["loss"]), float(m["grad_norm"]))
            launched = mha_v3.launches - f0
            check(launched == (2 * LP_ATTN if impl == "pallas_v3" else 0),
                  f"{impl} eval batch and step launched K1f {launched} times")
        (k_logits, kl, kg), (p_logits, pl, pg) = outs["pallas_v3"], outs["xla"]
        fp64_gaps = {name: ((t - x_logits).norm() / x_logits.norm()).item()
                     for name, t in (("kernel", k_logits), ("plain", p_logits))}
        # The bf16 budget of [finetune]: the two paths round attention at
        # other places in 12 blocks; the logits' relative L2 gap on the
        # loss's limit.
        dlog = ((k_logits - p_logits).norm() / p_logits.norm()).item()
        dl, dg = abs(kl - pl) / abs(pl), abs(kg - pg) / abs(pg)
        check(math.isfinite(dlog) and dlog <= 2.0 ** -7 and dl <= 2.0 ** -7 and dg <= 2.0 ** -5,
              f"kernel vs plain: logits rel gap {dlog}, loss {kl} vs {pl} (rel {dl}), "
              f"grad norm {kg} vs {pg} (rel {dg})")
        del runs, outs, k_logits, p_logits, x_logits, imgs, labels, e_imgs, e_labels
        del run, init, fresh, result["run"], repeated["run"]

    imgs_per_s = LP_BATCH / (ms / 1e3)
    flops = linprobe_train_flops_per_image(cfg)
    log("linprobe", card=json.dumps(card), steps=steps, batch=LP_BATCH,
        data_write_s=data_s, losses=json.dumps(result["losses"]),
        repeated_batch_losses=json.dumps(rep),
        eval=json.dumps({k: v for k, v in result["eval"].items() if k != "cm"}),
        launches_fwd=fwd, launches_bwd=bwd, eval_batches=eval_batches, ms_per_step=ms,
        imgs_per_s=imgs_per_s, loader_host_imgs_per_s=loader_host_imgs_per_s,
        loader_imgs_per_s=loader_imgs_per_s,
        train_flops_per_image=flops, mfu=mfu(imgs_per_s, flops),
        peak_bytes=peak, forward_only_estimate_bytes=estimate, graph_bytes=graph,
        kernel_vs_plain_logits_rel_gap=dlog, logits_rel_gap_to_fp64=json.dumps(fp64_gaps),
        kernel_vs_plain_loss=json.dumps([kl, pl]),
        kernel_vs_plain_grad_norm=json.dumps([kg, pg]))
    return fwd


# ------------------------------------------------------- the rest of the data

TEMPORAL_SIZE = 128                 # the flagship's input and the JPEGs' side
TEMPORAL_ROWS = 3 * TRAIN_BATCH     # 3 steps an epoch
TEMPORAL_FILES = 96                 # distinct pairs, reused across the rows
TEMPORAL_STEPS = 6
TEMPORAL_REPEAT_STEPS = 12
SN_SIZE = 64                        # ViT-L finetuning's input, the train TIFFs' side
SN_BANDS = 13
SN_DROPPED = (0, 9, 10)
SN_TRAIN = 2 * FT_BATCH             # 2 steps an epoch
SN_EVAL = FT_BATCH + FT_BATCH // 2  # one full eval batch and a ragged one
SN_FILES = 128
SN_STEPS = 6
SN_CLASSES = 62
NATIVE_IMAGES = 512


def host_cpu() -> str:
    """The host's CPU model (/proc/cpuinfo) and core count."""
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), model)
    except OSError:
        pass
    return f"{model}, {os.cpu_count()} cores"


def _write_tiff(path: str, arr: np.ndarray) -> None:
    """An uncompressed chunky little-endian TIFF of an (H, W, C) uint16
    array, one strip (the layout the tests' writer gives)."""
    import struct

    h, w, c = arr.shape
    data = np.ascontiguousarray(arr, "<u2").tobytes()
    bps_off = 8 + len(data)
    fmt_off = bps_off + 2 * c
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, c, bps_off), (259, 3, 1, 1),
               (262, 3, 1, 1), (273, 4, 1, 8), (277, 3, 1, c), (278, 4, 1, h),
               (279, 4, 1, len(data)), (284, 3, 1, 1), (339, 3, c, fmt_off)]
    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, fmt_off + 2 * c))
        f.write(data + struct.pack(f"<{c}H", *[16] * c) + struct.pack(f"<{c}H", *[1] * c))
        f.write(struct.pack("<H", len(entries)))
        for tag, typ, count, value in entries:
            inline = struct.pack("<HH", value, 0) if typ == 3 and count == 1 else \
                struct.pack("<I", value)
            f.write(struct.pack("<HHI", tag, typ, count) + inline)
        f.write(struct.pack("<I", 0))


def _write_pairs(root: str, rows: int, seed: int) -> str:
    """An fMoW temporal CSV of ``rows`` rows over TEMPORAL_FILES pairs of
    seeded TEMPORAL_SIZE px JPEGs (two noisy takes of one base image) (a file is reused by every TEMPORAL_FILES-th row),
    the first column the later capture in every other row."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(TEMPORAL_FILES):
        side = TEMPORAL_SIZE
        base = rng.integers(0, 200, (side, side, 3))
        for k in (1, 2):
            img = np.clip(base + rng.integers(0, 56, (side, side, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(f"{root}/p{i}_{k}.jpg", quality=90)
    lines = ["category,image_path,image_path2,timestamp,timestamp2"]
    for r in range(rows):
        i = r % TEMPORAL_FILES
        early, late = f"2016-0{1 + r % 9}-1{r % 10}", f"2017-0{1 + r % 7}-0{1 + r % 9}"
        stamps = (late, early) if r % 2 else (early, late)
        lines.append(f"{r % 62},p{i}_1.jpg,p{i}_2.jpg,{stamps[0]},{stamps[1]}")
    path = f"{root}/pairs_{rows}.csv"
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _write_sentinel(root: str, name: str, rows: int, canvas: int, seed: int) -> str:
    """An fMoW-Sentinel CSV of ``rows`` rows over SN_FILES seeded 13-band
    uint16 TIFFs on a ``canvas`` square; category i % SN_CLASSES."""
    rng = np.random.default_rng(seed)
    for i in range(SN_FILES):
        _write_tiff(f"{root}/{name}{i}.tif",
                    rng.integers(0, 5000, (canvas, canvas, SN_BANDS)).astype(np.uint16))
    lines = ["category,image_path,timestamp"] + [
        f"c{r % SN_CLASSES:02d},{name}{r % SN_FILES}.tif,2017-01-01" for r in range(rows)]
    path = f"{root}/{name}.csv"
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _loader_rate(loader) -> tuple[float, int]:
    """One epoch of ``loader`` on the host alone: samples per second and
    the sample count."""
    t0 = time.perf_counter()
    n = sum(len(labels) for _, labels in loader.epoch(0))
    return n / (time.perf_counter() - t0), n


def phase_native(card: str) -> None:
    """Host decode: the native C++ core against the Python path on the same
    seeded JPEGs and 13-band TIFFs, one epoch each; the TIFF batches equal
    byte for byte (at the canvas size neither resizes)."""
    import PIL

    from cross_scale_mae_torch.data import native
    from cross_scale_mae_torch.data.datasets import build_dataset
    from cross_scale_mae_torch.data.loader import DataLoader

    t0 = time.perf_counter()
    lib = native.get_library()
    build_s = time.perf_counter() - t0
    check(lib is not None, "the native core did not build (g++ missing or failing)")
    codecs = native.codecs(lib)
    rates: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        from PIL import Image

        rng = np.random.default_rng(11)
        with open(f"{tmp}/rgb.csv", "w") as f:
            f.write("category,image_path\n")
            for i in range(NATIVE_IMAGES // 4):
                Image.fromarray(rng.integers(0, 256, (128, 128, 3)).astype(np.uint8)).save(
                    f"{tmp}/r{i}.jpg", quality=90)
            f.writelines(f"{i % 10},r{i % (NATIVE_IMAGES // 4)}.jpg\n"
                         for i in range(NATIVE_IMAGES))
        sentinel = _write_sentinel(tmp, "n", NATIVE_IMAGES, SN_SIZE, 12)
        threads = os.cpu_count() or 4
        for source, kind, path, size, kw in (
                ("jpeg", "fmow_rgb", f"{tmp}/rgb.csv", 128, {}),
                ("tiff_13band", "fmow_sentinel", sentinel, SN_SIZE,
                 {"dropped_bands": list(SN_DROPPED)})):
            ds = build_dataset(kind, True, train_path=path, input_size=size, **kw)
            loaders = {b: DataLoader(ds, 64, shuffle=False, drop_last=False, num_threads=threads,
                                     use_native=None if b == "native" else False)
                       for b in ("python", "native")}
            check(loaders["python"].backend == "python", "use_native=False took the core")
            row = {"python_imgs_per_s": _loader_rate(loaders["python"])[0]}
            if loaders["native"].backend == "native":
                row["native_imgs_per_s"] = _loader_rate(loaders["native"])[0]
                row["native_over_python"] = row["native_imgs_per_s"] / row["python_imgs_per_s"]
            else:
                row["native_imgs_per_s"] = (f"not measured: the core on this host has no "
                                            f"{source} codec (codecs {list(codecs)})")
            rates[source] = row
            if source == "tiff_13band":
                check(loaders["native"].backend == "native",
                      "the native core did not take the 13-band TIFFs")
                for (a, la), (b, lb) in zip(loaders["native"].epoch(0),
                                            loaders["python"].epoch(0)):
                    check(np.array_equal(a, b) and np.array_equal(la, lb),
                          "native TIFF batch differs from the Python path's")
    log("native", card=json.dumps(card), host_cpu=json.dumps(host_cpu()),
        cxx=shutil.which("g++"), codecs=json.dumps(list(codecs)), pil=PIL.__version__,
        build_s=build_s, threads=os.cpu_count(), images=NATIVE_IMAGES,
        rates=json.dumps(rates))


def _temporal_argv(tmp: str, csv: str, steps: int):
    from cross_scale_mae_torch.cli.pretrain import get_args_parser

    return get_args_parser().parse_args([
        "--model", "mae_vit_base_MsLdCeCd", "--input_size", str(TEMPORAL_SIZE),
        "--patch_size", "16", "--mask_ratio", "0.75", "--batch_size", str(TRAIN_BATCH),
        "--dataset_type", "fmow_temporal", "--train_path", csv,
        # A constant lr: no warmup, and a cosine far longer than the run.
        "--warmup_epochs", "0", "--epochs", "100000",
        "--compute_dtype", "bfloat16", "--attention_impl", "pallas_v3", "--gelu", "tanh",
        "--max_steps", str(steps), "--log_interval", "5", "--seed", "0",
        "--device", "cuda", "--output_dir", tmp])


def phase_temporal(card: str) -> tuple[int, int]:
    """Temporal pretraining: the flagship step on seeded JPEG pairs through
    the loader (``cli/pretrain.main --dataset_type fmow_temporal``), 3
    steps an epoch for the timing, then one repeated batch of pairs at a
    constant lr; returns K1's (forward, backward) launches in those runs."""
    from cross_scale_mae_torch.cli.pretrain import build_run
    from cross_scale_mae_torch.cli.pretrain import main as pretrain_main
    from cross_scale_mae_torch.ops.attention import mha, mha_v3
    from cross_scale_mae_torch.utils.flops import mae_train_flops_per_image, mfu

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        timing_csv = _write_pairs(tmp, TEMPORAL_ROWS, 21)
        repeat_csv = _write_pairs(tmp, TRAIN_BATCH, 21)
        data_s = time.perf_counter() - t0
        run = build_run(_temporal_argv(tmp, timing_csv, 1))
        loader = run.loader
        check(run.frames == 2 and loader.sample_shape == (2, TEMPORAL_SIZE, TEMPORAL_SIZE, 3),
              f"frames {run.frames}, sample shape {loader.sample_shape}")
        draws = run.draws(0)[0]
        check(draws.hflip.shape == (2 * TRAIN_BATCH,) and draws.noise.shape[0] == 2 * TRAIN_BATCH,
              f"draws of {draws.hflip.shape[0]} frames, {draws.noise.shape[0]} noise rows")
        decode_pairs_s, n = _loader_rate(loader)
        check(n == TEMPORAL_ROWS, f"the loader gave {n} pairs, not {TEMPORAL_ROWS}")
        backend, cfg = loader.backend, run.cfg
        del run, loader
        torch.cuda.empty_cache()

        mha_v3.launches = mha_v3.bwd_launches = mha.launches = mha.bwd_launches = 0
        result = pretrain_main(_temporal_argv(tmp, timing_csv, TEMPORAL_STEPS))
        repeated = pretrain_main(_temporal_argv(tmp, repeat_csv, TEMPORAL_REPEAT_STEPS))
        fwd, bwd = mha_v3.launches, mha_v3.bwd_launches
        check(mha.launches == mha.bwd_launches == 0, "temporal pretraining launched K2")
        steps = result["steps"] + repeated["steps"]
        check(result["steps"] == TEMPORAL_STEPS and repeated["steps"] == TEMPORAL_REPEAT_STEPS,
              f"steps {result['steps']}, {repeated['steps']}")
        check(fwd == bwd == ATTN_PER_STEP * steps,
              f"K1 launches fwd {fwd}, bwd {bwd} != {ATTN_PER_STEP} x {steps} steps")
        losses = result["losses"] + repeated["losses"]
        check(all(math.isfinite(v) for v in losses), f"non-finite loss in {losses}")
        rep = repeated["losses"]
        check(rep[-1] < rep[0], f"loss did not fall on the repeated pairs: {rep}")
        torch.cuda.empty_cache()

    ms = result["steady_ms_per_step"]
    pairs_per_s = TRAIN_BATCH / (ms / 1e3)
    flops = mae_train_flops_per_image(cfg)
    log("temporal", card=json.dumps(card), steps=steps, batch_pairs=TRAIN_BATCH,
        frames_per_step=2 * TRAIN_BATCH, losses=json.dumps(result["losses"]),
        repeated_batch_losses=json.dumps(rep), launches_fwd=fwd, launches_bwd=bwd,
        ms_per_step=ms, pairs_per_s=pairs_per_s, train_flops_per_pair=flops,
        mfu=mfu(pairs_per_s, flops), loader_backend=backend,
        loader_pairs_per_s=decode_pairs_s, loader_frames_per_s=2 * decode_pairs_s,
        data_write_s=data_s, host_cpu=json.dumps(host_cpu()))
    return fwd, bwd


def _sentinel_argv(tmp: str, train: str, test: str):
    from cross_scale_mae_torch.cli.finetune import get_args_parser

    return get_args_parser().parse_args([
        "--model", "vit_large_patch16", "--input_size", str(SN_SIZE), "--patch_size", "8",
        "--dataset_type", "fmow_sentinel", "--train_path", train, "--test_path", test,
        "--dropped_bands", *map(str, SN_DROPPED), "--nb_classes", str(SN_CLASSES),
        "--batch_size", str(FT_BATCH), "--compute_dtype", "bfloat16",
        "--attention_impl", "pallas", "--gelu", "tanh", "--drop_path", "0.1",
        "--smoothing", "0.1", "--layer_decay", "0.75", "--lr", str(FT_LR),
        "--warmup_epochs", "0", "--epochs", "100000", "--eval_interval", "100000",
        "--max_steps", str(SN_STEPS), "--log_interval", "5", "--seed", "0",
        "--device", "cuda", "--output_dir", tmp])


def phase_sentinel(card: str) -> tuple[int, int]:
    """Multi-band finetuning: ViT-L on seeded 13-band fMoW-Sentinel TIFFs
    with bands 0, 9 and 10 dropped (``cli/finetune.main --dataset_type
    fmow_sentinel``), then the eval pass; returns K2's (forward, backward)
    launches in that run."""
    from cross_scale_mae_torch.cli.finetune import build_run
    from cross_scale_mae_torch.cli.finetune import main as finetune_main
    from cross_scale_mae_torch.ops.attention import mha, mha_v3
    from cross_scale_mae_torch.utils.flops import mfu, vit_train_flops_per_image

    in_c = SN_BANDS - len(SN_DROPPED)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train = _write_sentinel(tmp, "train", SN_TRAIN, SN_SIZE, 31)
        # The eval canvas is 1/0.875 of the input size (util/datasets.py:140-148).
        test = _write_sentinel(tmp, "val", SN_EVAL, round(SN_SIZE / 0.875), 32)
        data_s = time.perf_counter() - t0
        run = build_run(_sentinel_argv(tmp, train, test))
        cfg = run.cfg
        loaders = {"train": run.train_loader, "eval": run.eval_loader}
        check(cfg.input_channels == in_c and run.train_loader.dataset.in_c == in_c,
              f"input_channels {cfg.input_channels}, dataset in_c {run.train_loader.dataset.in_c}")
        backends = {k: v.backend for k, v in loaders.items()}
        check(backends == {"train": "native", "eval": "native"},
              f"the 13-band TIFFs did not go through the native core: {backends}")
        decode_imgs_s, n = _loader_rate(run.train_loader)
        check(n == SN_TRAIN, f"the loader gave {n} images, not {SN_TRAIN}")
        imgs, _ = next(iter(run.train_batches(0)))
        check(tuple(imgs.shape) == (FT_BATCH, SN_SIZE, SN_SIZE, in_c) and imgs.dtype == torch.uint8,
              f"train batch {tuple(imgs.shape)} {imgs.dtype}")
        del run, loaders, imgs
        torch.cuda.empty_cache()

        mha.launches = mha.bwd_launches = mha_v3.launches = mha_v3.bwd_launches = 0
        result = finetune_main(_sentinel_argv(tmp, train, test))
        fwd, bwd = mha.launches, mha.bwd_launches
        check(mha_v3.launches == mha_v3.bwd_launches == 0, "multi-band finetuning launched K1")
        steps, eval_batches = result["steps"], result["eval_batches"]
        check(steps == SN_STEPS and eval_batches == 2,
              f"{steps} steps, {eval_batches} eval batches")
        check(fwd == FT_ATTN * (steps + eval_batches) and bwd == FT_ATTN * steps,
              f"K2 launches fwd {fwd}, bwd {bwd}: expected {FT_ATTN} x ({steps} steps + "
              f"{eval_batches} eval batches) and {FT_ATTN} x {steps} steps")
        check(all(math.isfinite(v) for v in result["losses"]),
              f"non-finite loss in {result['losses']}")
        stats = result["eval"]
        check(stats["n"] == SN_EVAL == int(stats["cm"].sum()),
              f"confusion matrix sums to {stats['cm'].sum()}, eval count {SN_EVAL}")
        check(all(math.isfinite(stats[k]) for k in ("loss", "acc1", "acc5")),
              f"non-finite eval stats {stats}")
        torch.cuda.empty_cache()

    ms = result["steady_ms_per_step"]
    imgs_per_s = FT_BATCH / (ms / 1e3)
    flops = vit_train_flops_per_image(cfg)
    log("sentinel", card=json.dumps(card), steps=steps, batch=FT_BATCH, in_c=in_c,
        dropped_bands=json.dumps(list(SN_DROPPED)), losses=json.dumps(result["losses"]),
        eval=json.dumps({k: v for k, v in stats.items() if k != "cm"}),
        launches_fwd=fwd, launches_bwd=bwd, ms_per_step=ms, imgs_per_s=imgs_per_s,
        train_flops_per_image=flops, mfu=mfu(imgs_per_s, flops),
        loader_backend=json.dumps(backends), loader_imgs_per_s=decode_imgs_s,
        data_write_s=data_s, host_cpu=json.dumps(host_cpu()))
    return fwd, bwd


# [finetune_recipe]: scripts/finetune.sh:19-21's flags (mixup, cutmix; its
# smoothing, layer decay and drop path are _ft_argv's) with the reference
# finetune's --aa and --reprob defaults (ops/randaug.py:252-253 of the JAX
# package); then 2 steps in each other mix: pair and elem modes, a min/max box.
RECIPE_FLAGS = ("--mixup", "0.8", "--cutmix", "1.0", "--aa", "rand-m9-mstd0.5-inc1",
                "--reprob", "0.25")
RECIPE_VARIANTS = (("pair", ("--mixup_mode", "pair")), ("elem", ("--mixup_mode", "elem")),
                   ("minmax", ("--cutmix_minmax", "0.2", "0.8")))
RECIPE_VARIANT_STEPS = 2
RECIPE_RANGES = ("randaug", "random_erasing", "mixup_cutmix")
# [moments]: the flagship step with both Adam moments in bf16.
MOMENT_FLAGS = ("--adam_mu_dtype", "bfloat16", "--adam_nu_dtype", "bfloat16")
MOMENT_STEPS = 8


def _range_device_ms(prof, names) -> dict:
    """Device ms under each torch.profiler range of ``names``: the kernels
    launched inside it (the host-side range's device total, children
    included); "not measured" where the profiler shows none."""
    out = {name: 0.0 for name in names}
    for e in prof.key_averages():
        if e.key in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.key] += e.device_time_total / 1e3
    return {k: v if v > 0 else "not measured" for k, v in out.items()}


def _recipe_batch(run, draws):
    """The recipe step's input on the card, before the model: the augment
    with RandAugment and RandomErasing, then Mixup/CutMix against the
    reversed batch, as ``train/classify.make_classify_loss_fn`` runs them."""
    from cross_scale_mae_torch.data.datasets import DATASET_STATS
    from cross_scale_mae_torch.ops.augment import make_finetune_augment
    from cross_scale_mae_torch.train.mixup import mixup_cutmix, smooth_one_hot

    augment = make_finetune_augment(*DATASET_STATS["synthetic"], run.cfg.input_size,
                                    dtype=run.cfg.compute_dtype, aa=RECIPE_FLAGS[5],
                                    reprob=float(RECIPE_FLAGS[7]))
    with torch.no_grad():
        imgs = augment(run.images[:FT_BATCH], draws.hflip, draws.vflip, draws.crop_boxes,
                       draws.rot_k, **draws.augment_extras())
        targets = smooth_one_hot(run.labels[:FT_BATCH], run.cfg.num_classes,
                                 run.tcfg.label_smoothing)
        return mixup_cutmix(imgs, targets, imgs.flip(0), targets.flip(0), draws.mixup,
                            run.mixup.cutmix_minmax)


def phase_finetune_recipe(card: str) -> tuple[int, int]:
    """The finetuning recipe through ``cli/finetune.main`` on ViT-L; returns
    the K2 kernels' (forward, backward) launches during those runs."""
    from torch.profiler import ProfilerActivity, profile

    from cross_scale_mae_torch.cli.finetune import build_run
    from cross_scale_mae_torch.cli.finetune import main as finetune_main
    from cross_scale_mae_torch.ops.attention import mha, mha_v3
    from cross_scale_mae_torch.train.state import tree_leaves
    from cross_scale_mae_torch.utils.flops import mfu, vit_train_flops_per_image

    with tempfile.TemporaryDirectory() as tmp:
        mha.launches = mha.bwd_launches = mha_v3.launches = mha_v3.bwd_launches = 0
        result = finetune_main(_ft_argv(tmp, "pallas", FT_SYNTHETIC, FT_STEPS, *RECIPE_FLAGS))
        variants = {name: finetune_main(_ft_argv(tmp, "pallas", FT_BATCH, RECIPE_VARIANT_STEPS,
                                                 *RECIPE_FLAGS, *flags))
                    for name, flags in RECIPE_VARIANTS}
        fwd, bwd = mha.launches, mha.bwd_launches
        check(mha_v3.launches == mha_v3.bwd_launches == 0, "the recipe launched the K1 kernels")
        every = [result, *variants.values()]
        steps = sum(r["steps"] for r in every)
        eval_batches = sum(r["eval_batches"] for r in every)
        check(result["steps"] == FT_STEPS
              and all(v["steps"] == RECIPE_VARIANT_STEPS for v in variants.values()),
              f"steps {[r['steps'] for r in every]}")
        check(fwd == FT_ATTN * (steps + eval_batches) and bwd == FT_ATTN * steps,
              f"K2 launches fwd {fwd}, bwd {bwd}: expected {FT_ATTN} x ({steps} steps + "
              f"{eval_batches} eval batches) and {FT_ATTN} x {steps} steps")
        losses = {name: r["losses"] for name, r in (("recipe", result), *variants.items())}
        check(all(math.isfinite(v) for ls in losses.values() for v in ls),
              f"non-finite loss in {losses}")
        for r, n_eval in ((result, FT_SYNTHETIC // 4),
                          *((v, max(FT_BATCH // 4, 64)) for v in variants.values())):
            stats = r["eval"]
            check(stats["n"] == n_eval == int(stats["cm"].sum()),
                  f"confusion matrix sums to {stats['cm'].sum()}, eval count {n_eval}")
            check(all(math.isfinite(stats[k]) for k in ("loss", "acc1", "acc5", "macro_f1")),
                  f"non-finite eval stats {stats}")
        torch.cuda.empty_cache()

        # The recipe step through the kernels and the plain attention, and
        # [finetune]'s plain-augment step, from the same weights.
        recipe = {impl: build_run(_ft_argv(tmp, impl, FT_BATCH, 1, *RECIPE_FLAGS))
                  for impl in ("pallas", "xla")}
        plain_aug = build_run(_ft_argv(tmp, "pallas", FT_BATCH, 1))
        check(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(
            tree_leaves(recipe["pallas"].state.params), tree_leaves(recipe["xla"].state.params),
            tree_leaves(plain_aug.state.params))), "the runs did not start from the same weights")
        kernel = recipe["pallas"]
        draws = kernel.draws(0)
        imgs, targets = _recipe_batch(kernel, draws[0])
        row_err = float((targets.sum(dim=-1) - 1).abs().max())
        check(bool(torch.isfinite(imgs.float()).all()), "the recipe's batch is not finite")
        check(row_err <= 1e-5, f"mixed targets' rows sum to 1 within {row_err}, limit 1e-5")
        del imgs, targets

        def one_step(run, d):
            return run.step_fn(run.state, run.images[:FT_BATCH], run.labels[:FT_BATCH], d)[1]

        first = {}
        for impl, run in recipe.items():
            f0, b0 = mha.launches, mha.bwd_launches
            m = one_step(run, draws)
            first[impl] = (float(m["loss"]), float(m["grad_norm"]))
            launched = (mha.launches - f0, mha.bwd_launches - b0)
            check(launched == ((FT_ATTN,) * 2 if impl == "pallas" else (0, 0)),
                  f"recipe {impl} step launched {launched}")
        (kl, kg), (pl, pg) = first["pallas"], first["xla"]
        dl, dg = abs(kl - pl) / abs(pl), abs(kg - pg) / abs(pg)
        check(dl <= 2.0 ** -7 and dg <= 2.0 ** -5,
              f"recipe kernel vs plain step: loss {kl} vs {pl} (rel {dl}), "
              f"grad norm {kg} vs {pg} (rel {dg})")
        del recipe["xla"]
        torch.cuda.empty_cache()

        def step_ms(run, reps=3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                one_step(run, run.draws(run.state.step))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        step_ms(plain_aug, reps=1)   # its first step, as the recipe run's above
        p1, r1, r2, p2 = (step_ms(plain_aug), step_ms(kernel), step_ms(kernel),
                          step_ms(plain_aug))
        reps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                one_step(kernel, kernel.draws(kernel.state.step))
            torch.cuda.synchronize()
        kinds = _kernel_ms_by_kind(prof, K2_KINDS)
        ranges = _range_device_ms(prof, RECIPE_RANGES)
        busy = sum(kinds.values())
        cfg = kernel.cfg
        del kernel, recipe, plain_aug
        torch.cuda.empty_cache()

    ms = result["steady_ms_per_step"]
    imgs_per_s = FT_BATCH / (ms / 1e3)
    flops = vit_train_flops_per_image(cfg)
    log("finetune_recipe", card=json.dumps(card), flags=json.dumps(" ".join(RECIPE_FLAGS)),
        steps=steps, batch=FT_BATCH, losses=json.dumps(losses),
        eval=json.dumps({k: v for k, v in result["eval"].items() if k != "cm"}),
        launches_fwd=fwd, launches_bwd=bwd, ms_per_step=ms, imgs_per_s=imgs_per_s,
        train_flops_per_image=flops, mfu=mfu(imgs_per_s, flops),
        recipe_step_ms=json.dumps([r1, r2]), plain_augment_step_ms=json.dumps([p1, p2]),
        kernel_vs_plain_loss=json.dumps([kl, pl]), kernel_vs_plain_grad_norm=json.dumps([kg, pg]),
        target_row_sum_err=row_err,
        augment_device_ms_per_step=json.dumps(
            {k: v / reps if isinstance(v, float) else v for k, v in ranges.items()}),
        device_ms_per_step=json.dumps({k: v / reps for k, v in kinds.items()}),
        device_idle_share=(1 - busy / reps / ((r1 + r2) / 2)) if busy else "not measured")
    return fwd, bwd


def _opt_bytes(state) -> int:
    opt = state.opt_state
    return sum(t.numel() * t.element_size() for t in (*opt.mu, *opt.nu))


def phase_moments(card: str) -> tuple[int, int]:
    """The flagship pretrain step with bf16 Adam moments through
    ``cli/pretrain.main``; returns the K1 kernels' (forward, backward)
    launches during that run."""
    from cross_scale_mae_torch.cli.pretrain import build_run
    from cross_scale_mae_torch.cli.pretrain import main as pretrain_main
    from cross_scale_mae_torch.ops.attention import mha_v3
    from cross_scale_mae_torch.utils.checkpoint import STATE_FILE, latest_step, restore_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bf16")
        mha_v3.launches = mha_v3.bwd_launches = 0
        result = pretrain_main(_train_argv(out, "pallas_v3", *MOMENT_FLAGS, "--max_steps",
                                           str(MOMENT_STEPS), "--ckpt_interval",
                                           str(MOMENT_STEPS)))
        fwd, bwd = mha_v3.launches, mha_v3.bwd_launches
        losses, steps = result["losses"], result["steps"]
        check(steps == MOMENT_STEPS and len(losses) == steps, f"{steps} steps, {len(losses)} losses")
        check(all(math.isfinite(v) for v in losses), f"non-finite loss in {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}")
        check(fwd == bwd == ATTN_PER_STEP * steps,
              f"kernel launches fwd {fwd}, bwd {bwd} != {ATTN_PER_STEP} x {steps} steps")
        ckpt = os.path.join(out, "checkpoints")
        step = latest_step(ckpt)
        check(step == MOMENT_STEPS, f"checkpoint at step {step}, expected {MOMENT_STEPS}")
        flat = torch.load(os.path.join(ckpt, str(step), STATE_FILE), map_location="cpu",
                          weights_only=True)
        moments = {k: v.dtype for k, v in flat.items() if k.startswith(("opt_state/mu/",
                                                                         "opt_state/nu/"))}
        check(moments and set(moments.values()) == {torch.bfloat16},
              f"the checkpoint's moments are {set(moments.values())}, not bf16")
        ckpt_bytes = os.path.getsize(os.path.join(ckpt, str(step), STATE_FILE))
        del flat
        torch.cuda.empty_cache()

        runs = {"fp32": build_run(_train_argv(os.path.join(tmp, "f32"), "pallas_v3")),
                "bf16": build_run(_train_argv(os.path.join(tmp, "b16"), "pallas_v3",
                                              *MOMENT_FLAGS))}
        refused = None
        try:
            restore_checkpoint(ckpt, runs["fp32"].state)
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "dtype" in refused,
              f"a bf16-moment checkpoint restored into an fp32-moment state ({refused})")
        restore_checkpoint(ckpt, runs["bf16"].state)
        check(runs["bf16"].state.step == MOMENT_STEPS, "the bf16 checkpoint did not restore")
        state_bytes = {name: _opt_bytes(run.state) for name, run in runs.items()}
        n_params = sum(t.numel() for t in runs["fp32"].state.opt_state.mu)

        def step_ms(run, reps=3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                run.step_fn(run.state, run.images, run.draws(run.state.step))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        for run in runs.values():
            step_ms(run, reps=1)     # each run's first step, left out of the turns
        f1, b1, b2, f2 = (step_ms(runs["fp32"]), step_ms(runs["bf16"]), step_ms(runs["bf16"]),
                          step_ms(runs["fp32"]))
        del runs
        torch.cuda.empty_cache()
    log("moments", card=json.dumps(card), flags=json.dumps(" ".join(MOMENT_FLAGS)), steps=steps,
        batch=TRAIN_BATCH, loss_first=losses[0], loss_last=losses[-1], launches_fwd=fwd,
        launches_bwd=bwd,
        # The CLI's steady ms covers steps 2-8 and the checkpoint written after step 8.
        cli_ms_per_step_with_checkpoint=result["steady_ms_per_step"], params=n_params, opt_state_bytes=json.dumps(state_bytes),
        opt_state_bytes_saved=state_bytes["fp32"] - state_bytes["bf16"],
        checkpoint_bytes=ckpt_bytes, fp32_restore_refused=json.dumps(refused),
        bf16_step_ms=json.dumps([b1, b2]), fp32_step_ms=json.dumps([f1, f2]))
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
    # just after it: serving (forward only), pretraining, finetuning, the
    # finetuning recipe, pretraining with bf16 moments, linear probing from
    # the pretraining's weights, temporal pretraining on pairs and
    # multi-band finetuning through the loader, then pretraining through a
    # fault and a relaunch (each process counts from 0).
    served = phase_serving(card)
    with tempfile.TemporaryDirectory() as work:
        npz = os.path.join(work, "pretrain.npz")
        train_fwd, train_bwd = phase_train(card, npz)
        phase_train_grads_fp64(card)
        ddp_fwd, ddp_bwd = phase_ddp(card)
        ft_fwd, ft_bwd = phase_finetune(card)
        phase_finetune_grads_fp64(card)
        recipe_fwd, recipe_bwd = phase_finetune_recipe(card)
        moment_fwd, moment_bwd = phase_moments(card)
        lp_fwd = phase_linprobe(card, npz)
    phase_native(card)
    temporal_fwd, temporal_bwd = phase_temporal(card)
    sn_fwd, sn_bwd = phase_sentinel(card)
    resume_fwd, resume_bwd = phase_resume(card)
    by_path = {"mha3_fwd": {"serving": served, "train": train_fwd, "train_ddp": ddp_fwd,
                            "train_resume": resume_fwd, "linprobe": lp_fwd,
                            "train_temporal": temporal_fwd, "moments": moment_fwd},
               "mha3_bwd": {"serving": 0, "train": train_bwd, "train_ddp": ddp_bwd,
                            "train_resume": resume_bwd, "linprobe": 0,
                            "train_temporal": temporal_bwd, "moments": moment_bwd},
               "mha_fwd": {"finetune": ft_fwd, "finetune_sentinel": sn_fwd,
                           "finetune_recipe": recipe_fwd},
               "mha_bwd": {"finetune": ft_bwd, "finetune_sentinel": sn_bwd,
                           "finetune_recipe": recipe_bwd},
               "mha2_fwd": {}, "mha2_bwd": {}}
    replaces = {"mha3_fwd": "cross_scale_mae_tpu/ops/attention.py:326",
                "mha3_bwd": "cross_scale_mae_tpu/ops/attention.py:355",
                "mha_fwd": "cross_scale_mae_tpu/ops/attention.py:68",
                "mha_bwd": "cross_scale_mae_tpu/ops/attention.py:33",
                "mha2_fwd": "cross_scale_mae_tpu/ops/attention.py:192",
                "mha2_bwd": "cross_scale_mae_tpu/ops/attention.py:210"}
    kernels = []
    for name, line in replaces.items():
        case = REPORTED[name]
        row = rows[name][case]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cross_scale_mae_torch/csrc/{name}.cu", "replaces": line,
            "case": case, "shape": row["shape"],
            "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
            "design": row["design"],
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
