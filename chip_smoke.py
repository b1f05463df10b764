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
   bf16, at the shapes the serving, pretraining (128 px, and 192 px for
   MS-SSIM), finetuning, linear probing and evaluation paths give it (K3, which no path dispatches, at ViT-B's, the decoder's and the
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
    steps redone. Then [orbax] (b) and (c): run A's step-4 state written in
    the JAX package's Orbax form by ``utils/checkpoint.save_orbax_checkpoint``
    and restored, its write and read seconds and GB/s beside the
    ``state.pt`` times (the restore bit-equal to the ``state.pt`` one);
    then run C, ``cli/pretrain.main --resume <that directory>`` to the end.
    Gates: C's params no farther from A's than A''s are, its losses at
    steps 5-8 within the A-A' spread, 20 + 20 K1 launches a step (counted
    as ``train_resume_orbax``).
    It runs last, so that its checkpoint writes (19 of 1.37 GB) touch no
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
18. serve_classifier (runs after phase 11): [finetune]'s ViT-L params.npz
    (``attention_impl="pallas"``, K2f) and [linprobe]'s checkpoint (ViT-B/16
    with its BN head, ``pallas_v3``, K1f) served by ``cli/serve.build_app``
    over HTTP at batch 64, requests of 1, 7, 64 and 100 rows in
    ``CLS_ROUNDS`` rounds (a few hundred dispatches).
    Gates: K2f 24 x dispatches (K1f 12 x), no other kernel; the logits of
    every answered row against the same weights served with the plain
    attention, their relative L2 gap no larger than that of the plain bf16
    server to the same model in fp32; every row whose plain top-2 margin
    exceeds twice the largest logit difference has the same argmax.
    Printed: dispatch p50/p99, images/s at p50, HTTP rows/s.
19. quantize: the [serving] ViT-B encoder and the ViT-L classifier with
    ``quantize="int8"`` against bf16 weights on one seeded batch of 64: the
    weights' device bytes of each, the least cosine similarity of the
    outputs (gate: ``QUANT_COS_FLOOR``), the classifier's argmax gate as in
    phase 18, the dispatch ms in turns (bf16, int8, int8, bf16; 50 calls a
    reading) and the device ms a dispatch by kernel kind. The
    counts are set to 0 just before the int8 server's calls and read just
    after: K1f 12 (encoder) and K2f 24 (ViT-L) a call, no other kernel.
20. export: ``cli/export.main`` on cuda for the ViT-B encoder baked,
    ``--no_bake_weights``, ``--quantize int8`` and ``--symbolic_batch`` and
    the ViT-L classifier baked (each self-checks its reload); each served by
    ``cli/serve --artifact`` over HTTP and held to the in-process forward
    with the plain attention at ``EXPORT_TOL`` (the symbolic one also at
    batches 1, 7 and 100). Printed: artifact and sidecar bytes, export
    seconds, and the artifact's dispatch ms against checkpoint serving in
    turns.
21. embed: ``cli/embed.main`` over 1000 seeded 146 px JPEGs (an fMoW-RGB
    CSV) at batch 256 through [train]'s ViT-B encoder, with the plain
    attention and then with K1f: the row count, the labels, the features
    against the plain run's within the bf16 budget, K1f 12 x batches;
    images/s over a third run of 5000 rows.
22. data_parallel: ``cli/serve --data_parallel`` at
    ``torch.cuda.device_count()`` cards, its answers bit-equal to the
    single-card server's (one card) or within the bf16 budget (more).
23. ssim (runs after phase 17): SSIM and MS-SSIM of 16 images of 192 px
    (one channel's SSIM below zero) and the gradient of 1 - SSIM on the
    card, against the host's fp32 and float64 of the same functions
    (``SSIM_TOL``, ``SSIM_GRAD_TOL``: the blur must run in IEEE fp32; a
    blur rounded to TF32 is the control the gate must catch); the
    device ms of the mse_ssim loss, forward and backward, at the flagship's
    shape (both views, 768 images of 128 px) beside mse's, and its kernels.
24. pretrain_ssim: the flagship step with ``--loss mse_ssim --loss_cd mse``
    through ``cli/pretrain.main`` for 10 steps, checkpointed after the last;
    ``--loss ms_ssim`` at 192 px for 3 steps; 20 + 20 K1 launches a step;
    the mse_ssim and mse steps in turns (ms, images/s, MFU).
25. perceptual: the flagship step with ``--use_perceptual_loss`` on a random
    trunk and on ``--vgg_weights`` (a seeded fake torchvision ``.pth``
    written here), 4 steps each; the perceptual and plain steps in turns;
    the trunk's device ms at the step's shapes and its share of the step;
    the card's loss (TF32 convolutions) and with TF32 off against the
    host's fp32 on 4 images (``PERC_TF32_TOL``, ``PERC_IEEE_TOL``), the trunk
    in bf16 and the TF32 reading as the controls each limit must catch.
26. evalviz: ``cli/evalviz.main`` on phase 24's checkpoint over 8 seeded
    JPEGs, ``--noise gaussian salt_pepper`` and 384 temporal pairs: the
    figures, ``metrics.json`` and ``temporal_gaps.json`` as named, finite;
    K1f 20 x 4 x 8 + 12 x 3 launches, no backward; then a 2-step
    ``--plot_recon --val_img_path`` pretrain (its 8 figures, 20 K1f each).
27. variants (runs after phase 26): the reference's attention variants
    (``VARIANTS``), which run in stock PyTorch ops with no attention kernel.
    Each function at the flagship's encoder and decoder shapes
    (``VARIANT_SHAPES``), in IEEE fp32 against itself in float64 (max
    relative error, ``VARIANT_F32_TOL``; the control it must catch: its
    inputs narrowed to bf16; its products with TF32 allowed are printed
    beside, cuBLAS taking TF32 for some shapes only) and in
    bf16 against the bf16 path's own roundings done in float64
    (``bf16_path_fp64``; mean relative error, ``VARIANT_BF16_TOL``; the
    control: its fp32 steps left in bf16, for fourier_mix the first FFT's
    output rounded to bf16). Then each variant through
    ``cli/pretrain.build_run`` at the flagship's size (ViT-B MsLdCeCd, 128
    px, batch 384, bf16): 2 warm-up and 3 timed steps, the losses finite, no
    kernel launched, then one profiled step (device ms by kind, the idle
    share, the top kernels); one linformer finetune step of ViT-L (64 px, patch 8,
    batch 512) through ``cli/finetune.build_run``, no kernel launched; one
    64-image dispatch of a linformer ViT-B encoder through
    ``serving.build_serving_model`` on the card and on the host (gate: the
    card's bf16 output no farther from the host's fp32 than twice the
    host's bf16 is).
28. observability: ``cli/pretrain.main`` on the flagship step for 32 steps
    with ``--profile_dir``, ``--use_tensorboard``, ``--use_wandb`` (wandb
    disabled by ``WANDB_MODE`` where it imports: no network) and
    ``--log_interval 5``. Gates: one Chrome trace, parsed, holding 20
    ``mha3_fwd`` and 20 ``mha3_bwd`` kernel launches for each of its 20
    steps; K1 20 + 20 a step over the run; the TensorBoard event file
    written where tensorboard imports. Printed: the step ms inside the
    window and outside it, the profiler's own seconds, the trace's bytes,
    ``device_memory_stats()``, the event file's path or the skip line.
29. orbax (runs after phase 3): the JAX package's golden Orbax checkpoint
    (``tests/golden/ckpt_v1``) decoded by the port's reader
    (``utils/orbax.py``: OCDBT and zarr in numpy, zstd through
    ``libzstd.so.1``; no JAX, orbax or tensorstore on this host). Gates:
    every leaf's dtype, shape and sha256 equal to
    ``tests/torch_orbax_golden.json`` (taken from the JAX package's own
    restore, held to it by a CPU test); the golden loss on the card, from
    the decoded state on the recorded batch with the file's draws and the
    crop view resized at fp32 (the JAX CPU arithmetic the golden value
    holds), within 1e-5 of ``golden_values.json``'s; the same loss with the
    card's training crop (bf16 operands, as a TPU's) logged as the control
    (the golden is ``attention_impl`` "xla": the decoder's check, not a
    kernel's). Parts (b) and (c) run in phase 15.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits with code 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
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
# [orbax]: the golden loss's bound (tests/test_torch_port_checkpoint.py's),
# and the Orbax write and read of the flagship state, each this many times.
ORBAX_LOSS_TOL = 1e-5
ORBAX_REPS = 2
# The kernels' shapes: (N, L, H, hd); "linprobe" is the ViT-B probe's batch
# of 1024, train steps and padded eval batches alike; "embed" cli/embed's
# batch of 256; "ms_ssim_enc"/"ms_ssim_dec" the flagship step at 192 px
# (--loss ms_ssim: 36 + 1 visible tokens, 144 + 1 in the decoder, where K1
# takes several sweeps at 32 a head); "viz_enc"/"viz_dec" evalviz's and
# --plot_recon's single image. The JSON line reports the forward at
# the serving shape and the backward at the decoder's training shape, the
# one that costs the step most; each entry names its case and shape.
SHAPES = {"serving": (64, 65, 12, 64), "train_enc": (768, 17, 12, 64),
          "train_dec": (768, 65, 16, 32), "long_seq": (8, 257, 12, 64),
          "linprobe": (1024, 65, 12, 64), "embed": (256, 65, 12, 64),
          "ms_ssim_enc": (768, 37, 12, 64), "ms_ssim_dec": (768, 145, 16, 32),
          "viz_enc": (1, 17, 12, 64), "viz_dec": (1, 65, 16, 32),
          # One rank's head group of the flagship step at --model_parallel 2.
          "tp2_enc": (768, 17, 6, 64), "tp2_dec": (768, 65, 8, 32)}
BWD_SHAPES = ("train_enc", "train_dec", "long_seq", "ms_ssim_enc", "ms_ssim_dec",
              "tp2_enc", "tp2_dec")
# The K2 kernels' shapes, (N, L, H, hd) folded to (N*H, L, hd): the ViT-L
# finetune step, ViT-B's 65 tokens, and ViT-H at 224 px, the longest.
K2_SHAPES = {"finetune": (512, 65, 16, 64), "vit_b": (64, 65, 12, 64),
             "long_seq": (8, 257, 16, 80),
             # One rank's heads of the ViT-L finetune step at --model_parallel 2.
             "tp2_finetune": (512, 65, 8, 64)}
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


# The script's clock: every log line ends with the seconds since import,
# so each phase's share of the time limit reads off the output.
START = time.perf_counter()


def log(phase: str, **fields) -> None:
    fields["elapsed_s"] = round(time.perf_counter() - START, 1)
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
    """Each kernel against its plain version, bf16: mha3_fwd at every
    shape of SHAPES, mha3_bwd at the training (128 and 192 px) and
    long-sequence shapes (BWD_SHAPES)."""
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


def _bf16_close(got: np.ndarray, ref: np.ndarray, what: str) -> float:
    """The bf16 budget of [serving] (tests/test_torch_port_serving.py):
    max error 2**-4 x max(1, max|ref|), mean error 2**-7 x max(1, mean|ref|)."""
    err = np.abs(got - ref)
    max_tol = 2.0 ** -4 * max(1.0, float(np.abs(ref).max()))
    mean_tol = 2.0 ** -7 * max(1.0, float(np.abs(ref).mean()))
    check(bool(np.isfinite(got).all()), f"{what}: non-finite output")
    check(err.max() <= max_tol and err.mean() <= mean_tol,
          f"{what}: max {err.max()} (tol {max_tol}), mean {err.mean()} (tol {mean_tol})")
    return float(err.max())


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
            # Kernel and plain attention may round one ulp apart per block.
            worst = max(worst, _bf16_close(got, plain.fn(arr), f"{key}: served vs plain"))
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


def _wall_ms(fn, batch: np.ndarray, reps: int = 10) -> float:
    """Host ms of one call of ``fn`` on ``batch`` (numpy in and out), over
    ``reps`` calls after one warm-up."""
    fn(batch)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(batch)  # ends in a device-to-host copy: synchronous
    return (time.perf_counter() - t0) / reps * 1e3


def _device_ms(fn, batch: np.ndarray, rules, reps: int = 10) -> dict:
    """Device ms of one call of ``fn`` on ``batch`` by kernel kind, from a
    torch.profiler window of ``reps`` calls, and their sum as "total"."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(batch)
    kinds = {k: v / reps for k, v in _kernel_ms_by_kind(prof, rules).items()}
    kinds["total"] = sum(kinds.values())
    return kinds


def phase_dispatch(card: str, served_fn, plain_fn, batch: np.ndarray, reps: int = 10) -> None:
    """One 64-image dispatch end to end (host clock, numpy in and out),
    through the kernel and through the plain attention, in turns (plain,
    kernel, kernel, plain); then a profiled window of the kernel path:
    device time by kernel kind. The device's idle share is taken against
    the unprofiled dispatch time, since the profiler slows the host."""
    from torch.profiler import ProfilerActivity, profile

    p1, k1, k2, p2 = (_wall_ms(plain_fn, batch, reps), _wall_ms(served_fn, batch, reps),
                      _wall_ms(served_fn, batch, reps), _wall_ms(plain_fn, batch, reps))
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
                                  "npz": res["npz"],
                                  "steady_ms_per_step": res["steady_ms_per_step"]}), flush=True)
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


def phase_resume(card: str) -> tuple[tuple[int, int], tuple[int, int]]:
    """The flagship pretrain run through a lost process and a relaunch:
    run A unbroken (twice, A and A': their gap is the control), run B
    through ``cli/launch.main`` with one rank over NCCL, ended by the fault
    drill after step 5 and resumed from its step-4 checkpoint; then the
    save and restore times of the full state, and a truncated checkpoint
    refused; then [orbax]: A's step-4 state in the JAX package's Orbax
    form, written and read in turns, and run C resumed from it. Returns
    the K1 (forward, backward) launches of B's two attempts and of C."""
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
            if name == "A_prime":   # A's step 4 is [orbax]'s source
                shutil.rmtree(os.path.join(os.path.dirname(runs[name]["result"]["npz"]),
                                           "checkpoints"))
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
        # Each attempt writes its own run directory; attempt 2 resumes attempt 1's.
        first_run = os.path.join(work, "out", sorted(os.listdir(os.path.join(work, "out")),
                                                     key=len)[0])
        check(state["attempt"] == 2
              and state["cmd"][-2:] == ["--resume", os.path.join(first_run, "checkpoints")],
              f"attempt 2 was not given --resume: {state}")
        ckpt = launch.find_latest_checkpoints(work)
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
        shutil.rmtree(timed)
        orbax_run = orbax_resume(card, tmp, repo, run, a, steps, save_ms, restore_ms)
        del run
        torch.cuda.empty_cache()
        c, done_c = orbax_run()
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
    gap_c = c["params_gap_c_to_a"]
    check(gap_c <= control, f"C's params {gap_c} from A's, farther than A' ({control})")
    check(c["loss_gap"] <= loss_spread, f"C's losses at steps 5-{steps} {c['losses']} "
          f"against A's {a['losses'][4:]} (A' spread {loss_spread})")
    return ((exit1["fwd"] + done2["fwd"], exit1["bwd"] + done2["bwd"]),
            (done_c["fwd"], done_c["bwd"]))


def orbax_resume(card: str, tmp: str, repo: str, run, a: dict, steps: int,
                 save_ms: list, restore_ms: list):
    """[orbax] (b) and (c), on run A of [resume]: its step-4 state restored
    into ``run`` (the flagship state on the card) from its ``state.pt``,
    written in the JAX package's Orbax form by ``save_orbax_checkpoint``
    and restored from it, in turns, ORBAX_REPS times (the write: the state
    to the host, zstd level 1 on 8 threads, the files synced; the read: the
    files decoded, the optax state placed, the leaves copied to the card),
    each restore bit-equal to the ``state.pt`` one. Returns a function that
    runs C, ``cli/pretrain.main --resume <that directory>`` to the end, in a
    process of its own once ``run`` is freed, and returns (C's result, its
    K1 counts)."""
    from cross_scale_mae_torch.utils import orbax
    from cross_scale_mae_torch.utils.checkpoint import (
        checkpoint_meta,
        restore_checkpoint,
        save_orbax_checkpoint,
    )

    a_ckpt = os.path.join(os.path.dirname(a["npz"]), "checkpoints")
    restore_checkpoint(a_ckpt, run.state, step=4)
    want = {k: v.clone() for k, v in run.state.state_dict().items()}
    nbytes = sum(v.numel() * v.element_size() for v in want.values())
    meta = checkpoint_meta(a_ckpt, 4)
    extra = {k: v for k, v in meta.items() if k not in ("step", "config")}
    src = os.path.join(tmp, "orbax")
    write_s, read_s, decode_s = [], [], []
    for _ in range(ORBAX_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_orbax_checkpoint(src, 4, run.state, json.dumps(meta["config"]), extra)
        write_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tree = orbax.read_step(os.path.join(src, "4"), subset=None)
        decode_s.append(time.perf_counter() - t0)
        del tree
        t0 = time.perf_counter()
        _, got_meta = restore_checkpoint(src, run.state)
        torch.cuda.synchronize()
        read_s.append(time.perf_counter() - t0)
        got = run.state.state_dict()
        check(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
              "the Orbax restore differs from the state.pt restore")
        check(got_meta == meta, f"the Orbax sidecar {got_meta} is not run A's {meta}")
    del want
    on_disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(src) for f in fs)
    shutil.rmtree(a_ckpt)
    log("orbax", part="resume_write_read", card=json.dumps(card), state_bytes=nbytes,
        orbax_bytes_on_disk=on_disk, write_s=json.dumps(write_s),
        read_s=json.dumps(read_s), decode_s_host=json.dumps(decode_s),
        write_gb_s=json.dumps([nbytes / t / 1e9 for t in write_s]),
        read_gb_s=json.dumps([nbytes / t / 1e9 for t in read_s]),
        state_pt_save_ms=json.dumps(save_ms), state_pt_restore_ms=json.dumps(restore_ms),
        host_cpu=json.dumps(host_cpu()), read_note="warm: the files were just written")

    def run_c():
        proc = subprocess.run([sys.executable, "-c", _RESUME_WORKER, repo,
                               *_resume_argv(os.path.join(tmp, "C")), "--resume", src],
                              cwd=repo, capture_output=True, text=True,
                              timeout=RESUME_TIMEOUT_S)
        check(proc.returncode == 0, f"run C failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        resumed = [ln for ln in proc.stdout.splitlines() if ln.startswith("resumed from")]
        check(len(resumed) == 1 and " at epoch 2 (step 4, " in resumed[0],
              f"run C did not resume from the Orbax step 4: {resumed}")
        c, done = _tagged(proc.stdout, "RESULT")[-1], _tagged(proc.stdout, "DONE")[-1]
        check(c["steps"] == steps - 4, f"run C took {c['steps']} steps, not {steps - 4}")
        check(done["fwd"] == done["bwd"] == ATTN_PER_STEP * c["steps"],
              f"run C: K1 launches {done['fwd']}, {done['bwd']} != {ATTN_PER_STEP} x "
              f"{c['steps']} steps")
        c["params_gap_c_to_a"] = _npz_gap(c["npz"], a["npz"])
        c["loss_gap"] = max(abs(x - y) for x, y in zip(c["losses"], a["losses"][4:]))
        log("orbax", part="resume_run_c", card=json.dumps(card),
            params_gap_c_to_a=c["params_gap_c_to_a"],
            bit_equal=c["params_gap_c_to_a"] == 0.0, loss_gap_resumed_steps=c["loss_gap"],
            losses_c=json.dumps(c["losses"]), restore_ms_in_cli=float(
                resumed[0].rsplit(", ", 1)[1].split(" ms")[0]),
            launches=json.dumps([done["fwd"], done["bwd"]]))
        return c, done

    return run_c


def phase_orbax(card: str) -> None:
    """[orbax] (a): the JAX package's golden Orbax checkpoint decoded here
    by the port's reader, every leaf against the digests the JAX package's
    restore gave (tests/torch_orbax_golden.json), and the golden loss on
    the card from the decoded state with the recorded draws, the crop view
    resized at fp32."""
    from cross_scale_mae_torch import configs
    from cross_scale_mae_torch.models.mae import mae_loss_fn
    from cross_scale_mae_torch.ops.image import crop_resize
    from cross_scale_mae_torch.train.optim import build_optimizer
    from cross_scale_mae_torch.utils import orbax
    from cross_scale_mae_torch.utils.checkpoint import checkpoint_meta, restore_orbax_host
    from cross_scale_mae_torch.utils.params import params_from_jax, train_state_from_jax

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    golden = os.path.join(tests, "golden", "ckpt_v1")
    with open(os.path.join(tests, "torch_orbax_golden.json")) as f:
        held = json.load(f)
    with open(os.path.join(golden, "golden_values.json")) as f:
        want = json.load(f)["loss_after_restore"]
    t0 = time.perf_counter()
    tree, step = restore_orbax_host(golden, subset=None)
    read_ms = (time.perf_counter() - t0) * 1e3
    got = orbax.digests(tree)
    differ = sorted(k for k in set(got) | set(held["leaves"])
                    if got.get(k) != held["leaves"].get(k))
    check(step == held["step"] and not differ,
          f"golden leaves differ from their digests: {differ[:5]} ({len(differ)})")
    cfg = configs.MAEConfig.from_json(json.dumps(checkpoint_meta(golden, step)["config"]))
    dev = torch.device("cuda")
    template = params_from_jax(tree["params"], cfg, dev, full=True)
    state = train_state_from_jax(tree, cfg, build_optimizer(template, lambda s: 1e-3,
                                                            weight_decay=0.05), dev)
    batch = torch.from_numpy(
        np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(np.float32)).to(dev)
    boxes = torch.from_numpy(np.asarray(held["ms_boxes"], held["ms_boxes_dtype"])).to(dev)
    noise = torch.tensor(held["noise"], dtype=torch.float32, device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE fp32 products, as the CPU's
    try:
        with torch.no_grad():
            # The golden value is JAX's CPU arithmetic, where the crop's
            # DEFAULT precision is fp32. On the card the training crop rounds
            # its operands to bf16, as a TPU does (ops/image.py), so the crop
            # view goes in as a pair's second frame, resized at fp32; the
            # training crop's loss is the control, logged.
            crop = crop_resize(batch, boxes, cfg.input_size, "linear", exact=True)
            loss = float(mae_loss_fn(state.params, state.model_state, cfg,
                                     torch.stack([batch, crop], 1), noise=noise,
                                     train=False).loss)
            control = float(mae_loss_fn(state.params, state.model_state, cfg, batch,
                                        noise=noise, ms_boxes=boxes, train=False).loss)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    log("orbax", part="golden", card=json.dumps(card), leaves=len(got), digests_equal=True,
        step=step, read_ms=read_ms, library=orbax.ZSTD_LIBRARY, loss=loss, loss_want=want,
        loss_gap=abs(loss - want), tol=ORBAX_LOSS_TOL, loss_bf16_crop=control,
        loss_gap_bf16_crop=abs(control - want))
    check(abs(loss - want) <= ORBAX_LOSS_TOL,
          f"golden loss {loss} on the card, {want} wanted (within {ORBAX_LOSS_TOL})")


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


def phase_finetune(card: str, keep_npz: str) -> tuple[int, int]:
    """Finetune ViT-L through ``cli/finetune.main`` and evaluate; keeps the
    first run's params.npz at ``keep_npz``; returns the K2 kernels'
    (forward, backward) launches during those runs."""
    from torch.profiler import ProfilerActivity, profile

    from cross_scale_mae_torch.cli.finetune import build_run
    from cross_scale_mae_torch.cli.finetune import main as finetune_main
    from cross_scale_mae_torch.ops.attention import _mha_bwd_cuda, mha, mha_folded_bwd_reference, mha_v3
    from cross_scale_mae_torch.train.state import tree_leaves
    from cross_scale_mae_torch.utils.flops import mfu, vit_train_flops_per_image

    with tempfile.TemporaryDirectory() as tmp:
        mha.launches = mha.bwd_launches = mha_v3.launches = mha_v3.bwd_launches = 0
        result = finetune_main(_ft_argv(tmp, "pallas", FT_SYNTHETIC, FT_STEPS))
        shutil.copy(result["npz"], keep_npz)
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


def phase_linprobe(card: str, npz: str, keep_ckpt: str) -> int:
    """Linear-probe ViT-B through ``cli/linprobe.main`` from the pretrain
    phase's npz over seeded NAIP tiles; writes the first run's final state
    as a checkpoint in ``keep_ckpt`` (as ``--ckpt_interval`` would); returns
    K1f's launches in those runs."""
    from cross_scale_mae_torch.utils.checkpoint import save_checkpoint
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
        fwd_main = mha_v3.launches
        run = result["run"]
        save_checkpoint(keep_ckpt, run.state.step, run.state, run.cfg.to_json(), {"epoch": 1})
        check(mha_v3.launches == fwd_main, "writing the checkpoint launched a kernel")
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
        ckpt = os.path.join(result["output_dir"], "checkpoints")
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


# The served classifiers: [finetune]'s ViT-L (64 px, patch 8, 62 classes,
# bf16, K2) and [linprobe]'s ViT-B/16 behind the BN head (128 px, 10
# classes, bf16, K1), each at batch 64 over HTTP; the requests of
# REQUEST_ROWS in CLS_ROUNDS rounds.
CLS_ROUNDS = 64
# The [quantize] gate: the least cosine similarity of int8-weight outputs to
# the bf16-weight outputs on one seeded batch.
QUANT_COS_FLOOR = 0.99
# Calls of one dispatch-time reading in [quantize] and [export] (each
# reading after one warm-up call; four readings in turns).
DISPATCH_REPS = 50
# The [embed] phase: 1000 seeded 146 px JPEGs in an fMoW-RGB CSV, batch 256
# (three full batches and a ragged one of 232), through the pretrain
# phase's ViT-B encoder at 128 px.
EMBED_IMAGES = 1000
EMBED_BATCH = 256
EMBED_CANVAS = 146
# The [embed] rate is read over this many rows (the 1000 files cycled),
# after the gated runs: 20 batches, a ragged one of 136.
EMBED_TIMED = 5000
# The export's tolerance (rtol = atol) in bf16, the JAX export's
# (cli/export.py).
EXPORT_TOL = 3e-2
# [export]'s Fourier-mix encoder: ViT-B's widths at this depth (a check of
# the exported FFTs on the card, not a speed figure).
EXPORT_FOURIER_DEPTH = 2


def _serve_cfg():
    from cross_scale_mae_torch.configs import get_mae_config

    return get_mae_config("mae_vit_base_MsLdCeCd", input_size=128, patch_size=16,
                          compute_dtype="bfloat16", attention_impl="pallas_v3", gelu="tanh")


def write_serving_npz(path: str) -> str:
    """The [serving] phase's seeded ViT-B checkpoint (seed 0) as an npz."""
    from cross_scale_mae_torch.utils.checkpoint import save_params_npz
    from cross_scale_mae_torch.utils.params import random_mae_tree

    cfg = _serve_cfg()
    save_params_npz(path, random_mae_tree(cfg, seed=0), cfg.to_json())
    return path


def _serve_http(argv: list, rows=REQUEST_ROWS, rounds: int = CLS_ROUNDS, seed: int = 0):
    """cli/serve.build_app on ``argv`` (one warm-up dispatch), concurrent
    ``/predict`` requests of ``rows`` rows in ``rounds`` rounds; returns
    (sent [(key, uint8 batch)], answers {key: output}, /stats, /info, wall s)."""
    from cross_scale_mae_torch.cli.serve import build_app, get_args_parser

    server, batcher = build_app(get_args_parser().parse_args(argv))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    sent, answers = [], {}
    try:
        check(_get_json(url, "/healthz")["warm"], "/healthz: not warm")
        info = _get_json(url, "/info")
        _, canvas, _, c = info["input"]
        rng = np.random.default_rng(seed)

        def post(key, arr):
            answers[key] = _post_npy(url, arr)

        t0 = time.perf_counter()
        for rnd in range(rounds):
            threads = []
            for n in rows:
                arr = rng.integers(0, 256, (n, canvas, canvas, c), np.uint8)
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
    check(len(answers) == len(sent), "missing answers")
    return sent, answers, stats, info, wall


def _argmax_agreement(got: np.ndarray, ref: np.ndarray, what: str) -> dict:
    """Argmax of ``got`` against ``ref``'s: every row whose top-2 margin in
    ``ref`` is more than twice the largest logit difference must agree
    (a difference that small cannot reorder them); the share of all rows
    that agree is printed."""
    dev = float(np.abs(got - ref).max())
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * dev
    same = got.argmax(-1) == ref.argmax(-1)
    check(bool(same[clear].all()),
          f"{what}: argmax differs on {int((~same & clear).sum())} rows whose margin "
          f"exceeds 2 x {dev}")
    return {"agree": float(same.mean()), "rows": int(len(same)),
            "rows_gated": int(clear.sum())}


def _reset_counts() -> None:
    from cross_scale_mae_torch.ops.attention import mha, mha_qkv, mha_v3

    for c in (mha, mha_v3, mha_qkv):
        c.launches = c.bwd_launches = 0


def _counts() -> dict:
    from cross_scale_mae_torch.ops.attention import mha, mha_qkv, mha_v3

    return {"mha3_fwd": mha_v3.launches, "mha3_bwd": mha_v3.bwd_launches,
            "mha_fwd": mha.launches, "mha_bwd": mha.bwd_launches,
            "mha2_fwd": mha_qkv.launches, "mha2_bwd": mha_qkv.bwd_launches}


def _rel_gap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_serve_classifier(card: str, ft_ckpt: str, lp_ckpt: str) -> dict:
    """Serve [finetune]'s ViT-L (K2f, 24 launches a dispatch) and
    [linprobe]'s ViT-B with its BN head (K1f, 12 a dispatch) through
    cli/serve.build_app over HTTP at batch 64. The logits of every answered
    row against the same weights served with the plain attention: their
    relative L2 gap no larger than that of the plain server from the same
    model in fp32 (the kernel moves the logits less than bf16 itself does),
    and the argmax gate. Returns each kernel's launches."""
    from cross_scale_mae_torch.serving import build_serving_model, make_forward
    from cross_scale_mae_torch.utils.checkpoint import classifier_from_host, read_host_checkpoint

    launches = {}
    for name, ckpt, kernel, per in (("finetune", ft_ckpt, "mha_fwd", FT_ATTN),
                                    ("linprobe", lp_ckpt, "mha3_fwd", LP_ATTN)):
        _reset_counts()
        sent, answers, stats, info, wall = _serve_http(
            ["--ckpt", ckpt, "--port", "0", "--batch_size", str(SERVE_BATCH),
             "--device", "cuda", "--max_delay_ms", "5"])
        counts = _counts()
        launches[kernel] = counts[kernel]
        check(info["kind"] == "classifier", f"{name}: served kind {info['kind']}")
        impl = info["model_config"]["attention_impl"]
        check(impl == ("pallas" if kernel == "mha_fwd" else "pallas_v3"),
              f"{name}: attention_impl {impl}")
        expected = per * (stats["dispatches"] + 1)
        check(counts[kernel] == expected,
              f"{name}: {kernel} launches {counts[kernel]} != {per} x (dispatches "
              f"{stats['dispatches']} + 1 warm-up) = {expected}")
        check(sum(v for k, v in counts.items() if k != kernel) == 0,
              f"{name}: other kernels launched {counts}")
        plain = build_serving_model(ckpt, batch_size=SERVE_BATCH, device="cuda", portable=True)
        config, tree, state, _ = read_host_checkpoint(ckpt)
        params, model_state, cfg = classifier_from_host(config, tree, state, "cuda")
        del tree
        fp32 = make_forward(cfg.replace(compute_dtype="float32", attention_impl="xla"),
                            "classifier", "cls", "fmow_rgb", model_state)
        # The references run on every sent row in full batches of 64.
        rows_in = np.concatenate([arr for _, arr in sent])
        ref = np.concatenate([plain.fn(rows_in[i:i + SERVE_BATCH])
                              for i in range(0, len(rows_in), SERVE_BATCH)])
        with torch.inference_mode():
            ref32 = np.concatenate([
                fp32(params, torch.from_numpy(rows_in[i:i + SERVE_BATCH]).cuda()).cpu().numpy()
                for i in range(0, len(rows_in), SERVE_BATCH)])
        got, agree, at = [], [], 0
        for key, arr in sent:
            out = answers[key]
            check(out.shape == (len(arr), cfg.num_classes), f"{name} {key}: shape {out.shape}")
            check(bool(np.isfinite(out).all()), f"{name} {key}: non-finite logits")
            got.append(out)
            agree.append(_argmax_agreement(out, ref[at:at + len(arr)], f"{name} {key}"))
            at += len(arr)
        got = np.concatenate(got)
        gap, bf16_gap = _rel_gap(got, ref), _rel_gap(ref, ref32)
        check(gap <= bf16_gap, f"{name}: kernel vs plain logits rel gap {gap} above the "
              f"plain bf16 server's gap to fp32, {bf16_gap}")
        check(_counts()[kernel] == counts[kernel], "the plain servers launched a kernel")
        rows = sum(len(a) for _, a in sent)
        p50 = stats["dispatch_ms_p50"]
        log("serve_classifier", card=json.dumps(card), model=name, kernel=kernel,
            rounds=CLS_ROUNDS, requests=len(sent), rows=rows, dispatches=stats["dispatches"],
            launches=counts[kernel], dispatch_ms_p50=p50,
            dispatch_ms_p99=stats["dispatch_ms_p99"],
            imgs_per_s_at_p50=round(SERVE_BATCH / (p50 / 1e3), 1),
            http_rows_per_s=round(rows / wall, 1),
            max_abs_vs_plain=float(np.abs(got - ref).max()), rel_gap_vs_plain=gap,
            plain_bf16_rel_gap_vs_fp32=bf16_gap,
            argmax_agree=min(a["agree"] for a in agree),
            rows_gated=sum(a["rows_gated"] for a in agree))
        del plain, params, fp32
        torch.cuda.empty_cache()
    return launches


def phase_quantize(card: str, enc_npz: str, ft_ckpt: str) -> dict:
    """The [serving] ViT-B encoder and [finetune]'s ViT-L classifier served
    with --quantize int8 against bf16 weights: device bytes of the weights,
    the least cosine similarity of the outputs (gated), argmax agreement on
    the classifier (gated), the dispatch ms in turns (bf16, int8, int8,
    bf16, DISPATCH_REPS calls each) and the device ms a dispatch by kernel
    kind (a profiled window of 10 calls each). The counts are set to 0 just before the
    int8 server's calls and read just after, so each model's window holds
    its int8 dispatches alone: K1f 12 (encoder) or K2f 24 (ViT-L) a call
    and no other kernel. Returns those launches."""
    from cross_scale_mae_torch.serving import build_serving_model

    rng = np.random.default_rng(5)
    rows, launches = {}, {}
    for name, ckpt, kernel, per, rules in (
            ("encoder", enc_npz, "mha3_fwd", LP_ATTN, K1_KINDS),
            ("finetune", ft_ckpt, "mha_fwd", FT_ATTN, K2_KINDS)):
        kw = dict(batch_size=SERVE_BATCH, device="cuda",
                  **({"pool": "mean"} if name == "encoder" else {}))
        fp = build_serving_model(ckpt, **kw)
        batch = rng.integers(0, 256, (SERVE_BATCH, fp.canvas, fp.canvas, fp.channels), np.uint8)
        b = fp.fn(batch).astype(np.float64)
        f1 = _wall_ms(fp.fn, batch, DISPATCH_REPS)
        q8 = build_serving_model(ckpt, quantize="int8", **kw)
        calls = [0]

        def q8_fn(x):
            calls[0] += 1
            return q8.fn(x)

        _reset_counts()
        a = q8_fn(batch).astype(np.float64)
        q1, q2 = _wall_ms(q8_fn, batch, DISPATCH_REPS), _wall_ms(q8_fn, batch, DISPATCH_REPS)
        q8_dev = _device_ms(q8_fn, batch, rules)
        counts = _counts()
        f2 = _wall_ms(fp.fn, batch, DISPATCH_REPS)
        fp_dev = _device_ms(fp.fn, batch, rules)
        check(counts[kernel] == per * calls[0],
              f"int8 {name}: {kernel} launches {counts[kernel]} != {per} x {calls[0]} calls")
        check(sum(v for k, v in counts.items() if k != kernel) == 0,
              f"int8 {name}: other kernels launched {counts}")
        launches[kernel] = counts[kernel]
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
        check(bool(np.isfinite(a).all()), f"{name}: non-finite int8 output")
        check(cos.min() >= QUANT_COS_FLOOR,
              f"{name}: int8 cosine {cos.min()} below {QUANT_COS_FLOOR}")
        row = {"bytes_int8": q8.meta["param_bytes"], "bytes_bf16": fp.meta["param_bytes"],
               "cosine_vs_fp_min": float(cos.min()), "meta": q8.meta["quantize"],
               "int8_calls": calls[0], "launches": counts[kernel],
               "int8_dispatch_ms": [q1, q2], "bf16_dispatch_ms": [f1, f2],
               "reps_per_reading": DISPATCH_REPS,
               "int8_device_ms_per_dispatch": q8_dev, "bf16_device_ms_per_dispatch": fp_dev}
        if name == "finetune":
            row["argmax"] = _argmax_agreement(a, b, "int8 classifier")
        rows[name] = row
        del fp, q8
        torch.cuda.empty_cache()
    log("quantize", card=json.dumps(card), rows=json.dumps(rows), launches=json.dumps(launches))
    return launches


def phase_export(card: str, enc_npz: str, ft_ckpt: str, work: str) -> None:
    """cli/export.main on cuda: the ViT-B encoder baked, --no_bake_weights,
    --quantize int8 and --symbolic_batch, and the ViT-L classifier baked;
    each served through cli/serve --artifact over HTTP and held to the
    in-process forward (plain attention, the export's) at EXPORT_TOL;
    artifact bytes and dispatch ms against checkpoint serving, in turns
    (DISPATCH_REPS calls a reading)."""
    from cross_scale_mae_torch.cli.export import get_args_parser as export_parser
    from cross_scale_mae_torch.cli.export import main as export_main
    from cross_scale_mae_torch.serving import build_serving_model, load_artifact

    forms = (("encoder_baked", enc_npz, []), ("encoder_params", enc_npz, ["--no_bake_weights"]),
             ("encoder_int8", enc_npz, ["--quantize", "int8"]),
             ("encoder_symbolic", enc_npz, ["--symbolic_batch"]),
             ("finetune_baked", ft_ckpt, []))
    rows = {}
    for name, ckpt, extra in forms:
        pool = ["--pool", "mean"] if name.startswith("encoder") else []
        out = os.path.join(work, f"{name}.pt2")
        t0 = time.perf_counter()
        meta = export_main(export_parser().parse_args(
            ["--ckpt", ckpt, "--output", out, "--batch_size", str(SERVE_BATCH),
             "--platforms", "cuda", *pool, *extra]))
        export_s = time.perf_counter() - t0
        check(meta["verified"] == "roundtrip", f"{name}: {meta['verified']}")
        rows_sent = (1, 7, 64) if "--symbolic_batch" in extra else (SERVE_BATCH,)
        sent, answers, stats, info, _ = _serve_http(
            ["--artifact", out, "--port", "0", "--batch_size", str(SERVE_BATCH),
             "--device", "cuda", "--max_delay_ms", "1"], rows=rows_sent, rounds=1, seed=3)
        ref = build_serving_model(ckpt, batch_size=SERVE_BATCH, device="cuda", portable=True,
                                  quantize="int8" if "--quantize" in extra else None,
                                  **({"pool": "mean"} if pool else {}))
        worst = 0.0
        for key, arr in sent:
            got, want = answers[key], ref.fn(arr)
            np.testing.assert_allclose(got, want, rtol=EXPORT_TOL, atol=EXPORT_TOL,
                                       err_msg=f"{name} {key}")
            worst = max(worst, float(np.abs(got - want).max()))
        served = load_artifact(out, device="cuda")
        if "--symbolic_batch" in extra:
            check(served.batch_size is None, f"{name}: batch {served.batch_size}")
            for n in (1, 7, 100):
                arr = np.resize(sent[-1][1], (n, *sent[-1][1].shape[1:]))
                np.testing.assert_allclose(served.fn(arr), ref.fn(arr), rtol=EXPORT_TOL,
                                           atol=EXPORT_TOL, err_msg=f"{name} at batch {n}")
        kernel = build_serving_model(ckpt, batch_size=SERVE_BATCH, device="cuda",
                                     **({"pool": "mean"} if pool else {}))
        batch = sent[-1][1][:SERVE_BATCH]
        if len(batch) < SERVE_BATCH:
            batch = np.concatenate([batch] * (SERVE_BATCH // len(batch) + 1))[:SERVE_BATCH]
        k1, a1, a2, k2 = (_wall_ms(kernel.fn, batch, DISPATCH_REPS),
                          _wall_ms(served.fn, batch, DISPATCH_REPS),
                          _wall_ms(served.fn, batch, DISPATCH_REPS),
                          _wall_ms(kernel.fn, batch, DISPATCH_REPS))
        sidecar = meta["weights"]
        rows[name] = {"artifact_bytes": meta["bytes"],
                      "sidecar_bytes": os.path.getsize(sidecar) if sidecar != "baked" else 0,
                      "export_s": export_s, "max_abs_vs_inprocess": worst,
                      "quantize": meta["quantize"], "artifact_dispatch_ms": [a1, a2],
                      "checkpoint_dispatch_ms": [k1, k2], "dispatches": stats["dispatches"]}
        del ref, served, kernel
        for f in (out, sidecar):
            if f != "baked" and os.path.exists(f):
                os.remove(f)
        torch.cuda.empty_cache()
    rows["encoder_fourier_mix"] = _export_fourier_mix(work)
    log("export", card=json.dumps(card), rows=json.dumps(rows))


def _export_fourier_mix(work: str) -> dict:
    """cli/export.main on a Fourier-mix ViT-B encoder of EXPORT_FOURIER_DEPTH
    blocks (its complex FFTs in the exported program), reloaded on the card
    and held to the checkpoint server's output at EXPORT_TOL."""
    from cross_scale_mae_torch.cli.export import get_args_parser as export_parser
    from cross_scale_mae_torch.cli.export import main as export_main
    from cross_scale_mae_torch.serving import build_serving_model, load_artifact
    from cross_scale_mae_torch.utils.checkpoint import save_params_npz
    from cross_scale_mae_torch.utils.params import random_mae_tree

    cfg = _serve_cfg().replace(attention_impl="fourier_mix",
                               encoder_num_layers=EXPORT_FOURIER_DEPTH)
    npz, out = os.path.join(work, "fourier_mix.npz"), os.path.join(work, "fourier_mix.pt2")
    save_params_npz(npz, random_mae_tree(cfg, seed=0), cfg.to_json())
    t0 = time.perf_counter()
    meta = export_main(export_parser().parse_args(
        ["--ckpt", npz, "--output", out, "--batch_size", str(SERVE_BATCH), "--platforms",
         "cuda", "--pool", "mean"]))
    export_s = time.perf_counter() - t0
    check(meta["verified"] == "roundtrip", f"fourier_mix export: {meta['verified']}")
    served = load_artifact(out, device="cuda")
    ref = build_serving_model(npz, pool="mean", batch_size=SERVE_BATCH, device="cuda")
    batch = np.random.default_rng(7).integers(0, 256, (SERVE_BATCH, ref.canvas, ref.canvas, 3),
                                              np.uint8)
    got, want = served.fn(batch), ref.fn(batch)
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"fourier_mix export: {got.shape} against {want.shape}")
    np.testing.assert_allclose(got, want, rtol=EXPORT_TOL, atol=EXPORT_TOL,
                               err_msg="fourier_mix export against the checkpoint server")
    row = {"depth": EXPORT_FOURIER_DEPTH, "artifact_bytes": meta["bytes"], "export_s": export_s,
           "max_abs_vs_checkpoint_server": float(np.abs(got - want).max()),
           "shape": list(got.shape)}
    del served, ref
    for f in (npz, out):
        os.remove(f)
    torch.cuda.empty_cache()
    return row


def phase_embed(card: str, npz: str) -> int:
    """cli/embed.main over EMBED_IMAGES seeded 146 px JPEGs (an fMoW-RGB
    CSV) at batch 256 through the pretrain phase's ViT-B encoder, first with
    the plain attention (``--attention_impl xla``: the reference, and the
    warm-up), then with the checkpoint's K1f: the row count, the labels,
    the features against the plain run's within the bf16 budget, K1f 12 x
    batches and no other kernel. The images/s is read from a third run over
    EMBED_TIMED rows (the same files, cycled), K1f gated alike. Returns K1f's
    launches of the two kernel runs."""
    from PIL import Image

    from cross_scale_mae_torch.cli.embed import get_args_parser
    from cross_scale_mae_torch.cli.embed import main as embed_main
    from cross_scale_mae_torch.utils.checkpoint import read_config_json

    dim = json.loads(read_config_json(npz))["dim_model"]
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(13)
        labels = rng.integers(0, 62, EMBED_IMAGES)
        for i in range(EMBED_IMAGES):
            Image.fromarray(rng.integers(0, 256, (EMBED_CANVAS, EMBED_CANVAS, 3))
                            .astype(np.uint8)).save(f"{tmp}/e{i}.jpg", quality=90)
        for csv, rows in (("val", EMBED_IMAGES), ("timed", EMBED_TIMED)):
            with open(f"{tmp}/{csv}.csv", "w") as f:
                f.write("category,image_path\n")
                for r in range(rows):
                    f.write(f"{labels[r % EMBED_IMAGES]},e{r % EMBED_IMAGES}.jpg\n")

        def run(csv: str, out: str, *extra: str):
            _reset_counts()
            res = embed_main(get_args_parser().parse_args([
                "--ckpt", npz, "--dataset_type", "fmow_rgb", "--test_path", f"{tmp}/{csv}.csv",
                "--batch_size", str(EMBED_BATCH), "--pool", "cls",
                "--canvas_scale", str(EMBED_CANVAS / 128), "--device", "cuda",
                "--output_dir", f"{tmp}/{out}", *extra]))
            counts = _counts()
            rows = EMBED_IMAGES if csv == "val" else EMBED_TIMED
            batches = -(-rows // EMBED_BATCH)
            feats = np.load(f"{tmp}/{out}/features.npy")
            got_labels = np.load(f"{tmp}/{out}/labels.npy")
            check(res["count"] == rows and feats.shape == (rows, dim),
                  f"embed {out}: count {res['count']}, features {feats.shape}")
            check(res["batches"] == batches, f"embed {out}: {res['batches']} batches, "
                  f"expected {batches}")
            check(np.array_equal(got_labels, labels[np.arange(rows) % EMBED_IMAGES]),
                  f"embed {out}: labels differ from the CSV's")
            check(bool(np.isfinite(feats).all()), f"embed {out}: non-finite features")
            want = 0 if extra else LP_ATTN * batches
            check(counts["mha3_fwd"] == want,
                  f"embed {out}: K1f launches {counts['mha3_fwd']} != {want} ({batches} batches)")
            check(sum(counts.values()) == counts["mha3_fwd"], f"embed {out}: other kernels {counts}")
            return res, feats, counts["mha3_fwd"], batches

        _, plain, _, _ = run("val", "plain", "--attention_impl", "xla")
        _, feats, launches, batches = run("val", "kernel")
        max_err = _bf16_close(feats, plain, "embed: K1f features vs the plain attention's")
        timed, _, timed_launches, timed_batches = run("timed", "timed")
    log("embed", card=json.dumps(card), images=EMBED_IMAGES, batch=EMBED_BATCH,
        batches=batches, launches=launches, max_abs_vs_plain=max_err,
        timed_images=EMBED_TIMED, timed_batches=timed_batches, timed_launches=timed_launches,
        imgs_per_s=timed["imgs_per_sec"])
    return launches + timed_launches


def phase_data_parallel(card: str, enc_npz: str) -> int:
    """cli/serve --data_parallel over every visible card (one on the check
    host): its answers bit-equal to the single-device server's on the same
    weights. Returns K1f's launches of the data-parallel server."""
    from cross_scale_mae_torch.serving import build_serving_model

    n = torch.cuda.device_count()
    batch = SERVE_BATCH * n
    _reset_counts()
    sent, answers, stats, info, _ = _serve_http(
        ["--ckpt", enc_npz, "--port", "0", "--batch_size", str(batch), "--pool", "mean",
         "--device", "cuda", "--max_delay_ms", "1", "--data_parallel"],
        rows=(batch,), rounds=2, seed=4)
    launches = _counts()["mha3_fwd"]
    check(info["data_parallel"] == n, f"data_parallel {info['data_parallel']} != {n}")
    expected = LP_ATTN * n * (stats["dispatches"] + 1)
    check(launches == expected, f"K1f launches {launches} != 12 x {n} cards x (dispatches "
          f"{stats['dispatches']} + 1 warm-up) = {expected}")
    single = build_serving_model(enc_npz, pool="mean", batch_size=batch, device="cuda:0")
    for key, arr in sent:
        got, ref = answers[key], single.fn(arr)
        if n == 1:
            check(np.array_equal(got, ref), f"{key}: data-parallel output differs from one card's")
        else:
            _bf16_close(got, ref, f"data_parallel {key}")
    log("data_parallel", card=json.dumps(card), devices=n, batch=batch,
        dispatches=stats["dispatches"], launches=launches,
        dispatch_ms_p50=stats["dispatch_ms_p50"], bit_equal_to_one_card=(n == 1))
    return launches


# ------------------------------------------------------- evaluation and viz

# [ssim]: 16 images of 192 px (5 MS-SSIM levels need more than 160), one
# channel of the pair anticorrelated so its SSIM is below zero. The card's
# fp32 values against the same function in float64 on the host: SSIM_TOL on
# SSIM and MS-SSIM (means over 1.6M terms summed in fp32), SSIM_GRAD_TOL on
# the relative L2 gap of 1 - SSIM's gradient. Two controls on the same
# inputs: the blur with its TF32 guard taken away (the process's cuDNN
# setting, TF32 on), which must read the sound run's bits or fail the
# gate; and a blur whose convolutions round their operands to TF32's
# 10-bit mantissa, as a TF32 convolution does, which must fail it. Each
# limit sits between the sound readings and that control's (PERF.md
# section 6: sound 3.9e-8, 5.5e-8 and 9.9e-7; rounded 7.2e-4, 7.4e-4 and
# 5.5e-3; unguarded, the sound run's bits).
SSIM_SIZE = 192
SSIM_BATCH = 16
SSIM_TOL = 1e-5
SSIM_GRAD_TOL = 1e-4
SSIM_ARGS = ("--loss", "mse_ssim", "--loss_cd", "mse")
SSIM_STEPS = 10
MS_SSIM_STEPS = 3
# [perceptual]: the flagship step with the VGG16 trunk, a few steps each on
# a random and on an imported trunk; the card's loss (TF32 convolutions,
# PyTorch's default for cuDNN) against the host's fp32 on PERC_IMAGES
# images: within PERC_TF32_TOL relative, which the trunk in bf16 (autocast)
# must exceed; with TF32 off, within PERC_IEEE_TOL, which the TF32 reading
# must exceed (PERF.md section 6: TF32 read 1.03e-5, bf16 8.0e-4, TF32 off
# 0.0).
PERC_STEPS = 4
PERC_IMAGES = 4
PERC_TF32_TOL = 1e-4
PERC_IEEE_TOL = 1e-6
VGG16_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
               (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512), (21, 512, 512))
# [evalviz]: cli/evalviz on [pretrain_ssim]'s checkpoint over seeded JPEGs
# and temporal pairs; then a --plot_recon --val_img_path pretrain.
EVALVIZ_IMAGES = 8
EVALVIZ_PAIRS = 384
EVALVIZ_PAIR_BATCH = 128
PLOT_STEPS = 2
ENC_DEC_ATTN = 20   # K1f launches of one masked forward: 12 encoder + 8 decoder blocks


def _step_ms(run, reps: int = 3) -> float:
    """Host ms of one step of a built pretrain run, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run.step_fn(run.state, run.images, run.draws(run.state.step))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _in_turns(runs: dict, first: str, second: str) -> tuple[list, list]:
    """Each run's first step left out, then first, second, second, first."""
    for run in runs.values():
        _step_ms(run, reps=1)
    a1, b1, b2, a2 = (_step_ms(runs[first]), _step_ms(runs[second]), _step_ms(runs[second]),
                      _step_ms(runs[first]))
    return [a1, a2], [b1, b2]


def _check_run(result: dict, steps: int, what: str) -> None:
    losses = result["losses"]
    check(result["steps"] == steps and len(losses) == steps,
          f"{what}: {result['steps']} steps, {len(losses)} losses, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"{what}: non-finite loss in {losses}")


def _check_counts(counts: dict, fwd: int, bwd: int, what: str) -> None:
    check(counts["mha3_fwd"] == fwd and counts["mha3_bwd"] == bwd,
          f"{what}: K1 launches fwd {counts['mha3_fwd']}, bwd {counts['mha3_bwd']}, "
          f"expected {fwd}, {bwd}")
    check(sum(counts.values()) == fwd + bwd, f"{what}: other kernels launched {counts}")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _Tf32Blur(torch.autograd.Function):
    """The control of the [ssim] gate: ``ops/ssim._Blur``'s separable
    depthwise blur with every convolution operand rounded to TF32, forward
    and backward, as a TF32 convolution rounds them."""

    @staticmethod
    def forward(ctx, x, window):
        import torch.nn.functional as F

        from cross_scale_mae_torch.ops.ssim import _kernels

        ctx.save_for_backward(window)
        ctx.shape = x.shape
        kern_h, kern_w = (_tf32(k) for k in _kernels(window, x.shape[1]))
        y = F.conv2d(_tf32(x), kern_h, groups=x.shape[1])
        ctx.mid = y.shape
        return F.conv2d(_tf32(y), kern_w, groups=x.shape[1])

    @staticmethod
    def backward(ctx, grad):
        from cross_scale_mae_torch.ops.ssim import _kernels

        (window,) = ctx.saved_tensors
        c = ctx.shape[1]
        kern_h, kern_w = (_tf32(k) for k in _kernels(window, c))
        grad = torch.nn.grad.conv2d_input(ctx.mid, kern_w, _tf32(grad), groups=c)
        return torch.nn.grad.conv2d_input(ctx.shape, kern_h, _tf32(grad), groups=c), None


def phase_ssim(card: str) -> None:
    """SSIM, MS-SSIM and the gradient of 1 - SSIM on the card against the
    host's fp32 and float64 of the same function; the blur leaves the
    process's cuDNN TF32 setting as it found it. The gate's two controls
    (SSIM_TOL's comment): the blur without its guard, and the blur rounded
    to TF32. Then the device ms of the mse_ssim loss, forward and backward,
    at the flagship step's shape (both views of 384 images of 128 px, patch
    16, mask 0.75) beside mse's."""
    import contextlib

    from cross_scale_mae_torch.losses.recon import process_target, recon_loss
    from cross_scale_mae_torch.ops import ssim as ssim_mod
    from cross_scale_mae_torch.ops.ssim import ms_ssim, ssim

    rng = np.random.default_rng(31)
    x = rng.uniform(size=(SSIM_BATCH, SSIM_SIZE, SSIM_SIZE, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    y[..., 0] = 1.0 - x[..., 0]

    def readings(device: str, dtype: torch.dtype):
        xt = torch.from_numpy(x).to(device, dtype).requires_grad_(True)
        yt = torch.from_numpy(y).to(device, dtype)
        s = ssim(xt, yt)
        (1.0 - s).backward()
        return float(s.detach()), float(ms_ssim(xt.detach(), yt)), xt.grad.double().cpu()

    tf32 = torch.backends.cudnn.allow_tf32
    card_r, host_r, ref = (readings("cuda", torch.float32), readings("cpu", torch.float32),
                           readings("cpu", torch.float64))
    check(torch.backends.cudnn.allow_tf32 == tf32, "the blur changed the process's TF32 flag")
    guard, blur = ssim_mod._ieee_fp32_convs, ssim_mod._Blur
    torch.backends.cudnn.allow_tf32 = True
    ssim_mod._ieee_fp32_convs = contextlib.nullcontext
    try:
        unguarded_r = readings("cuda", torch.float32)
        ssim_mod._ieee_fp32_convs, ssim_mod._Blur = guard, _Tf32Blur
        rounded_r = readings("cuda", torch.float32)
    finally:
        ssim_mod._ieee_fp32_convs, ssim_mod._Blur = guard, blur
        torch.backends.cudnn.allow_tf32 = tf32

    def gaps(r):
        return {"ssim": abs(r[0] - ref[0]), "ms_ssim": abs(r[1] - ref[1]),
                "grad_rel_l2": float((r[2] - ref[2]).norm() / ref[2].norm())}

    def over(r):
        """The readings of ``r`` beyond their limits."""
        limits = {"ssim": SSIM_TOL, "ms_ssim": SSIM_TOL, "grad_rel_l2": SSIM_GRAD_TOL}
        return [k for k, v in gaps(r).items() if not v <= limits[k]]

    card_gaps, host_gaps = gaps(card_r), gaps(host_r)
    unguarded_same = (unguarded_r[:2] == card_r[:2] and torch.equal(unguarded_r[2], card_r[2]))
    log("ssim_control", card=json.dumps(card), card_vs_float64=json.dumps(card_gaps),
        unguarded_vs_float64=json.dumps(gaps(unguarded_r)), unguarded_bits_equal=unguarded_same,
        tf32_rounded_vs_float64=json.dumps(gaps(rounded_r)), tol=SSIM_TOL,
        grad_tol=SSIM_GRAD_TOL)
    check(not over(card_r),
          f"card SSIM vs float64: {card_gaps} (limits {SSIM_TOL}, {SSIM_GRAD_TOL})")
    check(abs(card_r[0] - host_r[0]) <= SSIM_TOL and abs(card_r[1] - host_r[1]) <= SSIM_TOL,
          f"card SSIM {card_r[:2]} vs the host's fp32 {host_r[:2]}")
    check(bool(over(rounded_r)), f"the gate passes a TF32-rounded blur: {gaps(rounded_r)}")
    check(unguarded_same or bool(over(unguarded_r)),
          f"the unguarded blur reads other bits within the gate: {gaps(unguarded_r)}")

    n, p = TRAIN_BATCH, 16
    gen = torch.Generator(device="cuda").manual_seed(5)
    imgs = torch.randn((2 * n, 128, 128, 3), device="cuda", generator=gen)
    target = process_target(imgs, p, 3, False)
    pred = torch.randn(target.shape, device="cuda", generator=gen).requires_grad_(True)
    mask = (torch.rand(target.shape[:2], device="cuda", generator=gen) < 0.75).float()

    def loss_step(name):
        def run(_):
            pred.grad = None
            loss = sum(recon_loss(name, target[v], pred[v], mask[v], p, 3)
                       for v in (slice(0, n), slice(n, 2 * n)))
            loss.backward()
        return run

    ms = {name: time_ms(loss_step(name), [None], reps=20) for name in ("mse", "mse_ssim", "mse")}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            loss_step("mse_ssim")(None)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 3e3, e.key) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    log("ssim", card=json.dumps(card), shape=json.dumps(list(x.shape)),
        card_values=json.dumps(card_r[:2]), host_fp32=json.dumps(host_r[:2]),
        float64=json.dumps(ref[:2]), card_vs_float64=json.dumps(card_gaps),
        host_fp32_vs_float64=json.dumps(host_gaps), tol=SSIM_TOL, grad_tol=SSIM_GRAD_TOL,
        loss_shape=json.dumps([2 * n, 128, 128, 3]),
        mse_ssim_fwd_bwd_ms=ms["mse_ssim"], mse_fwd_bwd_ms=ms["mse"],
        mse_ssim_device_ms=sum(t for t, _ in kernels),
        mse_ssim_top_kernels_ms=json.dumps([[round(t, 3), k[:60]] for t, k in kernels[:6]]))


def phase_pretrain_ssim(card: str, out: str) -> tuple[int, int]:
    """The flagship step with ``--loss mse_ssim`` (``--loss_cd mse``: the
    decoder predictor's term compares embeddings) through
    ``cli/pretrain.main`` for SSIM_STEPS steps, checkpointed at the last
    into ``out``; a short ``--loss ms_ssim`` run at 192 px; then the mse
    and mse_ssim steps timed in turns. Returns K1's (forward, backward)
    launches of the two CLI runs."""
    from cross_scale_mae_torch.cli.pretrain import build_run
    from cross_scale_mae_torch.cli.pretrain import main as pretrain_main
    from cross_scale_mae_torch.utils.checkpoint import latest_step
    from cross_scale_mae_torch.utils.flops import mae_train_flops_per_image, mfu

    _reset_counts()
    result = pretrain_main(_train_argv(out, "pallas_v3", *SSIM_ARGS, "--max_steps",
                                       str(SSIM_STEPS), "--ckpt_interval", str(SSIM_STEPS)))
    _check_run(result, SSIM_STEPS, "mse_ssim")
    _check_counts(_counts(), ATTN_PER_STEP * SSIM_STEPS, ATTN_PER_STEP * SSIM_STEPS, "mse_ssim")
    check(latest_step(os.path.join(result["output_dir"], "checkpoints")) == SSIM_STEPS,
          "no step-10 checkpoint")
    with tempfile.TemporaryDirectory() as tmp:
        _reset_counts()
        ms192 = pretrain_main(_train_argv(tmp, "pallas_v3", "--input_size", "192", "--loss",
                                          "ms_ssim", "--loss_cd", "mse", "--max_steps",
                                          str(MS_SSIM_STEPS)))
        _check_run(ms192, MS_SSIM_STEPS, "ms_ssim at 192 px")
        _check_counts(_counts(), ATTN_PER_STEP * MS_SSIM_STEPS, ATTN_PER_STEP * MS_SSIM_STEPS,
                      "ms_ssim")
        torch.cuda.empty_cache()
        runs = {"mse": build_run(_train_argv(os.path.join(tmp, "a"), "pallas_v3")),
                "mse_ssim": build_run(_train_argv(os.path.join(tmp, "b"), "pallas_v3",
                                                  *SSIM_ARGS))}
        mse_ms, ssim_ms = _in_turns(runs, "mse", "mse_ssim")
        cfg = runs["mse"].cfg
        del runs
        torch.cuda.empty_cache()
    ms = result["steady_ms_per_step"]
    flops = mae_train_flops_per_image(cfg)
    log("pretrain_ssim", card=json.dumps(card), steps=SSIM_STEPS, batch=TRAIN_BATCH,
        losses=json.dumps(result["losses"]), last=json.dumps(result["last_metrics"]),
        launches_fwd=ATTN_PER_STEP * SSIM_STEPS, launches_bwd=ATTN_PER_STEP * SSIM_STEPS,
        cli_ms_per_step_with_checkpoint=ms,
        step_ms_mse_ssim=json.dumps(ssim_ms), step_ms_mse=json.dumps(mse_ms),
        imgs_per_s=TRAIN_BATCH / (sum(ssim_ms) / 2e3),
        mfu=mfu(TRAIN_BATCH / (sum(ssim_ms) / 2e3), flops),
        ms_ssim_192_losses=json.dumps(ms192["losses"]),
        ms_ssim_192_ms_per_step=ms192["steady_ms_per_step"])
    return (ATTN_PER_STEP * (SSIM_STEPS + MS_SSIM_STEPS),) * 2


def _write_vgg16_pth(path: str, seed: int) -> None:
    """A torchvision-shaped VGG16 state dict (``features.N`` convs up to
    conv4_3), He-normal from ``seed``: the trunk without a download."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for i, c_in, c_out in VGG16_CONVS:
        sd[f"features.{i}.weight"] = (torch.randn((c_out, c_in, 3, 3), generator=gen)
                                      * math.sqrt(2.0 / (9 * c_in)))
        sd[f"features.{i}.bias"] = torch.zeros(c_out)
    torch.save(sd, path)


def _vgg16_flops(n: int, size: int) -> float:
    """FLOPs of the trunk's forward over n images of ``size`` px."""
    flops, side = 0.0, size
    for i, c_in, c_out in VGG16_CONVS:
        if i in (5, 10, 17):
            side //= 2
        flops += 2 * 9 * c_in * c_out * side * side
    return flops * n


def phase_perceptual(card: str) -> tuple[int, int]:
    """The flagship step with ``--use_perceptual_loss`` through
    ``cli/pretrain.main`` on a random trunk and on ``--vgg_weights`` (a
    seeded fake torchvision .pth written here), PERC_STEPS steps each; the
    perceptual and plain steps in turns; the trunk's own device ms at the
    step's shapes (pred and target forward, pred's input gradient); the
    card's loss against the host's. Returns K1's launches of the CLI runs."""
    from cross_scale_mae_torch.cli.pretrain import build_run
    from cross_scale_mae_torch.cli.pretrain import main as pretrain_main
    from cross_scale_mae_torch.losses.perceptual import perceptual_loss
    from cross_scale_mae_torch.utils.flops import mae_train_flops_per_image, mfu

    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "vgg16.pth")
        _write_vgg16_pth(pth, 17)
        _reset_counts()
        runs_cli = {trunk: pretrain_main(_train_argv(
            os.path.join(tmp, trunk), "pallas_v3", "--use_perceptual_loss", "--max_steps",
            str(PERC_STEPS), *(("--vgg_weights", pth) if trunk == "imported" else ())))
            for trunk in ("random", "imported")}
        launches = ATTN_PER_STEP * PERC_STEPS * 2
        _check_counts(_counts(), launches, launches, "perceptual")
        for trunk, res in runs_cli.items():
            _check_run(res, PERC_STEPS, f"perceptual ({trunk})")
            check(res["vgg_trunk"] == ("random" if trunk == "random" else f"imported:{pth}"),
                  f"vgg_trunk {res['vgg_trunk']}")
            check(math.isfinite(res["last_metrics"].get("loss_perceptual", math.nan)),
                  f"{trunk}: no finite loss_perceptual in {res['last_metrics']}")
        torch.cuda.empty_cache()
        runs = {"mse": build_run(_train_argv(os.path.join(tmp, "a"), "pallas_v3")),
                "perceptual": build_run(_train_argv(os.path.join(tmp, "b"), "pallas_v3",
                                                    "--use_perceptual_loss"))}
        plain_ms, perc_ms = _in_turns(runs, "mse", "perceptual")
        cfg, trunk = runs["perceptual"].cfg, runs["perceptual"].state.model_state["vgg"]
        del runs["mse"]
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(3)
        shape = (TRAIN_BATCH, cfg.input_size, cfg.input_size, 3)
        pred = torch.randn(shape, device="cuda", generator=gen).requires_grad_(True)
        target = torch.randn(shape, device="cuda", generator=gen)

        def vgg_step(_):
            pred.grad = None
            perceptual_loss(trunk, pred, target, resize_to=None).backward()

        torch.cuda.reset_peak_memory_stats()
        vgg_ms = time_ms(vgg_step, [None], reps=5)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        sub_p, sub_t = pred[:PERC_IMAGES].detach(), target[:PERC_IMAGES]
        card_tf32 = float(perceptual_loss(trunk, sub_p, sub_t, resize_to=None))
        with torch.autocast("cuda", dtype=torch.bfloat16):
            card_bf16 = float(perceptual_loss(trunk, sub_p, sub_t, resize_to=None))
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            card_ieee = float(perceptual_loss(trunk, sub_p, sub_t, resize_to=None))
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        host_trunk = {k: {n: t.cpu() for n, t in v.items()} for k, v in trunk.items()}
        host = float(perceptual_loss(host_trunk, sub_p.cpu(), sub_t.cpu(), resize_to=None))
        del runs, pred, target
        torch.cuda.empty_cache()
    gap_tf32, gap_ieee, gap_bf16 = (abs(v - host) / abs(host)
                                    for v in (card_tf32, card_ieee, card_bf16))
    log("perceptual_control", card=json.dumps(card), rel_gap_tf32=gap_tf32,
        rel_gap_ieee=gap_ieee, rel_gap_bf16=gap_bf16, tol_tf32=PERC_TF32_TOL,
        tol_ieee=PERC_IEEE_TOL)
    check(gap_tf32 <= PERC_TF32_TOL and gap_ieee <= PERC_IEEE_TOL,
          f"perceptual loss: card TF32 {card_tf32}, card IEEE {card_ieee}, host fp32 {host}")
    check(gap_bf16 > PERC_TF32_TOL, f"the TF32 gate passes a bf16 trunk: {gap_bf16}")
    check(gap_tf32 > PERC_IEEE_TOL, f"the IEEE gate passes the TF32 trunk: {gap_tf32}")
    step = sum(perc_ms) / 2
    vgg_flops = 3 * _vgg16_flops(TRAIN_BATCH, cfg.input_size)
    log("perceptual", card=json.dumps(card), steps=PERC_STEPS, batch=TRAIN_BATCH,
        losses=json.dumps({k: r["losses"] for k, r in runs_cli.items()}),
        loss_perceptual=json.dumps({k: r["last_metrics"]["loss_perceptual"]
                                    for k, r in runs_cli.items()}),
        launches_fwd=launches, launches_bwd=launches,
        step_ms_perceptual=json.dumps(perc_ms), step_ms_plain=json.dumps(plain_ms),
        imgs_per_s=TRAIN_BATCH / (step / 1e3),
        mfu_model_flops=mfu(TRAIN_BATCH / (step / 1e3), mae_train_flops_per_image(cfg)),
        vgg_fwd_fwd_bwd_ms=vgg_ms, vgg_share_of_step=vgg_ms / step,
        step_share_over_plain=(step - sum(plain_ms) / 2) / step,
        vgg_flops=vgg_flops, vgg_tflops_per_s=vgg_flops / (vgg_ms / 1e3) / 1e12,
        vgg_timing_peak_gb=peak_gb, loss_card_tf32=card_tf32, loss_card_ieee=card_ieee,
        loss_card_bf16=card_bf16, loss_host_fp32=host, rel_gap_tf32=gap_tf32,
        rel_gap_ieee=gap_ieee, rel_gap_bf16=gap_bf16, tol_tf32=PERC_TF32_TOL,
        tol_ieee=PERC_IEEE_TOL)
    return launches, launches


def phase_evalviz(card: str, ckpt: str) -> dict:
    """``cli/evalviz.main`` on [pretrain_ssim]'s checkpoint over seeded
    JPEGs (``--images``), two noise kinds and ``--temporal_csv`` pairs; then
    a ``--plot_recon --val_img_path`` pretrain of PLOT_STEPS steps. Returns
    {"evalviz": (fwd, bwd), "plot_recon": (fwd, bwd)} K1 launches."""
    from PIL import Image

    from cross_scale_mae_torch.cli import evalviz
    from cross_scale_mae_torch.cli.pretrain import main as pretrain_main

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(43)
        os.makedirs(f"{tmp}/val")
        files = []
        for i in range(EVALVIZ_IMAGES):
            files.append(f"{tmp}/val/v{i}.jpg")
            Image.fromarray(rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)).save(
                files[-1], quality=90)
        csv = _write_pairs(tmp, EVALVIZ_PAIRS, 41)
        out = f"{tmp}/viz"
        _reset_counts()
        t0 = time.perf_counter()
        sweep = evalviz.main(evalviz.get_args_parser().parse_args([
            "--ckpt", ckpt, "--images", *files, "--metrics", "mse", "ssim",
            "--noise", "gaussian", "salt_pepper", "--temporal_csv", csv,
            "--temporal_batch", str(EVALVIZ_PAIR_BATCH), "--out", out, "--device", "cuda"]))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        batches = -(-EVALVIZ_PAIRS // EVALVIZ_PAIR_BATCH)
        fwd = ENC_DEC_ATTN * EVALVIZ_IMAGES * 4 + LP_ATTN * batches
        _check_counts(_counts(), fwd, 0, "evalviz")
        name = os.path.basename(os.path.dirname(ckpt.rstrip("/")))
        want = {f"{name}_img{i}.png" for i in range(EVALVIZ_IMAGES)} | {
            "metrics.json", "temporal_gaps.json"}
        check(set(os.listdir(out)) == want, f"evalviz wrote {sorted(os.listdir(out))}")
        for i in range(EVALVIZ_IMAGES):
            with Image.open(f"{out}/{name}_img{i}.png") as im:
                check(im.size == (512, 128), f"figure {i} is {im.size}")
        scores = sweep[name]
        check(set(scores) == {f"{m}{k}" for m in ("mse", "ssim")
                              for k in ("", "_gaussian", "_salt_pepper")}
              and all(math.isfinite(v) for v in scores.values()), f"sweep {scores}")
        with open(f"{out}/temporal_gaps.json") as f:
            report = json.load(f)[name]
        check(report["overall"]["n"] == EVALVIZ_PAIRS
              and -1.0 <= report["overall"]["mean_cos"] <= 1.0, f"temporal {report['overall']}")

        _reset_counts()
        plot = pretrain_main(_train_argv(f"{tmp}/plot", "pallas_v3", "--plot_recon",
                                         "--val_img_path", f"{tmp}/val", "--max_steps",
                                         str(PLOT_STEPS), "--ckpt_interval", str(PLOT_STEPS)))
        _check_run(plot, PLOT_STEPS, "plot_recon")
        plot_fwd = ATTN_PER_STEP * PLOT_STEPS + ENC_DEC_ATTN * EVALVIZ_IMAGES
        _check_counts(_counts(), plot_fwd, ATTN_PER_STEP * PLOT_STEPS, "plot_recon")
        check(sorted(os.path.basename(p) for p in plot["figures"]) == sorted(
            f"epoch_{PLOT_STEPS - 1:04d}_v{i}.png" for i in range(EVALVIZ_IMAGES)),
            f"plot_recon wrote {plot['figures']}")
        torch.cuda.empty_cache()
    log("evalviz", card=json.dumps(card), images=EVALVIZ_IMAGES, pairs=EVALVIZ_PAIRS,
        sweep=json.dumps(scores), temporal=json.dumps(report["overall"]),
        buckets=json.dumps(report["buckets"]), launches_fwd=fwd, wall_s=wall_s,
        images_per_s=(4 * EVALVIZ_IMAGES + 2 * EVALVIZ_PAIRS) / wall_s,
        plot_recon_figures=len(plot["figures"]), plot_recon_launches_fwd=plot_fwd,
        plot_recon_losses=json.dumps(plot["losses"]))
    return {"evalviz": (fwd, 0), "plot_recon": (plot_fwd, ATTN_PER_STEP * PLOT_STEPS)}


VARIANTS = ("linformer", "nystrom", "orthoformer", "local", "fourier_mix")
# (N, L, H, hd) of the flagship step's attention: both views of 384 images,
# the masked encoder's 17 tokens and the decoder's 65.
VARIANT_SHAPES = {"encoder": (2 * TRAIN_BATCH, 17, 12, 64),
                  "decoder": (2 * TRAIN_BATCH, 65, 16, 32)}
VARIANT_SEQ = 65          # the declared seq_len of linformer's E and F
VARIANT_F32_TOL = 2.0 ** -16   # fp32: max |y32 - y64| / max |y64|
VARIANT_BF16_TOL = 2.0 ** -16  # bf16: mean |y16 - r64| / mean |r64|
VARIANT_WARMUP, VARIANT_TIMED = 2, 3
VARIANT_SERVE_ROWS = 64
# A variant step's kernels by kind: cuBLAS products, cuFFT, softmax,
# scatter/gather (segment sums, landmark rows) and the rest.
VARIANT_KINDS = (("matmul", MATMUL_NAMES), ("fft", ("fft",)), ("softmax", ("softmax",)),
                 ("index", ("index", "scatter", "gather")))
OBS_STEPS = 32
OBS_TRACED = 20           # --profile_dir's window: steps 10-30


def variant_fn(variant: str, q, k, v, e, f, products: bool = False):
    """One variant of ``ops/attention.py`` on (N, L, H, hd) q, k, v (E and F
    for linformer). ``products`` calls Nystrom's and orthoformer's products
    past their IEEE-fp32 guard, for the TF32 control."""
    from cross_scale_mae_torch.ops import attention as A

    if variant == "linformer":
        return A.linformer_mha(q, k, v, e, f)
    if variant == "fourier_mix":
        return A.fourier_mix(q)
    if variant == "local":
        return A.local_mha(q, k, v)
    m = A.NYSTROM_LANDMARKS if variant == "nystrom" else A.ORTHOFORMER_LANDMARKS
    if products and q.shape[1] > m:
        inner = A.nystrom_products if variant == "nystrom" else A.orthoformer_products
        return inner(q, k, v, m)
    return (A.nystrom_mha if variant == "nystrom" else A.orthoformer_mha)(q, k, v)


def bf16_path_fp64(variant: str, q, k, v, e, f):
    """The bf16 version's arithmetic in float64 on float64 q, k, v holding
    bf16 values: every cast to bf16 of the port's bf16 path (linformer's E,
    F and projections, P, Nystrom's segment sums and means, the output)
    rounds here too; every fp32 step runs in float64."""
    from cross_scale_mae_torch.ops import attention as A

    def rnd(x):
        return x.to(torch.bfloat16).to(x.dtype)

    def probs(a, b):
        return torch.softmax(a @ b.transpose(-1, -2) * a.shape[-1] ** -0.5, dim=-1)

    n, l, h, hd = q.shape
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if variant == "fourier_mix":
        x = q.reshape(n, l, h * hd)
        return rnd(torch.fft.fft(torch.fft.fft(x, dim=-1), dim=-2).real.reshape(q.shape))
    if variant == "linformer":
        k_p = rnd(torch.einsum("nlhd,lm->nhmd", k, rnd(e[:l])))
        v_p = rnd(torch.einsum("nlhd,lm->nhmd", v, rnd(f[:l])))
        return rnd(rnd(probs(qh, k_p)) @ v_p).transpose(1, 2)
    if variant == "local":
        pos = torch.arange(l, device=q.device)
        band = (pos[:, None] - pos[None, :]).abs() <= A.LOCAL_WINDOW // 2
        logits = (qh @ kh.transpose(-1, -2) * hd ** -0.5).masked_fill(~band, -1e30)
        return rnd(rnd(torch.softmax(logits, dim=-1)) @ vh).transpose(1, 2)
    m = A.NYSTROM_LANDMARKS if variant == "nystrom" else A.ORTHOFORMER_LANDMARKS
    if l <= m:
        return rnd(rnd(probs(qh, kh)) @ vh).transpose(1, 2)
    if variant == "orthoformer":
        q_l = qh[:, :, A.landmark_rows(l, m)]
        return rnd(probs(qh, q_l) @ (probs(q_l, kh) @ vh)).transpose(1, 2)
    seg = A.segment_ids(l, m, q.device)
    count = torch.zeros(m, dtype=q.dtype, device=q.device).index_add_(0, seg, q.new_ones(l))

    def means(x):
        sums = rnd(x.new_zeros((n, m, h, hd)).index_add_(1, seg, x))
        return rnd(sums / count[None, :, None, None]).transpose(1, 2)

    q_l, k_l = means(q), means(k)
    out = probs(qh, k_l) @ A.iterative_pinv(probs(q_l, k_l)) @ (probs(q_l, kh) @ vh)
    return rnd(out).transpose(1, 2)


def _fourier_bf16_mid(q):
    """fourier_mix with the first FFT's output rounded to bf16 (a control)."""
    n, l, h, hd = q.shape
    y = torch.fft.fft(q.reshape(n, l, h * hd).float(), dim=-1)
    y = torch.complex(y.real.bfloat16().float(), y.imag.bfloat16().float())
    return torch.fft.fft(y, dim=-2).real.reshape(q.shape).to(q.dtype)


def _no_widening(fn):
    """``fn()`` with ``ops/attention``'s fp32 steps left in the input dtype
    (its ``accum_dtype`` the identity): the bf16 gate's control."""
    from cross_scale_mae_torch.ops import attention as A

    widen = A.accum_dtype
    A.accum_dtype = lambda dtype: dtype
    try:
        return fn()
    finally:
        A.accum_dtype = widen


def _with_tf32(fn):
    """``fn()`` with fp32 matmuls allowed to run in TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _max_rel(got, ref) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


def _mean_rel(got, ref) -> float:
    return float((got.double() - ref).abs().mean() / ref.abs().mean())


def phase_variant_gates(card: str) -> None:
    """Each variant at the flagship's encoder and decoder shapes, fp32 and
    bf16, against float64 on the card, with the control each gate catches."""
    from cross_scale_mae_torch.models.layers import xavier_uniform

    for where, shape in VARIANT_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(27)
        q, k, v = (torch.randn(shape, device="cuda", generator=gen) for _ in range(3))
        e, f = (xavier_uniform(gen, (VARIANT_SEQ, VARIANT_SEQ // 4), VARIANT_SEQ,
                               VARIANT_SEQ // 4) for _ in range(2))
        wide = [t.double() for t in (q, k, v, e, f)]
        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        for variant in VARIANTS:
            y64 = variant_fn(variant, *wide)
            f32 = _max_rel(variant_fn(variant, q, k, v, e, f), y64)
            ctl32 = _max_rel(variant_fn(variant, qb.float(), kb.float(), vb.float(), e, f), y64)
            tf32 = _max_rel(_with_tf32(lambda: variant_fn(variant, q, k, v, e, f, True)), y64)
            r64 = bf16_path_fp64(variant, qb.double(), kb.double(), vb.double(), *wide[3:])
            y16 = variant_fn(variant, qb, kb, vb, e, f)
            check(y16.dtype == torch.bfloat16 and y16.shape == shape,
                  f"{variant} {where}: {y16.dtype} {tuple(y16.shape)}")
            b16 = _mean_rel(y16, r64)
            if variant == "fourier_mix":
                ctl16 = _mean_rel(_fourier_bf16_mid(qb), r64)
            else:
                ctl16 = _mean_rel(_no_widening(lambda: variant_fn(variant, qb, kb, vb, e, f)),
                                  r64)
            torch.cuda.synchronize()
            log("variant_gate", card=json.dumps(card), variant=variant, where=where,
                shape=json.dumps(list(shape)), fp32_max_rel=f32, fp32_control=ctl32,
                fp32_tol=VARIANT_F32_TOL, tf32_max_rel=tf32, bf16_mean_rel=b16,
                bf16_control=ctl16, bf16_tol=VARIANT_BF16_TOL,
                fp32_control_name="inputs narrowed to bf16",
                bf16_control_name=("first FFT rounded to bf16" if variant == "fourier_mix"
                                   else "fp32 steps left in bf16"))
            check(f32 <= VARIANT_F32_TOL, f"{variant} {where} fp32: {f32} > {VARIANT_F32_TOL}")
            check(b16 <= VARIANT_BF16_TOL, f"{variant} {where} bf16: {b16} > {VARIANT_BF16_TOL}")
            # A control that comes out NaN breaks its gate too.
            check(not ctl32 <= VARIANT_F32_TOL, f"{variant} {where}: the fp32 gate passes "
                  f"its control ({ctl32})")
            check(not ctl16 <= VARIANT_BF16_TOL, f"{variant} {where}: the bf16 gate passes "
                  f"its control ({ctl16})")
        del q, k, v, qb, kb, vb, wide
        torch.cuda.empty_cache()


def phase_variants(card: str) -> dict:
    """[variant_gate], then each variant through the pretrain CLI's run at
    the flagship's size, a linformer ViT-L finetune step and a linformer
    encoder served on the card and on the host. Returns {kernel: launches}
    over these paths (all 0)."""
    from torch.profiler import ProfilerActivity, profile

    from cross_scale_mae_torch.cli.finetune import build_run as ft_build_run
    from cross_scale_mae_torch.cli.pretrain import build_run
    from cross_scale_mae_torch.configs import get_mae_config
    from cross_scale_mae_torch.serving import build_serving_model
    from cross_scale_mae_torch.utils.checkpoint import save_params_npz
    from cross_scale_mae_torch.utils.params import random_mae_tree

    phase_variant_gates(card)
    total = dict.fromkeys(_counts(), 0)

    def add(counts):
        for name, n in counts.items():
            total[name] += n
        check(sum(counts.values()) == 0, f"an attention kernel ran behind a variant: {counts}")

    with tempfile.TemporaryDirectory() as tmp:
        for variant in VARIANTS:
            run = build_run(_train_argv(tmp, variant))
            check(run.cfg.attention_impl == variant, f"built {run.cfg.attention_impl}")
            _reset_counts()
            losses, times = [], []
            for i in range(VARIANT_WARMUP + VARIANT_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, metrics = run.step_fn(run.state, run.images, run.draws(run.state.step))
                losses.append(float(metrics["loss"]))
                if i >= VARIANT_WARMUP:
                    times.append((time.perf_counter() - t0) * 1e3)
            counts = _counts()
            add(counts)
            check(all(math.isfinite(x) for x in losses), f"{variant}: losses {losses}")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run.step_fn(run.state, run.images, run.draws(run.state.step))
                torch.cuda.synchronize()
            kinds = _kernel_ms_by_kind(prof, VARIANT_KINDS)
            top = sorted(((e.self_device_time_total / 1e3, e.key[:60]) for e in
                          prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
            ms = sum(times) / len(times)
            busy = sum(kinds.values())
            log("variants", card=json.dumps(card), variant=variant, batch=TRAIN_BATCH,
                step_ms=ms, imgs_per_s=TRAIN_BATCH / (ms / 1e3), step_ms_each=json.dumps(times),
                losses=json.dumps(losses), launches=json.dumps(counts),
                device_ms=json.dumps(kinds), device_idle_share=1 - busy / ms,
                top_kernels=json.dumps(top[:4]))
            del run
            torch.cuda.empty_cache()

        ft = ft_build_run(_ft_argv(tmp, "linformer", FT_BATCH, 1))
        imgs, labels = next(ft.train_batches(0))
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = ft.step_fn(ft.state, imgs, labels, ft.draws(ft.state.step))
        loss = float(metrics["loss"])
        ft_ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        add(counts)
        e_proj = ft.state.params["blocks"][0]["attn"]["e_proj"]
        check(math.isfinite(loss) and tuple(e_proj.shape) == (65, 16),
              f"linformer finetune: loss {loss}, E {tuple(e_proj.shape)}")
        log("variants", card=json.dumps(card), path="finetune_linformer", model="vit_large",
            batch=FT_BATCH, step_ms_first=ft_ms, loss=loss, launches=json.dumps(counts))
        del ft, imgs, labels
        torch.cuda.empty_cache()

        cfg = get_mae_config("mae_vit_base_MsLdCeCd", input_size=128, patch_size=16,
                             compute_dtype="bfloat16", attention_impl="linformer", gelu="tanh")
        tree = random_mae_tree(cfg, seed=0)
        paths = {}
        for dtype in ("bfloat16", "float32"):
            paths[dtype] = os.path.join(tmp, f"linformer_{dtype}.npz")
            save_params_npz(paths[dtype], tree, cfg.replace(compute_dtype=dtype).to_json())
        card_model = build_serving_model(paths["bfloat16"], pool="mean",
                                         batch_size=VARIANT_SERVE_ROWS, device="cuda")
        u8 = np.random.default_rng(5).integers(
            0, 256, (VARIANT_SERVE_ROWS, card_model.canvas, card_model.canvas, 3), np.uint8)
        _reset_counts()
        got = card_model.fn(u8)
        counts = _counts()
        add(counts)
        host = {d: build_serving_model(paths[d], pool="mean", batch_size=VARIANT_SERVE_ROWS,
                                       device="cpu").fn(u8) for d in paths}
        gap_card = _rel_gap(got, host["float32"])
        gap_host = _rel_gap(host["bfloat16"], host["float32"])
        log("variants", card=json.dumps(card), path="serve_linformer", rows=VARIANT_SERVE_ROWS,
            shape=json.dumps(list(got.shape)), rel_gap_card_bf16_to_host_fp32=gap_card,
            rel_gap_host_bf16_to_host_fp32=gap_host, launches=json.dumps(counts))
        check(got.shape == (VARIANT_SERVE_ROWS, 768) and np.isfinite(got).all(),
              f"linformer dispatch: {got.shape}")
        check(gap_card <= 2 * gap_host, f"linformer dispatch: card bf16 {gap_card} from the "
              f"host's fp32, the host's bf16 {gap_host}")
    return total


def phase_observability(card: str) -> tuple[int, int]:
    """The flagship step through ``cli/pretrain.main`` with the profile
    window, TensorBoard and wandb; returns its K1 (forward, backward)
    launches."""
    import importlib.util

    from cross_scale_mae_torch.cli.pretrain import main as pretrain_main
    from cross_scale_mae_torch.utils.profiling import device_memory_stats

    has_wandb = importlib.util.find_spec("wandb") is not None
    with tempfile.TemporaryDirectory() as tmp:
        if has_wandb:
            # A disabled run makes no network call.
            os.environ.update(WANDB_MODE="disabled", WANDB_DIR=tmp)
        # One epoch of OBS_STEPS batches: the window is in the first epoch.
        args = _train_argv(f"{tmp}/out", "pallas_v3", "--profile_dir", f"{tmp}/prof",
                           "--use_tensorboard", "--use_wandb", "--log_interval", "5",
                           "--synthetic_len", str(OBS_STEPS * TRAIN_BATCH),
                           "--max_steps", str(OBS_STEPS))
        _reset_counts()
        res = pretrain_main(args)
        counts = _counts()
        _check_run(res, OBS_STEPS, "observability")
        _check_counts(counts, ATTN_PER_STEP * OBS_STEPS, ATTN_PER_STEP * OBS_STEPS,
                      "observability")
        trace = res["trace"]
        check(trace["steps"] == OBS_TRACED and len(trace["files"]) == 1,
              f"trace window: {trace}")
        t0 = time.perf_counter()
        with open(trace["files"][0]) as fh:
            events = json.load(fh)["traceEvents"]
        parse_s = time.perf_counter() - t0
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        fwd = sum("mha3_fwd" in n for n in kernels)
        bwd = sum("mha3_bwd" in n for n in kernels)
        check(fwd == bwd == ATTN_PER_STEP * OBS_TRACED,
              f"trace: {fwd} mha3_fwd and {bwd} mha3_bwd launches over {OBS_TRACED} steps")
        outside = OBS_STEPS - 1 - OBS_TRACED      # the steps timed after the first
        all_s = res["steady_ms_per_step"] * (OBS_STEPS - 1) / 1e3
        tb = res["tensorboard_dir"]
        events_file = (sorted(os.path.join(tb, f) for f in os.listdir(tb)
                              if f.startswith("events.out.tfevents")) if tb else [])
        if importlib.util.find_spec("tensorboard") is not None:
            check(len(events_file) == 1, f"no TensorBoard event file in {tb}")
        log("observability", card=json.dumps(card), steps=OBS_STEPS, traced=trace["steps"],
            step_ms_in_window=trace["window_s"] / trace["steps"] * 1e3,
            step_ms_outside=(all_s - trace["window_s"] - trace["overhead_s"]) / outside * 1e3,
            profiler_overhead_s=trace["overhead_s"], trace_bytes=os.path.getsize(
                trace["files"][0]), trace_parse_s=parse_s, trace_kernels=len(kernels),
            trace_mha3_fwd=fwd, trace_mha3_bwd=bwd, launches=json.dumps(counts),
            device_memory_mib=json.dumps(device_memory_stats()),
            tensorboard=events_file[0] if events_file
            else "tensorboard unavailable; skipping TB logging",
            wandb="disabled run (WANDB_MODE)" if has_wandb
            else "wandb unavailable; skipping wandb logging",
            losses=json.dumps(res["losses"]))
        if has_wandb:
            for key in ("WANDB_MODE", "WANDB_DIR"):
                os.environ.pop(key, None)
    torch.cuda.empty_cache()
    return counts["mha3_fwd"], counts["mha3_bwd"]


# [mesh]: the flagship step through cli/pretrain.main under each layout flag
# at world size torch.cuda.device_count() (1 on a one-card machine: an NCCL
# group of one, where every layout holds whole leaves and the step is the
# plain one's arithmetic), held to the plain run of the same draws; on two
# or more cards also tensor and sequence parallelism over 2 model ranks,
# held to the one-card run.
MESH_STEPS = 4
MESH_LAYOUTS = {"zero1": ("--zero1",), "fsdp": ("--fsdp",), "num_slices": ("--num_slices", "1")}
MESH_MODEL_LAYOUTS = {"tp2": ("--model_parallel", "2"),
                      "tp2_sp": ("--model_parallel", "2", "--sequence_parallel")}
# The variants under tp 2 (no kernel launches), each held to a one-card
# run of the same variant.
MESH_VARIANT_LAYOUTS = {f"tp2_{v}": ("--model_parallel", "2", "--attention_impl", v)
                        for v in ("nystrom", "orthoformer", "fourier_mix")}
MESH_LOSS_RTOL = 1e-5       # one card: the same arithmetic as the plain run
MESH_PARAMS_ATOL = 0.0      # one card: the same params, bit for bit
# Across cards: the partial sums in other orders. Four cards read at most
# 6.2e-6; the contiguous qkv control reads far above (its first loss is
# another function's).
MESH_TP_LOSS_RTOL = 1e-4
# Faults the multi-card gate must see, each run as a layout with the fault
# put into the rank processes before cli/pretrain.main: JAX's contiguous
# slice of the 3D qkv columns (gated: must miss MESH_TP_LOSS_RTOL), the
# predictor's BatchNorm statistics without the model group's sum (logged),
# and Fourier mixing over each rank's own heads, without gathering q
# (gated). name -> (gated, layout, code).
MESH_CONTROLS = {
    "contiguous_qkv": (True, "tp2", """
import dataclasses
from cross_scale_mae_torch.parallel import mesh as pmesh
specs_of = pmesh.leaf_specs
pmesh.leaf_specs = lambda p, l: [s if s is None else dataclasses.replace(s, qkv=False)
                                 for s in specs_of(p, l)]
"""),
    "bn_without_model_sum": (False, "tp2", """
import torch.distributed as tdist
from cross_scale_mae_torch.models import layers
stats = layers.batch_stats
layers.batch_stats = lambda x, dims, g=False, group="data": stats(
    x, dims, g, "data" if group is tdist.group.WORLD else group)
"""),
    "fourier_mix_no_gather": (True, "tp2_fourier_mix", """
from cross_scale_mae_torch.models import layers
layers._fourier_mix_heads = lambda q, num_heads: layers.fourier_mix(q)
"""),
}
FSDP_FT_STEPS = 3
TP_PARTITION_TOL = 2.0 ** -7   # relative L2 gap of the summed head groups, bf16


def _mesh_worker_runs(tmp: str, world: int, layouts: dict,
                      faults: dict | None = None) -> dict:
    """Each layout's run at ``world`` ranks, one process per card through
    the [resume] worker, run after the code ``faults[name]`` where there is
    one; {name: rank 0's RESULT and DONE}."""
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name, flags in layouts.items():
        script = "import sys\nsys.path.insert(0, sys.argv[1])\n" \
            + (faults or {}).get(name, "") + _RESUME_WORKER
        address = f"localhost:{_free_port()}"
        argv = [*_resume_argv(os.path.join(tmp, name))[:-2], "--output_dir",
                os.path.join(tmp, name), "--synthetic_len", str(TRAIN_BATCH),
                "--epochs", "100000", "--warmup_epochs", "0", "--max_steps", str(MESH_STEPS),
                "--ckpt_interval", "100000", *flags, "--coordinator_address", address,
                "--num_processes", str(world)]
        procs = [subprocess.Popen([sys.executable, "-c", script, repo, *argv,
                                   "--process_id", str(r)], cwd=repo, text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  env=dict(os.environ, LOCAL_RANK=str(r)))
                 for r in range(world)]
        texts = [p.communicate(timeout=RESUME_TIMEOUT_S)[0] for p in procs]
        for r, (p, text) in enumerate(zip(procs, texts)):
            check(p.returncode == 0, f"[mesh] {name} rank {r} failed:\n{text[-3000:]}")
        out[name] = {"result": _tagged(texts[0], "RESULT")[-1],
                     "done": _tagged(texts[0], "DONE")[-1]}
    return out


def phase_mesh(card: str) -> tuple[int, int]:
    """[mesh]: --zero1, --fsdp and --num_slices 1 at world size
    torch.cuda.device_count() through cli/pretrain.main at the flagship's
    width (on two or more cards also --model_parallel 2 and with
    --sequence_parallel), each held to the plain run of the same draws, K1's
    20 + 20 launches a step; the per-rank step time, peak memory and
    optimizer-state bytes. Returns the K1 launches of the layout runs."""
    from cross_scale_mae_torch.cli.pretrain import build_run
    from cross_scale_mae_torch.cli.pretrain import main as pretrain_main
    from cross_scale_mae_torch.parallel import dist

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    fwd = bwd = 0
    with tempfile.TemporaryDirectory() as tmp:
        def argv(name, *flags):
            return _train_argv(os.path.join(tmp, name), "pallas_v3", "--max_steps",
                               str(MESH_STEPS), *flags)

        # The one-card plain run, no group: the reference.
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        ref = pretrain_main(argv("plain"))
        ref_peak = torch.cuda.max_memory_allocated()
        _check_run(ref, MESH_STEPS, "mesh plain")
        if world == 1:
            address = f"localhost:{_free_port()}"
            group = ("--coordinator_address", address, "--num_processes", "1",
                     "--process_id", "0")
            dist.initialize_distributed(address, 1, 0, "cuda")
            try:
                for name, flags in MESH_LAYOUTS.items():
                    _reset_counts()
                    torch.cuda.reset_peak_memory_stats()
                    res = pretrain_main(argv(name, *group, *flags))
                    counts = _counts()
                    peak = torch.cuda.max_memory_allocated()
                    _check_run(res, MESH_STEPS, f"mesh {name}")
                    _check_counts(counts, ATTN_PER_STEP * MESH_STEPS, ATTN_PER_STEP * MESH_STEPS,
                                  f"mesh {name}")
                    fwd, bwd = fwd + counts["mha3_fwd"], bwd + counts["mha3_bwd"]
                    gap = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], ref["losses"]))
                    params_gap = _npz_gap(res["npz"], ref["npz"])
                    check(gap <= MESH_LOSS_RTOL, f"mesh {name}: losses {res['losses']} against "
                          f"the plain run's {ref['losses']}")
                    check(params_gap <= MESH_PARAMS_ATOL,
                          f"mesh {name}: params {params_gap} from the plain run's")
                    run = build_run(argv(name + "_bytes", *group, *flags))
                    opt = _opt_bytes(run.state)
                    del run
                    log("mesh", card=json.dumps(card), layout=name, world_size=1,
                        flags=json.dumps(flags), steps=res["steps"],
                        loss_rel_gap_to_plain=gap, params_gap_to_plain=params_gap,
                        ms_per_step=res["steady_ms_per_step"],
                        plain_ms_per_step=ref["steady_ms_per_step"],
                        peak_mib=peak / 2**20, plain_peak_mib=ref_peak / 2**20,
                        optimizer_state_bytes=opt, launches=json.dumps(counts))
                    torch.cuda.empty_cache()
            finally:
                dist.shutdown()
        else:
            layouts, refs = dict(MESH_LAYOUTS), dict.fromkeys(MESH_LAYOUTS, ref)
            if world % 2 == 0:
                layouts.update(MESH_MODEL_LAYOUTS)
                refs.update(dict.fromkeys(MESH_MODEL_LAYOUTS, ref))
                layouts.update(MESH_VARIANT_LAYOUTS)
                for name, flags in MESH_VARIANT_LAYOUTS.items():
                    # The one-card run of the variant, no group: its reference.
                    refs[name] = pretrain_main(_train_argv(
                        os.path.join(tmp, "plain_" + name), flags[-1], "--max_steps",
                        str(MESH_STEPS)))
                    _check_run(refs[name], MESH_STEPS, f"mesh plain {flags[-1]}")
            for name, r in _mesh_worker_runs(tmp, world, layouts).items():
                res, done = r["result"], r["done"]
                n = res["steps"]
                want = 0 if name in MESH_VARIANT_LAYOUTS else ATTN_PER_STEP * n
                check(done["fwd"] == done["bwd"] == want,
                      f"mesh {name}: rank 0's K1 launches {done}, expected {want}")
                fwd, bwd = fwd + done["fwd"], bwd + done["bwd"]
                plain = refs[name]["losses"]
                gap = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], plain))
                log("mesh", card=json.dumps(card), layout=name, world_size=world,
                    loss_rel_gap_to_one_card=gap, tol=MESH_TP_LOSS_RTOL,
                    losses=json.dumps(res["losses"]), plain_losses=json.dumps(plain),
                    ms_per_step=res["steady_ms_per_step"],
                    plain_ms_per_step=refs[name]["steady_ms_per_step"])
                check(len(res["losses"]) == MESH_STEPS and gap <= MESH_TP_LOSS_RTOL,
                      f"mesh {name} at {world} cards: losses {res['losses']} against the "
                      f"one-card run's {plain}")
            if world % 2 == 0:
                # The controls compare a fault with the sound run: not counted.
                faults = {name: code for name, (_, _, code) in MESH_CONTROLS.items()}
                runs = _mesh_worker_runs(tmp, world, {name: layouts[layout] for name, (
                    _, layout, _) in MESH_CONTROLS.items()}, faults)
                for name, r in runs.items():
                    gated, layout, _ = MESH_CONTROLS[name]
                    losses = r["result"]["losses"]
                    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, refs[layout]["losses"]))
                    log("mesh_control", card=json.dumps(card), control=name, layout=layout,
                        world_size=world, loss_rel_gap_to_one_card=gap,
                        tol=MESH_TP_LOSS_RTOL, gated=gated, losses=json.dumps(losses))
                    check(not gated or gap > MESH_TP_LOSS_RTOL,
                          f"mesh control {name} at {world} cards passed the gate: {gap}")
    log("mesh_time", card=json.dumps(card), seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return fwd, bwd


def phase_tp_partition(card: str) -> None:
    """[tp_partition]: the flagship's first encoder and decoder blocks
    split into tp = 2 head groups by the layout rules
    (``parallel/mesh.leaf_specs``/``local_part``: each group qkv's columns
    of its heads in q, k and v, and its proj rows), each group run through
    K1f and K1b on the card, the proj and fc2 partials summed and their
    biases added once; held against the unsplit block, forward and the
    input's gradient. The decoder block also with Nystrom and orthoformer
    (65 tokens: both approximate), each head group through the variant.
    These launches compare a kernel path with its plain whole and are not
    counted. Fourier mixing has no row: its head groups gather every
    rank's q (``collectives.gather_heads``), which needs a model group of
    two ranks, and NCCL puts no two ranks on one card; [mesh]'s multi-card
    branch runs it."""
    from cross_scale_mae_torch.configs import get_mae_config
    from cross_scale_mae_torch.models import layers
    from cross_scale_mae_torch.models.mae import mae_init
    from cross_scale_mae_torch.parallel.mesh import Layout, leaf_specs, local_part
    from cross_scale_mae_torch.train.state import tree_items, tree_like

    t0 = time.perf_counter()
    cfg = get_mae_config("mae_vit_base_MsLdCeCd", input_size=128, patch_size=16)
    params, _ = mae_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    readings = {}
    for stack, heads, tokens, impl, control in (
            ("encoder_blocks", cfg.encoder_num_heads, 17, "pallas_v3", False),
            ("decoder_blocks", cfg.decoder_num_heads, 65, "pallas_v3", False),
            ("decoder_blocks", cfg.decoder_num_heads, 65, "pallas_v3", True),
            ("decoder_blocks", cfg.decoder_num_heads, 65, "nystrom", False),
            ("decoder_blocks", cfg.decoder_num_heads, 65, "orthoformer", False)):
        whole = params[stack][0]
        specs = leaf_specs({"blocks": [whole]}, Layout(1, 2))
        if control:
            # The control: a contiguous slice of the 3D qkv columns (the JAX
            # split), which hands rank 0 all of q and half of k.
            specs = [s if s is None else dataclasses.replace(s, qkv=False) for s in specs]
        groups = []
        for m in range(2):
            leaves = [local_part(leaf.detach(), spec, 0, m, 1, 2)
                      for (_, leaf), spec in zip(tree_items(whole), specs)]
            part = tree_like(whole, leaves)
            for sub in (part["attn"]["proj"], part["mlp"]["fc2"]):
                sub["bias"] = torch.zeros_like(sub["bias"])   # added once, after the sum
            groups.append(part)
        d = whole["norm1"]["scale"].shape[0]
        x0 = torch.randn(2 * TRAIN_BATCH, tokens, d, device="cuda", generator=gen).bfloat16()
        do = torch.randn(x0.shape, device="cuda", generator=gen).bfloat16()

        def split_block(x):
            h = layers.layer_norm(whole["norm1"], x)
            attn = sum(layers.attention(g["attn"], h, heads, impl) for g in groups)
            x = x + attn + whole["attn"]["proj"]["bias"].to(x.dtype)
            h = layers.layer_norm(whole["norm2"], x)
            mlp = sum(layers.mlp(g["mlp"], h, cfg.gelu, split=True) for g in groups)
            return x + mlp + whole["mlp"]["fc2"]["bias"].to(x.dtype)

        outs = {}
        for name, fn in (("split", split_block),
                         ("whole", lambda x: layers.block(whole, x, heads, impl,
                                                          gelu=cfg.gelu))):
            x = x0.clone().requires_grad_(True)
            y = fn(x)
            (dx,) = torch.autograd.grad(y, x, do)
            outs[name] = (y.detach().float(), dx.float())
        y_gap = float((outs["split"][0] - outs["whole"][0]).norm() / outs["whole"][0].norm())
        dx_gap = float((outs["split"][1] - outs["whole"][1]).norm() / outs["whole"][1].norm())
        key = (stack + ("" if impl == "pallas_v3" else "_" + impl)
               + ("_contiguous_control" if control else ""))
        readings[key] = {"out_rel_l2": y_gap, "dx_rel_l2": dx_gap,
                         "group_qkv": list(groups[0]["attn"]["qkv"]["kernel"].shape)}
        if control:
            check(y_gap > 8 * TP_PARTITION_TOL, f"tp_partition: the control passed {readings}")
        else:
            check(y_gap <= TP_PARTITION_TOL and dx_gap <= TP_PARTITION_TOL,
                  f"tp_partition {stack}: head groups against the whole block {readings[key]}")
    log("tp_partition", card=json.dumps(card), tol=TP_PARTITION_TOL,
        readings=json.dumps(readings), seconds=time.perf_counter() - t0,
        fourier_mix="absent: its head groups gather every rank's q, which needs a model "
                    "group of two ranks, and NCCL puts no two ranks on one card")
    del params
    torch.cuda.empty_cache()


def phase_finetune_fsdp(card: str) -> tuple[int, int]:
    """ViT-L finetuning through cli/finetune.main with --fsdp for a few
    steps and its eval (K2f/K2b 24 + 24 a step, 24 per eval batch); the
    per-rank step time and peak memory. Returns its K2 launches."""
    from cross_scale_mae_torch.cli.finetune import main as finetune_main

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res = finetune_main(_ft_argv(tmp, "pallas", FSDP_FT_STEPS * FT_BATCH, FSDP_FT_STEPS,
                                     "--fsdp"))
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
    _check_run(res, FSDP_FT_STEPS, "finetune --fsdp")
    evals = res["eval_batches"]
    want = FT_ATTN * (FSDP_FT_STEPS + evals)
    check(counts["mha_fwd"] == want and counts["mha_bwd"] == FT_ATTN * FSDP_FT_STEPS,
          f"finetune --fsdp: K2 launches {counts}, expected {want} and "
          f"{FT_ATTN * FSDP_FT_STEPS}")
    check(counts["mha3_fwd"] == counts["mha3_bwd"] == 0, f"finetune --fsdp: K1 ran {counts}")
    log("finetune_fsdp", card=json.dumps(card), steps=res["steps"], eval_batches=evals,
        losses=json.dumps(res["losses"]), peak_mib=peak / 2**20,
        launches=json.dumps(counts), seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return counts["mha_fwd"], counts["mha_bwd"]


def eval_phases(card: str, work: str) -> dict:
    """[ssim], [pretrain_ssim], [perceptual] and [evalviz], each path with
    the counts set to 0 just before it. Returns {path: (K1f, K1b)}."""
    from cross_scale_mae_torch.cli.launch import find_latest_checkpoints

    phase_ssim(card)
    ckpt_run = os.path.join(work, "ssim")
    paths = {"train_ssim": phase_pretrain_ssim(card, ckpt_run),
             "perceptual": phase_perceptual(card)}
    paths.update(phase_evalviz(card, find_latest_checkpoints(ckpt_run)))
    shutil.rmtree(ckpt_run)
    return paths


def serving_phases(card: str, work: str, pretrain_npz: str, ft_npz: str, lp_ckpt: str) -> dict:
    """The serving and export paths: [serve_classifier], [quantize],
    [export], [embed] and [data_parallel], each with the counts set to 0
    just before its own calls. Returns {kernel: {path: launches}}."""
    enc = write_serving_npz(os.path.join(work, "serving.npz"))
    served = phase_serve_classifier(card, ft_npz, lp_ckpt)
    quantized = phase_quantize(card, enc, ft_npz)
    phase_export(card, enc, ft_npz, work)
    return {"mha_fwd": {"serve_classifier": served["mha_fwd"],
                        "quantize": quantized["mha_fwd"]},
            "mha3_fwd": {"serve_classifier": served["mha3_fwd"],
                         "quantize": quantized["mha3_fwd"],
                         "embed": phase_embed(card, pretrain_npz),
                         "data_parallel": phase_data_parallel(card, enc)}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    rows = phase_kernel(card)
    phase_orbax(card)
    # Each path is driven with the counts set to 0 just before it and read
    # just after it: serving (forward only), pretraining, finetuning, the
    # finetuning recipe, pretraining with bf16 moments, the SSIM losses, the
    # perceptual loss, evalviz and --plot_recon, the attention variants (no
    # kernel may launch), the profiled and logged flagship step, linear probing from
    # the pretraining's weights, the classifiers served, int8 serving,
    # embedding and data-parallel serving, temporal pretraining on pairs and
    # multi-band finetuning through the loader, then pretraining through a
    # fault and a relaunch (each process counts from 0).
    served = phase_serving(card)
    with tempfile.TemporaryDirectory() as work:
        npz = os.path.join(work, "pretrain.npz")
        ft_npz = os.path.join(work, "finetune.npz")
        lp_ckpt = os.path.join(work, "linprobe_checkpoints")
        train_fwd, train_bwd = phase_train(card, npz)
        phase_train_grads_fp64(card)
        phase_tp_partition(card)
        ddp_fwd, ddp_bwd = phase_ddp(card)
        mesh_fwd, mesh_bwd = phase_mesh(card)
        ft_fwd, ft_bwd = phase_finetune(card, ft_npz)
        fsdp_ft_fwd, fsdp_ft_bwd = phase_finetune_fsdp(card)
        phase_finetune_grads_fp64(card)
        recipe_fwd, recipe_bwd = phase_finetune_recipe(card)
        moment_fwd, moment_bwd = phase_moments(card)
        eval_paths = eval_phases(card, work)
        variant_counts = phase_variants(card)
        obs_fwd, obs_bwd = phase_observability(card)
        lp_fwd = phase_linprobe(card, npz, lp_ckpt)
        new_paths = serving_phases(card, work, npz, ft_npz, lp_ckpt)
    phase_native(card)
    temporal_fwd, temporal_bwd = phase_temporal(card)
    sn_fwd, sn_bwd = phase_sentinel(card)
    (resume_fwd, resume_bwd), (orbax_fwd, orbax_bwd) = phase_resume(card)
    by_path = {"mha3_fwd": {"serving": served, "train": train_fwd, "train_ddp": ddp_fwd,
                            "train_mesh": mesh_fwd,
                            "train_resume": resume_fwd,
                            "train_resume_orbax": orbax_fwd, "linprobe": lp_fwd,
                            "train_temporal": temporal_fwd, "moments": moment_fwd,
                            **new_paths["mha3_fwd"],
                            **{k: v[0] for k, v in eval_paths.items()},
                            "observability": obs_fwd},
               "mha3_bwd": {"serving": 0, "train": train_bwd, "train_ddp": ddp_bwd,
                            "train_mesh": mesh_bwd,
                            "train_resume": resume_bwd,
                            "train_resume_orbax": orbax_bwd, "linprobe": 0,
                            "train_temporal": temporal_bwd, "moments": moment_bwd,
                            **{k: 0 for k in new_paths["mha3_fwd"]},
                            **{k: v[1] for k, v in eval_paths.items()},
                            "observability": obs_bwd},
               "mha_fwd": {"finetune": ft_fwd, "finetune_fsdp": fsdp_ft_fwd,
                           "finetune_sentinel": sn_fwd,
                           "finetune_recipe": recipe_fwd, **new_paths["mha_fwd"]},
               "mha_bwd": {"finetune": ft_bwd, "finetune_fsdp": fsdp_ft_bwd,
                           "finetune_sentinel": sn_bwd,
                           "finetune_recipe": recipe_bwd,
                           **{k: 0 for k in new_paths["mha_fwd"]}},
               "mha2_fwd": {}, "mha2_bwd": {}}
    for name, n in variant_counts.items():
        by_path[name]["variants"] = n
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
