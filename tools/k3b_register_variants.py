#!/usr/bin/env python3
"""K3b's tensor-core kernel built under other register limits, on one GPU.

    python3 tools/k3b_register_variants.py

Each variant is ``csrc/mha2_bwd.cu`` with its launch bounds and its
``kOneAcc`` choice (pass B with one accumulator, ``csrc/mha_tc.cuh``)
replaced, compiled by nvcc into a directory under ``build/``. For each it
prints one ``ptxas`` line (registers and spill bytes of every tensor-core
instantiation) and one ``row`` line per shape: the bf16 kernel held to
chip_smoke.py's K3b gates (one bf16 ulp and the mean gate against its plain
version, K1's order the control; a second launch; bf16 equal to fp32
rounded; each fp32 output within 2**-17 of float64), whether its bits equal
the committed build's, and its ms (two timings of 30 launches, inputs
cycled through more than the L2). The committed source is the first
variant. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from cross_scale_mae_torch.ops import attention as A  # noqa: E402
from cross_scale_mae_torch.ops import cuda_build  # noqa: E402

BOUNDS = "__launch_bounds__(tc::kTcMaxThreads, 1)"
ONE_ACC = "/*kOneAcc=*/kSingle && HD >= 64>"
# name: (the kernel's register attribute, its kOneAcc argument)
VARIANTS = {
    "committed: one block an SM, kOneAcc at HD >= 64": (BOUNDS, ONE_ACC),
    "128 registers (K1b's cap) up to HD 64, kOneAcc at HD 64": (
        "__launch_bounds__(tc::kTcMaxThreads, kSingle && HD <= 64 ? 2 : 1)",
        "/*kOneAcc=*/kSingle && HD == 64>"),
    "K2b's bounds, no kOneAcc": ("__launch_bounds__(tc::kTcMaxThreads)", "/*kOneAcc=*/false>"),
    "one block an SM, no kOneAcc": (BOUNDS, "/*kOneAcc=*/false>"),
    "136 registers one-sweep, kOneAcc at HD >= 64": ("__maxnreg__(kSingle ? 136 : 255)",
                                                     ONE_ACC),
    "168 registers one-sweep, no kOneAcc": ("__maxnreg__(kSingle ? 168 : 255)",
                                           "/*kOneAcc=*/false>"),
}
# (N, L, H, hd): chip_smoke's K3 shapes, a one-sweep shape at hd 80 and the
# encoder's.
SHAPES = {**cs.K3_SHAPES, "hd80_one_sweep": (256, 65, 16, 80), "encoder": (768, 17, 12, 64)}


def build(root: Path) -> dict:
    """Compiles every variant at once; returns {name: loaded library}."""
    src = (cuda_build.CSRC / "mha2_bwd.cu").read_text()
    if BOUNDS not in src or ONE_ACC not in src:
        raise SystemExit("csrc/mha2_bwd.cu no longer has the committed bounds and kOneAcc")
    procs = {}
    for i, (name, (bounds, one_acc)) in enumerate(VARIANTS.items()):
        d = root / str(i)
        d.mkdir(parents=True, exist_ok=True)
        for header in cuda_build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / "mha2_bwd.cu").write_text(src.replace(BOUNDS, bounds).replace(ONE_ACC, one_acc))
        procs[name] = (d / "lib.so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "mha2_bwd.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        props = {cs.tc_label(k): v for k, v in cs.ptxas_spills(out).items()
                 if cs.tc_instance(k)}
        print("ptxas", json.dumps({"variant": name, "spills_registers": props}), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k3b_register_variants: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_device()
    libs = build(cuda_build.BUILD_DIR.parent / "k3b_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (n, l, h, hd) in SHAPES.items():
        bufs = cs._buffers(gen, n * l * 4 * h * hd * 2, lambda g: (
            torch.randn(n, l, 3 * h, hd, device="cuda", generator=g).bfloat16(),
            torch.randn(n, l, h, hd, device="cuda", generator=g).bfloat16()))
        first = None
        for name, lib in libs.items():
            cuda_build._loaded["mha2_bwd"] = lib
            got, outputs, fp64 = cs.k3b_gates(label, *bufs[0], h)
            first = got if first is None else first
            print("row", json.dumps({
                "variant": name, "case": label, "shape": [n, l, h, hd], "card": card,
                "bits_equal_committed": torch.equal(first, got),
                "ms": [cs.time_ms(lambda x: A._mha2_bwd_cuda(*x, h), bufs) for _ in range(2)],
                "outputs": outputs, "fp64": fp64["kernel"]}), flush=True)
        del bufs, first
    cuda_build._loaded.pop("mha2_bwd")
    return 0


if __name__ == "__main__":
    sys.exit(main())
