"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, and loaded with ``ctypes``. Libraries go to
``build/cuda/`` beside the package (listed in ``.gitignore``), named by a hash
of the source, the shared headers and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing is compiled when a module is imported: the
first kernel launch builds its library, or ``build_libraries`` builds them
all up front, one ``nvcc`` process per source, all running together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# Every kernel of the package, by source name (csrc/<name>.cu).
KERNELS = ("mha3_fwd", "mha3_bwd", "mha_fwd", "mha_bwd", "mha2_fwd", "mha2_bwd", "adamw")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME or "
            "/usr/local/cuda): the CUDA kernels are compiled at first use")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers every
    source may include (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_libraries(names: list[str]) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns each name's compiler
    output (register, shared-memory and spill use from ``-Xptxas -v``),
    kept beside the library for one built earlier; raises with that output
    if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            kept = out.with_suffix(".log")
            logs[name] = kept.read_text() if kept.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_libraries([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
