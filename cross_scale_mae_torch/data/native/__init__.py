"""ctypes binding and on-demand build of the port's native loader core
(``loader.cpp`` beside this file, the port's own copy of the JAX package's
``data/native/loader.cpp``).

The library builds at first use with g++ into ``build/native/`` beside the
package (listed in ``.gitignore``), named by a hash of the source and the
flags, written to a temporary file and moved into place, so processes that
build at once do not read each other's half-written file. Each codec
library is optional: the build defines ``CSMAE_WITH_JPEG``, ``CSMAE_WITH_PNG``
and ``CSMAE_WITH_LIBTIFF`` for the headers g++ finds, and links those
libraries; ``codecs()`` reports what the built core holds. Uncompressed
TIFFs need no library. Without g++ the loader takes the Python path
(``data/loader.py``), as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
# The JAX package's flags; -ffp-contract=off keeps the float op order of
# SentinelNormalize equal to numpy's.
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-ffp-contract=off")
# Optional codec: (macro, header, library), and its bit in csmae_codecs().
CODECS = {"jpeg": ("CSMAE_WITH_JPEG", "jpeglib.h", "jpeg", 1),
          "png": ("CSMAE_WITH_PNG", "png.h", "png", 2),
          "libtiff": ("CSMAE_WITH_LIBTIFF", "tiffio.h", "tiff", 4)}
_EXT_CODEC = {".jpg": "jpeg", ".jpeg": "jpeg", ".png": "png"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _has_header(cxx: str, header: str) -> bool:
    """Whether ``cxx`` finds ``header`` (preprocessing only)."""
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                          input=f"#include <{header}>\n", capture_output=True, text=True,
                          timeout=60)
    return proc.returncode == 0


def build_command(cxx: str, out: str, codecs: tuple[str, ...]) -> list[str]:
    """The g++ command line that builds the core with ``codecs``."""
    return [cxx, *CXX_FLAGS, *(f"-D{CODECS[c][0]}" for c in codecs), str(SRC), "-o", out,
            *(f"-l{CODECS[c][2]}" for c in codecs)]


def library_path(codecs: tuple[str, ...]) -> Path:
    """The library's path, named by a hash of the source and the flags."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(build_command("g++", "", codecs)).encode())
    return BUILD_DIR / f"libcsmae_loader-{digest.hexdigest()[:16]}.so"


def build_library(force: bool = False, codecs: Optional[tuple[str, ...]] = None
                  ) -> Optional[str]:
    """Compile ``loader.cpp`` into ``build/native/``, with every codec whose
    header g++ finds (or exactly ``codecs``). Returns the library's path, or
    None when there is no g++ or the build fails (the failure is kept for
    the process unless ``force``)."""
    global _build_failed
    with _lock:
        if _build_failed and not force:
            return None
        cxx = shutil.which("g++")
        if cxx is None:
            _build_failed = True
            return None
        if codecs is None:
            codecs = tuple(c for c, (_, header, _, _) in CODECS.items()
                           if _has_header(cxx, header))
            # A header without its library fails the link: then the core
            # without codecs, which still reads uncompressed TIFFs.
            attempts = [codecs, ()] if codecs else [()]
        else:
            attempts = [codecs]
        for codecs in attempts:
            out = library_path(codecs)
            if out.exists() and not force:
                return str(out)
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            try:
                subprocess.run(build_command(cxx, str(tmp), codecs), check=True,
                               capture_output=True, timeout=300)
                os.replace(tmp, out)
                return str(out)
            except (OSError, subprocess.SubprocessError):
                tmp.unlink(missing_ok=True)
        _build_failed = True
        return None


def load_library(path: str) -> ctypes.CDLL:
    """``path`` loaded with every entry point's argument and result types."""
    lib = ctypes.CDLL(path)
    p_u8, p_i32, p_f32 = (ctypes.POINTER(t) for t in
                          (ctypes.c_uint8, ctypes.c_int32, ctypes.c_float))
    lib.csmae_codecs.restype = ctypes.c_int
    lib.csmae_codecs.argtypes = []
    lib.csmae_loader_create.restype = ctypes.c_void_p
    lib.csmae_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), p_i32, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.csmae_loader_start_epoch.restype = None
    lib.csmae_loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.csmae_loader_next.restype = ctypes.c_int
    lib.csmae_loader_next.argtypes = [ctypes.c_void_p, p_u8, p_i32]
    lib.csmae_loader_batches_per_epoch.restype = ctypes.c_int64
    lib.csmae_loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.csmae_loader_failed_count.restype = ctypes.c_int64
    lib.csmae_loader_failed_count.argtypes = [ctypes.c_void_p]
    lib.csmae_loader_destroy.restype = None
    lib.csmae_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.csmae_decode_jpeg.restype = ctypes.c_int
    lib.csmae_decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_int, p_u8]
    lib.csmae_loader_set_bands.restype = None
    lib.csmae_loader_set_bands.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, p_f32, p_f32, p_i32, ctypes.c_int,
        p_i32, ctypes.c_int]
    lib.csmae_tiff_info.restype = ctypes.c_int
    lib.csmae_tiff_info.argtypes = [ctypes.c_char_p, p_i32]
    lib.csmae_tiff_read_f32.restype = ctypes.c_int
    lib.csmae_tiff_read_f32.argtypes = [ctypes.c_char_p, p_f32, ctypes.c_int64]
    return lib


def get_library() -> Optional[ctypes.CDLL]:
    """The core built with every codec this host has, loaded once; None
    when it cannot be built."""
    global _lib
    if _lib is None:
        path = build_library()
        if path is not None:
            _lib = load_library(path)
    return _lib


def codecs(lib: Optional[ctypes.CDLL] = None) -> tuple[str, ...]:
    """The optional codecs of ``lib`` (the default core): a subset of
    ('jpeg', 'png', 'libtiff'); () when there is no core."""
    lib = lib or get_library()
    if lib is None:
        return ()
    bits = lib.csmae_codecs()
    return tuple(c for c, (_, _, _, bit) in CODECS.items() if bits & bit)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_jpeg(path: str, canvas: int, lib: Optional[ctypes.CDLL] = None
                ) -> Optional[np.ndarray]:
    """A JPEG or PNG decoded to a (canvas, canvas, 3) uint8 canvas; None
    when there is no core or the decode fails."""
    lib = lib or get_library()
    if lib is None:
        return None
    out = np.empty((canvas, canvas, 3), np.uint8)
    return out if lib.csmae_decode_jpeg(path.encode(), canvas, _ptr(out, ctypes.c_uint8)) else None


def read_tiff(path: str, lib: Optional[ctypes.CDLL] = None) -> Optional[np.ndarray]:
    """Raw multi-band TIFF read -> float32 HWC (the rasterio ``read()``
    equivalent: uint/int 8/16/32 or float32 samples, chunky or planar,
    striped or tiled, classic or BigTIFF; compressed files need libtiff in
    the core). None when there is no core or the file is not one it reads."""
    lib = lib or get_library()
    if lib is None:
        return None
    whc = np.zeros((3,), np.int32)
    if not lib.csmae_tiff_info(path.encode(), _ptr(whc, ctypes.c_int32)):
        return None
    w, h, c = (int(v) for v in whc)
    out = np.empty((h, w, c), np.float32)
    # The size is checked again: a file replaced between the two calls is refused.
    ok = lib.csmae_tiff_read_f32(path.encode(), _ptr(out, ctypes.c_float), out.size)
    return out if ok else None


class NativeJpegLoader:
    """Epoch iterator backed by the C++ worker pool (the JAX package's
    class of the same name)."""

    def __init__(self, lib: ctypes.CDLL, handle: int, batch: int, canvas: int,
                 channels: int, keepalive):
        self._lib = lib
        self._handle = handle
        self.batch = batch
        self.canvas = canvas
        self.channels = channels
        self._keepalive = keepalive   # the path array handed to C++

    @classmethod
    def maybe_create(cls, dataset, batch_size: int, loader,
                     lib: Optional[ctypes.CDLL] = None) -> Optional["NativeJpegLoader"]:
        """The core for ``dataset``, or None where the Python path must
        serve it (JAX data/native/__init__.py:141-200): JPEG/PNG-backed RGB
        datasets whose codecs the core holds, and multi-band TIFF datasets
        that opt in with ``sentinel_norm`` and whose first file the core
        reads with the dataset's band count; never temporal pairs, whose
        samples are frame stacks."""
        if len(dataset) == 0 or getattr(dataset, "temporal", False):
            return None
        head = [p.lower() for p in dataset.paths[:64]]
        multiband = (getattr(dataset, "sentinel_norm", False)
                     and all(p.endswith((".tif", ".tiff")) for p in head))
        if not multiband:
            if dataset.in_c != 3:
                return None
            exts = {os.path.splitext(p)[1] for p in head}
            if not exts <= set(_EXT_CODEC):
                return None
        lib = lib or get_library()
        if lib is None:
            return None
        if not multiband and not {_EXT_CODEC[e] for e in exts} <= set(codecs(lib)):
            return None
        if multiband:
            # Probe the first file before claiming the dataset: a codec or a
            # band count the core does not take falls back to the Python
            # path instead of zero-filling batches.
            probe = read_tiff(dataset.paths[0], lib)
            if probe is None or probe.shape[-1] != len(dataset.mean):
                return None
        n = len(dataset)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in dataset.paths])
        labels = np.ascontiguousarray(dataset.labels, np.int32)
        handle = lib.csmae_loader_create(
            ctypes.cast(c_paths, ctypes.POINTER(ctypes.c_char_p)), _ptr(labels, ctypes.c_int32),
            n, batch_size, dataset.canvas_size, dataset.in_c, loader.num_threads, 3,
            loader.seed, loader.shard_id, loader.num_shards, int(loader.drop_last),
            int(loader.shuffle))
        if not handle:
            return None
        if multiband:
            # mask -> SentinelNormalize -> drop, the Python path's order.
            mean = np.ascontiguousarray(dataset.mean, np.float32)
            std = np.ascontiguousarray(dataset.std, np.float32)
            masked = np.ascontiguousarray(list(dataset.masked_bands or ()), np.int32)
            dropped = np.ascontiguousarray(list(dataset.dropped_bands or ()), np.int32)
            lib.csmae_loader_set_bands(
                handle, len(mean), 1, _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float),
                _ptr(masked, ctypes.c_int32), len(masked), _ptr(dropped, ctypes.c_int32),
                len(dropped))
        return cls(lib, handle, batch_size, dataset.canvas_size, dataset.in_c, c_paths)

    def epoch(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yields (imgs uint8 (B, S, S, C), labels int32 (B,)). A failed
        decode is zero-filled with a warning; when half the epoch or more
        failed, RuntimeError after the epoch."""
        # Read before the workers start: the count is cumulative, and on a
        # small dataset they can finish every decode before a later read.
        failed_before = self._lib.csmae_loader_failed_count(self._handle)
        self._lib.csmae_loader_start_epoch(self._handle, epoch)
        served = 0
        while True:
            imgs = np.empty((self.batch, self.canvas, self.canvas, self.channels), np.uint8)
            labels = np.empty((self.batch,), np.int32)
            got = self._lib.csmae_loader_next(self._handle, _ptr(imgs, ctypes.c_uint8),
                                              _ptr(labels, ctypes.c_int32))
            if got == 0:
                break
            served += got
            yield imgs[:got], labels[:got]
        failed = self._lib.csmae_loader_failed_count(self._handle) - failed_before
        if failed * 2 >= max(served, 1) and failed:
            raise RuntimeError(
                f"native loader: {failed}/{served} image(s) failed to decode this epoch; "
                "the dataset is unreadable (corrupt files, an unsupported format or bad "
                "paths), so the run does not train on zero-filled batches")
        if failed:
            warnings.warn(f"native loader: {failed} image(s) failed to decode this epoch "
                          "and were zero-filled; check the dataset for corrupt or "
                          "unsupported files", stacklevel=2)

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.csmae_loader_destroy(handle)
