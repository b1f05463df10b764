"""The JAX package's Orbax checkpoints, read and written in numpy and libzstd,
with no JAX, orbax or tensorstore (counterpart of the on-disk format of
``cross_scale_mae_tpu/utils/checkpoint.py``'s ``save_checkpoint`` and
``restore_arrays_host``).

A step directory ``<ckpt_dir>/<step>/`` of the JAX package holds
``_CHECKPOINT_METADATA`` (written last: a step without it is unfinished) and
``default/``:

* ``_METADATA``: JSON; ``tree_metadata`` maps each leaf to its
  ``key_metadata`` (the tree path; ``key_type`` 2 a dict key, 1 a sequence
  index) and ``value_metadata`` (``value_type`` "jax.Array", or "None" for
  an empty node: optax's ``EmptyState``, a frozen leaf's ``MaskedNode``).
  ``use_ocdbt`` true and ``use_zarr3`` false are the only layout read.
* an OCDBT database (tensorstore's "OCDBT storage format",
  google.github.io/tensorstore/kvstore/ocdbt) whose keys are zarr v2 arrays
  named by the '.'-joined tree path: ``<name>/.zarray`` (JSON metadata) and
  one zstd-compressed chunk per grid cell, ``<name>/0.1`` (C order; a
  0-d array's one chunk is ``<name>/0``). A run on an FSDP mesh writes one
  chunk per shard.

OCDBT on disk: ``manifest.ocdbt`` and every B+tree node are an envelope,
magic (u32 big-endian; 0x0cdb3a2a a manifest, 0x0cdb20de a node), length
(u64 little-endian, the whole envelope), format version (varint 0),
compression (varint; 1 is one zstd frame), the body, and a crc32c (u32
little-endian) of all that precedes it. Bodies are column-major: a count,
then each field for every entry. A manifest body is its config (uuid,
manifest kind 0, max inline value bytes, max decoded node bytes, version
tree arity, compression and, for zstd, its level as i32), a data-file
table, the newest versions (generation, root height, root node's file,
offset and length, key count, tree bytes, indirect value bytes, commit
time as u64) and references to older version-tree nodes (generation,
file, offset, length, generation count, commit time, height), which a
restore never needs. A node body is its height, a data-file table, and its
entries: keys prefix-compressed against the entry before; a leaf's values
inline or in a data file (file, offset; the length is the value length);
an interior node's children (the part of the key shared by the whole
subtree, file, offset, length, and three statistics). A data-file table
lists paths, prefix-compressed, each split into a base path and a relative
one; they resolve against the database's directory, so a root node may
point into every process's ``ocdbt.process_<i>/d/`` files. Values carry no
checksum; zstd frames are decoded through ``ctypes`` on the system's
``libzstd.so.1``.

:func:`read_step` returns what the JAX package's ``restore_arrays_host``
does for one step, container for container (dicts, lists for sequences,
None for empty nodes), numpy leaves of the stored dtype and bfloat16 leaves
as torch bfloat16, bit for bit (numpy has no bfloat16).
Anything else is refused by name, with the file and the check:
:class:`OrbaxFormatError`.

:func:`write_step` writes such a step from a tree in the JAX layout, as one
process would (one data file of values and one leaf node, zarr chunks
under zstd level 1), so that the JAX package's ``restore_checkpoint`` and
``restore_arrays_host`` open it. Which step a checkpoint directory offers,
and how a ``TrainState`` maps to the tree, is ``utils/checkpoint.py``'s
business; this module reads and writes trees only.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import json
import math
import os
import struct
import threading
import time
import uuid
from typing import Any, Iterator, Optional

import numpy as np
import torch

ZSTD_LIBRARY = "libzstd.so.1"
MANIFEST = "manifest.ocdbt"
TREE_METADATA = "_METADATA"
STEP_METADATA = "_CHECKPOINT_METADATA"
ITEM = "default"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_FCS_UNKNOWN, _FCS_ERROR = 2 ** 64 - 1, 2 ** 64 - 2
_MANIFEST_MAX_BYTES = 1 << 24
# The OCDBT config the JAX package's Orbax writes (its manifests' values).
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
CHUNK_ZSTD_LEVEL = 1
# Threads that read and decode, or compress, the arrays of one step.
_THREADS = 8
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


class OrbaxFormatError(ValueError):
    """A checkpoint this module does not read: the message names the file
    and the check that failed."""


# ---------------------------------------------------------------- zstd and crc32c

_lib: Optional[ctypes.CDLL] = None


def _zstd(where: str) -> ctypes.CDLL:
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(ZSTD_LIBRARY)
        except OSError as e:
            raise OrbaxFormatError(
                f"{where}: zstd: {ZSTD_LIBRARY} could not be loaded ({e}); Orbax "
                "checkpoints are zstd-compressed (Debian/Ubuntu: libzstd1)") from None
        size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_getFrameContentSize.argtypes = [ptr, size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_decompress.argtypes = [ptr, size_t, ptr, size_t]
        lib.ZSTD_decompress.restype = size_t
        lib.ZSTD_compress.argtypes = [ptr, size_t, ptr, size_t, ctypes.c_int]
        lib.ZSTD_compress.restype = size_t
        lib.ZSTD_compressBound.argtypes = [size_t]
        lib.ZSTD_compressBound.restype = size_t
        lib.ZSTD_isError.argtypes = [size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _checked(lib: ctypes.CDLL, code: int, where: str) -> int:
    if lib.ZSTD_isError(code):
        raise OrbaxFormatError(f"{where}: zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def zstd_decompress(data: bytes, where: str, size: Optional[int] = None,
                    limit: int = _MANIFEST_MAX_BYTES) -> np.ndarray:
    """The content of the zstd frame ``data`` as uint8. ``size`` is the
    exact content size when the caller knows it (a zarr chunk); otherwise
    the frame's header gives it, or at most ``limit`` bytes are taken."""
    lib = _zstd(where)
    src = np.frombuffer(data, np.uint8)
    declared = lib.ZSTD_getFrameContentSize(src.ctypes.data, src.size)
    if declared == _FCS_ERROR:
        raise OrbaxFormatError(f"{where}: zstd: not a zstd frame")
    if declared != _FCS_UNKNOWN and size is not None and declared != size:
        raise OrbaxFormatError(f"{where}: zstd frame holds {declared} bytes, expected {size}")
    cap = size if size is not None else declared if declared != _FCS_UNKNOWN else limit
    dst = np.empty(cap, np.uint8)
    n = _checked(lib, lib.ZSTD_decompress(dst.ctypes.data, cap, src.ctypes.data, src.size),
                 where)
    if size is not None and n != size:
        raise OrbaxFormatError(f"{where}: zstd frame holds {n} bytes, expected {size}")
    return dst if n == cap else dst[:n].copy()


def zstd_compress(data: np.ndarray, level: int, where: str = "zstd") -> bytes:
    """One zstd frame of ``data``'s bytes (a contiguous array) at ``level``."""
    lib = _zstd(where)
    src = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    dst = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
    n = _checked(lib, lib.ZSTD_compress(dst.ctypes.data, dst.size, src.ctypes.data, src.size,
                                        level), where)
    return dst[:n].tobytes()


def _crc_table() -> list[int]:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(0x82F63B78), table >> 1)
    return [int(v) for v in table]


_CRC32C = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected, as tensorstore's ``absl::crc32c``)."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------- OCDBT decoding


class _Cursor:
    """Reads a body's fields in order; running past its end is a record cut
    short, named with the file."""

    def __init__(self, buf: bytes, where: str):
        self.buf, self.pos, self.where = buf, 0, where

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise OrbaxFormatError(f"{self.where}: the record ends after {len(self.buf)} "
                                   "bytes, inside a field")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(f"{self.where}: a varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.buf):
            raise OrbaxFormatError(f"{self.where}: {len(self.buf) - self.pos} bytes after "
                                   "the last field")


def _envelope(raw: bytes, where: str, magic: int, limit: int) -> bytes:
    """The body of a manifest or node envelope, after its length, crc32c,
    version and compression checks."""
    if len(raw) < 18:
        raise OrbaxFormatError(f"{where}: {len(raw)} bytes, shorter than an envelope")
    got = struct.unpack(">I", raw[:4])[0]
    if got != magic:
        raise OrbaxFormatError(f"{where}: magic {got:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", raw[4:12])[0]
    if length != len(raw):
        raise OrbaxFormatError(f"{where}: length field {length}, but {len(raw)} bytes "
                               "(truncated?)")
    want, got = struct.unpack("<I", raw[-4:])[0], crc32c(raw[:-4])
    if got != want:
        raise OrbaxFormatError(f"{where}: crc32c {got:#010x}, stored {want:#010x}")
    head = _Cursor(raw[:-4], where)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OrbaxFormatError(f"{where}: format version {version}, only 0 is read")
    body = raw[head.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise OrbaxFormatError(f"{where}: compression {compression}, only 0 (none) and "
                               "1 (zstd) are read")
    return zstd_decompress(body, where, limit=limit).tobytes()


def _keys(c: _Cursor, n: int, extra_columns: int = 0) -> tuple[list[bytes], list[list[int]]]:
    """``n`` prefix-compressed keys, with the per-entry varint columns that
    sit between the key lengths and the key bytes."""
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    columns = [c.varints(n) for _ in range(extra_columns)]
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OrbaxFormatError(f"{c.where}: key prefix {p} longer than the key before")
        prev = prev[:p] + c.raw(s)
        keys.append(prev)
    return keys, columns


def _data_files(c: _Cursor, root: str) -> list[str]:
    """A data-file table: paths prefix-compressed as keys are, each with
    the length of its base path, resolved against ``root``."""
    paths, (base,) = _keys(c, c.varint(), extra_columns=1)
    out = []
    for path, n in zip(paths, base):
        rel = path.decode()
        if n > len(path) or os.path.isabs(rel) or ".." in rel.split("/"):
            raise OrbaxFormatError(f"{c.where}: data file {rel!r} (base path of {n} bytes) "
                                   "lies outside the database")
        out.append(os.path.join(root, rel))
    return out


class _Files:
    """Byte ranges of the database's files, each file opened once (from
    any thread)."""

    def __init__(self):
        self.fds: dict[str, int] = {}
        self.lock = threading.Lock()

    def read(self, path: str, offset: int, length: int) -> bytes:
        with self.lock:
            fd = self.fds.get(path)
            if fd is None:
                try:
                    fd = self.fds[path] = os.open(path, os.O_RDONLY)
                except FileNotFoundError:
                    raise OrbaxFormatError(f"{path}: data file missing") from None
        out = os.pread(fd, length, offset)
        if len(out) != length:
            raise OrbaxFormatError(
                f"{path}: truncated data file: {os.fstat(fd).st_size} bytes, a record "
                f"needs {offset + length}")
        return out

    def close(self) -> None:
        for fd in self.fds.values():
            os.close(fd)
        self.fds.clear()


Value = bytes | tuple[str, int, int]   # inline bytes, or (file, offset, length)


class OcdbtReader:
    """The newest version of the OCDBT database in ``root``: its keys and
    their values (:meth:`get`)."""

    def __init__(self, root: str):
        self.root, self.files = root, _Files()
        path = os.path.join(root, MANIFEST)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            raise OrbaxFormatError(f"{path}: missing (not an OCDBT checkpoint)") from None
        c = _Cursor(_envelope(raw, path, MANIFEST_MAGIC, _MANIFEST_MAX_BYTES), path)
        c.raw(16)   # uuid
        kind = c.varint()
        if kind != 0:
            raise OrbaxFormatError(f"{path}: manifest kind {kind}; only 0 (single) is read")
        c.varint()  # max inline value bytes
        self.max_node_bytes = c.varint()
        c.byte()    # version tree arity log2
        if c.varint() == 1:
            c.raw(4)    # zstd level, i32
        files = _data_files(c, root)
        n = c.varint()
        if n == 0:
            raise OrbaxFormatError(f"{path}: the manifest lists no version")
        columns = {name: c.varints(n) if name != "height" else [c.byte() for _ in range(n)]
                   for name in ("generation", "height", "file", "offset", "length",
                                "num_keys", "tree_bytes", "indirect_bytes")}
        c.raw(8 * n)   # commit times
        # Older version-tree nodes: generation, file, offset, length,
        # generation count, commit time and height; no restore reads them.
        older = c.varint()
        for _ in range(5):
            c.varints(older)
        c.raw(9 * older)
        c.end()
        last = int(np.argmax(columns["generation"]))
        num_keys = columns["num_keys"][last]
        self.entries: dict[bytes, Value] = {}
        if columns["length"][last]:
            fid = columns["file"][last]
            if fid >= len(files):
                raise OrbaxFormatError(f"{path}: root node in data file {fid} of {len(files)}")
            self._node(files[fid], columns["offset"][last], columns["length"][last],
                       columns["height"][last], b"")
        if len(self.entries) != num_keys:
            raise OrbaxFormatError(f"{path}: the manifest counts {num_keys} keys, the "
                                   f"tree holds {len(self.entries)}")

    def _node(self, path: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        where = f"{path} (node at {offset}, {length} bytes)"
        c = _Cursor(_envelope(self.files.read(path, offset, length), where, NODE_MAGIC,
                              self.max_node_bytes), where)
        if c.byte() != height:
            raise OrbaxFormatError(f"{where}: height {c.buf[0]}, the parent says {height}")
        files = _data_files(c, self.root)
        n = c.varint()

        def file_of(i: int) -> str:
            if i >= len(files):
                raise OrbaxFormatError(f"{where}: data file {i} of {len(files)}")
            return files[i]

        if height == 0:
            keys, _ = _keys(c, n)
            lengths, kinds = c.varints(n), c.varints(n)
            if any(k > 1 for k in kinds):
                raise OrbaxFormatError(f"{where}: value kind {max(kinds)}, only 0 (inline) "
                                       "and 1 (indirect) are read")
            indirect = sum(kinds)
            fids, offsets = c.varints(indirect), c.varints(indirect)
            refs = iter(zip(fids, offsets))
            for key, size, kind in zip(keys, lengths, kinds):
                if kind:
                    fid, off = next(refs)
                    self.entries[prefix + key] = (file_of(fid), off, size)
                else:
                    self.entries[prefix + key] = c.raw(size)
            c.end()
            return
        keys, (shared,) = _keys(c, n, extra_columns=1)
        fids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        for _ in range(3):   # key count, tree bytes, indirect value bytes
            c.varints(n)
        c.end()
        for key, common, fid, off, size in zip(keys, shared, fids, offsets, lengths):
            self._node(file_of(fid), off, size, height - 1, prefix + key[:common])

    def get(self, key: str) -> Optional[bytes]:
        """The value of ``key``, or None when the database lacks it."""
        value = self.entries.get(key.encode())
        if value is None or isinstance(value, bytes):
            return value
        return self.files.read(*value)

    def where(self, key: str) -> str:
        value = self.entries.get(key.encode())
        path = value[0] if isinstance(value, tuple) else os.path.join(self.root, MANIFEST)
        return f"{path} (key {key!r})"

    def close(self) -> None:
        self.files.close()


# ---------------------------------------------------------------- zarr v2 arrays

BF16 = "bfloat16"


def _numpy_dtype(name: str, where: str) -> np.dtype:
    if name == BF16:
        return np.dtype("<u2")
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise OrbaxFormatError(f"{where}: unknown dtype {name!r}") from None
    if dtype.byteorder == ">":
        raise OrbaxFormatError(f"{where}: big-endian dtype {name!r}")
    if dtype.kind not in "biuf":
        raise OrbaxFormatError(f"{where}: unknown dtype {name!r}")
    return dtype


def _zarray(db: OcdbtReader, name: str) -> dict:
    key = f"{name}/.zarray"
    raw = db.get(key)
    where = db.where(key)
    if raw is None:
        raise OrbaxFormatError(f"{os.path.join(db.root, MANIFEST)}: no key {key!r} (the "
                               "array's zarr metadata)")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{where}: zarr_format {meta.get('zarr_format')}, only 2")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{where}: filters {meta['filters']}; none are read")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{where}: order {meta['order']!r}, only C")
    if meta.get("dimension_separator", ".") != ".":
        raise OrbaxFormatError(f"{where}: dimension_separator "
                               f"{meta['dimension_separator']!r}, only '.'")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{where}: compressor {comp}; only zstd and none are read")
    if len(meta["shape"]) != len(meta["chunks"]):
        raise OrbaxFormatError(f"{where}: shape {meta['shape']} and chunks {meta['chunks']}")
    return meta


def _read_array(db: OcdbtReader, name: str):
    meta = _zarray(db, name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype = _numpy_dtype(meta["dtype"], db.where(f"{name}/.zarray"))
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    nbytes = math.prod(chunks) * dtype.itemsize
    out = None
    for cell in np.ndindex(*grid):
        key = f"{name}/" + (".".join(map(str, cell)) if cell else "0")
        raw = db.get(key)
        if raw is None:
            raise OrbaxFormatError(f"{os.path.join(db.root, MANIFEST)}: missing chunk "
                                   f"{key!r} of a {list(shape)} array in chunks "
                                   f"{list(chunks)}")
        data = (zstd_decompress(raw, db.where(key), nbytes) if meta.get("compressor")
                else np.frombuffer(raw, np.uint8))
        if data.size != nbytes:
            raise OrbaxFormatError(f"{db.where(key)}: {data.size} bytes, a chunk holds "
                                   f"{nbytes}")
        block = data.view(dtype).reshape(chunks)
        if cell == tuple(0 for _ in grid) and chunks == shape:
            out = block
            break
        if out is None:
            out = np.empty(shape, dtype)
        index = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(cell, chunks, shape))
        out[index] = block[tuple(slice(0, sl.stop - sl.start) for sl in index)]
    if out is None:   # an empty array: no chunk
        out = np.empty(shape, dtype)
    if meta["dtype"] == BF16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ---------------------------------------------------------------- the tree


def is_step(step_dir: str) -> bool:
    """Whether ``step_dir`` holds a finished Orbax step (Orbax writes
    ``_CHECKPOINT_METADATA`` last, and ``default/_METADATA`` before it)."""
    return (os.path.isfile(os.path.join(step_dir, STEP_METADATA))
            and os.path.isfile(os.path.join(step_dir, ITEM, TREE_METADATA)))


def _tree_metadata(item_dir: str) -> dict:
    path = os.path.join(item_dir, TREE_METADATA)
    with open(path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: use_zarr3 is true; only zarr v2 arrays are read")
    if not meta.get("use_ocdbt"):
        raise OrbaxFormatError(f"{path}: use_ocdbt is false; only the OCDBT layout (the "
                               "JAX package's) is read")
    return meta["tree_metadata"]


def _nest(pairs: list[tuple[list[dict], Any]], where: str) -> Any:
    """A tree from (key_metadata, leaf) pairs: dict keys (key_type 2) make
    dicts, sequence indices (key_type 1) lists."""
    root: dict = {}
    kinds: dict[int, int] = {}
    for keys, leaf in pairs:
        node = root
        for depth, k in enumerate(keys):
            kind = k["key_type"]
            if kinds.setdefault(id(node), kind) != kind:
                raise OrbaxFormatError(f"{where}: {k['key']!r} mixes dict keys and sequence "
                                       "indices in one node")
            key = int(k["key"]) if kind == 1 else k["key"]
            if depth == len(keys) - 1:
                node[key] = leaf
            else:
                node = node.setdefault(key, {})

    def build(node):
        if not isinstance(node, dict):
            return node
        if kinds.get(id(node)) == 1:
            if sorted(node) != list(range(len(node))):
                raise OrbaxFormatError(f"{where}: a sequence with indices {sorted(node)}")
            return [build(node[i]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}

    return build(root)


# Empty nodes: optax's EmptyState and MaskedNode are "None", an empty dict
# (a classifier's model state without the BN head) "Dict".
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}


def read_step(step_dir: str, subset: Optional[tuple] = ("params", "model_state")) -> dict:
    """The tree of the Orbax step ``step_dir``: the top-level keys in
    ``subset`` (None for all), numpy leaves of the stored dtype and bf16
    leaves as torch bf16 (the JAX package's ``restore_arrays_host`` of that
    step, bit for bit)."""
    item = os.path.join(step_dir, ITEM)
    meta_path = os.path.join(item, TREE_METADATA)
    entries = _tree_metadata(item)
    leaves = []
    for value in entries.values():
        keys, kind = value["key_metadata"], value["value_metadata"]["value_type"]
        if subset is not None and keys[0]["key"] not in subset:
            continue
        if kind not in _EMPTY and kind not in ("jax.Array", "np.ndarray"):
            raise OrbaxFormatError(f"{meta_path}: value_type {kind!r} of "
                                   f"{'.'.join(k['key'] for k in keys)}; only arrays "
                                   "and empty nodes (None, Dict, List) are read")
        leaves.append((keys, kind))
    db = OcdbtReader(item)

    def leaf(entry):
        keys, kind = entry
        if kind in _EMPTY:
            return _EMPTY[kind]()
        return _read_array(db, ".".join(k["key"] for k in keys))

    try:
        with concurrent.futures.ThreadPoolExecutor(_THREADS) as pool:
            values = list(pool.map(leaf, leaves))
    finally:
        db.close()
    return _nest([(keys, v) for (keys, _), v in zip(leaves, values)], meta_path)


# ---------------------------------------------------------------- the writer


def _varints(values) -> bytes:
    out = bytearray()
    for v in values:
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)
    return bytes(out)


def _envelope_bytes(magic: int, body: bytes) -> bytes:
    payload = _varints([0, 1]) + zstd_compress(np.frombuffer(body, np.uint8), 0)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    data = head + payload
    return data + struct.pack("<I", crc32c(data))


def _file_table(paths: list[str]) -> bytes:
    # One relative path per file, no base path and no shared prefix.
    encoded = [p.encode() for p in paths]
    return (_varints([len(encoded)]) + _varints([0] * max(len(encoded) - 1, 0))
            + _varints(len(p) for p in encoded) + _varints([0] * len(encoded))
            + b"".join(encoded))


def write_ocdbt(root: str, items: dict[str, bytes]) -> None:
    """An OCDBT database of ``items`` in ``root``, as tensorstore reads it:
    one data file (the values above the inline limit, then one leaf node)
    and the manifest of one version."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    rel = f"d/{uuid.uuid4().hex}"
    keys = sorted(k.encode() for k in items)
    values = [items[k.decode()] for k in keys]
    kinds = [int(len(v) > MAX_INLINE_VALUE_BYTES) for v in values]
    offsets, pos, indirect = [], 0, []
    for v, kind in zip(values, kinds):
        if kind:
            offsets.append(pos)
            indirect.append(v)
            pos += len(v)
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    body = (bytes([0]) + _file_table([rel]) + _varints([len(keys)]) + _varints(prefix)
            + _varints(len(k) - p for k, p in zip(keys, [0] + prefix))
            + b"".join(k[p:] for k, p in zip(keys, [0] + prefix))
            + _varints(len(v) for v in values) + _varints(kinds)
            + _varints([0] * len(offsets)) + _varints(offsets)
            + b"".join(v for v, kind in zip(values, kinds) if not kind))
    node = _envelope_bytes(NODE_MAGIC, body)
    with open(os.path.join(root, rel), "wb") as f:
        for v in indirect:
            f.write(v)
        f.write(node)
        f.flush()
        os.fsync(f.fileno())
    manifest = (uuid.uuid4().bytes + _varints([0, MAX_INLINE_VALUE_BYTES, MAX_DECODED_NODE_BYTES])
                + bytes([VERSION_TREE_ARITY_LOG2]) + _varints([1]) + struct.pack("<i", 0)
                + _file_table([rel]) + _varints([1, 1]) + bytes([0])
                + _varints([0, pos, len(node), len(keys), len(node), pos])
                + struct.pack("<Q", time.time_ns()) + _varints([0]))
    _write_bytes(os.path.join(root, MANIFEST), _envelope_bytes(MANIFEST_MAGIC, manifest))


def _write_bytes(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _leaves(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(key_metadata path, leaf) in the JAX tree's flatten order: dict keys
    sorted, sequences by index; None and an empty dict or list stay leaves
    (empty nodes)."""
    if isinstance(tree, (dict, list, tuple)) and not tree and prefix:
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*prefix, (str(k), 2)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*prefix, (str(i), 1)))
    else:
        yield prefix, tree


def _array_bytes(leaf: Any) -> tuple[str, tuple, np.ndarray]:
    """(zarr dtype, shape, contiguous array) of a numpy or torch leaf."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        if leaf.dtype == torch.bfloat16:
            return BF16, tuple(leaf.shape), leaf.view(torch.int16).numpy()
        leaf = leaf.numpy()
    arr = np.asarray(leaf)   # (np.ascontiguousarray would make a 0-d leaf 1-d)
    arr = arr if arr.flags.c_contiguous else arr.copy()
    if arr.dtype.name == BF16:   # JAX's numpy bfloat16 (ml_dtypes)
        return BF16, arr.shape, arr.view(np.uint16)
    return arr.dtype.str, arr.shape, arr


def digests(tree: Any) -> dict[str, dict]:
    """Each array leaf of a restored tree (this module's, or the JAX
    package's with its numpy bfloat16), under its '/'-joined path: its zarr
    dtype, shape, and the sha256 of its bytes in C order."""
    out = {}
    for path, leaf in _leaves(tree):
        if leaf is None or isinstance(leaf, (dict, list, tuple)):
            continue
        dtype, shape, arr = _array_bytes(leaf)
        out["/".join(k for k, _ in path)] = {
            "dtype": dtype, "shape": list(shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    return out


def write_step(step_dir: str, tree: dict) -> None:
    """Step ``step_dir`` of a checkpoint holding ``tree`` (the JAX layout:
    dicts, lists, numpy or torch leaves, None for empty nodes), in the form
    the JAX package's Orbax ``StandardSave`` writes from one process: the
    OCDBT database of zarr v2 arrays, one chunk each under zstd level 1,
    ``_METADATA``, ``array_metadatas/process_0`` and, last,
    ``_CHECKPOINT_METADATA``."""
    started = time.time_ns()
    item = os.path.join(step_dir, ITEM)
    os.makedirs(os.path.join(item, "array_metadatas"), exist_ok=True)
    tree_meta, array_meta, arrays = {}, [], []
    for path, leaf in _leaves(tree):
        names = tuple(k for k, _ in path)
        entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in path]}
        if leaf is None or isinstance(leaf, (dict, list, tuple)):
            kind = "None" if leaf is None else "Dict" if isinstance(leaf, dict) else "List"
            entry["value_metadata"] = {"value_type": kind, "skip_deserialize": True}
        else:
            dtype, shape, arr = _array_bytes(leaf)
            entry["value_metadata"] = {"value_type": "jax.Array", "skip_deserialize": False,
                                       "write_shape": list(shape)}
            array_meta.append({"array_metadata": {"param_name": ".".join(names),
                                                  "write_shape": list(shape),
                                                  "chunk_shape": list(shape),
                                                  "ext_metadata": None}})
            arrays.append((".".join(names), dtype, shape, arr))
        tree_meta[str(names)] = entry

    def encode(array) -> dict[str, bytes]:
        name, dtype, shape, arr = array
        zarray = {"chunks": list(shape), "compressor": {"id": "zstd", "level": CHUNK_ZSTD_LEVEL},
                  "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                  "filters": None, "order": "C", "shape": list(shape), "zarr_format": 2}
        chunk = ".".join("0" for _ in shape) or "0"
        return {f"{name}/.zarray": json.dumps(zarray, separators=(",", ":")).encode(),
                f"{name}/{chunk}": zstd_compress(arr, CHUNK_ZSTD_LEVEL, name)}

    items: dict[str, bytes] = {}
    with concurrent.futures.ThreadPoolExecutor(_THREADS) as pool:
        for part in pool.map(encode, arrays):
            items.update(part)
    write_ocdbt(item, items)
    _write_json(os.path.join(item, "array_metadatas", "process_0"),
                {"array_metadatas": array_meta})
    _write_json(os.path.join(item, TREE_METADATA),
                {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                 "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    _write_json(os.path.join(step_dir, STEP_METADATA),
                {"item_handlers": {ITEM: _HANDLER}, "metrics": {}, "performance_metrics": {},
                 "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
                 "custom_metadata": {}})


def _write_json(path: str, obj: Any) -> None:
    _write_bytes(path, json.dumps(obj).encode())

