"""The port's multi-band data (EuroSAT and fMoW-Sentinel TIFFs) and its
native decode core (cross_scale_mae_torch/data/native) held against the
JAX package on the CPU, bit for bit.

* The port's ``DataLoader`` against the JAX ``DataLoader(use_native=False)``
  on both TIFF families: masked and dropped bands, 2 shards, both
  ``drop_last`` settings, 2 epochs.
* The port's native core against the JAX package's native core on JPEG,
  PNG and multi-band TIFF datasets (the same splitmix64 epoch order, the
  same decode), a corrupt file zero-filled with a warning, a mostly
  unreadable epoch refused, and the shards' step counts.
* The port's TIFF reader, which needs no library for uncompressed files,
  against the JAX package's libtiff reader on every layout it takes (byte
  orders, BigTIFF, planar, strips, tiles, sample types); a compressed file
  goes to libtiff where the core has it and is refused where it has not.
* The tiny CLIs: finetuning and the probe on EuroSAT with
  ``--dropped_bands``, finetuning on fMoW-Sentinel.

The TIFF fixtures are written by hand (neither rasterio nor tifffile is
installed): ``_write_tiff`` is a copy of ``tests/test_data.py``'s writer,
``_write_tiff_layout`` writes the other layouts.
"""

import os
import struct
import warnings

import numpy as np
import pytest
import torch

from cross_scale_mae_tpu.data import datasets as jds
from cross_scale_mae_tpu.data import native as jnative
from cross_scale_mae_tpu.data.loader import DataLoader as JLoader
from cross_scale_mae_torch.data import datasets as pds
from cross_scale_mae_torch.data import native as pnative
from cross_scale_mae_torch.data.loader import DataLoader

TINY_VIT = ["--model", "vit_base_patch16", "--embed_dim", "32", "--depth", "2",
            "--num_heads", "4", "--input_size", "16", "--patch_size", "8",
            "--compute_dtype", "float32", "--device", "cpu"]


def _write_tiff(path, arr, tiled=False):
    """Minimal uncompressed chunky little-endian TIFF writer (HWC array of
    uint8/uint16/float32), a copy of tests/test_data.py's."""
    h, w, c = arr.shape
    if arr.dtype == np.uint8:
        bps, fmt = 8, 1
    elif arr.dtype == np.uint16:
        bps, fmt = 16, 1
    elif arr.dtype == np.float32:
        bps, fmt = 32, 3
    else:
        raise ValueError(arr.dtype)
    if tiled:
        assert arr.shape[0] % 16 == 0 and arr.shape[1] % 16 == 0
    data = np.ascontiguousarray(arr).tobytes()
    data_off = 8
    bps_arr_off = data_off + len(data)
    sf_arr_off = bps_arr_off + 2 * c
    ifd_off = sf_arr_off + 2 * c

    def entry(tag, typ, count, value):
        return struct.pack("<HHII", tag, typ, count, value)

    def short_val(tag, v):
        return struct.pack("<HHIHH", tag, 3, 1, v, 0)

    entries = [
        short_val(256, w), short_val(257, h),
        entry(258, 3, c, bps_arr_off if c > 2 else 0),
        short_val(259, 1), short_val(262, 1), short_val(277, c), short_val(284, 1),
        entry(339, 3, c, sf_arr_off if c > 2 else 0),
    ]
    if tiled:
        entries += [short_val(322, w), short_val(323, h), entry(324, 4, 1, data_off),
                    entry(325, 4, 1, len(data))]
    else:
        entries += [entry(273, 4, 1, data_off), short_val(278, h), entry(279, 4, 1, len(data))]
    entries.sort(key=lambda e: int.from_bytes(e[:2], "little"))
    if c <= 2:
        entries[2] = struct.pack("<HHIHH", 258, 3, c, bps, bps if c == 2 else 0)
        entries[10] = struct.pack("<HHIHH", 339, 3, c, fmt, fmt if c == 2 else 0)
    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, ifd_off))
        f.write(data)
        f.write(struct.pack(f"<{c}H", *([bps] * c)))
        f.write(struct.pack(f"<{c}H", *([fmt] * c)))
        f.write(struct.pack("<H", len(entries)))
        for e in entries:
            f.write(e)
        f.write(struct.pack("<I", 0))


def _write_tiff_layout(path, arr, *, order="<", bigtiff=False, planar=False,
                       rows_per_strip=None, tile=None):
    """An uncompressed TIFF of any layout: byte order ``order``, classic or
    BigTIFF, chunky or planar, strips of ``rows_per_strip`` rows or
    ``tile`` = (height, width) tiles padded at the edges."""
    h, w, c = arr.shape
    a = arr.astype(arr.dtype.newbyteorder(order))
    planes = [a[..., k:k + 1] for k in range(c)] if planar else [a]
    blocks = []
    if tile:
        th, tw = tile
        for p in planes:
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, p.shape[2]), a.dtype)
                    part = p[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    blocks.append(blk.tobytes())
    else:
        rps = rows_per_strip or h
        for p in planes:
            blocks += [np.ascontiguousarray(p[y:y + rps]).tobytes() for y in range(0, h, rps)]
    pos = 16 if bigtiff else 8
    offsets, data = [], b""
    for b in blocks:
        offsets.append(pos + len(data))
        data += b + b"\0" * (len(b) % 2)
    pos += len(data)
    off_type = 16 if bigtiff else 4
    fmt = {"u": 1, "i": 2, "f": 3}[arr.dtype.kind]
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [arr.dtype.itemsize * 8] * c),
               (259, 3, [1]), (262, 3, [1]), (277, 3, [c]), (284, 3, [2 if planar else 1]),
               (339, 3, [fmt] * c)]
    if tile:
        entries += [(322, 3, [tile[1]]), (323, 3, [tile[0]]), (324, off_type, offsets),
                    (325, off_type, [len(b) for b in blocks])]
    else:
        entries += [(273, off_type, offsets), (278, 3, [rows_per_strip or h]),
                    (279, off_type, [len(b) for b in blocks])]
    code = {3: "H", 4: "I", 16: "Q"}
    inline = 8 if bigtiff else 4
    field_code = "Q" if bigtiff else "I"
    extern, packed = b"", []
    for tag, typ, vals in sorted(entries):
        raw = struct.pack(order + code[typ] * len(vals), *vals)
        if len(raw) <= inline:
            field = raw.ljust(inline, b"\0")
        else:
            field = struct.pack(order + field_code, pos + len(extern))
            extern += raw + b"\0" * (len(raw) % 2)
        packed.append(struct.pack(order + "HH" + field_code, tag, typ, len(vals)) + field)
    ifd_off = pos + len(extern)
    mark = b"II" if order == "<" else b"MM"
    with open(path, "wb") as f:
        if bigtiff:
            f.write(struct.pack(order + "2sHHHQ", mark, 43, 8, 0, ifd_off))
        else:
            f.write(struct.pack(order + "2sHI", mark, 42, ifd_off))
        f.write(data + extern)
        f.write(struct.pack(order + ("Q" if bigtiff else "H"), len(packed)))
        f.write(b"".join(packed))
        f.write(struct.pack(order + field_code, 0))


def _eurosat(root, n=11, side=16, canvas=16):
    """A EuroSAT file list over 13-band uint16 TIFFs in three class
    directories; every third tile is off the canvas size, so the Python
    path resizes it band by band."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        d = root / ("Forest", "River", "Highway")[i % 3]
        d.mkdir(exist_ok=True)
        s = side + 3 if i % 3 == 2 else canvas
        _write_tiff(str(d / f"t{i}.tif"), rng.integers(0, 4000, (s, s, 13), np.uint16))
        paths.append(str(d / f"t{i}.tif"))
    (root / "train.txt").write_text("\n".join(paths) + "\n")
    return str(root / "train.txt")


def _sentinel(root, n=11, canvas=16, categories=None):
    """An fMoW-Sentinel CSV (category, image_path, timestamp, and a column
    the reader ignores) over 13-band uint16 TIFFs at the canvas size."""
    rng = np.random.default_rng(1)
    cats = categories or ["airport", "barn", "dam"]
    rows = ["category,image_path,timestamp,location_id"]
    for i in range(n):
        _write_tiff(str(root / f"s{i}.tif"), rng.integers(0, 6000, (canvas, canvas, 13), np.uint16))
        rows.append(f"{cats[i % len(cats)]},s{i}.tif,{2015 + i % 3}-0{1 + i % 9}-11T10:00:00Z,{i}")
    (root / "train.csv").write_text("\n".join(rows) + "\n")
    return str(root / "train.csv")


def _build(kind, root, **kw):
    path = _eurosat(root) if kind == "euro_sat" else _sentinel(root)
    args = dict(train_path=path, input_size=16, **kw)
    return jds.build_dataset(kind, True, **args), pds.build_dataset(kind, True, **args)


def _assert_same_batches(got, ref):
    assert len(got) == len(ref) > 0
    for (gi, gl), (ri, rl) in zip(got, ref):
        assert gi.dtype == np.uint8 and gl.dtype == np.int32
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)


@pytest.fixture
def one_thread():
    """One intra-op thread for a test's small CPU run, which the other test
    workers would otherwise contend with; restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cores():
    """The JAX package's native core and the port's (both with every codec
    of this host); skip where either cannot be built."""
    jlib, plib = jnative.get_library(), pnative.get_library()
    if jlib is None or plib is None:
        pytest.skip("a native core could not be built (no g++ or no codec headers)")
    return jlib, plib


# ---------------------------------------------------------------- datasets


@pytest.mark.parametrize("kind", ["euro_sat", "fmow_sentinel"])
@pytest.mark.parametrize("bands", [{}, {"masked_bands": [2, 7]},
                                   {"dropped_bands": [0, 9, 10]},
                                   {"masked_bands": [1], "dropped_bands": [12, 5]}],
                         ids=["all", "masked", "dropped", "both"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_multiband_loader_yields_the_jax_batches(tmp_path, kind, bands, drop_last):
    """Two epochs at two shards, batch 2, on the Python path of both
    packages: every batch equal, and the step counts."""
    jd, pd = _build(kind, tmp_path, **bands)
    assert (pd.in_c, pd.labels.tolist(), pd.paths) == (jd.in_c, jd.labels.tolist(), jd.paths)
    for shard in range(2):
        kw = dict(shuffle=True, seed=3, drop_last=drop_last, num_threads=3, shard_id=shard,
                  num_shards=2, use_native=False)
        jl, pl = JLoader(jd, 2, **kw), DataLoader(pd, 2, **kw)
        assert pl.backend == "python"
        assert (pl.steps_per_epoch(), pl.max_shard_steps()) == (
            jl.steps_per_epoch(), jl.max_shard_steps())
        for epoch in range(2):
            got = list(pl.epoch(epoch))
            _assert_same_batches(got, list(jl.epoch(epoch)))
            assert got[0][0].shape[1:] == (16, 16, pd.in_c)


def test_sentinel_normalize_matches_jax(rng_np):
    raw = rng_np.integers(0, 9000, (5, 4, 13)).astype(np.uint16)
    np.testing.assert_array_equal(
        pds.sentinel_normalize(raw, pds.SENTINEL_MEAN, pds.SENTINEL_STD),
        jds.sentinel_normalize(raw, jds.SENTINEL_MEAN, jds.SENTINEL_STD))


def test_multiband_resize_matches_jax(rng_np):
    img = rng_np.integers(0, 256, (19, 23, 10), np.uint8)
    np.testing.assert_array_equal(pds._resize_uint8(img, 16), jds._resize_uint8(img, 16))


def test_sentinel_csv_columns_filters_and_errors_match_jax(tmp_path):
    """Numeric categories sort as numbers (as pandas reads them), the
    ``categories`` and ``years`` filters, and a missing column's KeyError."""
    path = _sentinel(tmp_path, categories=["10", "9", "2"])
    for kw in ({}, {"categories": [9, 10]}, {"years": [2016, 2017]},
               {"years": [2015], "categories": [2, 10], "dropped_bands": [3]}):
        jd = jds.SentinelDataset(path, 16, **kw)
        pd = pds.SentinelDataset(path, 16, **kw)
        assert pd.paths == jd.paths and pd.labels.tolist() == jd.labels.tolist(), kw
        assert (pd.in_c, pd.num_classes) == (jd.in_c, jd.num_classes)
    assert pds.SentinelDataset(path, 16).labels[:3].tolist() == [2, 1, 0]
    bad = tmp_path / "bad.csv"
    bad.write_text("label,image_path\n1,s0.tif\n")
    for cls in (jds.SentinelDataset, pds.SentinelDataset):
        with pytest.raises(KeyError, match="category"):
            cls(str(bad), 16)


def test_eurosat_labels_and_attributes_match_jax(tmp_path):
    jd, pd = _build("euro_sat", tmp_path, dropped_bands=[0, 9, 10])
    assert pd.labels.tolist() == jd.labels.tolist() and max(pd.labels) == 2
    assert (pd.in_c, pd.normalize_on_device, pd.mean, pd.std, pd.sentinel_norm) == (
        jd.in_c, jd.normalize_on_device, jd.mean, jd.std, jd.sentinel_norm) == (
        10, False, pds.SENTINEL_MEAN, pds.SENTINEL_STD, True)


# ---------------------------------------------------------------- the TIFF reader


@pytest.mark.parametrize("layout", [
    dict(), dict(order=">"), dict(bigtiff=True), dict(bigtiff=True, order=">"),
    dict(planar=True), dict(rows_per_strip=3), dict(planar=True, rows_per_strip=4),
    dict(tile=(16, 16)), dict(tile=(16, 16), planar=True, order=">"),
], ids=["ii", "mm", "bigtiff", "bigtiff_mm", "planar", "strips", "planar_strips", "tiles",
        "planar_tiles_mm"])
@pytest.mark.parametrize("dtype", ["uint16", "int16", "uint8", "float32", "int32"])
def test_tiff_reader_matches_libtiff(cores, tmp_path, layout, dtype):
    """The port's reader against the JAX package's libtiff reader on one
    19 x 21 image of 5 bands (tiles padded past both edges)."""
    rng = np.random.default_rng(4)
    info = np.iinfo(dtype) if dtype != "float32" else None
    arr = (rng.standard_normal((19, 21, 5)).astype(np.float32) if info is None else
           rng.integers(info.min, info.max, (19, 21, 5), dtype=np.int64).astype(dtype))
    path = str(tmp_path / "x.tif")
    _write_tiff_layout(path, arr, **layout)
    got, ref = pnative.read_tiff(path, cores[1]), jnative.read_tiff(path)
    assert got is not None and ref is not None and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, arr.astype(np.float32))


def test_compressed_tiff_needs_libtiff_in_the_core(cores, tmp_path):
    """An LZW TIFF (written by PIL) goes to libtiff, where the core has it,
    and reads as the JAX reader reads it; a core built without libtiff
    reads uncompressed files alone and refuses it, and a JPEG."""
    from PIL import Image

    rgb = np.random.default_rng(5).integers(0, 256, (12, 10, 3), np.uint8)
    lzw, plain = str(tmp_path / "lzw.tif"), str(tmp_path / "plain.tif")
    Image.fromarray(rgb).save(lzw, compression="tiff_lzw")
    _write_tiff(plain, rgb)
    if "libtiff" in pnative.codecs(cores[1]):
        np.testing.assert_array_equal(pnative.read_tiff(lzw, cores[1]), jnative.read_tiff(lzw))
    bare = pnative.load_library(pnative.build_library(codecs=()))
    assert pnative.codecs(bare) == ()
    assert pnative.read_tiff(lzw, bare) is None
    np.testing.assert_array_equal(pnative.read_tiff(plain, bare), rgb.astype(np.float32))
    jpg = str(tmp_path / "x.jpg")
    Image.fromarray(rgb).save(jpg)
    assert pnative.decode_jpeg(jpg, 8, bare) is None
    np.testing.assert_array_equal(pnative.decode_jpeg(jpg, 8, cores[1]), jnative.decode_jpeg(jpg, 8))


def test_native_build_goes_to_build_native_and_is_reused(cores):
    path = pnative.build_library()
    assert path is not None and os.path.dirname(path) == str(pnative.BUILD_DIR)
    assert pnative.BUILD_DIR.parts[-2:] == ("build", "native")
    assert pnative.build_library() == path
    assert "-ffp-contract=off" in pnative.build_command("g++", "x", ())


# ---------------------------------------------------------------- the native core


def _rgb_dataset(root, ext, n=13, corrupt=()):
    """An fMoW-RGB CSV over ``ext`` images of several sizes; the files in
    ``corrupt`` are cut to a few bytes."""
    from PIL import Image

    rng = np.random.default_rng(2)
    rows = ["category,image_path"]
    for i in range(n):
        side = 14 + 5 * (i % 3)
        p = root / f"im{i}.{ext}"
        Image.fromarray(rng.integers(0, 256, (side, side + 2, 3), np.uint8)).save(p)
        if i in corrupt:
            p.write_bytes(p.read_bytes()[:20])
        rows.append(f"{i % 4},im{i}.{ext}")
    (root / "index.csv").write_text("\n".join(rows) + "\n")
    return str(root / "index.csv")


def _native_pair(jd, pd, batch, **kw):
    jl, pl = JLoader(jd, batch, **kw), DataLoader(pd, batch, **kw)
    assert jl._native is not None and pl.backend == "native"
    return jl, pl


@pytest.mark.parametrize("source", ["jpg", "png", "euro_sat_dropped", "fmow_sentinel_masked"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_native_core_matches_the_jax_native_core(cores, tmp_path, source, drop_last):
    """Both cores on one dataset at two shards over two epochs: the same
    batches, and the step counts of the Python path's rule."""
    if source in ("jpg", "png"):
        path = _rgb_dataset(tmp_path, source)
        jd, pd = (m.build_dataset("fmow_rgb", True, train_path=path, input_size=12)
                  for m in (jds, pds))
    elif source == "euro_sat_dropped":
        jd, pd = _build("euro_sat", tmp_path, dropped_bands=[0, 9, 10])
    else:
        jd, pd = _build("fmow_sentinel", tmp_path, masked_bands=[4])
    for shard in range(2):
        kw = dict(shuffle=True, seed=7, drop_last=drop_last, num_threads=3, shard_id=shard,
                  num_shards=2)
        jl, pl = _native_pair(jd, pd, 3, **kw)
        steps = DataLoader(pd, 3, use_native=False, **kw).steps_per_epoch()
        for epoch in range(2):
            got = list(pl.epoch(epoch))
            _assert_same_batches(got, list(jl.epoch(epoch)))
            assert len(got) == steps == pl._native._lib.csmae_loader_batches_per_epoch(
                pl._native._handle)


def test_native_tiff_batches_equal_the_python_path(cores, tmp_path):
    """At the canvas size (no resize) the native core's band handling gives
    the Python path's bytes; only the epoch order is the core's own."""
    jd, pd = _build("fmow_sentinel", tmp_path, masked_bands=[1, 11], dropped_bands=[0, 9, 10])
    kw = dict(shuffle=False, drop_last=False, num_threads=2)
    native = list(DataLoader(pd, 4, **kw).epoch(0))
    python = list(DataLoader(pd, 4, use_native=False, **kw).epoch(0))
    _assert_same_batches(native, python)


def test_native_core_zero_fills_a_corrupt_file_and_refuses_a_broken_epoch(cores, tmp_path):
    (tmp_path / "one").mkdir()
    (tmp_path / "most").mkdir()
    path = _rgb_dataset(tmp_path / "one", "jpg", corrupt=(4,))
    jd, pd = (m.build_dataset("fmow_rgb", True, train_path=path, input_size=12) for m in (jds, pds))
    kw = dict(shuffle=False, drop_last=False, num_threads=2)
    jl, pl = _native_pair(jd, pd, 5, **kw)
    with pytest.warns(UserWarning, match="1 image"):
        got = list(pl.epoch(0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _assert_same_batches(got, list(jl.epoch(0)))
    assert not got[0][0][4].any() and got[0][0][3].any()

    path = _rgb_dataset(tmp_path / "most", "jpg", corrupt=range(1, 13))
    jd, pd = (m.build_dataset("fmow_rgb", True, train_path=path, input_size=12) for m in (jds, pds))
    for loader in _native_pair(jd, pd, 5, **kw):
        with pytest.raises(RuntimeError, match="12/13"):
            list(loader.epoch(0))


def test_native_core_declines_what_the_python_path_serves(cores, tmp_path):
    """Temporal pairs, a codec the core lacks, a TIFF dataset whose band
    count is not the statistics', and use_native=False take the Python
    path; so does every dataset when the core cannot be built."""
    path = _rgb_dataset(tmp_path, "png", n=3)
    pd = pds.build_dataset("fmow_rgb", True, train_path=path, input_size=12)
    bare = pnative.load_library(pnative.build_library(codecs=()))
    assert pnative.NativeJpegLoader.maybe_create(pd, 2, DataLoader(pd, 2), bare) is None
    assert DataLoader(pd, 2, use_native=False).backend == "python"
    (tmp_path / "gray").mkdir()
    _write_tiff(str(tmp_path / "gray" / "g.tif"), np.zeros((16, 16, 4), np.uint16))
    (tmp_path / "list.txt").write_text(str(tmp_path / "gray" / "g.tif") + "\n")
    eur = pds.build_dataset("euro_sat", True, train_path=str(tmp_path / "list.txt"), input_size=16)
    assert DataLoader(eur, 1).backend == "python"


def test_without_gxx_the_loader_takes_the_python_path(tmp_path, monkeypatch):
    path = _rgb_dataset(tmp_path, "png", n=3)
    pd = pds.build_dataset("fmow_rgb", True, train_path=path, input_size=12)
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_build_failed", False)
    monkeypatch.setattr(pnative.shutil, "which", lambda name: None)
    assert DataLoader(pd, 2).backend == "python"
    assert pnative.read_tiff(path) is None


# ---------------------------------------------------------------- the CLIs


def test_finetune_and_probe_clis_run_on_eurosat_with_dropped_bands(tmp_path, cores,
                                                                    one_thread):
    """Both classifier CLIs on a 10-channel EuroSAT (bands 0, 9 and 10
    dropped) through the native core: the classifier takes 10 channels,
    the loss is finite, and the eval covers every image."""
    from cross_scale_mae_torch.cli import finetune, linprobe

    (tmp_path / "d").mkdir()
    path = _eurosat(tmp_path / "d", n=12)
    data = ["--dataset_type", "euro_sat", "--train_path", path, "--test_path", path,
            "--dropped_bands", "0", "9", "10", "--nb_classes", "3", "--epochs", "2",
            "--warmup_epochs", "1", "--batch_size", "4", "--num_workers", "2"]
    ft = finetune.main(finetune.get_args_parser().parse_args(
        TINY_VIT + data + ["--output_dir", str(tmp_path / "ft"), "--attention_impl", "xla"]))
    run = linprobe.build_run(linprobe.get_args_parser().parse_args(
        TINY_VIT + data + ["--output_dir", str(tmp_path / "lp")]))
    lp = linprobe.main(linprobe.get_args_parser().parse_args(
        TINY_VIT + data + ["--output_dir", str(tmp_path / "lp")]))
    assert run.cfg.input_channels == 10 and run.train_loader.backend == "native"
    assert run.train_loader.dataset.in_c == run.eval_loader.dataset.in_c == 10
    for res in (ft, lp):
        assert res["eval"]["n"] == 12 and np.isfinite(res["eval"]["loss"])
        assert all(np.isfinite(v) for v in res["losses"])


def test_finetune_cli_runs_on_fmow_sentinel(tmp_path, one_thread):
    from cross_scale_mae_torch.cli import finetune

    (tmp_path / "d").mkdir()
    path = _sentinel(tmp_path / "d", n=8)
    run = finetune.build_run(finetune.get_args_parser().parse_args(TINY_VIT + [
        "--dataset_type", "fmow_sentinel", "--train_path", path, "--test_path", path,
        "--masked_bands", "3", "--dropped_bands", "0", "9", "10", "--batch_size", "4",
        "--nb_classes", "3", "--output_dir", str(tmp_path / "ft"), "--num_workers", "2"]))
    imgs, labels = next(iter(run.train_batches(0)))
    state, metrics = run.step_fn(run.state, imgs, labels, run.draws(0)[0])
    assert run.cfg.input_channels == 10 and imgs.shape == (4, 16, 16, 10)
    assert np.isfinite(float(metrics["loss"]))


def test_data_package_exports_what_the_jax_one_exports():
    import cross_scale_mae_torch.data as pdata
    import cross_scale_mae_tpu.data as jdata

    assert pdata.__all__ == jdata.__all__
    assert all(getattr(pdata, name) is not None for name in pdata.__all__)
