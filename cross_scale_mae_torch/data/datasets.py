"""Host-side dataset indexes and decoders (a copy of the part of
``cross_scale_mae_tpu/data/datasets.py`` the port runs), the normalization
statistics (a test holds them equal to the JAX package's), and the
synthetic data made on the host as the JAX package's ``SyntheticDataset``
makes it and held on the device.

* **Host**: build the (path, label) index, decode, resize to a fixed uint8
  canvas; ``data/loader.py`` batches the canvases.
* **Device**: normalize, flips, rot90 and RandomResizedCrop run inside the
  step (``ops/augment.py``).

Families: fMoW-RGB CSV, the COCO glob, EuroSAT and fMoW-Sentinel
multi-band TIFFs (SentinelNormalize on the host), NAIP ``.npy`` tiles, fMoW
temporal pairs, plus the synthetic set. PIL is imported when a JPEG or PNG
is read or a tile needs resizing, and raises naming PIL where it is
missing. TIFFs are read by rasterio, else tifffile, else the native core
(``data/native``, uncompressed TIFFs with no library), else PIL, the JAX
package's chain. The fMoW-Sentinel CSV is read without pandas, which the
JAX package uses: a column whose every value is an integer (or a number)
is read as integers (numbers), as pandas infers it, so categories sort as
pandas sorts them.
"""

from __future__ import annotations

import csv
import os
from glob import glob
from typing import Any, Optional, Sequence

import numpy as np
import torch

# Reference stats (util/datasets.py:167-168, 215-216, 322-352, 490-519).
FMOW_RGB_MEAN = (0.43392888, 0.43578541, 0.40744025)
FMOW_RGB_STD = (0.19828456, 0.19250111, 0.19454683)
COCO_MEAN = (0.47004986, 0.44683802, 0.40762289)
COCO_STD = (0.24388726, 0.23901215, 0.24204848)
SENTINEL_MEAN = (
    1370.19151926, 1184.3824625, 1120.77120066, 1136.26026392, 1263.73947144,
    1645.40315151, 1846.87040806, 1762.59530783, 1972.62420416, 582.72633433,
    14.77112979, 1732.16362238, 1247.91870117,
)
SENTINEL_STD = (
    633.15169573, 650.2842772, 712.12507725, 965.23119807, 948.9819932,
    1108.06650639, 1258.36394548, 1233.1492281, 1364.38688993, 472.37967789,
    14.3114637, 1310.36996126, 1087.6020813,
)

DATASET_STATS: dict[str, tuple] = {
    "fmow_rgb": (FMOW_RGB_MEAN, FMOW_RGB_STD),
    "coco": (COCO_MEAN, COCO_STD),
    "fmow_sentinel": (SENTINEL_MEAN, SENTINEL_STD),
    "euro_sat": (SENTINEL_MEAN, SENTINEL_STD),
    "naip": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "synthetic": (FMOW_RGB_MEAN, FMOW_RGB_STD),
    "fmow_temporal": (FMOW_RGB_MEAN, FMOW_RGB_STD),
}

def canvas_size(input_size: int, canvas_scale: float) -> int:
    """The host canvas side for an input size (``build_dataset``'s rule)."""
    return int(round(input_size * canvas_scale))


def synthetic_images(n: int, canvas: int, channels: int, seed: int,
                     device: torch.device | str) -> torch.Tensor:
    """(n, canvas, canvas, C) uint8 on ``device``: image i is the JAX
    package's ``SyntheticDataset(n, canvas, seed=seed).load(i)[0]``."""
    imgs = np.empty((n, canvas, canvas, channels), np.uint8)
    for i in range(n):
        rng = np.random.default_rng(seed * 1_000_003 + i)
        imgs[i] = rng.integers(0, 256, (canvas, canvas, channels), np.uint8)
    return torch.from_numpy(imgs).to(device)


def synthetic_labels(n: int, num_classes: int, seed: int,
                     device: torch.device | str) -> torch.Tensor:
    """(n,) int64 labels on ``device``: the JAX ``SyntheticDataset``'s."""
    labels = np.random.default_rng(seed).integers(0, num_classes, n).astype(np.int32)
    return torch.from_numpy(labels).long().to(device)


def _pil_image():
    """PIL's ``Image`` module, imported when an image is decoded or resized."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding JPEG/PNG images or resizing a tile to the canvas needs PIL "
            "(Pillow), which is not installed; NAIP .npy tiles at the canvas size "
            "need no PIL") from e
    return Image


def _resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """Bicubic resize of an HWC uint8 array to (size, size) via PIL."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    image = _pil_image()
    if img.ndim == 3 and img.shape[2] in (1, 3, 4):
        pil = image.fromarray(img.squeeze() if img.shape[2] == 1 else img)
        out = np.asarray(pil.resize((size, size), image.BICUBIC))
        return out.reshape(size, size, -1)
    bands = [np.asarray(image.fromarray(img[..., i]).resize((size, size), image.BICUBIC))
             for i in range(img.shape[2])]
    return np.stack(bands, axis=-1)


class Dataset:
    """Index + per-item decode. Subclasses fill paths/labels and `_load_raw`."""

    mean: tuple = FMOW_RGB_MEAN
    std: tuple = FMOW_RGB_STD
    in_c: int = 3
    normalize_on_device: bool = True

    def __init__(self, canvas_size: int):
        self.canvas_size = canvas_size
        self.paths: list[str] = []
        self.labels: np.ndarray = np.zeros((0,), np.int32)

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1 if len(self.labels) else 0

    def check_paths(self, *extra_lists: list) -> None:
        """Fail at construction on missing files, naming a few: an index
        written to another directory resolves its relative paths against
        its own."""
        missing = []
        for plist in (self.paths, *extra_lists):
            missing += [p for p in plist if not os.path.exists(p)][:5 - len(missing)]
            if len(missing) >= 5:
                break
        if missing:
            raise FileNotFoundError(
                f"{type(self).__name__}: dataset index points at missing files, e.g. "
                f"{missing[:3]}; relative paths resolve against the index file's "
                "directory, so an index written to another directory must use "
                "absolute paths")

    def _load_raw(self, index: int) -> np.ndarray:
        """Returns HWC uint8 (any spatial size)."""
        with _pil_image().open(self.paths[index]) as im:
            return np.asarray(im.convert("RGB"))

    def load(self, index: int) -> tuple[np.ndarray, int]:
        return _resize_uint8(self._load_raw(index), self.canvas_size), int(self.labels[index])


class FmowRgbDataset(Dataset):
    """fMoW-RGB CSV with a header row: col0 = label (int), col1 = relative
    or absolute path (util/datasets.py:161-210)."""

    mean, std = FMOW_RGB_MEAN, FMOW_RGB_STD

    def __init__(self, csv_path: str, canvas_size: int):
        super().__init__(canvas_size)
        base = os.path.dirname(csv_path)
        paths, labels = [], []
        with open(csv_path, newline="") as f:
            reader = csv.reader(f)
            next(reader)  # header row (pandas header=0)
            for row in reader:
                if row:
                    paths.append(row[1] if os.path.isabs(row[1]) else os.path.join(base, row[1]))
                    labels.append(int(row[0]))
        self.paths = paths
        self.labels = np.asarray(labels, np.int32)
        self.check_paths()


class GlobDataset(Dataset):
    """Unlabeled recursive glob (the reference's COCO pretraining loader,
    util/datasets.py:213-234). Label is always 0."""

    mean, std = COCO_MEAN, COCO_STD

    def __init__(self, root: str, canvas_size: int, pattern: str = "**/*.jpg"):
        super().__init__(canvas_size)
        self.paths = sorted(glob(os.path.join(root, pattern), recursive=True))
        self.labels = np.zeros((len(self.paths),), np.int32)


def sentinel_normalize(img: np.ndarray, mean: Sequence[float], std: Sequence[float]
                       ) -> np.ndarray:
    """SentinelNormalize (util/datasets.py:302-317): [mean - 2 std, mean +
    2 std] mapped linearly onto [0, 255], clipped, as uint8."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    lo, hi = mean - 2 * std, mean + 2 * std
    out = (img.astype(np.float32) - lo) * 255.0 / (hi - lo)
    return np.clip(out, 0, 255).astype(np.uint8)


class _MultibandMixin:
    """Band handling of the Sentinel and EuroSAT families: mask on the raw
    image, SentinelNormalize, then drop (util/datasets.py:431-441)."""

    masked_bands: Optional[Sequence[int]] = None
    dropped_bands: Optional[Sequence[int]] = None
    # Opts the dataset into the native core's mask -> SentinelNormalize ->
    # drop, which must never be chosen by inference.
    sentinel_norm = True

    def _mask_bands(self, img: np.ndarray) -> np.ndarray:
        """Masked bands take the band's mean on the RAW image, before
        SentinelNormalize (which maps them to ~127)."""
        if self.masked_bands is not None:
            img = img.astype(np.float32, copy=True)
            for b in self.masked_bands:
                img[..., b] = float(np.asarray(self.mean)[b])
        return img

    def _drop_bands(self, img: np.ndarray) -> np.ndarray:
        if self.dropped_bands is not None:
            keep = [i for i in range(img.shape[-1]) if i not in self.dropped_bands]
            img = img[..., keep]
        return img

    def _read_geotiff(self, path: str) -> np.ndarray:
        """A multi-band GeoTIFF as HWC: rasterio if installed, else
        tifffile, else the native core, else PIL."""
        try:
            import rasterio  # type: ignore

            with rasterio.open(path) as f:
                return f.read().transpose(1, 2, 0)  # CHW -> HWC
        except ImportError:
            pass
        try:
            import tifffile  # type: ignore

            arr = tifffile.imread(path)
            return arr if arr.ndim == 3 else arr[..., None]
        except ImportError:
            pass
        from cross_scale_mae_torch.data import native

        arr = native.read_tiff(path)
        if arr is not None:
            return arr
        with _pil_image().open(path) as im:
            arr = np.asarray(im)
        return arr if arr.ndim == 3 else arr[..., None]

    def _load_raw(self, index: int) -> np.ndarray:
        img = self._mask_bands(self._read_geotiff(self.paths[index]))
        return self._drop_bands(sentinel_normalize(img, self.mean, self.std))

    def _set_bands(self, masked_bands, dropped_bands) -> None:
        self.masked_bands = masked_bands
        self.dropped_bands = dropped_bands
        if dropped_bands:
            self.in_c = 13 - len(dropped_bands)


class EurosatDataset(_MultibandMixin, Dataset):
    """EuroSAT 13-band txt file list (util/datasets.py:489-564): one path
    per line; the label is the parent directory's name, as its index among
    the sorted names."""

    mean, std = SENTINEL_MEAN, SENTINEL_STD
    in_c = 13
    normalize_on_device = False  # SentinelNormalize runs on the host

    def __init__(self, file_path: str, canvas_size: int,
                 masked_bands: Optional[Sequence[int]] = None,
                 dropped_bands: Optional[Sequence[int]] = None):
        super().__init__(canvas_size)
        with open(file_path) as f:
            self.paths = [line.strip() for line in f if line.strip()]
        cats = sorted({os.path.basename(os.path.dirname(p)) for p in self.paths})
        cat_id = {c: i for i, c in enumerate(cats)}
        self.labels = np.asarray(
            [cat_id[os.path.basename(os.path.dirname(p))] for p in self.paths], np.int32)
        self.check_paths()
        self._set_bands(masked_bands, dropped_bands)


def _infer_column(values: list[str]) -> list:
    """A CSV column as pandas infers it: integers where every value is one,
    else floats where every value is a number, else the strings."""
    for kind in (int, float):
        try:
            return [kind(v) for v in values]
        except ValueError:
            pass
    return values


class SentinelDataset(_MultibandMixin, Dataset):
    """fMoW-Sentinel CSV with ``category``, ``image_path`` and (for
    ``years``) ``timestamp`` columns (util/datasets.py:320-487); a category's
    label is its index among the sorted categories, after the ``categories``
    and ``years`` filters. A missing column raises KeyError naming it, as
    pandas does."""

    mean, std = SENTINEL_MEAN, SENTINEL_STD
    in_c = 13
    normalize_on_device = False

    def __init__(self, csv_path: str, canvas_size: int,
                 years: Optional[Sequence[int]] = None,
                 categories: Optional[Sequence[str]] = None,
                 masked_bands: Optional[Sequence[int]] = None,
                 dropped_bands: Optional[Sequence[int]] = None):
        super().__init__(canvas_size)
        with open(csv_path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            rows = [r for r in reader if r]
        columns = {name: _infer_column([r[i] for r in rows]) for i, name in enumerate(header)}
        keep = list(range(len(rows)))
        if categories is not None:
            keep = [i for i in keep if columns["category"][i] in set(categories)]
        if years is not None and "timestamp" in columns:
            keep = [i for i in keep if int(str(columns["timestamp"][i])[:4]) in set(years)]
        category = [columns["category"][i] for i in keep]
        cat_id = {c: i for i, c in enumerate(sorted(set(category)))}
        base = os.path.dirname(csv_path)
        self.paths = [p if os.path.isabs(p) else os.path.join(base, p)
                      for p in (str(columns["image_path"][i]) for i in keep)]
        self.labels = np.asarray([cat_id[c] for c in category], np.int32)
        self.check_paths()
        self._set_bands(masked_bands, dropped_bands)


class NaipDataset(Dataset):
    """NAIP .npy tiles and an index CSV of ``path,label`` rows (an optional
    ``path`` header); tiles are uint8 HWC or CHW arrays (util/naip_loader.py
    without its hard-coded paths). Its normalization statistics are the base
    class's fMoW-RGB ones, as in the JAX package, whose CLIs normalize with
    the dataset's own."""

    def __init__(self, index_csv: str, canvas_size: int):
        super().__init__(canvas_size)
        base = os.path.dirname(index_csv)
        paths, labels = [], []
        with open(index_csv, newline="") as f:
            for row in csv.reader(f):
                if not row or row[0] == "path":
                    continue
                paths.append(row[0] if os.path.isabs(row[0]) else os.path.join(base, row[0]))
                labels.append(int(row[1]))
        self.paths = paths
        self.labels = np.asarray(labels, np.int32)
        self.check_paths()

    def _load_raw(self, index: int) -> np.ndarray:
        arr = np.load(self.paths[index])
        if arr.ndim == 3 and arr.shape[0] in (1, 3, 4) and arr.shape[0] < arr.shape[2]:
            arr = arr.transpose(1, 2, 0)  # CHW -> HWC
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr


class FmowTemporalDataset(Dataset):
    """fMoW temporal pairs: two captures of one site (the JAX package's
    repair of the reference's dead ``Dataset_fmow_temporal``,
    util/datasets.py:237-294).

    CSV columns, by name: ``category`` (int label), ``image_path``,
    ``image_path2``, ``timestamp`` and ``timestamp2``
    (``YYYY-MM-DD[THH...]``); other columns are ignored, a missing one
    raises ValueError. ``load`` returns a (2, S, S, C) uint8 stack, frame 0
    the earlier capture: pairs are put in chronological order at
    construction by (year, month, day, hour), whatever the column order.
    ``timestamps`` (N, 2, 3) int32 holds the reference's ``parse_timestamp``
    features [year - min_year, month - 1, hour], min_year over both
    columns."""

    mean, std = FMOW_RGB_MEAN, FMOW_RGB_STD
    temporal = True
    frames = 2

    def __init__(self, csv_path: str, canvas_size: int):
        super().__init__(canvas_size)
        base = os.path.dirname(csv_path)

        def absolute(p: str) -> str:
            return p if os.path.isabs(p) else os.path.join(base, p)

        with open(csv_path, newline="") as f:
            rows = [r for r in csv.DictReader(f) if r and r.get("image_path")]
        for col in ("category", "image_path", "image_path2", "timestamp", "timestamp2"):
            if rows and col not in rows[0]:
                raise ValueError(f"fmow_temporal csv {csv_path!r} is missing column "
                                 f"{col!r} (have {sorted(rows[0])})")
        self.paths = [absolute(r["image_path"]) for r in rows]
        self.paths2 = [absolute(r["image_path2"]) for r in rows]
        self.labels = np.asarray([int(r["category"]) for r in rows], np.int32)
        self.check_paths(self.paths2)
        stamps = [(r["timestamp"], r["timestamp2"]) for r in rows]
        self.min_year = min((int(t[:4]) for pair in stamps for t in pair), default=0)
        self.timestamps = np.asarray(
            [[self.parse_timestamp(t) for t in pair] for pair in stamps],
            np.int32).reshape(len(rows), 2, 3)

        # The order compares the whole (year, month, day, hour): the stored
        # features drop the day, which cannot order two captures of a month.
        def order_key(stamp: str) -> tuple:
            return (int(stamp[:4]), int(stamp[5:7]),
                    int(stamp[8:10]) if len(stamp) >= 10 else 1,
                    int(stamp[11:13]) if len(stamp) >= 13 else 0)

        for i in range(len(rows)):
            if order_key(stamps[i][1]) < order_key(stamps[i][0]):
                self.paths[i], self.paths2[i] = self.paths2[i], self.paths[i]
                self.timestamps[i] = self.timestamps[i, ::-1]

    def time_gaps_months(self) -> np.ndarray:
        """(N,) int32 gap between a pair's captures in whole months (>= 0;
        the hour ignored)."""
        t = self.timestamps
        return ((t[:, 1, 0] - t[:, 0, 0]) * 12 + (t[:, 1, 1] - t[:, 0, 1])).astype(np.int32)

    @property
    def sample_shape(self) -> tuple[int, ...]:
        return (2, self.canvas_size, self.canvas_size, self.in_c)

    def parse_timestamp(self, stamp: str) -> np.ndarray:
        """[year - min_year, month - 1, hour] (util/datasets.py:287-292); a
        date alone has hour 0."""
        hour = int(stamp[11:13]) if len(stamp) >= 13 else 0
        return np.array([int(stamp[:4]) - self.min_year, int(stamp[5:7]) - 1, hour], np.int32)

    def _decode(self, path: str) -> np.ndarray:
        with _pil_image().open(path) as im:
            arr = np.asarray(im.convert("RGB"))
        return _resize_uint8(arr, self.canvas_size)

    def load(self, index: int) -> tuple[np.ndarray, int]:
        pair = np.stack([self._decode(self.paths[index]), self._decode(self.paths2[index])])
        return pair, int(self.labels[index])


class SyntheticDataset(Dataset):
    """Deterministic random data for benchmarks and tests: image i is drawn
    from ``default_rng(seed * 1_000_003 + i)``, the labels from
    ``default_rng(seed)``."""

    def __init__(self, n: int, canvas_size: int, channels: int = 3, num_classes: int = 62,
                 seed: int = 0):
        super().__init__(canvas_size)
        self.in_c = channels
        self._seed = seed
        self.paths = [f"synthetic://{i}" for i in range(n)]
        self.labels = np.random.default_rng(seed).integers(0, num_classes, n).astype(np.int32)

    def load(self, index: int) -> tuple[np.ndarray, int]:
        rng = np.random.default_rng(self._seed * 1_000_003 + index)
        img = rng.integers(0, 256, (self.canvas_size, self.canvas_size, self.in_c), np.uint8)
        return img, int(self.labels[index])


_DATASET_CLASSES: dict[str, type] = {
    "fmow_rgb": FmowRgbDataset,
    "coco": GlobDataset,
    "euro_sat": EurosatDataset,
    "fmow_sentinel": SentinelDataset,
    "naip": NaipDataset,
    "synthetic": SyntheticDataset,
    "fmow_temporal": FmowTemporalDataset,
}


def normalize_on_device_for(dataset_type: str) -> bool:
    """True when the dataset family's normalization runs on the device, so
    a serving forward must apply it; False when the loader already did (the
    SentinelNormalize families)."""
    if dataset_type not in _DATASET_CLASSES:
        raise ValueError(f"Invalid dataset type: {dataset_type}")
    return _DATASET_CLASSES[dataset_type].normalize_on_device


def build_dataset(dataset_type: str, is_train: bool, *, train_path: str = "",
                  test_path: str = "", input_size: int = 128, canvas_scale: float = 1.0,
                  masked_bands=None, dropped_bands=None, synthetic_len: int = 4096,
                  **kw: Any) -> Dataset:
    """The JAX package's factory (util/datasets.py:567-626).
    ``canvas_scale`` sets the host decode canvas relative to ``input_size``
    (the eval path wants 1/0.875); the band flags reach the multi-band
    families, ``kw`` the Sentinel (``years``, ``categories``) and synthetic
    ones."""
    path = train_path if is_train else test_path
    canvas = canvas_size(input_size, canvas_scale)
    if dataset_type == "fmow_rgb":
        return FmowRgbDataset(path, canvas)
    if dataset_type == "coco":
        return GlobDataset(path, canvas)
    if dataset_type == "euro_sat":
        return EurosatDataset(path, canvas, masked_bands, dropped_bands)
    if dataset_type == "fmow_sentinel":
        return SentinelDataset(path, canvas, masked_bands=masked_bands,
                               dropped_bands=dropped_bands, **kw)
    if dataset_type == "naip":
        return NaipDataset(path, canvas)
    if dataset_type == "synthetic":
        return SyntheticDataset(synthetic_len, canvas, **kw)
    if dataset_type == "fmow_temporal":
        return FmowTemporalDataset(path, canvas)
    raise ValueError(f"Invalid dataset type: {dataset_type}")
