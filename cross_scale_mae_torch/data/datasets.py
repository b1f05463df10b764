"""Host-side dataset indexes and decoders (a copy of the part of
``cross_scale_mae_tpu/data/datasets.py`` the port runs), the normalization
statistics (a test holds them equal to the JAX package's), and the
synthetic data made on the host as the JAX package's ``SyntheticDataset``
makes it and held on the device.

* **Host**: build the (path, label) index, decode, resize to a fixed uint8
  canvas; ``data/loader.py`` batches the canvases.
* **Device**: normalize, flips, rot90 and RandomResizedCrop run inside the
  step (``ops/augment.py``).

Families: fMoW-RGB CSV, the COCO glob and NAIP ``.npy`` tiles, plus the
synthetic set. PIL is imported when a JPEG or PNG is read or a tile needs
resizing, and raises naming PIL where it is missing. The TIFF families
(``euro_sat``, ``fmow_sentinel``) and ``fmow_temporal`` are not ported yet
and refuse (ROADMAP.md, queue 1 item 10).
"""

from __future__ import annotations

import csv
import os
from glob import glob
from typing import Any

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

# Whether each family's pipeline normalizes on the device (True) or on the
# host in the loader (the SentinelNormalize families, False).
_NORMALIZE_ON_DEVICE: dict[str, bool] = {
    "fmow_rgb": True,
    "coco": True,
    "euro_sat": False,
    "fmow_sentinel": False,
    "naip": True,
    "synthetic": True,
    "fmow_temporal": True,
}


def normalize_on_device_for(dataset_type: str) -> bool:
    """True when the dataset family's normalization runs on the device, so
    a serving forward must apply it; False when the loader already did."""
    if dataset_type not in _NORMALIZE_ON_DEVICE:
        raise ValueError(f"Invalid dataset type: {dataset_type}")
    return _NORMALIZE_ON_DEVICE[dataset_type]


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


# Families the port does not read yet: dataset type -> ROADMAP.md queue 1 item.
UNPORTED_DATASETS = {"euro_sat": 10, "fmow_sentinel": 10, "fmow_temporal": 10}


def build_dataset(dataset_type: str, is_train: bool, *, train_path: str = "",
                  test_path: str = "", input_size: int = 128, canvas_scale: float = 1.0,
                  synthetic_len: int = 4096, **kw: Any) -> Dataset:
    """The JAX package's factory (util/datasets.py:567-626) for the ported
    families. ``canvas_scale`` sets the host decode canvas relative to
    ``input_size`` (the eval path wants 1/0.875)."""
    path = train_path if is_train else test_path
    canvas = canvas_size(input_size, canvas_scale)
    if dataset_type in UNPORTED_DATASETS:
        raise NotImplementedError(
            f"dataset type {dataset_type!r} is not ported yet (the TIFF readers and "
            "the temporal pairs); see ROADMAP.md (queue 1 item "
            f"{UNPORTED_DATASETS[dataset_type]})")
    if dataset_type == "fmow_rgb":
        return FmowRgbDataset(path, canvas)
    if dataset_type == "coco":
        return GlobDataset(path, canvas)
    if dataset_type == "naip":
        return NaipDataset(path, canvas)
    if dataset_type == "synthetic":
        return SyntheticDataset(synthetic_len, canvas, **kw)
    raise ValueError(f"Invalid dataset type: {dataset_type}")
