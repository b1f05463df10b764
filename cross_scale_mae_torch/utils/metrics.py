"""Classification metrics, the training log's smoothed meters and the
reconstruction metrics (a numpy copy of ``ConfusionMatrix`` and of the part
of ``SmoothedValue`` / ``MetricLogger`` that the finetune CLI uses, and
``METRICS_DICT`` / ``calc_metric`` on torch, from
``cross_scale_mae_tpu/utils/metrics.py``)."""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np
import torch

from cross_scale_mae_torch.ops.ssim import ms_ssim, ssim


class SmoothedValue:
    """A series with a smoothing window (util/misc.py:26-86)."""

    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self) -> str:
        return f"{self.median:.4f} ({self.global_avg:.4f})"


class MetricLogger:
    """Named meters, printed as ``name: median (global average)``."""

    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())


class ConfusionMatrix:
    """Streaming confusion matrix (rows true, columns predicted); acc, F1
    and mIoU at epoch end (engine_finetune.py:154-236 uses sklearn)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        idx = labels.astype(np.int64) * self.num_classes + preds.astype(np.int64)
        self.mat += np.bincount(
            idx, minlength=self.num_classes ** 2).reshape(self.num_classes, self.num_classes)

    @property
    def accuracy(self) -> float:
        return float(np.trace(self.mat)) / max(self.mat.sum(), 1)

    def f1(self, average: str = "macro") -> float:
        """Macro or micro F1 (engine_finetune.py:177-181)."""
        tp = np.diag(self.mat).astype(np.float64)
        fp = self.mat.sum(axis=0) - tp
        fn = self.mat.sum(axis=1) - tp
        if average == "micro":
            p = tp.sum() / max(tp.sum() + fp.sum(), 1e-12)
            r = tp.sum() / max(tp.sum() + fn.sum(), 1e-12)
            return float(2 * p * r / max(p + r, 1e-12))
        with np.errstate(divide="ignore", invalid="ignore"):
            p = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
            r = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
            f1 = np.where(p + r > 0, 2 * p * r / (p + r), 0.0)
        return float(f1.mean())

    def miou(self) -> float:
        """Mean IoU over the classes present (engine_finetune.py:226-236)."""
        tp = np.diag(self.mat).astype(np.float64)
        denom = self.mat.sum(axis=0) + self.mat.sum(axis=1) - tp
        present = denom > 0
        if not present.any():
            return 0.0
        return float((tp[present] / denom[present]).mean())


# --------------------------------------------------------- reconstruction


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _mse(x, y) -> float:
    return float(((_f32(x) - _f32(y)) ** 2).mean())


def _mae(x, y) -> float:
    return float((_f32(x) - _f32(y)).abs().mean())


def _l1(x, y) -> float:
    return float((_f32(x) - _f32(y)).abs().sum())


def _l2(x, y) -> float:
    return float(((_f32(x) - _f32(y)) ** 2).sum())


def _ssim(x, y) -> float:
    return float(ssim(_f32(x), _f32(y), data_range=1.0))


def _ms_ssim(x, y) -> float:
    return float(ms_ssim(_f32(x), _f32(y), data_range=1.0))


METRICS_DICT = {
    # util/metrics.py:13-46, with the direction flags.
    "mse": {"full_name": "Mean Squared Error", "is_lower_better": True, "fn": _mse},
    "mae": {"full_name": "Mean Absolute Error", "is_lower_better": True, "fn": _mae},
    "l1": {"full_name": "L1 Norm", "is_lower_better": True, "fn": _l1},
    "l2": {"full_name": "L2 Norm", "is_lower_better": True, "fn": _l2},
    "ssim": {"full_name": "Structural Similarity Index", "is_lower_better": False,
             "fn": _ssim},
    # Needs images larger than 160 px (util/metrics.py:39-40).
    "ms_ssim": {"full_name": "Multi-Scale Structural Similarity Index",
                "is_lower_better": False, "fn": _ms_ssim},
}


def calc_metric(x, y, metric_name: str) -> float:
    """A metric of NHWC images in [0, 1] (numpy arrays or tensors), by
    name; the aliases ssd -> l2 and sad -> l1 (util/metrics.py:49-56)."""
    name = metric_name.lower()
    name = {"ssd": "l2", "sad": "l1"}.get(name, name)
    return METRICS_DICT[name]["fn"](x, y)
