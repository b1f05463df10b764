"""Data pipeline: dataset indexes and decoders on the host (the native C++
core or PIL), batching and the copy to the device. Augmentation runs on
the device (``ops/augment.py``)."""

from cross_scale_mae_torch.data.datasets import (
    DATASET_STATS,
    Dataset,
    EurosatDataset,
    FmowRgbDataset,
    FmowTemporalDataset,
    GlobDataset,
    NaipDataset,
    SyntheticDataset,
    build_dataset,
)
from cross_scale_mae_torch.data.loader import DataLoader

__all__ = [
    "DATASET_STATS",
    "build_dataset",
    "Dataset",
    "FmowRgbDataset",
    "FmowTemporalDataset",
    "GlobDataset",
    "EurosatDataset",
    "NaipDataset",
    "SyntheticDataset",
    "DataLoader",
]
