"""Dataset normalization statistics (a copy of the constants of
``cross_scale_mae_tpu/data/datasets.py``; a test holds the two equal)."""

from __future__ import annotations

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
