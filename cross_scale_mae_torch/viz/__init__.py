"""Evaluation and visualization (counterpart of ``cross_scale_mae_tpu/viz``)."""

from cross_scale_mae_torch.viz.recon import (
    add_noise,
    plot_reconstruction,
    prepare_image,
    prepare_model,
    run_eval,
    run_one_image,
)
from cross_scale_mae_torch.viz.temporal import temporal_consistency_by_gap

__all__ = [
    "add_noise",
    "plot_reconstruction",
    "prepare_image",
    "prepare_model",
    "run_eval",
    "run_one_image",
    "temporal_consistency_by_gap",
]
