"""Learning-rate schedule (counterpart of ``cross_scale_mae_tpu/train/schedule.py``).

Per-iteration linear warmup, then half-cosine decay: the curve of
util/lr_sched.py:9-27, indexed by the step (a fractional epoch).
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_half_cosine(base_lr: float, min_lr: float, warmup_epochs: float,
                       total_epochs: float, steps_per_epoch: int
                       ) -> Callable[[int], float]:
    """Returns ``schedule(step) -> lr`` (a Python float, so reading it never
    waits on the device)."""

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr * epoch / max(warmup_epochs, 1e-8)
        denom = max(total_epochs - warmup_epochs, 1e-8)
        return min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * (epoch - warmup_epochs) / denom))

    return schedule
