"""The whole step's share of one card's bf16 peak: model FLOPs of an image
x images/s per card, taken with the profiler off, over 989 TFLOP/s."""

from portbench.counts import PEAK_BF16_FLOPS


def read(t):
    if t.images_per_s <= 0 or t.flops_per_image <= 0:
        return None
    return 100.0 * t.flops_per_image * t.images_per_s / t.chips / PEAK_BF16_FLOPS
