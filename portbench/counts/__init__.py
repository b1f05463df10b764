"""The benchmark's frozen arithmetic: the card's published peaks, the model
FLOPs of a training image, and the least work of an attention call."""

# One NVIDIA H100 SXM (NVIDIA data sheet): dense bf16 tensor-core rate and
# HBM3 bandwidth, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
