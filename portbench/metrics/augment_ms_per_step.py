"""Device ms a step of the program's ``augment`` spans (the raw batch to
the model's input: flips, crops, RandAugment, normalisation, Mixup/CutMix),
each the interval between its two CUDA events on the compute stream."""

from portbench import spans


def read(t):
    return spans.device_ms_per_step(t, "augment")
