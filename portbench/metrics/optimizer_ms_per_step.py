"""Device ms a step of the program's ``optimizer`` spans (the gradient
norm and the AdamW update), each the interval between its two CUDA events
on the compute stream."""

from portbench import spans


def read(t):
    return spans.device_ms_per_step(t, "optimizer")
