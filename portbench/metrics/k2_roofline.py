"""K2's share of its roofline (csrc/mha_fwd.cu, csrc/mha_bwd.cu): the
least time of the step's K2 attention calls over the device time of the K2
kernels, both summed over the traced steps."""

from portbench.metrics._roofline import roofline


def read(t):
    return roofline(t, "k2", ("mha_fwd", "mha_bwd"))
