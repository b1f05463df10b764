"""K1's share of its roofline (csrc/mha3_fwd.cu, csrc/mha3_bwd.cu): the
least time of the step's K1 attention calls over the device time of the K1
kernels, both summed over the traced steps."""

from portbench.metrics._roofline import roofline


def read(t):
    return roofline(t, "k1", ("mha3_fwd", "mha3_bwd"))
