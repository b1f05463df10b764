"""Device ms a step of every kernel that is neither a matrix product, an
attention kernel nor a collective (copies and fills are not kernels and are
left out), averaged over the cards."""

from portbench.trace import is_attention, is_comm, is_gemm


def read(t):
    spent = sum(a.end - a.start for tr in t.traces for a in tr.device
                if a.kind == "kernel" and not (is_gemm(a.name) or is_attention(a.name)
                                               or is_comm(a.name)))
    return spent / 1e3 / t.steps / len(t.traces) if spent > 0 else None
