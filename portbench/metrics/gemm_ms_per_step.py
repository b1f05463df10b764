"""Device ms a step of the matrix-product kernels (cuBLAS and CUTLASS
names), averaged over the cards."""

from portbench.trace import is_gemm


def read(t):
    spent = sum(a.end - a.start for tr in t.traces for a in tr.device
                if a.kind == "kernel" and is_gemm(a.name))
    return spent / 1e3 / t.steps / len(t.traces) if spent > 0 else None
