"""What the kernel rooflines share."""

from portbench.counts.attention import step_bound_s


def roofline(t, family: str, names: tuple[str, ...]):
    """100 x the bound of ``family``'s calls in the traced steps over the
    device seconds of kernels whose name holds one of ``names``; None where
    the cell makes no such call or the trace holds no such kernel."""
    calls = t.attention.get(family)
    spent = sum(a.end - a.start for tr in t.traces for a in tr.device
                if a.kind == "kernel" and any(n in a.name for n in names)) / 1e6
    if not calls or spent <= 0:
        return None
    return 100.0 * t.steps * len(t.traces) * step_bound_s(calls) / spent
