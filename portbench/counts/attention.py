"""The least time an attention call can take on the card: the larger of
its FLOPs over the bf16 peak and its bytes over HBM's bandwidth. The work is
that of the computation, whatever implements it: the forward reads q, k and
v once and writes o once, 2 N H L^2 hd multiply-adds twice (q k^T, P v);
the backward reads q, k, v and dO once and writes dq, dk and dv once, four
products (dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q), with nothing
recomputed counted."""

from __future__ import annotations

from portbench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def bound_s(seqs: int, tokens: int, heads: int, head_dim: int, itemsize: int,
            backward: bool) -> float:
    one = seqs * tokens * heads * head_dim * itemsize
    flops = (8 if backward else 4) * seqs * heads * tokens * tokens * head_dim
    moved = (7 if backward else 4) * one
    return max(flops / PEAK_BF16_FLOPS, moved / PEAK_HBM_BYTES)


def step_bound_s(calls: list[dict]) -> float:
    """Summed bound of one step's attention calls, each a dict of seqs,
    tokens, heads, head_dim, itemsize and layers (calls of that shape in a
    forward; the backward makes as many)."""
    total = 0.0
    for c in calls:
        shape = (c["seqs"], c["tokens"], c["heads"], c["head_dim"], c["itemsize"])
        total += c["layers"] * (bound_s(*shape, False) + bound_s(*shape, True))
    return total
