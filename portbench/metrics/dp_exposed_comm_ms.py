"""Device ms a step in which a collective (NCCL) kernel runs and no other
kernel does: the gradient exchange and the step's other collectives not
hidden behind compute. Every step launches the same collectives, so the
card's collective kernels, in launch order, fall into the traced steps in
equal runs; the median step is taken on each card (a collective that
waits for a late rank reads long on the others, step by step), and the
cards' medians are averaged."""

import statistics

from portbench.trace import exposed, is_comm


def read(t):
    per_card = []
    for tr in t.traces:
        comm = sorted((a.start, a.end) for a in tr.device
                      if a.kind == "kernel" and is_comm(a.name))
        if comm:
            compute = [(a.start, a.end) for a in tr.device
                       if a.kind == "kernel" and not is_comm(a.name)]
            steps = [[] for _ in range(t.steps)]
            for i, interval in enumerate(comm):
                steps[i * t.steps // len(comm)].append(interval)
            per_card.append(statistics.median(exposed(s, compute) for s in steps) / 1e3)
    return sum(per_card) / len(per_card) if per_card else None
