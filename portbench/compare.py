"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings of the first three steps from the same
weights and inputs: each step's loss, each leaf's first gradient (the
program's as its optimizer got it) and each leaf's change after the third
update. Four numbers compare them, each against a limit of the cell's own
(``limits/<workload>.json``; a null limit leaves a number uncompared):

* ``loss_gap``: the largest |program - reference| / |reference| of the
  three losses;
* ``grad_gap``: the worst leaf's |program norm - reference norm| of the
  first gradient, over the larger of that leaf's reference norm and the
  median leaf's;
* ``change_gap``: the same of the leaves' changes, each taken over the
  elements whose reference gradient at the first step is at least a
  thousandth of the median leaf's root-mean-square gradient. An element
  whose gradient is nought to rounding (the key's third of a fused qkv
  bias, under softmax) moves under Adam by round-off alone; a leaf with no
  element left is left out;
* ``grad_err``: the worst leaf's norm of the difference of the first
  gradients, over the same denominator. A gap of norms is of second order
  in an error that is random from element to element, and so barely
  tells a lower precision from the program's; this number is of first
  order in it.
"""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_err")
MOVING = 1e-3   # an element moves where its reference gradient is this share of the median rms


def _worst(prog: dict, ref: dict, keys: list, diff: bool = True) -> tuple[float, object]:
    """The worst leaf's gap |prog - ref| (or, without ``diff``, ``prog``
    itself) over the larger of the leaf's and the median leaf's ``ref``,
    and its path."""
    if set(prog) != set(ref):
        missing = sorted(map(str, set(ref) ^ set(prog)))[:3]
        raise ValueError(f"the program's leaves differ from the reference's: {missing}")
    median = statistics.median(ref[k] for k in keys)
    worst, where = 0.0, None
    for k in keys:
        num = abs(prog[k] - ref[k]) if diff else prog[k]
        gap = num / max(ref[k], median, 1e-30) if math.isfinite(num) else math.inf
        if gap >= worst:
            worst, where = gap, k
    return worst, where


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v)) for k, v in tensors.items()}


def gaps(prog: dict, ref: dict, where: dict | None = None) -> dict[str, float]:
    """The four numbers of ``prog``'s readings against ``ref``'s; ``where``
    gets the worst leaf of each leaf-wise number."""
    loss = 0.0
    for p, r in zip(prog["loss"], ref["loss"], strict=True):
        loss = max(loss, abs(p - r) / abs(r)) if math.isfinite(p) else math.inf
    keys = list(ref["g1"])
    mine, theirs = _norms(prog["g1"]), _norms(ref["g1"])
    rms = statistics.median(theirs[k] / math.sqrt(ref["g1"][k].numel()) for k in keys)
    moved, moved_ref = {}, {}
    for k in keys:
        moving = ref["g1"][k].abs() >= MOVING * rms
        if bool(moving.any()):
            moved[k] = float(torch.linalg.vector_norm(prog["delta"][k][moving]))
            moved_ref[k] = float(torch.linalg.vector_norm(ref["delta"][k][moving]))
    errs = _norms({k: prog["g1"][k] - ref["g1"][k] for k in keys})
    out, at = {"loss_gap": loss}, {}
    out["grad_gap"], at["grad_gap"] = _worst(mine, theirs, keys)
    out["change_gap"], at["change_gap"] = _worst(moved, moved_ref, list(moved_ref))
    out["grad_err"], at["grad_err"] = _worst(errs, theirs, keys, diff=False)
    if where is not None:
        where.update(at)
    return out


def unchanged(ref: dict) -> dict:
    """The readings of a step that returns its state unchanged: the
    optimizer never saw a gradient and no leaf moved."""
    return {"loss": ref["loss"], "g1": {k: torch.zeros_like(v) for k, v in ref["g1"].items()},
            "delta": {k: torch.zeros_like(v) for k, v in ref["delta"].items()}}


def judge(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, each number compared beside its limit). A number whose
    limit is null is not compared: neither the control nor a fault reads
    far enough above the program's sound runs on it."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS
              if limits[k] is not None}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
