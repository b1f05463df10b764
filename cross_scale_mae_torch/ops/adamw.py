"""The fused AdamW update on the card (``csrc/adamw.cu``) and what the host
prepares for it.

``train/optim.AdamW.update`` hands its trainable leaves to
:func:`fused_adamw`, which updates every leaf that :func:`kernel_takes` in
one launch of the kernel (counted by ``fused_adamw.launches``) and returns
the others, which keep the optimizer's ``torch._foreach_*`` chain, the plain
PyTorch version of the same arithmetic: so does every leaf on the CPU. The
kernel reads each element's param, gradient and two moments once and
writes the param and the moments once.

The launch takes one table, built each step from the leaves the kernel
takes (:func:`launch_table`): a ``LEAF`` record per leaf with its pointers
(a gradient is a new tensor each step), its element count, its first work
item (block b updates chunk b - first of the leaf whose items hold b,
``CHUNK`` elements a chunk and a shorter last one), the weight decay it
takes (0 where it does not decay), its layer-decay scale, and whether all
four pointers allow the kernel's four-element loads and stores. The table
goes to the card with the launch, through pinned memory, and nothing of it
stays there. The step's scalars (the learning rate, the bias corrections)
go to the kernel as arguments, computed on the host from its own count; the
clip factor stays a 0-d tensor on the device that the kernel reads. Nothing
waits for the device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

# Elements of one work item: a multiple of 4, so every chunk of a leaf whose
# pointers are aligned starts aligned. 8 four-element steps of 256 threads:
# ViT-L's 302.6M elements make some 37,000 blocks and the MAE's 113.8M some
# 14,000, so the card (1,056 resident blocks, 8 on each of 132 SMs) idles
# little while the last ones finish.
CHUNK = 1 << 13
# The device type the kernel runs on.
DEVICE = "cuda"
# The moment dtypes the kernel is instantiated for (csrc/adamw.cu mu_type, nu_type).
MOMENT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/adamw.cu Leaf: pointers, element count, first work item, weight
# decay, layer-decay scale, the vector flag.
LEAF = np.dtype([("p", "<i8"), ("g", "<i8"), ("m", "<i8"), ("v", "<i8"), ("n", "<i8"),
                 ("first", "<i8"), ("wd", "<f4"), ("scale", "<f4"), ("vec", "<i4"),
                 ("pad", "<i4")])


def first_items(numels: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """Each leaf's first work item, then the count of items: leaf l has
    items [first[l], first[l + 1]), one per ``chunk`` elements and one for a
    ragged rest, none when it is empty."""
    counts = (np.asarray(numels, dtype=np.int64) + chunk - 1) // chunk
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def launch_table(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor], wd: Sequence[float],
                 scales: Optional[Sequence[float]]) -> tuple[np.ndarray, int]:
    """The kernel's table for these leaves, one ``LEAF`` record each, and
    its number of work items. ``wd`` is each leaf's weight decay (0 where it
    does not decay), ``scales`` its layer-decay scale (1 where None). The
    vector flag is 1 where all four pointers allow four-element loads and
    stores (16 bytes for the fp32 param and gradient, four elements for a
    moment); each moment has one dtype over the leaves."""
    table = np.zeros(len(ps), dtype=LEAF)
    ptrs = np.array([(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
                     for p, g, m, v in zip(ps, gs, mu, nu)], dtype=np.int64).reshape(-1, 4)
    for k, name in enumerate("pgmv"):
        table[name] = ptrs[:, k]
    table["n"] = [p.numel() for p in ps]
    first = first_items(table["n"])
    table["first"] = first[:-1]
    table["wd"] = wd
    table["scale"] = 1.0 if scales is None else scales
    if len(table):
        align = np.array([16, 16, 4 * mu[0].element_size(), 4 * nu[0].element_size()])
        table["vec"] = (ptrs % align == 0).all(axis=1)
    return table, int(first[-1])


def kernel_takes(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel updates this leaf: an fp32 param and gradient,
    moments of a ``MOMENT_CODES`` dtype, all four of one shape, contiguous
    (a ZeRO-1 chunk cut across a leaf's rows is not) and on one ``DEVICE``
    device. Every other leaf keeps the foreach chain."""
    return (p.device.type == DEVICE and p.dtype is torch.float32 and g.dtype is torch.float32
            and m.dtype in MOMENT_CODES and v.dtype in MOMENT_CODES
            and p.shape == g.shape == m.shape == v.shape
            and p.is_contiguous() and g.is_contiguous() and m.is_contiguous()
            and v.is_contiguous() and p.device == g.device == m.device == v.device)


def fused_adamw(ps: list[torch.Tensor], gs: list[torch.Tensor], mu: list[torch.Tensor],
                nu: list[torch.Tensor], decay: Sequence[bool], scales: Optional[Sequence[float]],
                clip: Optional[torch.Tensor], *, lr: float, b1: float, b2: float, eps: float,
                weight_decay: float, count: int, upcast_first: bool) -> list[int]:
    """One AdamW update, in place, in one launch of ``csrc/adamw.cu``, of
    every leaf that :func:`kernel_takes`; returns the indices of the other
    leaves, left as they were. ``decay`` marks the leaves that take
    ``weight_decay``, ``scales`` are the layer-decay scales (None without
    layer decay: ``-lr u`` and the scale are then not rounded one at a
    time, as the foreach chain does), ``count`` is the update's number (1
    for the first), ``clip`` the clip factor (a 0-d fp32 tensor) or None and
    ``upcast_first`` the bf16 moments' rule (train/optim.py). The leaves the
    kernel takes lie on one card, with one moment dtype each for mu and nu."""
    idx, rest = [], []
    for i, leaf in enumerate(zip(ps, gs, mu, nu)):
        (idx if kernel_takes(*leaf) else rest).append(i)
    if not idx:
        return rest
    ps, gs, mu, nu = ([t[i] for i in idx] for t in (ps, gs, mu, nu))
    if len({p.device for p in ps}) > 1:
        raise ValueError("fused_adamw takes the leaves of one card")
    if len({m.dtype for m in mu}) > 1 or len({v.dtype for v in nu}) > 1:
        raise ValueError("fused_adamw takes one dtype for each moment")
    if clip is not None and (clip.dtype != torch.float32 or clip.numel() != 1
                             or clip.device != ps[0].device):
        raise ValueError("the clip factor is one fp32 element on the leaves' device")
    table, blocks = launch_table(
        ps, gs, mu, nu, [weight_decay if decay[i] else 0.0 for i in idx],
        None if scales is None else [scales[i] for i in idx])
    _launch(table, blocks, clip, ps[0].device, lr=lr, b1=b1, b2=b2, eps=eps, count=count,
            scaled=scales is not None, upcast_first=upcast_first, mu_dtype=mu[0].dtype,
            nu_dtype=nu[0].dtype)
    fused_adamw.launches += 1
    return rest


fused_adamw.launches = 0


@functools.cache
def _entry():
    """The kernel's C entry, its library built and loaded at the first call."""
    from cross_scale_mae_torch.ops.cuda_build import load_library

    fn = load_library("adamw").csmae_adamw
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_longlong] + [ctypes.c_float] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(table: np.ndarray, blocks: int, clip: Optional[torch.Tensor], device: torch.device,
            *, lr: float, b1: float, b2: float, eps: float, count: int, scaled: bool,
            upcast_first: bool, mu_dtype: torch.dtype, nu_dtype: torch.dtype) -> None:
    """``table`` to the card through pinned memory and the kernel's launch
    on the current stream, ``blocks`` work items."""
    fn = _entry()
    on_card = torch.from_numpy(table.view(np.uint8)).pin_memory().to(device, non_blocking=True)
    b1_stored = float(torch.tensor(b1, dtype=mu_dtype))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(on_card.data_ptr(), len(table), blocks,
                 None if clip is None else clip.data_ptr(), CHUNK,
                 b1, b2, 1 - b1, 1 - b2, b1_stored, 1 - b1 ** count, 1 - b2 ** count, eps,
                 -lr, int(scaled), MOMENT_CODES[mu_dtype], MOMENT_CODES[nu_dtype],
                 int(upcast_first), stream)
    if err:
        raise RuntimeError(f"adamw kernel launch failed: cudaError_t {err}")
