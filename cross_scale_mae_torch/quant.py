"""Weight-only int8 quantization for serving (counterpart of
``cross_scale_mae_tpu/quant.py``, the same scheme and the same bits).

Scheme: symmetric, per output channel. For a kernel ``(..., in, out)`` the
scale is ``max|w|`` over the ``in`` axis (axis -2) over 127, floored at
1e-12 and kept broadcastable, and the codes are ``rint(w / scale)`` clipped
to +-127. Only leaves named ``kernel`` with ndim >= 2 are quantized; biases,
norms, the cls and position tables and BatchNorm state keep full precision.
The JAX package quantizes its stacked ``(layers, in, out)`` block kernels,
which gives per-(layer, out) scales; the port's per-layer ``(in, out)``
kernels give the same scales and codes layer by layer, since the maximum
runs over ``in`` alone. The arithmetic is numpy's, op for op the JAX
package's, so the codes and scales are bit-equal to its on the same fp32
tree.

A quantized kernel is a node ``{"__int8__": codes, "scale": scale}``.
``models/layers.linear`` dequantizes such a node just before its matmul,
``codes.to(dtype) * scale.to(dtype)`` in the activation dtype (the JAX
package's ``dequantize_params`` order), so at most one layer's weights are
ever held at full width. That dequantize writes a compute-dtype copy of
each kernel per call: the device holds a quarter of fp32's kernel bytes and
half of bf16's, but each dispatch still reads the weights at the compute dtype's width once
more (no fused int8-weight GEMM; see ROADMAP.md).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

QKEY = "__int8__"


def is_qnode(node: Any) -> bool:
    return isinstance(node, dict) and QKEY in node


def _quantize_array(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    w = np.asarray(w, np.float32)
    scale = np.max(np.abs(w), axis=-2, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12)  # all-zero channels
    codes = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return codes, scale.astype(np.float32)


def quantize_params_int8(params: Any) -> Any:
    """A params tree (nested dicts and lists of tensors or numpy arrays, in
    the port's or the JAX layout) -> the same structure with every kernel of
    ndim >= 2 replaced by ``{"__int8__": int8 codes, "scale": fp32}``,
    computed on the host; tensors come back as tensors on their device."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if name != "kernel" or getattr(node, "ndim", 0) < 2:
            return node
        if isinstance(node, torch.Tensor):
            codes, scale = _quantize_array(node.detach().cpu().float().numpy())
            return {QKEY: torch.from_numpy(codes).to(node.device),
                    "scale": torch.from_numpy(scale).to(node.device)}
        codes, scale = _quantize_array(node)
        return {QKEY: codes, "scale": scale}

    return walk(params)


def dequantize(node: dict, dtype: torch.dtype) -> torch.Tensor:
    """One quantized kernel in ``dtype``: the codes cast, the scale cast,
    then their product, each rounded to ``dtype``."""
    return node[QKEY].to(dtype) * node["scale"].to(dtype)


def dequantize_params(qparams: Any, dtype: torch.dtype = torch.float32) -> Any:
    """The inverse transform over a whole tree (tensors)."""
    if is_qnode(qparams):
        return dequantize(qparams, dtype)
    if isinstance(qparams, dict):
        return {k: dequantize_params(v, dtype) for k, v in qparams.items()}
    if isinstance(qparams, list):
        return [dequantize_params(v, dtype) for v in qparams]
    return qparams


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantized_bytes(qparams: Any) -> tuple[int, int]:
    """(bytes of the quantized tree, bytes the fp32 tree would take)."""
    q_total = fp_total = 0
    for leaf in _leaves(qparams):
        if isinstance(leaf, torch.Tensor):
            n, item, is_int8 = leaf.numel(), leaf.element_size(), leaf.dtype == torch.int8
        else:
            leaf = np.asarray(leaf)
            n, item, is_int8 = leaf.size, leaf.dtype.itemsize, leaf.dtype == np.int8
        q_total += n * item
        fp_total += n * (4 if is_int8 else item)
    return q_total, fp_total
