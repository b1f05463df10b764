"""Plain PyTorch pieces the references share: linear layers, LayerNorm,
softmax attention, the transformer block, the fixed sin-cos table, the
crop-and-resize matrices, AdamW and the warmup + half-cosine schedule.

Everything runs in float32 with TF32 off. :class:`Arith` decides how a
matrix product is computed: in float32, or (the control) with both operands
rounded to float8 e4m3 and the incoming gradient to e5m2, each with one
scale per tensor, and the product accumulated in float32, as an fp8 GEMM
path computes it.

Nothing here imports the program: this is the yardstick the program's
training step is held to.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

Tree = Any

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def ieee_fp32() -> None:
    """Matrix products in IEEE float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_fp8(x: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under one scale for the whole
    tensor (its absolute maximum onto the format's largest value), and
    returned in float32."""
    x = x.float()
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = largest / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with e4m3 operands; the backward's incoming gradient in e5m2."""

    @staticmethod
    def forward(ctx, a, b):
        aq = round_fp8(a, torch.float8_e4m3fn, E4M3_MAX)
        bq = round_fp8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = round_fp8(g, torch.float8_e5m2, E5M2_MAX)
        ga = gq @ bq.transpose(-1, -2)
        if bq.dim() == 2 and aq.dim() > 2:
            gb = aq.reshape(-1, aq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        else:
            gb = aq.transpose(-1, -2) @ gq
        return ga, gb


class Arith:
    """How the references multiply matrices: ``fp8=False`` in float32,
    ``fp8=True`` the control's float8 products."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Fp8Matmul.apply(a, b) if self.fp8 else a @ b


def linear(ar: Arith, p: Tree, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b with W stored (in, out)."""
    return ar.mm(x, p["kernel"]) + p["bias"]


def layer_norm(p: Tree, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def attention(ar: Arith, p: Tree, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head self-attention, qkv fused as (D, 3D) with columns (3, H, hd):
    softmax(q k^T / sqrt(hd)) v per head, then the output projection."""
    n, l, d = x.shape
    hd = d // heads
    qkv = linear(ar, p["qkv"], x).reshape(n, l, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    scores = ar.mm(q, k.transpose(-1, -2)) * hd ** -0.5
    out = ar.mm(torch.softmax(scores, dim=-1), v)
    return linear(ar, p["proj"], out.transpose(1, 2).reshape(n, l, d))


def block(ar: Arith, p: Tree, x: torch.Tensor, heads: int, eps: float) -> torch.Tensor:
    """Pre-norm block: x + attn(ln1(x)), then + fc2(gelu_tanh(fc1(ln2(x))))."""
    x = x + attention(ar, p["attn"], layer_norm(p["norm1"], x, eps), heads)
    h = F.gelu(linear(ar, p["mlp"]["fc1"], layer_norm(p["norm2"], x, eps)), approximate="tanh")
    return x + linear(ar, p["mlp"]["fc2"], h)


def checkpointed(fn: Callable, *args):
    """``fn(*args)`` whose activations are recomputed in the backward, so a
    whole batch's reference fits beside what the program left behind."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def patchify(imgs: torch.Tensor, p: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, L, p*p*C), each patch's pixels in (ph, pw, c) order."""
    n, h, w, c = imgs.shape
    x = imgs.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (h // p) * (w // p), p * p * c)


def sincos_table(dim: int, grid: int) -> np.ndarray:
    """The MAE's fixed 2-D sin-cos position table with a zero cls row,
    (1 + grid^2, dim) float32: half the columns encode one grid axis and
    half the other, each as [sin, cos] of the position times 10000^(-2i/half)."""

    def one_axis(half: int, pos: np.ndarray) -> np.ndarray:
        omega = 1.0 / 10000 ** (np.arange(half // 2, dtype=np.float64) / (half / 2.0))
        out = np.outer(pos.reshape(-1).astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    ww, hh = np.meshgrid(np.arange(grid, dtype=np.float64), np.arange(grid, dtype=np.float64))
    emb = np.concatenate([one_axis(dim // 2, ww), one_axis(dim // 2, hh)], axis=1)
    return np.concatenate([np.zeros((1, dim)), emb], axis=0).astype(np.float32)


def _cubic(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    at = t.abs()
    near = (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1
    far = a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a
    return torch.where(at <= 1, near, torch.where(at < 2, far, torch.zeros_like(at)))


def resample_matrix(src_len: int, out_len: int, start: torch.Tensor, length: torch.Tensor,
                    method: str) -> torch.Tensor:
    """(N, out, src) interpolation weights of a crop [start, start + length)
    resized to ``out_len`` (half-pixel centres; bicubic with a = -0.75,
    normalized, or bilinear; taps past the border land on the edge pixel)."""
    dst = torch.arange(out_len, dtype=torch.float32, device=start.device)
    src = start[:, None] + (dst + 0.5) * (length / out_len)[:, None] - 0.5
    base = torch.floor(src)
    frac = src - base
    if method == "cubic":
        offs = torch.tensor([-1.0, 0.0, 1.0, 2.0], device=start.device)
        w = _cubic(frac[..., None] - offs)
        w = w / w.sum(dim=-1, keepdim=True)
    else:
        offs = torch.tensor([0.0, 1.0], device=start.device)
        w = torch.stack([1.0 - frac, frac], dim=-1)
    idx = (base[..., None] + offs).clamp(0, src_len - 1).long()
    mat = torch.zeros((*src.shape, src_len), dtype=torch.float32, device=start.device)
    return mat.scatter_add_(-1, idx, w)


def crop_resize(imgs: torch.Tensor, boxes: torch.Tensor, out: int, method: str) -> torch.Tensor:
    """Each image's (top, left, height, width) box resized to out x out."""
    _, h, w, _ = imgs.shape
    rows = resample_matrix(h, out, boxes[:, 0], boxes[:, 2], method)
    cols = resample_matrix(w, out, boxes[:, 1], boxes[:, 3], method)
    tmp = torch.einsum("noh,nhwc->nowc", rows, imgs)
    return torch.einsum("npw,nowc->nopc", cols, tmp)


def flips(x: torch.Tensor, hflip: torch.Tensor, vflip: torch.Tensor) -> torch.Tensor:
    x = torch.where(hflip[:, None, None, None], x.flip(2), x)
    return torch.where(vflip[:, None, None, None], x.flip(1), x)


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def schedule(opt: dict, steps_per_epoch: int) -> Callable[[int], float]:
    """lr of an update: linear warmup over ``warmup_epochs``, then half-cosine
    to ``min_lr``, both on the fractional epoch step / steps_per_epoch; the
    base lr is blr * batch / 256."""
    base = opt["blr"] * opt["batch"] / 256.0

    def lr(step: int) -> float:
        epoch = step / steps_per_epoch
        if epoch < opt["warmup_epochs"]:
            return base * epoch / opt["warmup_epochs"]
        frac = (epoch - opt["warmup_epochs"]) / (opt["epochs"] - opt["warmup_epochs"])
        return opt["min_lr"] + (base - opt["min_lr"]) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return lr


class AdamW:
    """AdamW over a list of leaves: m, v, bias correction, eps added to the
    square root, decoupled weight decay on the leaves ``decay`` marks, and
    each leaf's whole update times its ``scale`` (layer decay)."""

    def __init__(self, leaves: list[torch.Tensor], decay: list[bool], scales: list[float],
                 b1: float, b2: float, eps: float, wd: float):
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.decay, self.scales = decay, scales
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd
        self.count = 0

    @torch.no_grad()
    def update(self, leaves: list[torch.Tensor], grads: list[torch.Tensor], lr: float) -> None:
        t = self.count + 1
        for i, (p, g) in enumerate(zip(leaves, grads)):
            self.m[i].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[i].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (self.m[i] / (1 - self.b1 ** t)) / ((self.v[i] / (1 - self.b2 ** t)).sqrt()
                                                     + self.eps)
            if self.decay[i]:
                u = u + self.wd * p
            p.sub_(self.scales[i] * lr * u)
        self.count = t


def tree_from_paths(flat: dict[tuple, torch.Tensor]) -> Tree:
    """A nested dict (and list, for integer keys) from path -> leaf."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def train_readings(loss_fn: Callable[[Tree, int], torch.Tensor],
                   weights: dict[tuple, torch.Tensor], opt: dict, lr: Callable[[int], float],
                   decay: list[bool], scales: list[float], steps: int) -> dict:
    """``steps`` training steps from ``weights`` (path -> leaf, not changed):
    each step's loss, and, on the host, each leaf's first gradient (``g1``)
    and its change after the last step (``delta``), by path."""
    paths = list(weights)
    leaves = [weights[k].detach().float().clone().requires_grad_(True) for k in paths]
    tree = tree_from_paths(dict(zip(paths, leaves)))
    adam = AdamW(leaves, decay, scales, opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"])
    losses, first = [], {}
    for k in range(steps):
        loss = loss_fn(tree, k)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if k == 0:
            first = {path: g.cpu() for path, g in zip(paths, grads)}
        adam.update(leaves, grads, lr(k))
        losses.append(float(loss.detach()))
        del grads, loss
    with torch.no_grad():
        delta = {k: (p - weights[k].float()).cpu() for k, p in zip(paths, leaves)}
    return {"loss": losses, "g1": first, "delta": delta}
