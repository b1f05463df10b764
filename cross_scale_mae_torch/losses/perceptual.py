"""VGG16 perceptual loss: feature L1 and the optional Gram style L1
(counterpart of ``cross_scale_mae_tpu/losses/perceptual.py``; the
reference's ``util/vggloss.py``).

The trunk is torchvision VGG16's ``features[:23]`` (conv1_1 .. conv4_3),
tapped after relu1_2, relu2_2, relu3_3 and relu4_3. Its parameters keep the
JAX package's tree and layout, ``conv{stage}_{i}`` -> {"kernel" (3, 3, in,
out) HWIO, "bias"}, so a JAX trunk carries over unchanged and a checkpoint
holds it under the JAX paths; each call turns the kernels into OIHW once.
3x3 SAME convolutions are ``padding=1``, the VALID 2x2 max pool
``F.max_pool2d(2)``. The trunk is fp32; on the GPU its convolutions run in
TF32 where the process allows it (``torch.backends.cudnn.allow_tf32``,
PyTorch's default), the counterpart of the JAX fp32 convolutions' DEFAULT
precision on the TPU.

Weights: :func:`load_torch_vgg16_features` imports torchvision's from a
local ``.pth`` (nothing is downloaded); otherwise :func:`init_vgg16_params`
draws a He-normal random trunk. A random trunk is not the torchvision loss:
a run records which one it used (``vgg_trunk`` in ``cli/pretrain.py``).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from cross_scale_mae_torch.ops.image import normalize_images, resize

# (out_channels, convs) of the VGG16 stages that vggloss.py taps.
_VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3))
# torchvision's indices of those convs inside ``features``.
_TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg16_shapes(in_channels: int = 3) -> dict[str, dict[str, tuple]]:
    """The trunk's tree of shapes, HWIO kernels, in the order of its convs."""
    shapes, c_in = {}, in_channels
    for stage, (c_out, n_convs) in enumerate(_VGG16_STAGES):
        for conv in range(n_convs):
            shapes[f"conv{stage}_{conv}"] = {"kernel": (3, 3, c_in, c_out), "bias": (c_out,)}
            c_in = c_out
    return shapes


def init_vgg16_params(gen: torch.Generator, in_channels: int = 3) -> dict[str, Any]:
    """A He-normal random trunk on ``gen``'s device: kernels
    normal * sqrt(2 / fan_in), zero biases."""
    params = {}
    for name, shape in vgg16_shapes(in_channels).items():
        fan_in = math.prod(shape["kernel"][:3])
        kernel = torch.randn(shape["kernel"], generator=gen, device=gen.device)
        params[name] = {"kernel": kernel * math.sqrt(2.0 / fan_in),
                        "bias": torch.zeros(shape["bias"], device=gen.device)}
    return params


def load_torch_vgg16_features(path: str, in_channels: int = 3) -> dict[str, Any]:
    """torchvision VGG16 ``features`` weights from a local ``.pth`` state
    dict, keyed ``features.N.weight`` (a whole VGG16) or ``N.weight`` (the
    features module alone), as fp32 CPU tensors with HWIO kernels. A kernel
    or bias of another shape than the trunk's raises ValueError."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    params = {}
    for (name, shape), i in zip(vgg16_shapes(in_channels).items(), _TORCHVISION_CONVS):
        key = f"features.{i}" if f"features.{i}.weight" in sd else str(i)
        params[name] = {"kernel": sd[f"{key}.weight"].float().permute(2, 3, 1, 0).contiguous(),
                        "bias": sd[f"{key}.bias"].float().clone()}
        for leaf, want in shape.items():
            if tuple(params[name][leaf].shape) != want:
                raise ValueError(f"{path}: {key} gives {name}/{leaf} of shape "
                                 f"{tuple(params[name][leaf].shape)}, expected {want}")
    return params


def _oihw(params: dict) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    return {name: (p["kernel"].permute(3, 2, 0, 1).contiguous(), p["bias"])
            for name, p in params.items()}


def _taps_nchw(weights: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """The four taps of NCHW ``x`` through the OIHW trunk."""
    taps = []
    for stage, (_, n_convs) in enumerate(_VGG16_STAGES):
        for conv in range(n_convs):
            w, b = weights[f"conv{stage}_{conv}"]
            x = torch.relu(F.conv2d(x, w.to(x.dtype), b.to(x.dtype), padding=1))
        taps.append(x)
        if stage < len(_VGG16_STAGES) - 1:
            x = F.max_pool2d(x, 2)
    return taps


def vgg16_features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """The activations after each stage's last relu, NHWC in and out."""
    taps = _taps_nchw(_oihw(params), x.permute(0, 3, 1, 2))
    return [t.permute(0, 2, 3, 1) for t in taps]


def _gram(f: torch.Tensor) -> torch.Tensor:
    a = f.flatten(2)  # (N, C, H*W)
    return a @ a.transpose(1, 2)


def perceptual_loss(params: dict, pred: torch.Tensor, target: torch.Tensor,
                    feature_layers: Sequence[int] = (0, 1, 2, 3),
                    style_layers: Sequence[int] = (),
                    resize_to: int | None = 224) -> torch.Tensor:
    """Feature L1 (and Gram style L1) between NHWC images in [0, 1]
    (util/vggloss.py:28-55): a channel count other than 3 repeats the first
    channel, both are ImageNet-normalized, and resized (bilinear) to
    ``resize_to`` unless None or already that size."""
    pred, target = pred.to(torch.float32), target.to(torch.float32)
    if pred.shape[-1] != 3:
        pred = pred[..., :1].expand(*pred.shape[:-1], 3)
        target = target[..., :1].expand(*target.shape[:-1], 3)
    pred = normalize_images(pred, _IMAGENET_MEAN, _IMAGENET_STD)
    target = normalize_images(target, _IMAGENET_MEAN, _IMAGENET_STD)
    if resize_to is not None and pred.shape[1] != resize_to:
        pred = resize(pred, resize_to, method="linear")
        target = resize(target, resize_to, method="linear")
    weights = _oihw(params)
    feats_p = _taps_nchw(weights, pred.permute(0, 3, 1, 2))
    feats_t = _taps_nchw(weights, target.permute(0, 3, 1, 2))
    loss = torch.zeros((), dtype=torch.float32, device=pred.device)
    for i, (fp, ft) in enumerate(zip(feats_p, feats_t)):
        if i in feature_layers:
            loss = loss + (fp - ft).abs().mean()
        if i in style_layers:
            loss = loss + (_gram(fp) - _gram(ft)).abs().mean()
    return loss
