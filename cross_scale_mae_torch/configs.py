"""Typed model and training configs and the string-name registry.

A copy of ``MAEConfig``, ``get_mae_config`` and ``TrainConfig`` from
``cross_scale_mae_tpu/configs.py`` (the port may not import the JAX
package). The JSON written by either package's ``to_json`` reads back in the
other: the field sets are equal and a test holds them so.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Mapping

# GELU flavors (models/layers.py: mlp). 'tanh' = the approximation;
# 'exact' = erf GELU; 'exact_tanhbwd' = exact forward with the tanh-GELU
# derivative as backward (the forward is what serving runs).
GELU_MODES = ("tanh", "exact", "exact_tanhbwd")


@dataclass(frozen=True)
class ViTSize:
    """Encoder/decoder stack dimensions (reference: models_mae/__init__.py:23-67)."""

    dim_model: int
    encoder_num_layers: int
    encoder_num_heads: int
    decoder_embed_dim: int
    decoder_num_layers: int
    decoder_num_heads: int


VIT_SIZES: Mapping[str, ViTSize] = {
    "tiny": ViTSize(128, 4, 8, 256, 4, 8),
    "small": ViTSize(512, 8, 8, 512, 8, 16),
    "base": ViTSize(768, 12, 12, 512, 8, 16),
    "large": ViTSize(1024, 24, 16, 512, 8, 16),
    "huge": ViTSize(1280, 32, 16, 512, 8, 16),
}


@dataclass(frozen=True)
class MAEConfig:
    """Full Cross-Scale-MAE model configuration (same fields and defaults as
    the JAX package's ``MAEConfig``; see its docstrings for each field)."""

    input_size: int = 128
    input_channels: int = 3
    patch_size: int = 16
    mask_ratio: float = 0.75

    dim_model: int = 768
    encoder_num_layers: int = 12
    encoder_num_heads: int = 12
    decoder_embed_dim: int = 512
    decoder_num_layers: int = 8
    decoder_num_heads: int = 16
    ffn_ratio: int = 4

    loss: str = "mse"
    norm_pix_loss: bool = False

    # Reference quirk (MAE_ViT_Baseline.py:264): the encoder norm's output is
    # discarded. False matches released checkpoints; True applies it.
    apply_encoder_norm: bool = False

    multi_scale: bool = False
    ms_range: tuple[float, float] = (0.25, 0.75)
    ms_aspect_ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    ms_decoder_loss_reduction: str = "sum"
    ms_per_sample_crop: bool = True

    use_le: bool = False
    use_ce_pred: bool = False
    use_cd_pred: bool = False
    use_ce_ntxent: bool = False
    loss_e: str | None = None
    loss_ce: str | None = None
    loss_cd: str | None = None
    ntxent_tau: float = 0.5
    ntxent_cos_sim: bool = True
    predictor_hidden_size: int = 2048

    use_perceptual: bool = False
    perceptual_weight: float = 1.0

    # "pre" = timm Block (x + f(ln(x))); "post" = xFormers post-norm.
    residual_norm_style: str = "pre"

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attention_impl: str = "xla"
    # Layout knobs of the JAX package (jax.checkpoint, flat carry, scan vs
    # unrolled). They change how the work is laid out, not the math, so the
    # port's forward runs the same loop for every setting.
    remat: bool = False
    gelu: str = "tanh"
    flat_blocks: bool = False
    sequence_parallel: bool = False
    scan_blocks: bool = True

    @property
    def grid_size(self) -> int:
        if self.input_size % self.patch_size:
            raise ValueError(
                f"input_size {self.input_size} is not a multiple of "
                f"patch_size {self.patch_size}")
        return self.input_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def len_keep(self) -> int:
        return int(self.num_patches * (1 - self.mask_ratio))

    @property
    def patch_dim(self) -> int:
        return self.patch_size ** 2 * self.input_channels

    def loss_name(self, term: str) -> str:
        """The loss of a latent term ('e', 'ce', 'cd'): its own, else ``loss``."""
        value = {"e": self.loss_e, "ce": self.loss_ce, "cd": self.loss_cd}[term]
        return (value or self.loss).lower()

    def replace(self, **kw: Any) -> "MAEConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "MAEConfig":
        d = json.loads(s)
        for k in ("ms_range", "ms_aspect_ratio"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        # Checkpoint-compat: configs written before the gelu field existed
        # were trained with exact GELU.
        d.setdefault("gelu", "exact")
        if d["gelu"] not in GELU_MODES:
            raise ValueError(f"unknown gelu flavor {d['gelu']!r}")
        # Execution-layout detail, not model semantics: rehydrated configs
        # never run sequence-parallel.
        d["sequence_parallel"] = False
        return cls(**d)


# Variant flag sets (models_mae/__init__.py:71-124).
_VARIANTS: Mapping[str, Mapping[str, Any]] = {
    "": {},
    "MsLd": dict(multi_scale=True),
    "MsLdLe": dict(multi_scale=True, use_le=True),
    "MsLdCe": dict(multi_scale=True, use_ce_pred=True),
    "MsLdCd": dict(multi_scale=True, use_cd_pred=True),
    "MsLdCeCd": dict(multi_scale=True, use_cd_pred=True, use_ce_ntxent=True),
    "MsLdLeCd": dict(multi_scale=True, use_le=True, use_cd_pred=True),
}


def get_mae_config(name: str, **overrides: Any) -> MAEConfig:
    """Resolve a reference-style model name (e.g. ``mae_vit_base_MsLdCeCd``)."""
    if not name.startswith("mae_vit_"):
        raise ValueError(f"unknown model name: {name!r}")
    rest = name[len("mae_vit_"):]
    parts = rest.split("_", 1)
    size_name = parts[0]
    variant = parts[1] if len(parts) > 1 else ""
    if size_name not in VIT_SIZES:
        raise ValueError(f"unknown ViT size {size_name!r} in {name!r}")
    if variant not in _VARIANTS:
        raise ValueError(f"unknown variant {variant!r} in {name!r}")
    size = VIT_SIZES[size_name]
    kw: dict[str, Any] = dict(
        dim_model=size.dim_model,
        encoder_num_layers=size.encoder_num_layers,
        encoder_num_heads=size.encoder_num_heads,
        decoder_embed_dim=size.decoder_embed_dim,
        decoder_num_layers=size.decoder_num_layers,
        decoder_num_heads=size.decoder_num_heads,
    )
    kw.update(_VARIANTS[variant])
    kw.update(overrides)
    return MAEConfig(**kw)


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and runtime knobs (same fields and defaults as the
    JAX package's ``TrainConfig``)."""

    epochs: int = 400
    warmup_epochs: int = 40
    batch_size: int = 512            # global batch per optimizer step
    accum_iter: int = 1
    blr: float = 5e-5                # lr = blr * eff_batch / 256
    lr: float | None = None
    min_lr: float = 0.0
    weight_decay: float = 0.05
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    clip_grad: float | None = None
    layer_decay: float | None = None
    optimizer: str = "adamw"          # "adamw" | "lars" | "sgd"
    lars_momentum: float = 0.9
    lars_trust_coefficient: float = 0.001
    label_smoothing: float = 0.1
    mixup: float = 0.0
    cutmix: float = 0.0
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    mixup_mode: str = "batch"        # "batch" | "pair" | "elem"
    cutmix_minmax: "tuple[float, float] | None" = None
    seed: int = 0
    log_interval: int = 20
    ckpt_interval_epochs: int = 25
    mask_seed: int | None = None
    consistent_mask: bool = False
    watch_gradients: bool = False

    def resolved_lr(self, world_batch: int) -> float:
        if self.lr is not None:
            return self.lr
        return self.blr * world_batch / 256.0

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        return cls(**json.loads(s))
