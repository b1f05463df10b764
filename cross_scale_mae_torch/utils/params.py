"""The weight carry between the JAX package's parameter tree and the port's.

The JAX package keeps parameters as a nested dict with linear kernels in
(in, out) layout and every block leaf stacked on a leading (layers, ...)
axis. The port keeps the (in, out) layout (``layers.linear`` computes
``x @ W + b``), so nothing is transposed; the carry unstacks the block
leaves into a list of per-layer dicts. ``params_from_jax`` keeps only what
the encoder runs (serving, as the JAX package's ``serving.py:94-97``) or,
with ``full=True``, the whole tree the training step runs;
``state_from_jax`` carries the predictors' BatchNorm statistics and the
perceptual loss's VGG16 trunk (HWIO kernels, kept so);
``train_state_from_jax`` carries a whole JAX pretrain TrainState (params,
BatchNorm state, optax's Adam moments and count, step) into the port's;
``vit_params_from_jax`` carries the downstream classifier's tree;
``params_to_jax`` is the way back for every tree. A tree quantized by the
JAX package's ``quantize_params_int8`` (``{"__int8__", "scale"}`` kernel
nodes, as a ``.q8.npz`` holds them) carries both ways, its codes int8.
``mae_encoder_to_classifier`` and ``merge_pretrained`` start a classifier
from a pretrained encoder, as the JAX package's
``utils/torch_import.py:157-221`` do.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from cross_scale_mae_torch.configs import MAEConfig, ViTClassifierConfig
from cross_scale_mae_torch.losses.perceptual import vgg16_shapes
from cross_scale_mae_torch.quant import QKEY
from cross_scale_mae_torch.train.state import TrainState, jax_paths


def _linear_shapes(d_in: int, d_out: int, lead: tuple = ()) -> dict:
    return {"kernel": (*lead, d_in, d_out), "bias": (*lead, d_out)}


def _norm_shapes(dim: int, lead: tuple = ()) -> dict:
    return {"scale": (*lead, dim), "bias": (*lead, dim)}


def _block_shapes(dim: int, hidden: int, layers: int, attn_variant: str = "xla",
                  seq_len: int = 0) -> dict:
    """A block stack's shapes; a linformer stack's attention also holds E
    and F, (seq_len, max(seq_len // 4, 1)) each (``layers.block_init``)."""
    lead = (layers,)
    attn = {"qkv": _linear_shapes(dim, 3 * dim, lead), "proj": _linear_shapes(dim, dim, lead)}
    if attn_variant == "linformer":
        attn["e_proj"] = attn["f_proj"] = (layers, seq_len, max(seq_len // 4, 1))
    return {
        "norm1": _norm_shapes(dim, lead),
        "attn": attn,
        "norm2": _norm_shapes(dim, lead),
        "mlp": {"fc1": _linear_shapes(dim, hidden, lead),
                "fc2": _linear_shapes(hidden, dim, lead)},
    }


def encoder_param_shapes(cfg: MAEConfig) -> dict:
    """Shapes of the encoder subtrees in the JAX layout (blocks stacked)."""
    d = cfg.dim_model
    shapes = {
        "patch_embed": _linear_shapes(cfg.patch_dim, d),
        "cls_token": (1, 1, d),
        "encoder_blocks": _block_shapes(d, d * cfg.ffn_ratio, cfg.encoder_num_layers,
                                        cfg.attention_impl, cfg.num_patches + 1),
    }
    if cfg.apply_encoder_norm:
        shapes["encoder_norm"] = _norm_shapes(d)
    return shapes


def mae_param_shapes(cfg: MAEConfig) -> dict:
    """Shapes of the whole tree of the JAX package's ``mae_init`` (blocks
    stacked): encoder, decoder, tokens and the configured predictors."""
    d, dd = cfg.dim_model, cfg.decoder_embed_dim
    spec = encoder_param_shapes(cfg.replace(apply_encoder_norm=True))
    spec.update({
        "mask_token": (1, 1, dd),
        "decoder_embed": _linear_shapes(d, dd),
        "decoder_blocks": _block_shapes(dd, dd * cfg.ffn_ratio, cfg.decoder_num_layers,
                                        cfg.attention_impl, cfg.num_patches + 1),
        "decoder_norm": _norm_shapes(dd),
        "decoder_pred": _linear_shapes(dd, cfg.patch_dim),
    })
    hidden = cfg.predictor_hidden_size
    if cfg.use_cd_pred:
        spec["predictor_cd"] = {"fc1": _linear_shapes(dd, hidden),
                                "bn": _norm_shapes(cfg.num_patches),
                                "fc2": _linear_shapes(hidden, dd)}
    if cfg.use_ce_pred:
        spec["predictor_ce"] = {"fc1": _linear_shapes(d, hidden),
                                "bn": _norm_shapes(cfg.len_keep),
                                "fc2": _linear_shapes(hidden, d)}
    return spec


def mae_state_shapes(cfg: MAEConfig) -> dict:
    """Shapes of the JAX ``mae_init`` state: predictor BatchNorm statistics
    and, with ``use_perceptual``, the VGG16 trunk (HWIO kernels, the layout
    the port keeps too)."""
    spec = {}
    if cfg.use_perceptual:
        spec["vgg"] = vgg16_shapes(cfg.input_channels)
    if cfg.use_cd_pred:
        spec["predictor_cd"] = {"bn": {"mean": (cfg.num_patches,),
                                       "var": (cfg.num_patches,)}}
    if cfg.use_ce_pred:
        spec["predictor_ce"] = {"bn": {"mean": (cfg.len_keep,), "var": (cfg.len_keep,)}}
    return spec


def vit_param_shapes(cfg: ViTClassifierConfig) -> dict:
    """Shapes of the JAX ``vit_init`` tree (blocks stacked)."""
    d = cfg.embed_dim
    shapes = {
        "patch_embed": _linear_shapes(cfg.patch_size ** 2 * cfg.input_channels, d),
        "cls_token": (1, 1, d),
        "pos_embed": (1, cfg.num_patches + 1, d),
        "blocks": _block_shapes(d, d * cfg.mlp_ratio, cfg.depth, cfg.attention_impl,
                                cfg.num_patches + 1),
        "head": _linear_shapes(d, cfg.num_classes),
    }
    shapes["fc_norm" if cfg.global_pool else "norm"] = _norm_shapes(d)
    return shapes


def _checked_qnode(node: Mapping, spec: tuple, path: str) -> dict:
    """An int8 kernel node of ``quant.py`` (a JAX ``quantize_params_int8``
    tree's, or a ``.q8.npz``'s): int8 codes of the kernel's shape and fp32
    scales with the ``in`` axis kept as 1."""
    if set(node) != {QKEY, "scale"}:
        raise KeyError(f"{path}: an int8 node holds {QKEY} and scale, got {sorted(node)}")
    codes, scale = np.asarray(node[QKEY]), np.asarray(node["scale"])
    want = (*spec[:-2], 1, spec[-1])
    if codes.shape != spec or codes.dtype != np.int8:
        raise ValueError(f"{path}/{QKEY}: {codes.dtype} {codes.shape}, expected int8 {spec}")
    if scale.shape != want:
        raise ValueError(f"{path}/scale: shape {scale.shape}, expected {want}")
    return {QKEY: codes, "scale": scale.astype(np.float32)}


def _checked(node: Any, spec: Any, path: str) -> Any:
    if isinstance(node, Mapping) and QKEY in node and isinstance(spec, tuple):
        return _checked_qnode(node, spec, path)
    if isinstance(spec, dict):
        if not isinstance(node, Mapping):
            raise ValueError(f"{path}: expected a subtree, got {type(node).__name__}")
        missing = sorted(set(spec) - set(node))
        extra = sorted(set(node) - set(spec))
        if missing:
            raise KeyError(f"parameter tree lacks {path}/{missing[0]}")
        if extra:
            raise KeyError(f"unexpected parameter {path}/{extra[0]}")
        return {k: _checked(node[k], spec[k], f"{path}/{k}") for k in spec}
    arr = np.asarray(node)
    if arr.shape != spec:
        raise ValueError(f"{path}: shape {arr.shape}, expected {spec}")
    return arr.astype(np.float32)


def _to_torch(tree: Any, device, index: int | None = None) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    arr = tree if index is None else tree[index]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def params_from_jax(tree: Mapping[str, Any], cfg: MAEConfig,
                    device: torch.device | str = "cpu", *,
                    full: bool = False) -> dict[str, Any]:
    """Map a JAX MAE parameter tree (nested dict of numpy arrays) to the
    port's params: fp32 tensors on ``device``, with each ``*_blocks`` stack
    a list of per-layer dicts.

    By default only the encoder's subtrees are kept and the others
    (decoder, mask token, predictors) dropped. ``full=True`` carries the
    whole ``mae_init`` tree and refuses any other top-level key. A missing
    key, an unexpected key inside a kept subtree or a wrong shape raises."""
    spec = mae_param_shapes(cfg) if full else encoder_param_shapes(cfg)
    if full:
        extra = sorted(set(tree) - set(spec))
        if extra:
            raise KeyError(f"unexpected parameter {extra[0]}")
    checked = {}
    for key, sub in spec.items():
        if key not in tree:
            raise KeyError(f"parameter tree lacks {key}")
        checked[key] = _checked(tree[key], sub, key)
    depth = {"encoder_blocks": cfg.encoder_num_layers,
             "decoder_blocks": cfg.decoder_num_layers}
    return {k: ([_to_torch(v, device, i) for i in range(depth[k])] if k in depth
                else _to_torch(v, device))
            for k, v in checked.items()}


def vit_params_from_jax(tree: Mapping[str, Any], cfg: ViTClassifierConfig,
                        device: torch.device | str = "cpu") -> dict[str, Any]:
    """Map a JAX classifier parameter tree (nested dict of numpy arrays) to
    the port's: fp32 tensors on ``device``, ``blocks`` a list of per-layer
    dicts. A missing or unexpected key or a wrong shape raises."""
    spec = vit_param_shapes(cfg)
    extra = sorted(set(tree) - set(spec))
    if extra:
        raise KeyError(f"unexpected parameter {extra[0]}")
    out = {}
    for key, sub in spec.items():
        if key not in tree:
            raise KeyError(f"parameter tree lacks {key}")
        arr = _checked(tree[key], sub, key)
        out[key] = ([_to_torch(arr, device, i) for i in range(cfg.depth)]
                    if key == "blocks" else _to_torch(arr, device))
    return out


def state_from_jax(state: Mapping[str, Any], cfg: MAEConfig,
                   device: torch.device | str = "cpu") -> dict[str, Any]:
    """The JAX ``mae_init`` state (predictor BatchNorm statistics, the VGG16
    trunk) as fp32 tensors on ``device``; the same checks as
    :func:`params_from_jax`."""
    return _to_torch(_checked(state, mae_state_shapes(cfg), "state"), device)


def _adam_state(node: Any) -> Mapping | None:
    """The Adam state (``count``, ``mu``, ``nu``) inside a chain's state:
    optax's ``ScaleByAdamState`` or the JAX package's own
    (``scale_by_adam_moment_dtypes``, with ``--adam_nu_dtype``), a
    namedtuple in a live JAX TrainState, a dict in a host restore; its place
    in the chain depends on the options (clipping comes first)."""
    if hasattr(node, "_asdict"):
        node = node._asdict()
    if isinstance(node, Mapping):
        if "mu" in node and "nu" in node:
            return node
        children = list(node.values())
    elif isinstance(node, (list, tuple)):
        children = list(node)
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def _from_numpy(value: Any) -> torch.Tensor:
    """A JAX leaf as a tensor of its dtype; numpy has no bfloat16 of its own
    (JAX's is ml_dtypes'), so a bf16 leaf goes through fp32, exactly."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def train_state_from_jax(state: Any, cfg: MAEConfig, tx,
                         device: torch.device | str = "cpu") -> TrainState:
    """A JAX pretrain TrainState as the port's: its params, BatchNorm
    state, optax Adam moments and count and its step, restored into a
    state made with ``tx`` (the port's AdamW for the same options, the
    moment dtypes included: bf16 moments restore only into bf16 ones).
    ``state`` is a JAX TrainState or the dict of
    ``restore_arrays_host(..., subset=None)``; leaves go through numpy,
    bf16 ones exactly through fp32."""
    def get(key):
        return state[key] if isinstance(state, Mapping) else getattr(state, key)

    adam = _adam_state(get("opt_state"))
    if adam is None:
        raise ValueError("the JAX optimizer state holds no Adam moments (mu, nu)")
    params = params_from_jax(get("params"), cfg, device, full=True)
    out = TrainState.create(params, state_from_jax(get("model_state"), cfg, device), tx)
    trees = {"params": get("params"), "model_state": get("model_state"),
             "opt_state/mu": adam["mu"], "opt_state/nu": adam["nu"]}
    flat = {k: _from_numpy(v).to(device)
            for prefix, tree in trees.items() for k, v in jax_paths(tree, prefix).items()}
    flat["opt_state/count"] = torch.tensor(int(np.asarray(adam["count"])))
    flat["step"] = torch.tensor(int(np.asarray(get("step"))))
    return out.load_state_dict(flat)


def params_to_jax(tree: Any) -> Any:
    """The inverse carry: the port's params or state (tensors, block stacks
    as lists) -> the JAX layout as numpy arrays (fp32; int8 codes stay
    int8), block leaves stacked on a leading layer axis."""
    if isinstance(tree, Mapping):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        layers = [params_to_jax(v) for v in tree]
        return _stack(layers)
    if tree.dtype == torch.int8:
        return tree.detach().cpu().numpy()
    return tree.detach().to("cpu", torch.float32).numpy()


def _stack(layers: list) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers, axis=0)


def random_mae_tree(cfg: MAEConfig, seed: int) -> dict[str, Any]:
    """A seeded random MAE parameter tree in the JAX layout, with the JAX
    package's full set of subtrees (encoder, decoder, predictors) so that a
    file written from it exercises the carry's drop. Kernels are
    xavier-uniform as in ``mae_init``; biases, norm parameters and tokens are
    small random values, so that no parameter is a constant a wrong mapping
    could hide behind."""
    return _random_tree(mae_param_shapes(cfg), seed)


def random_vit_tree(cfg: ViTClassifierConfig, seed: int) -> dict[str, Any]:
    """A seeded random classifier tree in the JAX layout (``vit_init``'s
    keys), drawn as :func:`random_mae_tree` draws."""
    return _random_tree(vit_param_shapes(cfg), seed)


def _random_tree(shapes: dict, seed: int) -> dict[str, Any]:
    rng = np.random.default_rng(seed)

    def draw(shape, name):
        if name == "kernel":
            fan_in, fan_out = shape[-2], shape[-1]
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            return rng.uniform(-lim, lim, shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)

    def fill(spec, name=""):
        if isinstance(spec, dict):
            return {k: fill(v, k) for k, v in spec.items()}
        return draw(spec, name)

    return fill(shapes)


def mae_encoder_to_classifier(mae_params: Mapping[str, Any], cfg: ViTClassifierConfig
                              ) -> tuple[dict[str, Any], list[str]]:
    """The classifier subtrees a pretrained MAE encoder provides, and the
    top-level keys it leaves fresh: pos_embed and head always, fc_norm with
    the global-pool head (else ``norm`` comes from the encoder norm). A
    linformer encoder's blocks bring their E and F along."""
    out = {"patch_embed": mae_params["patch_embed"],
           "cls_token": mae_params["cls_token"],
           "blocks": mae_params["encoder_blocks"]}
    missing = ["pos_embed", "head"]
    if cfg.global_pool:
        missing.append("fc_norm")
    else:
        out["norm"] = mae_params["encoder_norm"]
    return out, missing


def merge_pretrained(template: Mapping[str, Any], pretrained: Mapping[str, Any],
                     _path: str = "") -> dict[str, Any]:
    """Overlay pretrained subtrees onto a fresh template (load_state_dict
    with strict=False and shape checks). Keys the template lacks are
    skipped; a shape or depth mismatch raises naming the parameter. Leaves
    take the template's dtype and device."""
    out = dict(template)
    for k, v in pretrained.items():
        if k not in template:
            continue
        key = f"{_path}/{k}" if _path else str(k)
        t = template[k]
        if isinstance(t, Mapping) and isinstance(v, Mapping):
            out[k] = merge_pretrained(t, v, key)
        elif isinstance(t, list) and isinstance(v, list):
            if len(t) != len(v):
                raise ValueError(_misfit(key, f"{len(v)} layers", f"{len(t)}"))
            out[k] = [merge_pretrained(a, b, f"{key}/{i}") for i, (a, b) in enumerate(zip(t, v))]
        else:
            if tuple(t.shape) != tuple(v.shape):
                raise ValueError(_misfit(key, f"shape {tuple(v.shape)}", f"{tuple(t.shape)}"))
            out[k] = v.to(dtype=t.dtype, device=t.device)
    return out


def _misfit(key: str, got: str, want: str) -> str:
    return (f"pretrained checkpoint does not fit this model: param '{key}' has {got} "
            f"in the checkpoint but {want} in the model — check "
            "--model/--embed_dim/--depth/--num_heads against the pretrained encoder's size")
