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
BatchNorm state, optax's Adam moments and count, step) into the port's,
through ``train_state_flat_from_jax``, the mapping of any JAX TrainState
(pretrain, finetune, linear probe) to the port's flat state_dict, whose
inverse ``jax_train_state`` the Orbax writer uses; ``optax_layout`` is the
optax state's structure for each ``build_optimizer`` option;
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


def _from_numpy(value: Any) -> torch.Tensor:
    """A JAX leaf as a tensor of its dtype; numpy has no bfloat16 of its own
    (JAX's is ml_dtypes'), so a bf16 leaf goes through fp32, exactly. A
    tensor (``utils/orbax``'s bf16 leaves) is taken as it is."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


COUNT = "count"


def optax_layout(tx) -> Any:
    """The structure of the JAX package's optax state for the options the
    port's optimizer ``tx`` was built with (``train/optim.build_optimizer``;
    the JAX ``build_optimizer``'s chain), as a host restore holds it: dicts
    for optax's NamedTuple states, lists for chains and tuples, and as
    leaves ``"count"`` (the step count), ``"mu"`` or ``"nu"`` (a moment tree
    shaped like the params; SGD's ``trace`` is the port's ``mu``) and None
    (an empty state). The chain is [clip] + the optimizer + [layer decay],
    inside ``optax.masked`` when a frozen mask was given; AdamW is optax's
    ``adamw`` (a chain of its own), or with ``nu_dtype`` the JAX package's
    ``scale_by_adam_moment_dtypes``, weight decay and lr in the outer chain."""
    from cross_scale_mae_torch.train.optim import AdamW, Lars, Sgd

    if isinstance(tx, Sgd):
        core = [[{"trace": "mu"}, {"count": COUNT}]]
    elif isinstance(tx, Lars):
        core = [[{"mu": "mu"}, COUNT]]
    elif isinstance(tx, AdamW):
        adam = [{"count": COUNT, "mu": "mu", "nu": "nu"}, {"inner_state": None},
                {"count": COUNT}]
        core = adam if tx.upcast_first else [adam]
    else:
        raise ValueError(f"optimizer {type(tx).__name__}: no known optax state structure "
                         "(build it with train/optim.build_optimizer)")
    chain = [None] * (tx.clip_grad is not None) + core + [None] * (tx.scales is not None)
    return [{"inner_state": chain}, {"inner_state": None}] if tx.masked else chain


def _plain(node: Any) -> Any:
    """A live JAX state's node as a host restore holds it: a NamedTuple as
    a dict, a tuple as a list, an empty one (optax's EmptyState, a frozen
    leaf's MaskedNode) as None."""
    if hasattr(node, "_asdict"):
        node = dict(node._asdict())
    elif isinstance(node, tuple):
        node = list(node)
    return None if isinstance(node, (dict, list)) and not node else node


def opt_state_from_jax(opt_state: Any, tx) -> dict[str, torch.Tensor]:
    """The port's flat optimizer state (``count``, ``mu/<path>``,
    ``nu/<path>``; a frozen leaf has none) from the JAX optax state
    ``opt_state`` (live, or a host restore's dicts and lists), every node
    placed by :func:`optax_layout` of ``tx``. A node that does not fit, or
    step counts that disagree, raise naming the node's path: a state the
    port cannot place is refused, never restarted from zero."""
    flat: dict[str, torch.Tensor] = {}
    counts: list[int] = []

    def refuse(path, node, want):
        got = type(node).__name__ if not isinstance(node, Mapping) else f"keys {sorted(node)}"
        raise ValueError(f"{path}: the JAX optimizer state holds {got} where the port's "
                         f"{type(tx).__name__} has {want}: the two runs' optimizer options "
                         "differ (optimizer, clip_grad, nu_dtype, layer_decay, frozen mask)")

    def walk(node, spec, path):
        node = _plain(node)
        if spec is None:
            if node is not None:
                refuse(path, node, "an empty state")
        elif spec == COUNT:
            if node is None or isinstance(node, (Mapping, list)) or np.ndim(node):
                refuse(path, node, "a step count")
            counts.append(int(np.asarray(node)))
        elif isinstance(spec, str):
            if not isinstance(node, Mapping):
                refuse(path, node, f"the moment tree {spec}")
            flat.update({k: _from_numpy(v) for k, v in jax_paths(node, spec).items()})
        elif isinstance(spec, dict):
            if not isinstance(node, Mapping) or set(node) != set(spec):
                refuse(path, node, f"keys {sorted(spec)}")
            for k in spec:
                walk(node[k], spec[k], f"{path}/{k}")
        else:
            if not isinstance(node, list) or len(node) != len(spec):
                refuse(path, node, f"a sequence of {len(spec)}")
            for i, (child, sub) in enumerate(zip(node, spec)):
                walk(child, sub, f"{path}/{i}")

    walk(opt_state, optax_layout(tx), "opt_state")
    if len(set(counts)) != 1:
        raise ValueError(f"opt_state: the step counts {counts} disagree")
    flat[COUNT] = torch.tensor(counts[0])
    return flat


def opt_state_to_jax(flat: Mapping[str, Any], tx, param_paths: list[str]) -> Any:
    """The inverse of :func:`opt_state_from_jax`: the port's flat optimizer
    state (``count``, ``mu/<path>``, ...) as the JAX optax state of the
    options ``tx`` was built with; ``param_paths`` are the params'
    '/'-joined paths (a frozen leaf's moment is None, a MaskedNode)."""
    count = np.asarray(int(flat[COUNT]), np.int32)

    def moments(name):
        tree: dict = {}
        for path in param_paths:
            value = flat.get(f"{name}/{path}")
            if value is None and not tx.masked:
                raise KeyError(f"the optimizer state lacks {name}/{path}")
            _put(tree, path.split("/"), value)
        return tree

    def build(spec):
        if spec is None:
            return None
        if spec == COUNT:
            return count
        if isinstance(spec, str):
            return moments(spec)
        if isinstance(spec, dict):
            return {k: build(v) for k, v in spec.items()}
        return [build(v) for v in spec]

    return build(optax_layout(tx))


def _put(tree: dict, parts: list[str], value: Any) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def train_state_flat_from_jax(state: Any, tx) -> dict[str, torch.Tensor]:
    """The port's flat ``TrainState.state_dict`` (``params/...``,
    ``model_state/...``, ``opt_state/...``, ``step``; host tensors) of a JAX
    TrainState: a live one, or the dict of ``restore_arrays_host(...,
    subset=None)`` from the JAX package or ``utils/orbax``. The optimizer
    state is placed by :func:`opt_state_from_jax` for ``tx``."""
    def get(key):
        return state[key] if isinstance(state, Mapping) else getattr(state, key)

    flat = {k: _from_numpy(v) for prefix in ("params", "model_state")
            for k, v in jax_paths(get(prefix), prefix).items()}
    flat.update({f"opt_state/{k}": v for k, v in opt_state_from_jax(get("opt_state"),
                                                                       tx).items()})
    flat["step"] = torch.tensor(int(np.asarray(get("step"))))
    return flat


def jax_train_state(flat: Mapping[str, Any], tx) -> dict[str, Any]:
    """The inverse of :func:`train_state_flat_from_jax`: the JAX TrainState
    tree (``params``, ``model_state``, ``opt_state``, ``step``; the step and
    counts int32, as JAX keeps them) of the port's flat state_dict, for the
    options ``tx`` was built with."""
    trees: dict[str, dict] = {"params": {}, "model_state": {}}
    opt = {}
    for key, value in flat.items():
        top, _, rest = key.partition("/")
        if top in trees:
            _put(trees[top], rest.split("/"), value)
        elif top == "opt_state":
            opt[rest] = value
    param_paths = [k[len("params/"):] for k in flat if k.startswith("params/")]
    return {**trees, "opt_state": opt_state_to_jax(opt, tx, param_paths),
            "step": np.asarray(int(flat["step"]), np.int32)}


def train_state_from_jax(state: Any, cfg: MAEConfig, tx,
                         device: torch.device | str = "cpu") -> TrainState:
    """A JAX pretrain TrainState as the port's: its params, BatchNorm
    state, optax Adam moments and count and its step, restored into a
    state made with ``tx`` (the port's AdamW for the same options, the
    moment dtypes included: bf16 moments restore only into bf16 ones).
    ``state`` is a JAX TrainState or the dict of
    ``restore_arrays_host(..., subset=None)``; the mapping is
    :func:`train_state_flat_from_jax`, bf16 leaves carried exactly."""
    def get(key):
        return state[key] if isinstance(state, Mapping) else getattr(state, key)

    params = params_from_jax(get("params"), cfg, device, full=True)
    out = TrainState.create(params, state_from_jax(get("model_state"), cfg, device), tx)
    return out.load_state_dict(train_state_flat_from_jax(state, tx))


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
