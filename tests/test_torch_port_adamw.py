"""The fused AdamW kernel's host side (``ops/adamw.py``) on the CPU: the
launch table's per-leaf constants, the chunk and launch plan (with the
kernel's search for a block's leaf), the pointers and their alignment
flags, the rule that sends a leaf to the kernel or to the foreach chain,
and ``AdamW.update`` splitting its leaves between the two. The
trees are ViT-L's (the finetuning cell) and the flagship MAE's (the
pretraining cells) at full size, as fake tensors: shapes without storage.
The kernel itself runs on the card only (``tests/test_torch_port_cuda.py``).
"""

from unittest import mock

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from cross_scale_mae_torch import configs as pcfg
from cross_scale_mae_torch.models import vit
from cross_scale_mae_torch.models.mae import mae_init
from cross_scale_mae_torch.ops import adamw as fused
from cross_scale_mae_torch.train import optim
from cross_scale_mae_torch.train.state import tree_items, tree_leaves, tree_like

# The cells' optimizers (portbench/configs, cli/finetune.py's and
# cli/pretrain.py's defaults): ViT-L with layer decay 0.75 and no decay on
# pos_embed and cls_token; the MAE without layer decay.
TREES = {
    "vit_l": dict(b2=0.999, layer_decay=0.75, depth=24,
                  no_decay_names=("pos_embed", "cls_token")),
    "mae": dict(b2=0.95),
}
# A frozen mask per tree: the linear probe's (the head alone trains), and
# the MAE's decoder frozen.
FROZEN = {"vit_l": lambda path: path[0] == "head",
          "mae": lambda path: not path[0].startswith("decoder")}


def _tree(name: str) -> dict:
    """The tree's full-size params as fake tensors."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        if name == "mae":
            return mae_init(pcfg.get_mae_config("mae_vit_base_MsLdCeCd", input_size=128),
                            torch.Generator())[0]
        cfg = pcfg.get_vit_config("vit_large_patch16", input_size=64, patch_size=8,
                                  num_classes=62)
        # trunc_normal_ reads its draws back (data-dependent): zeros of the shape.
        with mock.patch.object(vit, "trunc_normal", lambda gen, shape, std: torch.zeros(shape)):
            return vit.vit_init(cfg, torch.Generator())[0]


@pytest.fixture(scope="module", params=sorted(TREES))
def tree(request):
    return request.param, _tree(request.param)


def _meta(params: dict) -> dict:
    """``params`` as meta tensors: shapes whose pointers read 0."""
    return tree_like(params, (torch.empty(p.shape, device="meta") for p in tree_leaves(params)))


def _launches(tx, params: dict) -> list:
    """What one ``tx.update`` of ``params`` hands the kernel, every leaf
    taken (the device check answering for the host's tensors): each
    launch's table and work items."""
    calls = []
    state = tx.init(params)
    leaves = tree_leaves(params)
    with mock.patch.object(fused, "DEVICE", leaves[0].device.type), \
            mock.patch.object(fused, "_launch", lambda table, blocks, *a, **kw:
                              calls.append((table, blocks))):
        tx.update(leaves, [torch.zeros_like(p) for p in leaves], state)
    assert tx.fused_share == 1.0
    return calls


@pytest.mark.parametrize("frozen", [False, True])
def test_launch_table_follows_decay_scales_and_frozen_mask(tree, frozen):
    """The launch's table: one record per trainable leaf, in tree order,
    with its element count, its first work item, wd where wd_mask marks it
    (0 elsewhere) and its layer-decay scale (1 without layer decay); frozen
    leaves left out; the grid every item of the chunk plan."""
    name, params = tree
    params = _meta(params)
    items = list(tree_items(params))
    mask = None
    if frozen:
        mask = tree_like(params, (FROZEN[name](path) for path, _ in items))
    kw = TREES[name]
    tx = optim.build_optimizer(params, lambda s: 1e-3, weight_decay=0.05, frozen_mask=mask,
                               **kw)
    [(table, blocks)] = _launches(tx, params)
    keep = [not frozen or FROZEN[name](path) for path, _ in items]
    decay = [d for d, k in zip(optim.wd_mask(params, kw.get("no_decay_names", ())), keep) if k]
    scales = ([s for s, k in zip(optim.layer_decay_scales(params, 0.75, 24), keep) if k]
              if "layer_decay" in kw else [1.0] * sum(keep))
    assert table.dtype == fused.LEAF and table.dtype.itemsize == 64
    assert table["n"].tolist() == [leaf.numel() for (_, leaf), k in zip(items, keep) if k]
    first = fused.first_items(table["n"])
    np.testing.assert_array_equal(table["first"], first[:-1])
    assert blocks == first[-1]
    np.testing.assert_array_equal(table["wd"], np.where(decay, np.float32(0.05), 0))
    np.testing.assert_array_equal(table["scale"], np.float32(scales))
    if name == "vit_l" and not frozen:
        assert sum(table["n"]) == 302_640_190 and len(table) == 296
        paths = [path for path, _ in items]
        head = paths.index(("head", "kernel"))
        assert table["wd"][head] == np.float32(0.05) and table["scale"][head] == 1.0
        assert table["wd"][paths.index(("pos_embed",))] == 0
        assert table["scale"][paths.index(("patch_embed", "kernel"))] == np.float32(0.75 ** 25)
    if name == "mae" and not frozen:
        assert sum(table["n"]) == 113_755_520 and set(table["scale"]) == {1.0}


def _blocks(first: np.ndarray, numels, chunk: int) -> list[np.ndarray]:
    """How many times the kernel's blocks cover each element of each leaf,
    each block finding its leaf as csrc/adamw.cu does: the last leaf whose
    first item is at most the block's index."""
    counts = [np.zeros(n, np.int64) for n in numels]
    for b in range(first[-1]):
        leaf = int(np.searchsorted(first[:-1], b, side="right")) - 1
        c = b - first[leaf]
        assert 0 <= c * chunk < numels[leaf]
        counts[leaf][c * chunk:(c + 1) * chunk] += 1
    return counts


@pytest.mark.parametrize("numels", [[1, 3, 62, 7, 8, 9], [0, 5, 0, 16, 17], [31, 32, 33, 0]])
def test_chunk_plan_covers_every_element_once_at_odd_lengths(numels):
    """Every element of every leaf in exactly one block, empty leaves (first,
    between and last) with none, the blocks of each leaf consecutive."""
    chunk = 8
    first = fused.first_items(numels, chunk)
    assert first.dtype == np.int64 and len(first) == len(numels) + 1
    assert first[-1] == sum(-(-n // chunk) for n in numels)
    assert all((c == 1).all() for c in _blocks(first, numels, chunk))


def test_chunk_plan_of_the_trees_fills_the_card(tree):
    """At the trees' own leaf sizes: the launch's grid within CUDA's limit,
    each leaf's chunks filling it with only the last ragged, and many waves
    of the 1,056 blocks an H100 holds at once (8 of 256 threads on each of
    132 SMs)."""
    _, params = tree
    numels = np.array([leaf.numel() for leaf in tree_leaves(params)])
    first = fused.first_items(numels)
    assert fused.CHUNK % 4 == 0 and (np.diff(first) >= 1).all()
    assert ((np.diff(first) - 1) * fused.CHUNK < numels).all()
    assert (np.diff(first) * fused.CHUNK >= numels).all()
    assert 8 * 1056 < first[-1] < 2 ** 31 - 1


@pytest.mark.parametrize("moment", [torch.float32, torch.bfloat16])
def test_launch_table_flags_views_that_are_not_aligned(moment):
    """The pointers as the kernel reads them, beside the constants, and the
    vector flag set only where all four pointers allow four-element loads
    and stores: views of flat buffers (FlatGrads' gradients, a ZeRO-1 chunk)
    after odd lengths are not 16-byte aligned, and one such pointer is
    enough to refuse."""
    sizes = [3, 61, 5, 16, 8, 12]
    wd, scales = [0.05, 0.0, 0.05, 0.05, 0.0, 0.05], [0.5, 0.6, 0.7, 0.8, 0.9, 1.0]

    def views(dtype, shift=0):
        flat = torch.zeros(sum(sizes) + shift, dtype=dtype)
        assert flat.data_ptr() % 16 == 0
        return list(flat[shift:].split(sizes))   # at 0, 3, 64, 69, 85, 93

    ps, gs, mu = views(torch.float32), views(torch.float32), views(moment)
    nu = [torch.zeros(n, dtype=moment) for n in sizes]
    table, blocks = fused.launch_table(ps, gs, mu, nu, wd, scales)
    assert table.dtype == fused.LEAF and blocks == 6
    assert table["n"].tolist() == sizes and table["first"].tolist() == [0, 1, 2, 3, 4, 5]
    np.testing.assert_array_equal(table["wd"], np.float32(wd))
    np.testing.assert_array_equal(table["scale"], np.float32(scales))
    for k, leaf in enumerate(zip(ps, gs, mu, nu)):
        assert [table[name][k] for name in "pgmv"] == [t.data_ptr() for t in leaf]
    assert table["vec"].tolist() == [1, 0, 1, 0, 0, 0]
    shifted, _ = fused.launch_table(ps, views(torch.float32, shift=1), mu, nu, wd, None)
    assert shifted["vec"].tolist() == [0] * len(sizes)
    assert set(shifted["scale"]) == {1.0}


def _leaf(shape=(6, 4), dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


RULE_CASES = {
    "fp32 leaf": ((_leaf(), _leaf(), _leaf(), _leaf()), True),
    "bf16 moments": ((_leaf(), _leaf(), _leaf(dtype=torch.bfloat16),
                      _leaf(dtype=torch.bfloat16)), True),
    "ZeRO-1 chunk on the leading axis": ((_leaf((7, 4)).chunk(2, 0)[1], _leaf((3, 4)),
                                          _leaf((3, 4)), _leaf((3, 4))), True),
    "ZeRO-1 chunk across the rows": ((_leaf((6, 4)).chunk(2, 1)[1], _leaf((6, 2)),
                                      _leaf((6, 2)), _leaf((6, 2))), False),
    "transposed gradient": ((_leaf((4, 6)), _leaf((6, 4)).t(), _leaf((4, 6)),
                             _leaf((4, 6))), False),
    "bf16 param": ((_leaf(dtype=torch.bfloat16), _leaf(dtype=torch.bfloat16),
                    _leaf(), _leaf()), False),
    "fp16 moment": ((_leaf(), _leaf(), _leaf(dtype=torch.float16), _leaf()), False),
    "bf16 gradient": ((_leaf(), _leaf(dtype=torch.bfloat16), _leaf(), _leaf()), False),
    "other shape": ((_leaf(), _leaf((24,)), _leaf(), _leaf()), False),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_sends_a_leaf_to_the_kernel_or_the_foreach_chain(case):
    """kernel_takes on each kind of leaf, with the host's device in the
    card's place; it also asks for the card, so on the CPU every leaf stays
    on the foreach chain."""
    leaf, fits = RULE_CASES[case]
    with mock.patch.object(fused, "DEVICE", "cpu"):
        assert fused.kernel_takes(*leaf) is fits
    assert fused.kernel_takes(*leaf) is False


@pytest.mark.parametrize("moments", [None, "bfloat16"])
def test_every_leaf_of_the_trees_fits_the_kernel(tree, moments):
    """The cells' leaves as the step hands them over: every param with the
    moments init makes (fp32, or bf16 for both) and a gradient of its own,
    or a view of FlatGrads' buffer (the four-card cell's), fits the kernel,
    so on the card every element goes to it (a fused share of 1)."""
    from cross_scale_mae_torch.parallel.mesh import FlatGrads

    name, params = tree
    tx = optim.build_optimizer(params, lambda s: 1e-3, mu_dtype=moments, nu_dtype=moments,
                               **TREES[name])
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = tx.init(params)
        leaves = tree_leaves(params)
        own = [torch.zeros_like(p) for p in leaves]
        views = FlatGrads(own).views
    with mock.patch.object(fused, "DEVICE", leaves[0].device.type):
        for grads in (own, views):
            assert all(fused.kernel_takes(*leaf)
                       for leaf in zip(leaves, grads, state.mu, state.nu))


def _adamw(mu_dtype=None, nu_dtype=None, scales=True, clip=None):
    """AdamW over five leaves, the third frozen."""
    return optim.AdamW(lambda s: 1e-2 * (s + 1), [True, False, True, True, False], b1=0.9,
                       b2=0.95, eps=1e-8, weight_decay=0.05, clip_grad=clip,
                       scales=[0.5, 0.6, 0.7, 0.8, 0.9] if scales else None,
                       trainable=[True, True, False, True, True], mu_dtype=mu_dtype,
                       nu_dtype=nu_dtype)


@pytest.mark.parametrize("dtypes", [(None, None), (torch.bfloat16, None),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("scales,clip", [(True, 0.3), (False, None)])
def test_update_splits_leaves_between_the_kernel_and_the_foreach_chain(dtypes, scales, clip):
    """With the rule answering for every other trainable leaf (as on the card
    for leaves it takes), each update launches once, for exactly those: the
    table holds their pointers, constants and first work items, the grid
    their chunks, and the arguments the step's count, lr, clip factor and
    rules; the foreach chain updates the others as it updates them alone;
    the kernel's leaves are left to the kernel; and fused_share is the
    kernel's share of the trainable elements."""
    shapes = [(4, 3), (7,), (2, 2), (5, 2), (3,)]
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(s, generator=gen) for s in shapes]
    grads = [torch.randn(s, generator=gen) for s in shapes]
    grads[4] = None   # a trainable leaf the objective did not reach
    tx, ref = _adamw(*dtypes, scales, clip), _adamw(*dtypes, scales, clip)
    ref_params = [p.clone() for p in params]
    state, ref_state = tx.init(params), ref.init(ref_params)
    ref.update(ref_params, grads, ref_state)
    ref_params2 = [p.clone() for p in ref_params]   # a second update on the foreach chain
    ref.update(ref_params2, grads, ref_state)
    trainable = [params[i] for i in tx.idx]        # leaves 0, 1, 3, 4
    picked = {id(trainable[0]), id(trainable[2])}
    calls = []

    def stand_in(table, blocks, clip_factor, device, **kw):
        calls.append((table, blocks, clip_factor, device, kw))

    before = [p.clone() for p in params]
    launches = fused.fused_adamw.launches
    with mock.patch.object(fused, "kernel_takes", lambda p, g, m, v: id(p) in picked), \
            mock.patch.object(fused, "_launch", stand_in):
        tx.update(params, grads, state)
        tx.update(params, grads, state)
    assert len(calls) == 2 and state.count == 2 and fused.fused_adamw.launches == launches + 2
    for k, (table, blocks, clip_factor, device, kw) in enumerate(calls):
        assert table.dtype == fused.LEAF and blocks == 2 and device == params[0].device
        assert table["p"].tolist() == [params[0].data_ptr(), params[3].data_ptr()]
        if clip is None:
            assert table["g"].tolist() == [grads[0].data_ptr(), grads[3].data_ptr()]
        assert table["m"].tolist() == [state.mu[0].data_ptr(), state.mu[2].data_ptr()]
        assert table["v"].tolist() == [state.nu[0].data_ptr(), state.nu[2].data_ptr()]
        assert table["n"].tolist() == [12, 10] and table["first"].tolist() == [0, 1]
        np.testing.assert_array_equal(table["wd"], np.float32([0.05, 0.05]))
        np.testing.assert_array_equal(table["scale"], np.float32([0.5, 0.8] if scales else 1))
        assert kw == dict(lr=1e-2 * (k + 1), b1=0.9, b2=0.95, eps=1e-8, count=k + 1,
                          scaled=scales, upcast_first=dtypes[1] is not None,
                          mu_dtype=state.mu[0].dtype, nu_dtype=state.nu[0].dtype)
        assert (clip_factor is None) == (clip is None)
    for i in (1, 4):                    # the foreach chain's leaves
        assert torch.equal(params[i], ref_params2[i])
        assert torch.equal(state.mu[tx.idx.index(i)], ref_state.mu[tx.idx.index(i)])
        assert torch.equal(state.nu[tx.idx.index(i)], ref_state.nu[tx.idx.index(i)])
    for i in (0, 2, 3):                 # the kernel's leaves, and the frozen one
        assert torch.equal(params[i], before[i])
    assert state.mu[0].abs().max() == 0 and state.nu[2].abs().max() == 0
    assert tx.fused_share == 1 - (7 + 3) / (12 + 7 + 10 + 3)


def test_update_on_the_cpu_launches_nothing():
    """On the CPU every leaf takes the foreach chain: no launch, a fused
    share of 0, and the wrapper returns every leaf as it was."""
    params = [torch.ones(4, 3), torch.ones(7)]
    tx = optim.build_optimizer({"a": {"kernel": params[0]}, "b": {"bias": params[1]}},
                               lambda s: 1e-3)
    state = tx.init({"a": {"kernel": params[0]}, "b": {"bias": params[1]}})
    before = fused.fused_adamw.launches
    assert tx.fused_share is None
    tx.update(params, [torch.ones(4, 3), torch.ones(7)], state)
    assert fused.fused_adamw.launches == before and tx.fused_share == 0.0
    assert (params[0] < 1).all()
    after = [p.clone() for p in params]
    assert fused.fused_adamw(params, params, state.mu, state.nu, [True, False], None, None,
                             lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=1e-4, count=2,
                             upcast_first=False) == [0, 1]
    assert fused.fused_adamw.launches == before
    assert all(torch.equal(p, q) for p, q in zip(params, after))
