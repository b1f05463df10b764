"""The PyTorch port's data layer (cross_scale_mae_torch/data/datasets.py,
data/loader.py) and the NAIP rotation (ops/image.random_rot90, the rot90
chains of ops/augment.py) held against the JAX package on the CPU.

The loaders must yield the same batches bit for bit: the same epoch
permutations, the same drop_last truncation before the shards' strides, the
same decode (PIL's bicubic resize, NAIP's CHW and dtype handling). Both
sides run their Python loaders (``use_native=False``); the native cores
are held against each other in ``tests/test_torch_port_data_multiband.py``. Augmentation on injected JAX draws: fp32 atol 1e-5 (sums in
another order); bf16 one bf16 ulp of the largest value, as the pretrain
chain's test in tests/test_torch_port_train.py.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu.data import datasets as jds
from cross_scale_mae_torch.data import datasets as pds


def _write_fmow(root, n=11):
    """An fMoW-RGB CSV over PNGs of varying sizes, so that the loader
    resizes them to its canvas with PIL's bicubic filter."""
    from PIL import Image

    rng = np.random.default_rng(0)
    rows = ["category,image_path"]
    for i in range(n):
        side = 12 + 3 * (i % 4)
        Image.fromarray(rng.integers(0, 256, (side, side + i % 2, 3), np.uint8)).save(
            root / f"img_{i}.png")
        rows.append(f"{i % 3},img_{i}.png")
    (root / "index.csv").write_text("\n".join(rows) + "\n")
    return str(root / "index.csv")


def _write_naip(root, n=11, canvas=16):
    """NAIP tiles as HWC uint8, CHW uint8 and HWC float beyond [0, 255]."""
    rng = np.random.default_rng(1)
    rows = ["path,label"]
    for i in range(n):
        tile = rng.integers(0, 256, (canvas, canvas, 3)).astype(np.uint8)
        if i % 3 == 1:
            tile = tile.transpose(2, 0, 1)
        elif i % 3 == 2:
            tile = tile.astype(np.float32) * 1.5 - 40.0
        np.save(root / f"tile_{i}.npy", tile)
        rows.append(f"tile_{i}.npy,{i % 4}")
    (root / "index.csv").write_text("\n".join(rows) + "\n")
    return str(root / "index.csv")


def _datasets(kind, tmp_path):
    if kind == "fmow_rgb":
        path = _write_fmow(tmp_path)
        kw = dict(train_path=path, input_size=14)
    elif kind == "naip":
        path = _write_naip(tmp_path)
        kw = dict(train_path=path, input_size=16)
    else:
        kw = dict(input_size=8, synthetic_len=11)
    return jds.build_dataset(kind, True, **kw), pds.build_dataset(kind, True, **kw)


@pytest.mark.parametrize("kind", ["fmow_rgb", "naip", "synthetic"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_yields_the_jax_batches(tmp_path, kind, drop_last):
    """Two epochs at two shards, batch 2: every batch equal to the JAX
    Python loader's, and the step counts too."""
    from cross_scale_mae_tpu.data.loader import DataLoader as JLoader
    from cross_scale_mae_torch.data.loader import DataLoader

    jd, pd = _datasets(kind, tmp_path)
    assert len(jd) == len(pd) == 11 and jd.canvas_size == pd.canvas_size
    for shard in range(2):
        kw = dict(shuffle=True, seed=3, drop_last=drop_last, num_threads=3, shard_id=shard,
                  num_shards=2)
        jl = JLoader(jd, 2, use_native=False, **kw)
        pl = DataLoader(pd, 2, use_native=False, **kw)
        assert pl.steps_per_epoch() == jl.steps_per_epoch()
        assert pl.max_shard_steps() == jl.max_shard_steps()
        for epoch in range(2):
            got, ref = list(pl.epoch(epoch)), list(jl.epoch(epoch))
            assert len(got) == len(ref) > 0
            for (gi, gl), (ri, rl) in zip(got, ref):
                assert gi.dtype == np.uint8 and gl.dtype == np.int32
                np.testing.assert_array_equal(gi, ri)
                np.testing.assert_array_equal(gl, rl)


def test_glob_dataset_matches_jax(tmp_path):
    from PIL import Image

    (tmp_path / "a").mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (10, 9, 3), np.uint8)).save(tmp_path / "a" / f"{i}.jpg")
    jd = jds.build_dataset("coco", True, train_path=str(tmp_path), input_size=8)
    pd = pds.build_dataset("coco", True, train_path=str(tmp_path), input_size=8)
    assert pd.paths == jd.paths and (pd.mean, pd.std) == (jd.mean, jd.std)
    for i in range(3):
        np.testing.assert_array_equal(pd.load(i)[0], jd.load(i)[0])
        assert pd.load(i)[1] == jd.load(i)[1] == 0


def test_eval_canvas_and_dataset_attributes_match_jax(tmp_path):
    path = _write_naip(tmp_path, canvas=18)
    kw = dict(test_path=path, input_size=16, canvas_scale=1.0 / 0.875)
    jd, pd = jds.build_dataset("naip", False, **kw), pds.build_dataset("naip", False, **kw)
    assert pd.canvas_size == jd.canvas_size == 18
    assert (pd.mean, pd.std, pd.in_c, pd.normalize_on_device, pd.num_classes) == (
        jd.mean, jd.std, jd.in_c, jd.normalize_on_device, jd.num_classes)


@pytest.mark.parametrize("kind", ["euro_sat", "fmow_sentinel", "fmow_temporal"])
def test_build_dataset_refuses_the_unported_families(kind, tmp_path):
    """The families once refused are ported; an index that points at a
    missing file is refused at construction, as the JAX package refuses it
    (their loads: tests/test_torch_port_data_multiband.py and
    tests/test_torch_port_temporal.py)."""
    index = tmp_path / "index.csv"
    index.write_text({"euro_sat": "gone/a.tif\n",
                      "fmow_sentinel": "category,image_path\nbarn,gone.tif\n",
                      "fmow_temporal": "category,image_path,image_path2,timestamp,timestamp2\n"
                                       "0,gone.jpg,gone2.jpg,2016-01-01,2017-01-01\n"}[kind])
    for m in (jds, pds):
        with pytest.raises(FileNotFoundError, match="gone"):
            m.build_dataset(kind, True, train_path=str(index))


def test_missing_files_fail_at_construction(tmp_path):
    (tmp_path / "index.csv").write_text("path,label\nnot_there.npy,0\n")
    with pytest.raises(FileNotFoundError, match="not_there.npy"):
        pds.NaipDataset(str(tmp_path / "index.csv"), 16)


def test_without_pil_only_canvas_sized_tiles_load(tmp_path, monkeypatch):
    """With PIL missing, NAIP tiles at the canvas size load; a tile that
    needs resizing and a PNG dataset raise naming PIL."""
    path = _write_naip(tmp_path, n=2, canvas=16)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert pds.NaipDataset(path, 16).load(0)[0].shape == (16, 16, 3)
    with pytest.raises(ImportError, match="PIL"):
        pds.NaipDataset(path, 20).load(0)
    with pytest.raises(ImportError, match="PIL"):
        pds.Dataset(8)._load_raw(0)


def test_loader_stops_its_producer_when_the_consumer_stops():
    from cross_scale_mae_torch.data.loader import DataLoader

    loader = DataLoader(pds.SyntheticDataset(40, 4), 2, num_threads=2)
    it = loader.epoch(0)
    next(it)
    it.close()
    assert loader.steps_per_epoch() == 20


def test_loader_raises_a_decode_error_in_the_consumer():
    from cross_scale_mae_torch.data.loader import DataLoader

    class Broken(pds.SyntheticDataset):
        def load(self, index):
            raise OSError(f"cannot decode {index}")

    with pytest.raises(OSError, match="cannot decode"):
        list(DataLoader(Broken(4, 4), 2, num_threads=1).epoch(0))


def test_device_prefetch_on_the_cpu_yields_the_host_batches():
    from cross_scale_mae_torch.data.loader import DataLoader, device_prefetch

    loader = DataLoader(pds.SyntheticDataset(6, 4), 2, num_threads=1)
    got = list(device_prefetch(loader.epoch(1), "cpu"))
    ref = list(loader.epoch(1))
    assert len(got) == len(ref) == 3
    for (gi, gl), (ri, rl) in zip(got, ref):
        assert gi.device.type == "cpu"
        np.testing.assert_array_equal(gi.numpy(), ri)
        np.testing.assert_array_equal(gl.numpy(), rl)


# ---------------------------------------------------------------- rot90


def _jax_rot_draws(key, n, h, w):
    """The flips, rotations and crop boxes ``make_pretrain_augment(rot90=True)``
    draws from ``key``: split 3 into flip, rot and crop keys (augment.py:44),
    the flips' split 2 (image.py:47-53), randint(0, 4) (image.py:57-67)."""
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes as jboxes

    k_flip, k_rot, k_crop = jax.random.split(key, 3)
    kh, kv = jax.random.split(k_flip)
    flips = [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (n,)))) for k in (kh, kv)]
    rot = torch.from_numpy(np.array(jax.random.randint(k_rot, (n,), 0, 4)))
    boxes = torch.from_numpy(np.array(jboxes(k_crop, n, h, w, (0.25, 1.0)), np.float32))
    return flips, rot, boxes


def test_random_rot90_matches_jax_on_injected_draws():
    from cross_scale_mae_tpu.ops.image import random_rot90 as jrot
    from cross_scale_mae_torch.ops.image import random_rot90

    x = np.random.default_rng(3).normal(size=(12, 5, 5, 3)).astype(np.float32)
    key = jax.random.key(4)
    ref = np.asarray(jrot(key, jnp.asarray(x)))
    k = torch.from_numpy(np.array(jax.random.randint(key, (12,), 0, 4)))
    assert set(k.tolist()) == {0, 1, 2, 3}
    np.testing.assert_array_equal(random_rot90(torch.from_numpy(x), k).numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pretrain_augment_with_rot90_matches_jax(dtype):
    from cross_scale_mae_tpu.ops.augment import make_pretrain_augment as jaug
    from cross_scale_mae_torch.ops.augment import make_pretrain_augment

    mean, std = pds.NaipDataset.mean, pds.NaipDataset.std
    batch = np.random.default_rng(5).integers(0, 256, (8, 20, 20, 3), np.uint8)
    key = jax.random.key(6)
    ref = jaug(mean, std, 16, rot90=True, dtype=dtype)(key, jnp.asarray(batch))
    ref = np.asarray(ref.astype(jnp.float32))
    (hflip, vflip), rot, boxes = _jax_rot_draws(key, 8, 20, 20)
    got = make_pretrain_augment(mean, std, 16, rot90=True, dtype=dtype)(
        torch.from_numpy(batch), hflip, vflip, boxes, rot)
    assert got.dtype == getattr(torch, dtype) and got.shape == (8, 16, 16, 3)
    atol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


def test_finetune_augment_with_rot90_matches_jax():
    """The finetune chain's split of 5 (augment.py:98): flip, rot, crop."""
    from cross_scale_mae_tpu.ops.augment import make_finetune_augment as jaug
    from cross_scale_mae_tpu.ops.image import sample_crop_boxes as jboxes
    from cross_scale_mae_torch.ops.augment import make_finetune_augment

    mean, std = pds.NaipDataset.mean, pds.NaipDataset.std
    batch = np.random.default_rng(7).integers(0, 256, (8, 20, 20, 3), np.uint8)
    key = jax.random.key(8)
    ref = np.asarray(jaug(mean, std, 16, rot90=True)(key, jnp.asarray(batch)))
    k_flip, k_rot, k_crop, _, _ = jax.random.split(key, 5)
    kh, kv = jax.random.split(k_flip)
    got = make_finetune_augment(mean, std, 16, rot90=True)(
        torch.from_numpy(batch),
        *(torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (8,)))) for k in (kh, kv)),
        torch.from_numpy(np.array(jboxes(k_crop, 8, 20, 20, (0.25, 1.0)), np.float32)),
        torch.from_numpy(np.array(jax.random.randint(k_rot, (8,), 0, 4))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_rot90_chain_needs_its_draws():
    from cross_scale_mae_torch.ops.augment import make_pretrain_augment

    aug = make_pretrain_augment((0.5,) * 3, (0.5,) * 3, 8, rot90=True)
    with pytest.raises(ValueError, match="rotation draws"):
        aug(torch.zeros(2, 8, 8, 3, dtype=torch.uint8), torch.zeros(2, dtype=torch.bool),
            torch.zeros(2, dtype=torch.bool), torch.tensor([[0.0, 0.0, 8.0, 8.0]] * 2))


def test_rotation_draws_come_last():
    """The rotations are drawn after every other draw, so a chain without
    rot90 gets the same flips, boxes and masks from the same generator."""
    from cross_scale_mae_torch import configs as pcfg
    from cross_scale_mae_torch.train.classify import sample_finetune_draws
    from cross_scale_mae_torch.train.pretrain import sample_pretrain_draws

    vc = pcfg.get_vit_config("vit_base_patch16", input_size=16, patch_size=4, embed_dim=32,
                             depth=2, num_heads=4, num_classes=3, drop_path_rate=0.1)
    a = sample_finetune_draws(torch.Generator().manual_seed(0), 6, vc, 20)
    b = sample_finetune_draws(torch.Generator().manual_seed(0), 6, vc, 20, rot90=True)
    assert a.rot_k is None and b.rot_k.shape == (6,) and int(b.rot_k.max()) <= 3
    assert torch.equal(a.crop_boxes, b.crop_boxes) and torch.equal(a.drop_masks, b.drop_masks)
    mc = pcfg.get_mae_config("mae_vit_tiny_MsLdCeCd", input_size=16, patch_size=4)
    tc = pcfg.TrainConfig()
    p = sample_pretrain_draws(torch.Generator().manual_seed(1), 4, mc, tc)
    q = sample_pretrain_draws(torch.Generator().manual_seed(1), 4, mc, tc, canvas=20, rot90=True)
    assert torch.equal(p.noise, q.noise) and q.rot_k.shape == (4,)
    assert float(q.crop_boxes[:, 2].max()) <= 20 and not torch.equal(p.crop_boxes, q.crop_boxes)
