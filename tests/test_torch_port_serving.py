"""The PyTorch port's serving path held against the JAX package on the CPU:
the weight carry from a JAX-written npz, the whole serving forward, the
micro-batcher and the HTTP app (``--device cpu``).

The JAX side of the serving forward is the one ``cross_scale_mae_tpu/
serving.py:123-149`` builds: eval preprocess, ``mae_encode``, pool. The
canvas (37 px) differs from the input (32 px), so the bicubic
center-crop resize runs. Tolerances are those of test_torch_port_model.py:
fp32 1e-5; bf16 max error 2**-4 * max(1, max|ref|) and mean error
2**-7 * max(1, mean|ref|) (GELU rounding differs; see that file).
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_scale_mae_tpu import configs as jcfg
from cross_scale_mae_torch import serving as psrv
from cross_scale_mae_torch.utils import checkpoint as pckpt
from cross_scale_mae_torch.utils.params import params_from_jax

TINY = dict(input_size=32, patch_size=8, dim_model=64, encoder_num_layers=2,
            encoder_num_heads=4, decoder_embed_dim=32, decoder_num_layers=1,
            decoder_num_heads=4, predictor_hidden_size=32,
            attention_impl="pallas_v3")


def _jax_params(cfg, seed=0):
    from cross_scale_mae_tpu.models.mae import mae_init

    params, _ = mae_init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    # Move every leaf off its init constant so a mis-mapped parameter shows.
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def npz_files(tmp_path_factory):
    """JAX mae_init -> JAX save_params_npz, once per compute dtype."""
    from cross_scale_mae_tpu.utils.checkpoint import save_params_npz

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = jcfg.get_mae_config("mae_vit_base_MsLdCeCd", **TINY,
                                  compute_dtype=dtype)
        params = _jax_params(cfg)
        path = str(tmp_path_factory.mktemp("ckpt") / f"params_{dtype}.npz")
        save_params_npz(path, params, cfg.to_json())
        out[dtype] = (path, cfg, params)
    return out


def _jax_serving_forward(cfg, params, pool, u8):
    from cross_scale_mae_tpu.data.datasets import DATASET_STATS
    from cross_scale_mae_tpu.models.mae import mae_encode
    from cross_scale_mae_tpu.ops.augment import make_eval_preprocess

    mean, std = DATASET_STATS["fmow_rgb"]
    pre = make_eval_preprocess(mean, std, cfg.input_size, normalize=True,
                               dtype=cfg.compute_dtype)
    keep = {"patch_embed", "cls_token", "encoder_blocks"}
    p = {k: jnp.asarray(v) if not isinstance(v, dict) else jax.tree.map(jnp.asarray, v)
         for k, v in params.items() if k in keep}
    feats = mae_encode(p, cfg, pre(jnp.asarray(u8)))
    if pool == "cls":
        out = feats[:, 0]
    elif pool == "mean":
        out = jnp.mean(feats[:, 1:], axis=1)
    else:
        out = feats
    return np.asarray(out.astype(jnp.float32))


# ------------------------------------------------------------ weight carry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["cls", "mean", "tokens"])
def test_serving_forward_matches_jax(npz_files, pool, dtype):
    path, cfg, params = npz_files[dtype]
    model = psrv.build_serving_model(path, pool=pool, batch_size=4, device="cpu")
    assert model.canvas == 37 and model.channels == 3 and model.kind == "mae"
    assert model.meta["model_config"]["attention_impl"] == "pallas_v3"
    u8 = np.random.default_rng(1).integers(0, 256, (3, 37, 37, 3), np.uint8)
    got = model.fn(u8)
    ref = _jax_serving_forward(cfg, params, pool, u8)
    assert got.dtype == np.float32 and got.shape == ref.shape
    err = np.abs(got - ref)
    if dtype == "float32":
        assert err.max() <= 1e-5, err.max()
    else:
        assert err.max() <= 2.0 ** -4 * max(1.0, np.abs(ref).max()), err.max()
        assert err.mean() <= 2.0 ** -7 * max(1.0, np.abs(ref).mean()), err.mean()


def test_carry_unstacks_and_drops(npz_files):
    path, cfg, params = npz_files["float32"]
    pc = psrv.MAEConfig.from_json(cfg.to_json())
    tree = pckpt.load_flat_npz(path)
    assert "decoder_blocks" in tree and "predictor_cd" in tree
    got = params_from_jax(tree, pc)
    assert set(got) == {"patch_embed", "cls_token", "encoder_blocks"}
    assert len(got["encoder_blocks"]) == 2
    for i, blk in enumerate(got["encoder_blocks"]):
        np.testing.assert_array_equal(
            blk["attn"]["qkv"]["kernel"].numpy(),
            params["encoder_blocks"]["attn"]["qkv"]["kernel"][i])
    with_norm = params_from_jax(tree, pc.replace(apply_encoder_norm=True))
    assert "encoder_norm" in with_norm


def test_carry_is_strict(npz_files):
    _, cfg, params = npz_files["float32"]
    pc = psrv.MAEConfig.from_json(cfg.to_json())

    def edited(fn):
        tree = jax.tree.map(lambda a: a, params)
        fn(tree)
        return tree

    with pytest.raises(KeyError, match="cls_token"):
        params_from_jax(edited(lambda t: t.pop("cls_token")), pc)
    with pytest.raises(KeyError, match="encoder_blocks/mlp"):
        params_from_jax(edited(lambda t: t["encoder_blocks"].pop("mlp")), pc)
    with pytest.raises(KeyError, match="unexpected"):
        params_from_jax(edited(
            lambda t: t["encoder_blocks"]["attn"].update(e_proj=np.zeros(3))), pc)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(edited(
            lambda t: t["patch_embed"].update(bias=np.zeros(65, np.float32))), pc)


def test_npz_format_is_shared(npz_files, tmp_path):
    from cross_scale_mae_tpu.utils import checkpoint as jckpt

    path, cfg, params = npz_files["float32"]
    assert pckpt.read_config_json(path) == cfg.to_json()
    port_tree = pckpt.load_flat_npz(path)
    jax_tree = jckpt.load_flat_npz(path)
    assert jax.tree.structure(port_tree) == jax.tree.structure(jax_tree)
    for a, b in zip(jax.tree.leaves(port_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_array_equal(a, b)
    # And back: a port-written file restores through the JAX loader.
    out = str(tmp_path / "port.npz")
    pckpt.save_params_npz(out, port_tree, cfg.to_json())
    restored, config_json = jckpt.load_params_npz(out, params)
    assert config_json == cfg.to_json()
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_directory_checkpoint_points_to_roadmap(tmp_path):
    with pytest.raises(ValueError, match="ROADMAP.md"):
        pckpt.load_flat_npz(str(tmp_path))


def test_build_serving_model_refusals(npz_files, tmp_path):
    path = npz_files["float32"][0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        psrv.build_serving_model(path, quantize="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        psrv.build_serving_model(path, data_parallel=True, device="cpu")
    with pytest.raises(ValueError, match="step"):
        psrv.build_serving_model(path, step=3, device="cpu")
    clf = str(tmp_path / "clf.npz")
    pckpt.save_params_npz(clf, {"w": np.zeros(2)},
                          json.dumps({"embed_dim": 64, "num_classes": 3}))
    with pytest.raises(NotImplementedError, match="classifier"):
        psrv.build_serving_model(clf, device="cpu")


def test_cuda_default_raises_without_a_card(npz_files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        psrv.build_serving_model(npz_files["float32"][0])


# ---------------------------------------------------------------- batcher


def _batcher(max_batch=8, delay=30.0, **kw):
    calls = []

    def fn(rows):
        calls.append(len(rows))
        return rows[..., 0, 0, 0].astype(np.float32) * 2.0

    return psrv.MicroBatcher(fn, max_batch, 4, 3, max_delay_ms=delay, **kw), calls


def _join_all(threads, timeout=10):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive()


def test_batcher_coalesces_concurrent_requests():
    b, calls = _batcher()
    outs = {}

    def post(i):
        outs[i] = b.submit(np.full((2, 4, 4, 3), i, np.uint8))

    threads = [threading.Thread(target=post, args=(i,)) for i in (1, 2, 3)]
    for t in threads:
        t.start()
    _join_all(threads)
    b.close()
    for i in (1, 2, 3):
        np.testing.assert_allclose(outs[i], np.full(2, 2.0 * i))
    assert len(calls) < 3 and all(c == 8 for c in calls)


def test_batcher_pads_to_smallest_bucket():
    b, calls = _batcher(delay=0.0, buckets=[2, 4, 8])
    np.testing.assert_allclose(b.submit(np.full((1, 4, 4, 3), 5, np.uint8)), [10.0])
    assert calls[-1] == 2
    np.testing.assert_allclose(b.submit(np.full((3, 4, 4, 3), 7, np.uint8)),
                               np.full(3, 14.0))
    assert calls[-1] == 4
    stats = b.stats()
    b.close()
    np.testing.assert_allclose(stats["mean_batch_fill"], 4 / 6, atol=1e-3)
    with pytest.raises(ValueError, match="must equal"):
        psrv.MicroBatcher(lambda r: r, 8, 4, 3, buckets=[2, 4])


def test_batcher_chunks_large_requests():
    b, calls = _batcher(max_batch=4, delay=0.0)
    rows = np.arange(10, dtype=np.uint8)[:, None, None, None] * np.ones((1, 4, 4, 3), np.uint8)
    out = b.submit(rows)
    b.close()
    np.testing.assert_allclose(out, np.arange(10) * 2.0)
    assert calls == [4, 4, 4]  # 4 + 4 + 2 rows, each padded to 4


def test_batcher_rejects_bad_input_and_full_queue():
    release = threading.Event()

    def slow(rows):
        release.wait(10)
        return np.zeros(len(rows), np.float32)

    b = psrv.MicroBatcher(slow, 4, 4, 3, max_delay_ms=0.0, max_queue_rows=4)
    for bad in (np.zeros((2, 5, 4, 3), np.uint8), np.zeros((2, 4, 4, 3), np.float32),
                np.zeros((0, 4, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            b.submit(bad)
    first = threading.Thread(target=b.submit, args=(np.zeros((4, 4, 4, 3), np.uint8),))
    first.start()
    time.sleep(0.2)  # the worker holds the first batch in `slow`
    queued = threading.Thread(target=b.submit, args=(np.zeros((3, 4, 4, 3), np.uint8),))
    queued.start()
    time.sleep(0.2)
    with pytest.raises(psrv.QueueFullError):
        b.submit(np.zeros((2, 4, 4, 3), np.uint8))
    release.set()
    _join_all([first, queued])
    assert b.stats()["rejected_full"] == 1
    b.close()


def test_batcher_deadline_with_two_queued_requests():
    # One dispatch blocks; two requests queue behind it and run out of time.
    # Their entries hold numpy arrays, so the batcher must remove them by
    # identity: an `==` comparison of the dicts raises ValueError instead.
    release = threading.Event()

    def slow(rows):
        release.wait(10)
        return np.zeros(len(rows), np.float32)

    b = psrv.MicroBatcher(slow, 4, 4, 3, max_delay_ms=0.0, deadline_ms=300.0)
    errors = {}

    def post(i):
        try:
            b.submit(np.full((1, 4, 4, 3), i, np.uint8))
        except Exception as e:  # noqa: BLE001 — the test inspects the type
            errors[i] = e

    head = threading.Thread(target=post, args=(0,))
    head.start()
    time.sleep(0.1)  # the worker is inside `slow` with request 0
    queued = [threading.Thread(target=post, args=(i,)) for i in (1, 2)]
    for t in queued:
        t.start()
    _join_all(queued)
    for i in (1, 2):
        assert isinstance(errors.get(i), psrv.DeadlineExceededError), errors
    assert b.stats()["queue_depth"] == 0
    release.set()
    _join_all([head])
    assert isinstance(errors.get(0), psrv.DeadlineExceededError)
    assert b.stats()["deadline_expired"] == 3
    # The worker is still alive and serves new requests.
    np.testing.assert_allclose(b.submit(np.zeros((1, 4, 4, 3), np.uint8)), [0.0])
    b.close()


# ---------------------------------------------------------------- HTTP app


@pytest.fixture
def app(npz_files):
    from cross_scale_mae_torch.cli.serve import build_app, get_args_parser

    args = get_args_parser().parse_args(
        ["--ckpt", npz_files["float32"][0], "--device", "cpu", "--port", "0",
         "--batch_size", "4", "--pool", "mean", "--max_delay_ms", "1"])
    server, batcher = build_app(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", batcher
    server.shutdown()
    batcher.close()
    server.server_close()
    thread.join(5)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.load(r)


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_app_serves(app, npz_files):
    url, _ = app
    assert _get(url + "/healthz") == {"ok": True, "warm": True, "kind": "mae"}
    info = _get(url + "/info")
    assert info["input"] == [4, 37, 37, 3] and info["device"] == "cpu"
    u8 = np.random.default_rng(3).integers(0, 256, (6, 37, 37, 3), np.uint8)
    buf = io.BytesIO()
    np.save(buf, u8)
    code, body = _post(url + "/predict", buf.getvalue())
    assert code == 200
    got = np.load(io.BytesIO(body))
    path, cfg, params = npz_files["float32"]
    np.testing.assert_allclose(got, _jax_serving_forward(cfg, params, "mean", u8),
                               rtol=0, atol=1e-5)
    code, body = _post(url + "/predict", buf.getvalue(), {"Accept": "application/json"})
    assert code == 200 and np.asarray(json.loads(body)["output"]).shape == (6, 64)
    stats = _get(url + "/stats")
    assert stats["requests"] == 2 and stats["rows"] == 12


def test_http_app_rejects_bad_bodies(app):
    url, _ = app
    assert _post(url + "/predict", b"not an npy")[0] == 400
    assert _post(url + "/predict", b"")[0] == 400
    buf = io.BytesIO()
    np.save(buf, np.zeros((1, 8, 8, 3), np.uint8))
    assert _post(url + "/predict", buf.getvalue())[0] == 400
    buf = io.BytesIO()
    np.save(buf, np.zeros((1, 37, 37, 3), np.float32))
    assert _post(url + "/predict", buf.getvalue())[0] == 400
    assert _post(url + "/predict_image", b"not an image")[0] == 400
    assert _post(url + "/nope", b"")[0] == 404


@pytest.mark.parametrize("flag", [["--artifact", "x.stablehlo"], ["--quantize", "int8"],
                                  ["--data_parallel"]])
def test_cli_refuses_unported_flags(flag, npz_files):
    from cross_scale_mae_torch.cli.serve import build_app, get_args_parser

    argv = (["--device", "cpu"] + flag if flag[0] == "--artifact"
            else ["--ckpt", npz_files["float32"][0], "--device", "cpu"] + flag)
    with pytest.raises(SystemExit, match="ROADMAP"):
        build_app(get_args_parser().parse_args(argv))
