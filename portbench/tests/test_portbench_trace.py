"""The trace arithmetic and the per-layer readers on a hand-made trace,
and the frozen counts against the program's published figures."""

from __future__ import annotations

import json

import pytest

from portbench import cell as cells
from portbench.counts import attention, flops
from portbench.tests import _tiny
from portbench.trace import Activity, Trace, Traced, covered, device_ops, exposed, merged

K = "kernel"


def _trace():
    """Two steps on a window of 100 us: a GEMM, K1f on a second stream
    overlapping it, an elementwise kernel, a copy, K1b, an all-reduce; idle
    20-30 and 70-80."""
    return Trace(
        device=[Activity("sm90_xmma_gemm_bf16", K, 0, 15),
                Activity("void mha3_fwd_tc_kernel<64>(...)", K, 10, 20),
                Activity("elementwise_kernel<add>", K, 30, 50),
                Activity("Memcpy DtoD (Device -> Device)", "memcpy", 50, 60),
                Activity("void mha3_bwd_tc_kernel<64>(...)", K, 60, 70),
                Activity("ncclDevKernel_AllReduce_Sum_f32", K, 80, 100)])


def _traced(trace, **kw):
    args = dict(steps=2, chips=1, images_per_s=1000.0, flops_per_image=39.08e9,
                attention={"k1": [{"seqs": 1024, "tokens": 17, "heads": 12, "head_dim": 64,
                                   "itemsize": 2, "layers": 1}]})
    args.update(kw)
    return Traced([trace], **args)


def test_interval_union_and_exposed_time():
    assert merged([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]
    assert covered([(0, 10), (5, 15), (20, 30)]) == 25
    assert exposed([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert exposed([(0, 10)], []) == 10
    assert exposed([(2, 4)], [(0, 10)]) == 0


def _readers():
    bench = json.loads((_tiny.REPO / "BENCHMARK.json").read_text())
    return {m["name"]: cells.load_module(_tiny.REPO / "portbench" / "metrics" / f"{m['name']}.py")
            for m in bench["per_layer"]}


def test_readers_on_a_hand_made_trace():
    r = _readers()
    t = _traced(_trace())
    assert r["device_idle_share"].read(t) == pytest.approx(20.0)   # 80 of 100 us busy
    assert r["gemm_ms_per_step"].read(t) == pytest.approx(15e-3 / 2)
    # elementwise: the add alone (the copy is not a kernel, NCCL and K1 are not counted)
    assert r["elementwise_ms_per_step"].read(t) == pytest.approx(20e-3 / 2)
    bound = 2 * attention.step_bound_s(t.attention["k1"])
    assert r["k1_roofline"].read(t) == pytest.approx(100 * bound / 20e-6)
    assert r["k2_roofline"].read(t) is None                        # no K2 call, no kernel
    assert r["step_mfu"].read(t) == pytest.approx(100 * 39.08e9 * 1000 / 989e12)


def test_readers_read_nothing_where_nothing_ran():
    r = _readers()
    t = _traced(Trace([]))
    for name in ("device_idle_share", "gemm_ms_per_step", "elementwise_ms_per_step",
                 "k1_roofline", "k2_roofline", "dp_exposed_comm_ms"):
        assert r[name].read(t) is None


def test_breakdown_names_ops_and_gaps():
    top = device_ops(_trace())
    ops = dict(top)
    assert len(ops) == 6 and ops["ncclDevKernel_AllReduce_Sum_f32"] == pytest.approx(20e-6)
    assert [t for _, t in top] == sorted(ops.values(), reverse=True)
    assert [name for name, _ in device_ops(_trace(), top=2)] == [
        "elementwise_kernel<add>", "ncclDevKernel_AllReduce_Sum_f32"]


def test_exposed_comm_is_the_median_step():
    """Three steps of two collectives each, exposed 4, 10 and 30 us (a
    collective waiting for a late rank): the median step, 10 us."""
    ar, ag = "ncclDevKernel_AllReduce_Sum_f32", "ncclDevKernel_AllGather"
    dev = []
    for base, wait in ((0, 0), (100, 6), (200, 26)):
        dev += [Activity("sm90_xmma_gemm_bf16", K, base, base + 40),
                Activity(ag, K, base + 38, base + 44),          # 4 us beyond the GEMM
                Activity("elementwise_kernel<add>", K, base + 44, base + 80),
                Activity(ar, K, base + 80, base + 80 + wait),   # nothing beside it
                Activity("elementwise_kernel<mul>", K, base + 80 + wait, base + 90 + wait)]
    r = _readers()["dp_exposed_comm_ms"]
    assert r.read(_traced(Trace(dev), steps=3)) == pytest.approx(10e-3)
    assert r.read(_traced(Trace(dev), steps=1)) == pytest.approx(44e-3)


def test_frozen_counts():
    conf = _tiny.REPO / "portbench" / "configs"
    mae = json.loads((conf / "mae_vit_base_MsLdCeCd_in128.json").read_text())
    vit = json.loads((conf / "vit_large_in64_p8_c62.json").read_text())
    assert flops.mae_train_flops(mae) / 1e9 == pytest.approx(39.08, abs=5e-3)
    assert flops.vit_train_flops(vit) / 1e9 == pytest.approx(119.1, abs=5e-2)
    # K1f at the decoder's shape: bytes-bound, q, k, v read and o written once
    one = 1024 * 65 * 16 * 32 * 2
    assert attention.bound_s(1024, 65, 16, 32, 2, False) == pytest.approx(4 * one / 3.35e12)
    assert attention.bound_s(1024, 65, 16, 32, 2, True) == pytest.approx(7 * one / 3.35e12)
