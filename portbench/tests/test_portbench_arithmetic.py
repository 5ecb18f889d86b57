"""The rate, percentile and spread arithmetic, the import check and the
roofline's counts, on hand-made inputs."""
import numpy as np
import pytest
import torch

from portbench import guard, roofline, stats
from portbench.generators import render, train
from portbench.run import Window


def test_rates_and_p90_count_a_stall():
    lat = [0.1] * 99 + [5.0]                     # one stalled request
    w = Window(requests=100, rays=100 * 65536, seconds=sum(lat), latencies=lat)
    # the stall's time is in the window: 6.55M rays over 14.9 s, not 9.9 s
    assert render.Generator.end_to_end(None, w)["camera_rays_per_s"] == pytest.approx(
        100 * 65536 / 14.9)
    e2e = train.Generator.end_to_end(None, w)
    assert e2e["train_rays_per_s"] == pytest.approx(100 * 65536 / 14.9)
    assert e2e["train_step_ms_p90"] == pytest.approx(100.0)   # the 90th smallest of 100
    lat[85:] = [5.0] * 15                        # fifteen stalls: p90 sees them
    assert Window(100, 0, sum(lat), lat).p90 == 5.0
    assert stats.percentile(list(range(1, 11)), 90) == 9


@pytest.mark.parametrize("mods,bad", [
    (["grail_torch", "grail_torch.engine", "numpy"], []),
    (["grail", "grail_torch"], ["grail"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen", "grailx"], ["flax"]),
])
def test_import_check_compares_top_level_names_whole(mods, bad):
    assert guard.forbidden_modules(dict.fromkeys(mods)) == bad


def test_brute_counts_by_hand():
    # two triangles in the plane z = 1: the first over x, y in [0, 1], the
    # second over x in [2, 3]
    v0 = torch.tensor([[0.0, 0.0, 1.0], [2.0, 0.0, 1.0]])
    e1 = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    e2 = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    tris9 = torch.cat([v0, e1, e2], 1)
    o = torch.tensor([[0.2, 0.2, 0.0], [2.9, 0.05, 0.0], [5.0, 5.0, 0.0], [0.2, 0.2, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    tmin = torch.zeros(4)
    tmax = torch.tensor([10.0, 10.0, 10.0, 0.0])   # the last ray is dead
    ops = roofline.brute_ops(tris9, o, d, tmin, tmax, any_hit=False)
    # ray 0: hits tri 0 (29+18+8); tri 1 fails b1 (b1 = -1.8): 29
    # ray 1: tri 0 has b1 = 2.9 > 1: 29; tri 1 hits: 55
    # ray 2: b1 = 5 and 3 beyond both: 29 each; ray 3 is dead: 0
    assert ops.tolist() == [55 + 29, 29 + 55, 58, 0]
    ops_any = roofline.brute_ops(tris9, o, d, tmin, tmax, any_hit=True)
    assert ops_any.tolist() == [55, 29 + 55, 58, 0]   # ray 0 stops at its first hit


def _f(i):
    return np.array([i], np.int32).view(np.float32)[0]


def test_bvh4_counts_by_hand():
    # node 0 holds 3 child nodes (slots 0-2) and an empty slot; nodes 1-3
    # each hold one leaf of one triangle, at z = 1, 2, 3 over x, y in [0, 1]
    inf = np.inf
    nodes = np.zeros((4, 32), np.float32)

    def put(n, slot, lo, hi, child, count):
        for a in range(3):
            nodes[n, a * 4 + slot] = lo[a]
            nodes[n, 12 + a * 4 + slot] = hi[a]
        nodes[n, 24 + slot] = _f(child)
        nodes[n, 28 + slot] = _f(count)

    for n in range(4):
        for s in range(4):
            put(n, s, (inf,) * 3, (inf,) * 3, -1, 0)
    for k in range(3):
        z = 1.0 + k
        put(0, k, (0, 0, z - 0.1), (1, 1, z + 0.1), k + 1, 0)
        put(k + 1, 0, (0, 0, z - 0.1), (1, 1, z + 0.1), ~k, 1)
    tris = np.zeros((3, 12), np.float32)
    for k in range(3):
        tris[k, 0:3] = (0, 0, 1.0 + k)
        tris[k, 3] = _f(k)
        tris[k, 4:7] = (1, 0, 0)
        tris[k, 8:11] = (0, 1, 0)
        tris[k, 11] = _f(0)
    nodes, tris = torch.tensor(nodes), torch.tensor(tris)
    o = torch.tensor([[0.2, 0.2, 0.0], [5.0, 5.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    tmin, tmax = torch.zeros(2), torch.full((2,), 100.0)
    slab = 4 * 26
    ops = roofline.bvh4_ops(nodes, tris, o, d, tmin, tmax, any_hit=False)
    # ray 0: root (3 children hit), node 1, tri 0 (hit, t = 1), then the
    # stack: node 2 and node 3, whose boxes start beyond t = 1: no leaf
    assert ops.tolist() == [4 * slab + 55, slab]     # ray 1 misses the root's boxes
    ops_any = roofline.bvh4_ops(nodes, tris, o, d, tmin, tmax, any_hit=True)
    assert ops_any.tolist() == [2 * slab + 55, slab]
    launch = {"kind": "bvh4", "any_hit": False, "n": 1000, "rays": (o, d, tmin, tmax)}
    tables = {"nodes": nodes, "tris": tris}
    want = max(1000 * float(ops.mean()) / roofline.PEAK_FP32_OPS,
               (1000 * 48 + 4 * 128 + 3 * 48) / roofline.PEAK_BYTES)
    assert roofline.launch_bound_s(launch, tables) == pytest.approx(want)


def test_trace_reduction_on_a_hand_made_trace():
    from portbench.tracing import Trace

    def x(name, cat, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    ev = [x("pb:window", "user_annotation", 0, 100),
          x("pb:light", "user_annotation", 10, 30), x("pb:intersect", "user_annotation", 20, 5),
          x("pb:binning", "user_annotation", 50, 10),
          x("cudaLaunchKernel", "cuda_runtime", 22, 1, corr=1),
          x("cudaLaunchKernel", "cuda_runtime", 55, 1, corr=2),
          x("cudaLaunchKernel", "cuda_runtime", 70, 1, corr=3),
          x("bvh4_kernel<false>", "kernel", 25, 10, tid=7, corr=1),
          x("sort", "kernel", 58, 4, tid=7, corr=2),
          x("sort", "kernel", 75, 5, tid=7, corr=3),
          x("late", "kernel", 150, 5, tid=7, corr=4)]        # after the window
    tr = Trace(ev)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(19e-6)
    assert tr.kernel_s(("bvh4_kernel",)) == pytest.approx(10e-6)
    assert tr.outer_spans(("light",)) == pytest.approx(25e-6)   # 30 less intersect's 5
    assert tr.stage_device_s("binning") == pytest.approx(4e-6)  # launch 55 only
    b = tr.breakdown()
    assert b["device_ops"][0] == ["bvh4_kernel<false>", pytest.approx(10e-6)]
    gaps = dict(b["idle_gaps"])
    # idle 0-25 (begins outside any range), 35-58 (begins inside light),
    # 62-75 and 80-100 (outside): a gap goes to the range open where it begins
    assert gaps["outside stages"] == pytest.approx((25 + 13 + 20) * 1e-6)
    assert gaps["light"] == pytest.approx(23e-6)
