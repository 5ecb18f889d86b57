"""The instanced sweep's spans (kernels/instanced.py, shade/geometry.py) on
the instanced test scene of tests/test_torch_instances.py (a floor, a point
light, 3 still, 1 animated and 1 mirrored instance of one sphere and one
instance of another), built through the port's SceneBuilder alone.

Under torch.profiler each `instances_intersect` call is one `instanced`
span whose lanes are the rays handed in; each round is one `sweep/closest`
or `sweep/any` span inside it whose lanes are the rays with a candidate
that round, counted here from the candidate masks themselves; the rounds
are LAST_SWEEPS's, and each round, and the last check that ends the loop,
reads the device once inside `sync/sweep_round`. Shading an instanced wave
is one `instance_to_world` span with the wave's lanes. With no profiler
recording nothing is logged, and the results are the same bits."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grail_torch import telemetry
from grail_torch.core import transform as tr
from grail_torch.engine import camera as cam
from grail_torch.kernels import instanced as tinst, intersect as tisect
from grail_torch.scene.buffers import SceneBuilder
from grail_torch.scene.shapes import sphere
from grail_torch.shade import geometry as tgeom

torch.set_num_threads(2)

N = 2048


def _scene():
    b = SceneBuilder()
    b.xres = b.yres = 16
    b.matte(kd=(0.6, 0.6, 0.6))
    b.matte(kd=(0.7, 0.4, 0.3))
    b.add_mesh(np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]], np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int64), 0)
    b.add_point_light((0.0, 4.0, 0.0), (30.0, 30.0, 30.0))
    c2w = tr.look_at((0, 1.5, 4.0), (0, 0.5, 0), (0, 1, 0))
    b.camera = cam.build_camera(cam.PERSPECTIVE, c2w, c2w, 16, 16, fov=50.0)
    coarse = b.add_object()
    v, i, n, uv = sphere(radius=0.3, nu=14, nv=7)
    b.add_object_mesh(coarse, v, i, 0, normals=n, uvs=uv)
    ball = b.add_object()
    v, i, n, uv = sphere(radius=0.4, nu=12, nv=6)
    b.add_object_mesh(ball, v, i, 1, normals=n, uvs=uv)
    for k in range(3):
        b.add_instance(ball, tr.translate((-1.2 + 1.2 * k, 0.45, -0.6)))
    b.add_instance(ball, tr.translate((-0.8, 0.5, 0.6)),
                   tr.translate((0.8, 0.5, 0.6)) @ tr.rotate_y(40.0))
    b.add_instance(ball, tr.translate((0.0, 1.35, 0.0)) @ tr.scale(-1.0, 1.0, 1.0))
    b.add_instance(coarse, tr.translate((1.5, 0.3, 0.8)) @ tr.rotate_x(30.0))
    return b.finalize(device="cpu")[0]


def _rays():
    """Camera rays and rays from points in the scene, some shadow-length,
    some dead, at random times."""
    rs = np.random.RandomState(3)
    o = (rs.rand(N, 3) * [4, 2, 3] + [-2, 0.05, -1.5]).astype(np.float32)
    o[:768] = [0.0, 1.5, 4.0]
    d = rs.randn(N, 3).astype(np.float32)
    d[:768] = [0.0, -0.2, -1.0] + rs.randn(768, 3) * [0.35, 0.25, 0.1]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(N, 1.0e7, np.float32)
    tmax[768:1100] = rs.rand(332).astype(np.float32) * 3.0
    tmax[1100:1150] = 0.0
    return tuple(torch.from_numpy(a) for a in (o, d, tmax, rs.rand(N).astype(np.float32)))


@pytest.fixture(scope="module")
def traced():
    """Both sweeps unprofiled, then profiled with each round's candidate
    count taken from next_candidates's mask; the log, the counts, the
    rounds and both sides' results."""
    scene = _scene()
    o, d, tmax, time = _rays()

    def sweeps():
        return [tinst.instances_intersect(scene, o, d, tmax, None, time, any_hit=a)
                for a in (False, True)]
    plain = sweeps()
    telemetry.reset()
    counts, real = [], tinst.next_candidates

    def counted(*a, **kw):
        sel, near, act = real(*a, **kw)
        counts.append(int(act.sum()))
        return sel, near, act
    tinst.next_candidates = counted
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = sweeps()
            hit = tisect.intersect(scene, o, d, tmax, device="cpu", time=time)
            tgeom.shading_geometry(scene, hit, o, d, time)
    finally:
        tinst.next_candidates = real
    spans = list(telemetry.SPANS)
    telemetry.reset()
    return {"spans": spans, "counts": counts, "rounds": list(tinst.LAST_SWEEPS)[-3:],
            "plain": plain, "got": got}


def _calls(spans):
    return [s for s in spans if s.name == "instanced"]


def _rounds(spans, call):
    return [s for s in spans if s.parent == call.id and s.name.startswith("sweep/")]


def test_round_lanes_are_the_candidate_counts(traced):
    spans, counts = traced["spans"], traced["counts"]
    calls = _calls(spans)
    assert len(calls) == 3 and all(c.lanes == N for c in calls[:2])
    # next_candidates runs once a round and once more to end the loop
    lanes = [[s.lanes for s in _rounds(spans, c)] for c in calls]
    expect, k = [], 0
    for c in calls:
        n_rounds = len(_rounds(spans, c))
        expect.append(counts[k:k + n_rounds])
        assert counts[k + n_rounds] == 0
        k += n_rounds + 1
    assert k == len(counts) and lanes == expect
    assert all(x > 0 for call in lanes for x in call)


def test_rounds_are_last_sweeps(traced):
    spans = traced["spans"]
    calls = _calls(spans)
    assert [r[2] for r in traced["rounds"]] == [len(_rounds(spans, c)) for c in calls]
    assert [r[0] for r in traced["rounds"]] == ["closest", "any_hit", "closest"]
    for c, kind in zip(calls, ("closest", "any", "closest")):
        assert {s.name for s in _rounds(spans, c)} == {"sweep/" + kind}
        assert len(_rounds(spans, c)) >= 2


def test_one_sync_a_round(traced):
    spans = traced["spans"]
    for c in _calls(spans):
        syncs = [s for s in spans if s.parent == c.id and s.name == "sync/sweep_round"]
        assert len(syncs) == len(_rounds(spans, c)) + 1


def test_instance_to_world_spans_the_instanced_shading(traced):
    spans = traced["spans"]
    sg = [s for s in spans if s.name == "shading_geometry"]
    i2w = [s for s in spans if s.name == "instance_to_world"]
    assert len(sg) == 1 and len(i2w) == 1
    assert i2w[0].parent == sg[0].id and i2w[0].lanes == N


def test_spans_change_no_result(traced):
    closest, any_hit = traced["got"]
    for k in ("t", "prim", "b1", "b2", "inst"):
        assert torch.equal(closest[k], traced["plain"][0][k])
    assert torch.equal(any_hit["occluded"], traced["plain"][1]["occluded"])


def test_no_profiler_no_sweep_span():
    telemetry.reset()
    scene = _scene()
    o, d, tmax, time = _rays()
    tinst.instances_intersect(scene, o[:64], d[:64], tmax[:64], None, time[:64])
    assert not telemetry.SPANS
