"""The port's instanced route (TLAS sweep, per-ray BLAS roots in the 4-wide
walk, instance transforms, POINT light, the ray time) against grail's.

Scene: a floor, a point light, 3 still, 1 animated and 1 mirrored instance
(negative scale: its `swap` is set) of a sphere(nu=12, nv=6) object, and one
instance of another object (a sphere(nu=14, nv=7)) whose BLAS comes first,
so the first object's does not start at node 0; a 16x16 camera. (On these
meshes the port's SAH builder gives the reference's trees; on spheres of 100
triangles or fewer the reference's numpy builder, which it uses below 2,048
triangles, splits otherwise.) Every comparison feeds both packages the same numpy
inputs. Tolerances: t, b1, b2 within rtol 1e-4, atol 1e-5 where the prims
agree, because the reference applies its transforms with einsum and XLA
contracts multiply-adds, which moves the object-space ray by a few ulps;
prim and inst must agree on all but equal-t ties (at most 0.1% of rays).
The walk with roots against the Pallas stream kernel with per-stream start
records (interpret mode): t within rtol 1e-4, as tests/test_torch_bvh4.py
(the interpret-mode kernel's FMAs moved t by up to 9.7e-6 of itself). li: at least 99% of lanes
within rtol 1e-4, atol 1e-6, as tests/test_torch_render.py. Ray gradients
on instance hits, which the reference cannot take (no reverse mode through
its BVH routes): against Möller-Trumbore on the world-space hit triangle,
and a render's gradient against the same scene flattened, within rtol 1e-3
and atol 1e-5 (1e-3 for the render) of the largest entry. The reference's
programs are traced one after another and compiled on threads (XLA compiles
without the GIL), which keeps the file's cold run short.
"""
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import rng as jrng
from grail.core import transform as jtr
from grail.engine import camera as jcam, film as jfilm, integrator as jint
from grail.kernels import instanced as jinst, intersect as jisect
from grail.kernels.bvh_stream import _run
from grail.scene.buffers import SceneBuilder as JaxBuilder
from grail.scene.shapes import sphere as jax_sphere
from grail.shade import geometry as jgeom, lights as jlights
from grail_torch.core import transform as tr
from grail_torch.engine import camera as cam, film as tfilm, integrator as tint
from grail_torch.engine.render import render_wave
from grail_torch.kernels import bvh4 as b4, instanced as tinst, intersect as tisect
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.buffers import SceneBuilder
from grail_torch.scene.shapes import sphere
from grail_torch.shade import bsdf as tbx, geometry as tgeom, lights as tlights
from grail_torch.shade.materials import CONV_INV

torch.set_num_threads(2)

RES, SPP = 16, 16            # 4,096 camera lanes
N = 4096
TIE_MAX = 0.001


def _build(builder, tr, cam, sphere):
    """The test scene through either package's builder and helpers."""
    b = builder()
    b.xres = b.yres = RES
    b.matte(kd=(0.6, 0.6, 0.6))
    b.matte(kd=(0.7, 0.4, 0.3))
    b.add_mesh(np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]], np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int64), 0)
    b.add_point_light((0.0, 4.0, 0.0), (30.0, 30.0, 30.0))
    c2w = tr.look_at((0, 1.5, 4.0), (0, 0.5, 0), (0, 1, 0))
    b.camera = cam.build_camera(cam.PERSPECTIVE, c2w, c2w, RES, RES, fov=50.0)
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
    return b


@pytest.fixture(scope="module")
def scenes():
    js, jm = _build(JaxBuilder, jtr, jcam, jax_sphere).finalize()
    sn = jax.tree_util.tree_map(np.asarray, js)
    own, own_meta = _build(SceneBuilder, tr, cam, sphere).finalize(device="cpu")
    ts, tm = scene_from_numpy(sn, jm, device="cpu")
    return js, jm, sn, own, own_meta, ts, tm


@pytest.fixture(scope="module")
def rays():
    """Rays from the camera and from points in the scene, random directions,
    some shadow-length, some dead, at random times."""
    rs = np.random.RandomState(3)
    o = (rs.rand(N, 3) * [4, 2, 3] + [-2, 0.05, -1.5]).astype(np.float32)
    o[:1536] = [0.0, 1.5, 4.0]
    d = rs.randn(N, 3).astype(np.float32)
    d[:1536] = [0.0, -0.2, -1.0] + rs.randn(1536, 3) * [0.35, 0.25, 0.1]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(N, 1.0e7, np.float32)
    tmax[1536:2200] = rs.rand(664).astype(np.float32) * 3.0
    tmax[2200:2300] = 0.0
    return {"o": o, "d": d, "tmax": tmax, "time": rs.rand(N).astype(np.float32)}


def _object_rays():
    """Object-space rays for the sphere(nu=12, nv=6)'s BLAS alone: 8
    streams of 128, some short, some dead (tmax = -3e37, as the sweep's)."""
    rs = np.random.RandomState(5)
    n = 1024
    o = (rs.rand(n, 3) * 1.6 - 0.8).astype(np.float32)
    o[:512] = rs.randn(512, 3) * 0.1 + [0.0, 0.0, 1.5]
    d = rs.randn(n, 3).astype(np.float32) * 1.3
    d[:512] = [0.0, 0.0, -1.0] + rs.randn(512, 3) * 0.2
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1.0e7, np.float32)
    tmax[600:700] = rs.rand(100) * 0.5
    tmax[700:720] = -3.0e37
    return o, d, tmin, tmax


BALL = 1                      # the sphere(nu=12, nv=6): the tables' second object
LI_CFG = jint.IntegratorConfig(kind="path", max_depth=3)


def _dispatch(js, o, d, tmax, time):
    """The reference's dispatch (closest hit and occlusion), its instanced
    sweep's closest hit (its jnp walk, the CPU default), and its shading
    geometry at the dispatch's closest hit."""
    hit = jisect.intersect(js, o, d, tmax, time=time)
    return {"intersect": hit,
            "instances": jinst.instances_intersect(js, o, d, tmax, None, time),
            "intersect_p": {"occluded": jisect.intersect_p(js, o, d, tmax, time=time)},
            "shading": jgeom.shading_geometry(js, hit, o, d, time=time)}


class _Programs:
    """The reference's jitted programs, traced in turn on this thread and
    compiled on the pool's; calling one by name waits for its compile and
    gives its outputs as numpy (run once, kept)."""

    def __init__(self, pool):
        self.pool, self.jobs, self.outs = pool, {}, {}

    def add(self, name, fn, *args):
        self.jobs[name] = (self.pool.submit(jax.jit(fn).lower(*args).compile), args)

    def __call__(self, name):
        if name not in self.outs:
            compiled, args = self.jobs[name]
            self.outs[name] = jax.tree_util.tree_map(np.asarray,
                                                     compiled.result()(*args))
        return self.outs[name]


@pytest.fixture(scope="module")
def reference(scenes, rays):
    """The reference's programs of this file, the longest compile first:
    li on its own camera rays, the dispatch on `rays` at their times, and
    the Pallas stream kernels with per-stream start records on
    _object_rays (interpret mode)."""
    js, jm, sn = scenes[:3]
    with ThreadPoolExecutor(4) as pool:
        progs = _Programs(pool)
        progs.add("li", partial(_camera_li, js, jm, LI_CFG))
        progs.add("dispatch", partial(_dispatch, js), *_j(rays, "o", "d", "tmax", "time"))
        n = 1024
        starts = jnp.full((n // 128,), sn["inst"]["obj_roots"][BALL], jnp.int32)
        for any_hit in (False, True):
            progs.add(("walk", any_hit),
                      partial(_run, any_hit=any_hit, interpret=True, starts=starts),
                      jnp.asarray(sn["inst"]["stream"]), *map(jnp.asarray, _object_rays()))
        yield progs


def _j(r, *keys):
    return [jnp.asarray(r[k]) for k in keys]


def _t(r, *keys):
    return [torch.tensor(r[k]) for k in keys]


def _agree(ref, got, keys=("t", "b1", "b2")):
    """prim (and inst) agree up to counted ties; floats close where they do."""
    same = got["prim"] == ref["prim"]
    assert 1.0 - same.mean() <= TIE_MAX, f"prim differs on {(~same).sum()} rays"
    if "inst" in ref:
        assert (got["inst"][same] == ref["inst"][same]).all()
    for k in keys:
        np.testing.assert_allclose(got[k][same], ref[k][same], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    return same


def test_builder_matches_reference(scenes):
    """The port's SceneBuilder against the reference's; the bridge gives the
    same tables as the port's own build."""
    _, jm, sn, own, own_meta, ts, tm = scenes
    for k in ("verts", "vnorm", "vuv", "tri_idx", "tri_mat", "tri_light", "tri_flags"):
        np.testing.assert_array_equal(own[k].numpy(), sn[k], err_msg=k)
    assert own_meta == tm and own_meta.n_tris == jm.n_tris == 2
    inst = own["inst"]
    for k in ("obj", "anim", "swap"):
        np.testing.assert_array_equal(inst[k].numpy(), sn["inst"][k], err_msg=k)
    for k in ("t", "q", "s", "m0", "m0_inv", "wmin", "wmax"):
        np.testing.assert_allclose(inst[k].numpy(), sn["inst"][k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert inst["anim"].tolist() == [False] * 3 + [True, False, False]
    assert inst["swap"].tolist() == [False] * 4 + [True, False]
    # the sphere(nu=12, nv=6)'s BLAS follows the other object's
    roots = inst["root"].tolist()
    assert roots[0] == roots[1] == roots[2] == roots[3] == roots[4] != roots[5]
    # bridge and own build: every leaf of the instance table and the tables
    for k, v in list(inst.items()) + [("world_bounds", own["world_bounds"])]:
        got = ts["world_bounds"] if k == "world_bounds" else ts["inst"][k]
        if isinstance(v, int):
            assert v == got, k
        else:   # float words compared as bits: child refs of -1 are NaN
            assert v.dtype == got.dtype and torch.equal(v.view(torch.uint8),
                                                        got.view(torch.uint8)), k
    for k in ("bvh4_nodes", "bvh4_tris"):
        assert torch.equal(own["bvh"][k].view(torch.int32), ts["bvh"][k].view(torch.int32))
    # the world bounds: the floor and the instances' motion boxes
    wb = own["world_bounds"].numpy()
    np.testing.assert_array_equal(wb[0], np.minimum([-5, 0, -5], sn["inst"]["wmin"].min(0)))
    np.testing.assert_array_equal(wb[1], np.maximum([5, 0, 5], sn["inst"]["wmax"].max(0)))


def test_mat_specs_match_reference(scenes):
    """Each material's lobe slots (SceneMeta.mat_specs), from the port's
    builder and through the bridge, as the reference's."""
    _, jm, _, _, own_meta, _, tm = scenes
    assert own_meta.mat_specs == tm.mat_specs == jm.mat_specs and len(jm.mat_specs) == 2


def test_single_leaf_object_root():
    """An object of at most 4 triangles is one leaf: its root is the leaf ref
    ~first, and no node is stored for it."""
    b = _build(SceneBuilder, tr, cam, sphere)
    tiny = b.add_object()
    b.add_object_mesh(tiny, [[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 1, 2]], 0)
    b.add_instance(tiny, tr.translate((0.0, 0.2, 1.5)))
    s, _ = b.finalize(device="cpu")
    inst = s["inst"]
    tiny_prim = s["tri_idx"].shape[0] - 1          # appended last
    n_rows = inst["bvh4_tris"].shape[0]
    assert int(inst["root"][-1]) == ~(n_rows - 1)
    assert int(inst["bvh4_tris"][-1, 3:4].view(torch.int32)) == tiny_prim
    o = torch.tensor([[0.2, 0.4, 3.0], [0.9, 0.9, 3.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    hit = tisect.intersect(s, o, d, torch.full((2,), 1e7), device="cpu")
    assert hit["inst"].tolist() == [6, -1] and int(hit["prim"][0]) == tiny_prim
    assert abs(float(hit["t"][0]) - 1.5) < 1e-6


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_roots_walk_matches_pallas_interpret(scenes, reference, any_hit):
    """bvh4_traverse_plain with per-ray roots against grail's stream kernel
    with per-stream start records (ordered closest hit, skip any hit), on
    object-space rays of the sphere(nu=12, nv=6), whose BLAS is the second
    in the tables: 8 streams of 128."""
    _, _, sn, _, _, ts, _ = scenes
    o, d, tmin, tmax = _object_rays()
    n = o.shape[0]
    assert sn["inst"]["obj_roots"][BALL] > 0
    ref = reference(("walk", any_hit))
    inst = ts["inst"]
    k = int(np.nonzero(sn["inst"]["obj"] == BALL)[0][0])
    roots = inst["root"][k].repeat(n)
    assert int(roots[0]) > 0
    before = dict(b4.LAUNCHES)
    t, prim, b1, b2, n_node, _, _ = [a.numpy() for a in b4.bvh4_traverse_plain(
        inst["bvh4_nodes"], inst["bvh4_tris"], *map(torch.tensor, (o, d, tmin, tmax)),
        any_hit=any_hit, stack=inst["bvh4_stack"], roots=roots)]
    hit = prim >= 0
    np.testing.assert_array_equal(hit, ref[1] >= 0)
    assert 0.2 < hit.mean() < 0.9 and not hit[700:720].any()
    # every prim is a global id of the object's triangles
    lo, hi = 2 + 2 * 14 * 7, 2 + 2 * 14 * 7 + 2 * 12 * 6
    assert ((prim[hit] >= lo) & (prim[hit] < hi)).all()
    if any_hit:
        assert (t[hit] == np.float32(-3.0e37)).all()
    else:
        same = prim == ref[1]
        assert 1.0 - same.mean() <= TIE_MAX
        # XLA contracts the interpret-mode kernel's multiply-adds into FMAs
        np.testing.assert_allclose(t[same], ref[0][same], rtol=1e-4)
        np.testing.assert_allclose(b1[same], ref[2][same], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b2[same], ref[3][same], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(t[~hit], tmax[~hit])
    assert (n_node >= 1).all()          # the root is a node here
    # the wrapper takes the plain version on the CPU and launches nothing
    got = b4.bvh4_traverse(inst["bvh4_nodes"], inst["bvh4_tris"],
                           *map(torch.tensor, (o, d, tmin, tmax)), any_hit=any_hit,
                           stack=inst["bvh4_stack"], roots=roots)
    np.testing.assert_array_equal(got[1].numpy(), prim)
    assert b4.LAUNCHES == before


@pytest.mark.parametrize("call", ["instances", "instances_any_hit", "intersect",
                                  "intersect_p"])
def test_intersect_matches_reference(scenes, rays, reference, call):
    """instances_intersect and the dispatch against the reference (its jnp
    walk) at random ray times. The sweep's any hit occludes exactly the
    rays on which the reference's sweep finds a closest hit."""
    ts = scenes[5]
    tr_ = _t(rays, "o", "d", "tmax", "time")
    if call.startswith("instances"):
        any_hit = call.endswith("any_hit")
        got = tinst.instances_intersect(ts, *tr_[:3], None, tr_[3], any_hit=any_hit)
        assert tinst.LAST_SWEEPS[-1][:2] == ("any_hit" if any_hit else "closest", N)
    elif call == "intersect":
        got = tisect.intersect(ts, *tr_[:3], device="cpu", time=tr_[3])
    else:
        got = {"occluded": tisect.intersect_p(ts, *tr_[:3], device="cpu", time=tr_[3])}
    ref = reference("dispatch")
    ref = ref[call] if call in ref else {"occluded": ref["instances"]["prim"] >= 0}
    got = {k: v.numpy() for k, v in got.items()}
    if "occluded" in ref:
        np.testing.assert_array_equal(got["occluded"], ref["occluded"])
        assert 0.1 < got["occluded"].mean() < 0.9
        return
    same = _agree(ref, got)
    on_inst = got["inst"] >= 0
    assert on_inst.mean() > 0.1 and len(set(got["inst"][on_inst].tolist())) == 6
    np.testing.assert_array_equal(got["t"][got["prim"] < 0], np.float32(3.0e37))
    if call == "intersect":
        assert (got["prim"][same & ~on_inst] < 2).all()      # base hits: the floor


def test_shading_geometry_on_instances(scenes, rays, reference):
    """p, ng, ns and uv on instance hits (the mirrored one included) from
    the same hit record, at the rays' times."""
    ts = scenes[5]
    tr_ = _t(rays, "o", "d", "tmax", "time")
    ref = reference("dispatch")
    hit = ref["intersect"]
    got = tgeom.shading_geometry(ts, {k: torch.tensor(v) for k, v in hit.items()},
                                 tr_[0], tr_[1], time=tr_[3])
    on = hit["inst"] >= 0
    assert on.sum() > 200 and (hit["inst"] == 4).sum() > 10     # the mirrored one
    for k in ("p", "ng", "ns", "uv"):
        np.testing.assert_allclose(got[k].numpy()[on], ref["shading"][k][on],
                                   rtol=1e-4, atol=2e-5, err_msg=k)
    # the mirrored instance's normals face out, as the still ones' do
    for i in (0, 4):
        m = hit["inst"] == i
        centre = np.asarray(ts["inst"]["m0"][i, :3, 3])
        out = ((got["p"].numpy()[m] - centre) * got["ns"].numpy()[m]).sum(1)
        assert (out > 0).all(), i


def test_point_light_sample_li(scenes):
    js, jm, _, _, _, ts, tm = scenes
    rs = np.random.RandomState(9)
    p = (rs.rand(512, 3) * [6, 3, 6] + [-3, 0, -3]).astype(np.float32)
    p[:4] = [0.0, 4.0, 0.0]              # at the light: d^2 clamped at 1e-20
    u = rs.rand(3, 512).astype(np.float32)
    li = np.zeros(512, np.int32)
    ref = jax.jit(lambda *a: jlights.sample_li(js, *a, jm.light_types))(
        jnp.asarray(li), jnp.asarray(p), *map(jnp.asarray, u))
    got = tlights.sample_li(ts, torch.tensor(li), torch.tensor(p), *map(torch.tensor, u),
                            tm.light_types)
    assert tm.light_types == (tlights.POINT,)
    for k in ("wi", "radiance", "pdf", "dist"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert got["delta"].all() and (got["pdf"] == 1.0).all()
    # a light type the scene lacks changes no point light's sample
    more = tlights.sample_li(ts, torch.tensor(li), torch.tensor(p), *map(torch.tensor, u),
                             (tlights.POINT, tlights.PROJECTION, tlights.GONIOMETRIC))
    for k in ("wi", "radiance", "pdf", "dist", "delta"):
        assert torch.equal(more[k], got[k]), k


def _camera_li(js, jm, cfg):
    """The reference's camera rays of one SPP-sample megawave (each with its
    shutter time) and its li on them, in one jitted function."""
    n_pix = RES * RES
    px_t, py_t = jfilm.lane_pixel(jnp.arange(n_pix, dtype=jnp.uint32), RES)
    pix = jnp.tile(py_t.astype(jnp.uint32) * RES + px_t.astype(jnp.uint32), SPP)
    samp = jnp.repeat(jnp.arange(SPP, dtype=jnp.uint32), n_pix)
    ufx, ufy = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_FILM)
    ul1, ul2 = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_LENS)
    ut = jrng.sample_1d(jm.sampler, pix, samp, jint.SLOT_TIME)
    rays = jcam.generate_rays(js["camera"], (pix % RES).astype(jnp.int32),
                              (pix // RES).astype(jnp.int32), ufx, ufy, ul1, ul2, ut,
                              jm.cam_kind)
    rays = {k: rays[k] for k in ("o", "d", "weight", "time")}
    return rays, pix, samp, jint.li(js, jm, cfg, rays, pix, samp)


def test_li_matches_reference_per_lane(scenes, reference, monkeypatch):
    """The path integrator with motion blur, per lane, on the reference's
    camera rays; the pre-RR split, which repacks the lanes with their
    times, leaves every lane's value as it was; and the moving instance
    smears across the shutter."""
    ts, tm = scenes[5:]
    assert LI_CFG.compact_min > N                 # no split in the reference
    out = reference("li")
    rays, pix, samp = ({k: torch.tensor(v) for k, v in out[0].items()},
                       *(torch.tensor(a.astype(np.int64)) for a in out[1:3]))
    L_ref = out[3]
    assert float(rays["time"].min()) < 0.1 and float(rays["time"].max()) > 0.9
    L = tint.li(ts, tm, tint.IntegratorConfig(kind="path", max_depth=3),
                rays, pix, samp).numpy()
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"
    seen = []
    take = tint._compaction_take

    def recording_take(active, cap):
        out = take(active, cap)
        seen.append((cap, int(out[1])))
        return out

    monkeypatch.setattr(tint, "_compaction_take", recording_take)
    L_split = tint.li(ts, tm, tint.IntegratorConfig(kind="path", max_depth=3,
                                                    compact_min=N),
                      rays, pix, samp).numpy()
    assert seen and seen[0][0] == N // 2 and seen[0][1] <= N // 2
    np.testing.assert_array_equal(L_split, L)
    # the animated instance (3) at shutter open and close: the camera lanes
    # that see it move
    seen = [tisect.intersect(ts, rays["o"], rays["d"], torch.full((N,), 1e7),
                             device="cpu", time=torch.full((N,), u))["inst"] == 3
            for u in (0.0, 1.0)]
    assert seen[0].sum() > 50 and seen[1].sum() > 50
    assert (seen[0] != seen[1]).sum() > 0.5 * seen[0].sum()


def test_ray_gradients_on_instance_hits(scenes, rays):
    """The closest hit's t, b1 and b2 differentiate to the rays on instance
    hits (still, animated and mirrored) as on the floor: against
    Möller-Trumbore on the hit triangle in world space (its object rows
    through o2w_point at the ray's time). The values are the sweep's."""
    ts = scenes[5]
    tmax, time = _t(rays, "tmax", "time")
    o, d = (a.requires_grad_(True) for a in _t(rays, "o", "d"))
    hit = tisect.intersect(ts, o, d, tmax, device="cpu", time=time)
    with torch.no_grad():
        plain = tisect.intersect(ts, o, d, tmax, device="cpu", time=time)
    for k in plain:
        assert torch.equal(hit[k], plain[k]), k
    ok, on_inst = hit["prim"] >= 0, hit["inst"] >= 0
    assert {int(i) for i in hit["inst"][on_inst]} == set(range(6))
    w = torch.tensor(np.random.RandomState(1).rand(3, N).astype(np.float32))

    def loss(t, b1, b2):
        return (torch.where(ok, t, 0.0) * w[0] + torch.where(ok, b1, 0.0) * w[1]
                + torch.where(ok, b2, 0.0) * w[2]).sum()

    got = torch.autograd.grad(loss(hit["t"], hit["b1"], hit["b2"]), (o, d))
    o2, d2 = (a.detach().requires_grad_(True) for a in (o, d))
    idx = ts["tri_idx"][hit["prim"].clamp_min(0).long()]
    pk = tinst.gather_pack(ts["inst"], hit["inst"].clamp_min(0))
    v0, v1, v2 = (torch.where(on_inst[:, None], tinst.o2w_point(pk, time, v), v)
                  for v in (ts["verts"][idx[:, k]] for k in range(3)))
    _, t, b1, b2 = tisect.moller_trumbore(o2, torch.where(ok[:, None], d2, 0.0), v0,
                                          v1 - v0, v2 - v0, torch.zeros(N), tmax)
    want = torch.autograd.grad(loss(t, b1, b2), (o2, d2))
    for g, g_want in zip(got, want):
        assert (g[on_inst].abs().sum(1) > 0).all()
        np.testing.assert_allclose(g.numpy(), g_want.numpy(), rtol=1e-3,
                                   atol=1e-5 * float(g_want.abs().max()))


def test_render_wave_refuses_geometry_gradients(scenes):
    """No gradient reaches instanced geometry or the instance transforms;
    material gradients do."""
    _, _, _, own, own_meta, _, _ = scenes
    cfg = tint.IntegratorConfig(kind="path", max_depth=1)
    film = tfilm.new_film(RES, RES, "cpu")
    verts = own["verts"].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="instanced"):
        render_wave(dict(own, verts=verts), own_meta, cfg, film, 0, device="cpu")
    m0 = own["inst"]["m0"].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="instanced"):
        render_wave(dict(own, inst=dict(own["inst"], m0=m0)), own_meta, cfg, film, 0,
                    device="cpu")
    const = own["tex_data"]["const"].clone().requires_grad_(True)
    scene = dict(own, tex_data=dict(own["tex_data"], const=const))
    tfilm.develop(render_wave(scene, own_meta, cfg, film, 0, device="cpu")).mean().backward()
    assert torch.isfinite(const.grad).all() and (const.grad != 0).any()


def _glossy_field(instanced):
    """Three spheres on a floor, all of a LAMBERT + BLINN material whose
    roughness (the exponent's inverse) is texture 0, with every sphere
    instanced or in world space in the base soup (the same vertices: a
    translation moves an object row exactly)."""
    b = SceneBuilder()
    b.xres = b.yres = RES
    rough = b.const_tex(0.05)
    mat = b.add_material([
        {"type": tbx.LAMBERT, "s0": b.const_tex((0.3, 0.3, 0.3))},
        {"type": tbx.BLINN, "s0": b.const_tex((0.6, 0.6, 0.6)), "fr": tbx.FR_DIELECTRIC,
         "f0": rough, "f0_conv": CONV_INV, "f2": b.const_tex((1.5, 1.5, 1.5))}])
    b.add_mesh(np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]], np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int64), mat)
    b.add_point_light((0.0, 4.0, 2.0), (30.0, 30.0, 30.0))
    c2w = tr.look_at((0, 1.2, 4.0), (0, 0.3, 0), (0, 1, 0))
    b.camera = cam.build_camera(cam.PERSPECTIVE, c2w, c2w, RES, RES, fov=50.0)
    v, i, n, uv = sphere(radius=0.4, nu=12, nv=6)
    ball = b.add_object() if instanced else None
    if instanced:
        b.add_object_mesh(ball, v, i, mat, normals=n, uvs=uv)
    for p in ((-1.0, 0.45, -0.5), (0.2, 0.45, -0.9), (1.1, 0.45, -0.3)):
        if instanced:
            b.add_instance(ball, tr.translate(p))
        else:
            b.add_mesh(v + np.asarray(p, np.float32), i, mat, normals=n, uvs=uv)
    assert rough == 0
    return b.finalize(device="cpu")


def test_glossy_gradient_instanced_matches_flattened():
    """A glossy exponent bends the sampled direction, so its gradient runs
    through the next hit's ray: on instance hits as on base hits. The
    render's texture gradients on the instanced field equal those on the
    same field flattened."""
    cfg = tint.IntegratorConfig(kind="path", max_depth=2)
    grads, imgs = [], []
    for instanced in (True, False):
        scene, meta = _glossy_field(instanced)
        assert ("inst" in scene) == instanced
        const = scene["tex_data"]["const"].clone().requires_grad_(True)
        scene = dict(scene, tex_data=dict(scene["tex_data"], const=const))
        img = tfilm.develop(render_wave(scene, meta, cfg, tfilm.new_film(RES, RES, "cpu"),
                                        0, device="cpu"))
        img.mean().backward()
        grads.append(const.grad.numpy())
        imgs.append(img.detach().numpy())
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-4, atol=1e-6)
    assert grads[0][0, 0] != 0.0                       # the roughness
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-3,
                               atol=1e-3 * float(np.abs(grads[1]).max()))
