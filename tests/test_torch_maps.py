"""The port's cameras, procedural textures and mappings, projection and
goniometric lights, bump frames and alpha cutouts against the reference's.

Seeded numpy inputs through both packages:
- Perlin noise, fbm and turbulence at 4,096 points, negative coordinates
  included (allclose rtol 1e-5, atol 1e-6; bitwise on this CPU);
- every mapping's (s, t) and every texture kind, rows of one table built
  by the reference's SceneBuilder and carried across by the bridge, at
  4,096 shade points with uv screen differentials (so image rows take EWA,
  at zero width through a non-uv mapping) (rtol 1e-5, atol 1e-6). The
  checkerboard and dots decisions must agree but within 1e-5 of a cell
  edge (or of a dot's rim); no point of these inputs needs that allowance.
  The image row under the spherical mapping is looked up at the
  reference's (s, t): the two packages' arccos differ in the last bits
  (1.3e-6 in s, within the mapping's tolerance), which the random image's
  texel steps amplify to 2e-5;
- the orthographic camera's rays, with and without a thin lens, within
  1e-6; the environment camera's within 1e-5 of the reference's with the
  film resolution added to its camera dict, which its build_camera leaves
  out (ROADMAP C.8);
- projection and goniometric lights with image maps, and a goniometric
  light without one: their factors and sample_li (rtol 1e-5); a projection
  light without a map, which crashes the reference (ROADMAP C.2), against
  pbrt's rule (the point light's radiance inside the frustum, 0 outside);
  light_power;
- the bump-mapped shading frames (ns, ss, ts) of bump.pbrt's camera hits
  (atol 1e-5);
- the alpha cutouts' re-traces on alphacut (grail_torch/tools/gen_assets.py):
  camera and shadow rays through scene_intersect and scene_intersect_p, prim
  and occlusion equal, t within 1e-6; b1 and b2 within 4e-6, because the
  two packages' plain closest hits of the same rays, with no cutout,
  already differ by up to 1.9e-6 there (the floor's 0.86-unit cells seen
  from 5 units: Möller-Trumbore's products round in another order);
- gen_assets' arrays against those of the reference's scenes/gen_assets.py.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import transform as jtr
from grail.engine import camera as jcam
from grail.engine import integrator as jint
from grail.kernels import intersect as jisect
from grail.scene import parser as jparser
from grail.scene.buffers import SceneBuilder as JBuilder
from grail.shade import geometry as jgeom, lights as jlt, textures as jtex
from grail_torch.engine import camera as tcam
from grail_torch.engine import integrator as tint
from grail_torch.engine.imageio import read_image
from grail_torch.kernels import intersect as tisect
from grail_torch.scene import parser as tparser
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.shade import geometry as tgeom, lights as tlt, textures as ttex
from grail_torch.tools import gen_assets

torch.set_num_threads(2)

N = 4096
REPO = os.path.join(os.path.dirname(__file__), os.pardir)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, ref, what, rtol=1e-5, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """scenes/ with the generated assets and alphacut.pbrt beside them."""
    return gen_assets.scene_copy(str(tmp_path_factory.mktemp("maps") / "scenes"))


# ----------------------------------------------------------------- noise
@pytest.mark.parametrize("fn", ("noise", "fbm", "turbulence"))
def test_noise_matches_reference(fn):
    p = (np.random.default_rng(1).random((N, 3)) * 40.0 - 20.0).astype(np.float32)
    args = {"noise": (), "fbm": (0.5, 8), "turbulence": (0.6, 6)}[fn]
    ref = getattr(jtex, fn)(jnp.asarray(p), *args)
    got = getattr(ttex, fn)(_t(p), *args)
    _close(got, ref, fn)
    assert np.asarray(ref).std() > 0.1


# --------------------------------------------------------------- textures
_W2T = {"shift": jtr.translate([0.3, -0.2, 0.1]), "scale3": jtr.scale(3.0, 3.0, 3.0),
        "scale4": jtr.scale(4.0, 4.0, 4.0)}
# name -> (TexSpec fields, inputs from the four constant rows, w2t)
_KINDS = {
    "bilerp": (dict(kind="bilerp", su=2.0), (0, 1, 2, 3), None),
    "uv": (dict(kind="uv", su=3.0, du=0.2), (), None),
    "checkerboard_2d": (dict(kind="checkerboard", su=8.0, sv=8.0), (0, 1), None),
    "checkerboard_3d": (dict(kind="checkerboard", dim=3), (0, 1), "scale4"),
    "dots": (dict(kind="dots", su=6.0, sv=6.0), (2, 3), None),
    "fbm": (dict(kind="fbm", octaves=8, omega=0.5), (), "scale3"),
    "wrinkled": (dict(kind="wrinkled", octaves=6, omega=0.6), (), "scale3"),
    "windy": (dict(kind="windy"), (), "scale3"),
    "marble": (dict(kind="marble", scale=3.0, variation=0.2), (), None),
    "image_uv": (dict(kind="image", image_id=0, su=2.0), (), None),
    "image_spherical": (dict(kind="image", image_id=0, mapping="spherical"), (), "shift"),
    "image_planar": (dict(kind="image", image_id=0, mapping="planar", filt="trilinear",
                          v1=(1.0, 0.0, 0.0), v2=(0.0, 0.0, 1.0)), (), None),
}


_MAPPINGS = {"uv": (dict(su=3.0, sv=-2.0, du=0.2, dv=0.3), None),
             "spherical": (dict(su=2.0, dv=0.1), "shift"),
             "cylindrical": (dict(sv=1.5, du=-0.4), "shift"),
             "planar": (dict(v1=(0.6, 0.0, 0.8), v2=(0.0, 1.0, 0.0), du=0.25, dv=-0.5),
                        None)}


def _shade_points(rng):
    return {"p": (rng.random((N, 3)) * 6.0 - 3.0).astype(np.float32),
            "uv": (rng.random((N, 2)) * 4.0 - 2.0).astype(np.float32),
            "duvdx": (rng.normal(size=(N, 2)) * 0.01).astype(np.float32),
            "duvdy": (rng.normal(size=(N, 2)) * 0.01).astype(np.float32)}


@pytest.mark.parametrize("mapping", sorted(_MAPPINGS))
def test_mapping_matches_reference(mapping):
    fields, w2t = _MAPPINGS[mapping]
    w2t = jtr.identity() if w2t is None else _W2T[w2t]
    sg = _shade_points(np.random.default_rng(6))
    ref = jtex.apply_mapping(jtex.TexSpec(kind="uv", mapping=mapping, **fields),
                             jnp.asarray(w2t), {k: jnp.asarray(v) for k, v in sg.items()})
    got = ttex.apply_mapping(ttex.TexSpec(kind="uv", mapping=mapping, **fields),
                             _t(w2t), {k: _t(v) for k, v in sg.items()})
    for axis, g, r in zip("st", got, ref):
        _close(g, r, axis)
        assert g.std() > 0.05


@pytest.fixture(scope="module")
def textures():
    """{name: (the reference's (N,3), the port's (N,3), the port's (s, t))}
    for each row of _KINDS, evaluated by both eval_textures."""
    b = JBuilder()
    consts = [b.const_tex(c) for c in ((0.9, 0.1, 0.1), (0.2, 0.7, 0.3),
                                       (0.1, 0.2, 0.8), (0.6, 0.6, 0.1))]
    rng = np.random.default_rng(2)
    b.add_image(rng.random((24, 40, 3)).astype(np.float32))
    rows = {}
    for name, (fields, inputs, w2t) in _KINDS.items():
        spec = jtex.TexSpec(inputs=tuple(consts[i] for i in inputs), **fields)
        rows[name] = b.add_texture(spec, w2t=None if w2t is None else _W2T[w2t])
    b.add_mesh(np.eye(3, dtype=np.float32), np.array([[0, 1, 2]]), b.matte())
    b.camera = jcam.build_camera(jcam.PERSPECTIVE, jtr.identity(), jtr.identity(), 8, 8)
    js, jm = b.finalize()
    ts, tm = scene_from_numpy(_np(js), jm, device="cpu")
    sg = _shade_points(rng)
    ref = np.asarray(jtex.eval_textures(jm.tex_specs, js["tex_data"],
                                        {k: jnp.asarray(v) for k, v in sg.items()},
                                        js["images"], js["mipmaps"]))
    tsg = {k: _t(v) for k, v in sg.items()}
    got = ttex.eval_textures(tm.tex_specs, ts["tex_data"], tsg, ts["images"],
                             ts["mipmaps"]).numpy()
    r = rows["image_spherical"]
    jsg = {k: jnp.asarray(v) for k, v in sg.items()}
    s_ref, t_ref = jtex.apply_mapping(jm.tex_specs[r], js["tex_data"]["w2t"][r], jsg)
    got[r] = ttex.image_lookup(tm.tex_specs[r], ts["images"], ts["mipmaps"], tsg,
                               _t(s_ref), _t(t_ref)).numpy()
    st = {name: [x.numpy() for x in ttex.apply_mapping(
        tm.tex_specs[r], ts["tex_data"]["w2t"][r], tsg)]
        if tm.tex_specs[r].dim == 2 else None for name, r in rows.items()}
    return {name: (ref[r], got[r], st[name]) for name, r in rows.items()}


@pytest.mark.parametrize("name", sorted(_KINDS))
def test_texture_kind_matches_reference(textures, name):
    ref, got, st = textures[name]
    assert np.isfinite(got).all()
    if name.startswith(("checkerboard", "dots")):
        # a decision may flip only within 1e-5 of a cell edge (or a dot's rim)
        differ = np.any(got != ref, axis=-1)
        if name == "checkerboard_2d":
            edge = np.min([np.abs(x - np.round(x)) for x in st], axis=0) < 1e-5
        else:
            edge = np.zeros(N, bool)
        assert not (differ & ~edge).any(), f"{int(differ.sum())} decisions differ"
        assert int(differ.sum()) == 0       # none of these points lies on an edge
        assert len(np.unique(got[:, 0])) == 2
    else:
        _close(got, ref, name)
    assert got.std(axis=0).max() > 1e-3     # the row varies over the points


def test_unknown_mapping_raises():
    sg = {"p": torch.zeros(4, 3), "uv": torch.zeros(4, 2)}
    with pytest.raises(ValueError, match="mapping"):
        ttex.apply_mapping(ttex.TexSpec(kind="uv", mapping="conical"), torch.eye(4), sg)


# ---------------------------------------------------------------- cameras
@pytest.mark.parametrize("case", ("ortho", "ortho_lens", "environment"))
def test_camera_rays_match_reference(case):
    c2w0 = jtr.inverse(jtr.look_at([0.5, 2.0, 3.0], [0.0, 0.3, 0.0], [0.0, 1.0, 0.0]))
    c2w1 = jtr.translate([0.2, 0.0, 0.0]) @ c2w0
    xres, yres = 48, 32
    kind = jcam.ENVIRONMENT if case == "environment" else jcam.ORTHOGRAPHIC
    kw = dict(screen_window=[-2.0, 2.0, -1.5, 1.5])
    if case == "ortho_lens":
        kw.update(lens_radius=0.1, focal_distance=3.0)
    jc = jcam.build_camera(kind, c2w0, c2w1, xres, yres, **kw)
    tc = tcam.build_camera(kind, c2w0, c2w1, xres, yres, **kw)
    if case == "environment":
        # the reference's pack lacks the film size its raygen reads (C.8)
        assert "yres" not in jc and tc["yres"] == yres and tc["xres"] == xres
        jc = dict(jc, xres=xres, yres=yres)
    rng = np.random.default_rng(3)
    px = rng.integers(0, xres, N).astype(np.int32)
    py = rng.integers(0, yres, N).astype(np.int32)
    u = rng.random((5, N)).astype(np.float32)
    ref = jcam.generate_rays(jc, jnp.asarray(px), jnp.asarray(py),
                             *map(jnp.asarray, u), kind)
    got = tcam.generate_rays({k: _t(v) if not isinstance(v, dict)
                              else {kk: _t(vv) for kk, vv in v.items()}
                              for k, v in tc.items()},
                             _t(px), _t(py), *map(_t, u), kind)
    tol = 1e-5 if case == "environment" else 1e-6
    for k in ("o", "d", "time"):
        _close(got[k], ref[k], k, rtol=tol, atol=tol)


# ----------------------------------------------------------------- lights
@pytest.fixture(scope="module")
def light_scene():
    """Two lights with maps (projection, goniometric) and two without,
    built by the reference's builder and carried across; the scene's seeded
    shade points and light rows."""
    b = JBuilder()
    assets = gen_assets.assets()
    slide = b.add_image(assets["slide"])
    gonio = b.add_image(assets["gonio"])
    l2w_p = (jtr.translate([-1.5, 2.5, 2.5]) @ jtr.rotate(-45, [1, 0, 0])
             @ jtr.rotate(-30, [0, 1, 0]))
    b.add_projection_light(l2w_p, (30, 30, 30), fov=35, image_id=slide)
    b.add_goniometric_light(jtr.translate([1.5, 1.8, 0.0]) @ jtr.rotate(20, [0, 0, 1]),
                            (10, 10, 10), image_id=gonio)
    b.add_goniometric_light(jtr.translate([0.0, 3.0, 0.0]), (5, 5, 5))
    b.add_projection_light(jtr.translate([0.0, 2.0, 0.0]) @ jtr.rotate(90, [1, 0, 0]),
                           (8, 8, 8), fov=50)
    b.add_mesh(np.eye(3, dtype=np.float32), np.array([[0, 1, 2]]), b.matte())
    b.camera = jcam.build_camera(jcam.PERSPECTIVE, jtr.identity(), jtr.identity(), 8, 8)
    js, jm = b.finalize()
    ts, tm = scene_from_numpy(_np(js), jm, device="cpu")
    rng = np.random.default_rng(4)
    p = (rng.random((N, 3)) * [6, 2, 6] + [-3, -0.5, -3]).astype(np.float32)
    li = rng.integers(0, 4, N).astype(np.int32)
    u = rng.random((3, N)).astype(np.float32)
    return js, jm, ts, tm, p, li, u


def test_light_meta_matches_reference(light_scene):
    js, jm, ts, tm, *_ = light_scene
    assert tm.light_image_rows == jm.light_image_rows == ((0, 0), (1, 1))
    assert tm.light_types == (tlt.PROJECTION, tlt.GONIOMETRIC)
    ref = np.asarray(jlt.light_power(js))
    got = tlt.light_power(ts["lights"], ts["world_radius"]).numpy()
    _close(got, ref, "light_power")


@pytest.mark.parametrize("factor", ("projection", "gonio"))
def test_light_factor_matches_reference(light_scene, factor):
    js, jm, ts, tm, p, li, _ = light_scene
    rows = (1, 2) if factor == "gonio" else (0,)       # the lights of that type
    li = np.asarray(rows, np.int32)[np.arange(N) % len(rows)]
    w = p / np.linalg.norm(p, axis=1, keepdims=True)
    fn = {"projection": "_projection_factor", "gonio": "_gonio_factor"}[factor]
    ref = getattr(jlt, fn)(js["lights"], jnp.asarray(li), jnp.asarray(w), js["images"],
                           dict(jm.light_image_rows))
    got = getattr(tlt, fn)(ts["lights"], _t(li), _t(w), ts["images"], tm.light_image_rows)
    _close(got, ref, factor)
    assert (np.asarray(ref) > 0).any() and (np.asarray(ref) == 0).any() == (factor != "gonio")


def test_sample_li_matches_reference(light_scene):
    js, jm, ts, tm, p, li, u = light_scene
    ref = jax.jit(lambda *a: jlt.sample_li(js, *a, jm.light_types, jm.light_image_rows))(
        jnp.asarray(li), jnp.asarray(p), *map(jnp.asarray, u))
    got = tlt.sample_li(ts, _t(li), _t(p), *map(_t, u), tm.light_types,
                        tm.light_image_rows)
    # the mapless projection light (row 3) is pbrt's below: the reference
    # gives it 0 when the scene has light maps, and crashes without (C.2)
    keep = li != 3
    for k in ("wi", "radiance", "pdf", "dist"):
        _close(got[k].numpy()[keep], np.asarray(ref[k])[keep], k)
    assert got["delta"].all()
    # pbrt's mapless projection light: I/d² inside the frustum, 0 outside
    m = ~keep
    lights = {k: v.numpy() for k, v in ts["lights"].items()}
    vec = lights["l2w"][3, :3, 3] - p[m]
    d2 = np.maximum((vec * vec).sum(1), 1e-20)
    wl = -vec / np.sqrt(d2)[:, None] @ lights["w2l"][3, :3, :3].T
    scr = lights["proj"][3] @ np.concatenate([wl, np.ones((len(wl), 1))], 1).T
    sx, sy = scr[0] / scr[3], scr[1] / scr[3]
    inside = (wl[:, 2] >= 1e-3) & (np.abs(sx) <= 1) & (np.abs(sy) <= 1)
    edge = (np.abs(np.abs(sx) - 1) < 1e-4) | (np.abs(np.abs(sy) - 1) < 1e-4)
    want = np.where(inside[:, None], lights["emit"][3] / d2[:, None], 0.0)
    rad = got["radiance"].numpy()[m]
    np.testing.assert_allclose(rad[~edge], want[~edge], rtol=1e-5, atol=1e-7)
    assert inside.any() and (~inside).any()


# -------------------------------------------------------------- bump, alpha
def _parsed(scene_dir, name, res):
    with open(os.path.join(scene_dir, name + ".pbrt")) as f:
        text = f.read().replace('"integer xresolution" [64] "integer yresolution" [64]',
                                f'"integer xresolution" [{res}] '
                                f'"integer yresolution" [{res}]')
    return (jparser.parse_string(text, search_path=scene_dir),
            tparser.parse_string(text, device="cpu", search_path=scene_dir))


def _camera_rays(js, jm, res):
    """Rays through every pixel centre's neighbourhood, by the reference."""
    rng = np.random.default_rng(5)
    n = res * res
    px, py = np.arange(n) % res, np.arange(n) // res
    u = rng.random((5, n)).astype(np.float32)
    r = jcam.generate_rays(js["camera"], jnp.asarray(px, jnp.int32),
                           jnp.asarray(py, jnp.int32), *map(jnp.asarray, u), jm.cam_kind)
    return np.asarray(r["o"]), np.asarray(r["d"])


def test_bump_frames_match_reference(scene_dir):
    (js, jm, _), (ts, tm, _) = _parsed(scene_dir, "bump", 48)
    assert tm.has_bump and tm.bump_rows == jm.bump_rows and len(tm.bump_rows) == 1
    o, d = _camera_rays(js, jm, 48)
    n = o.shape[0]
    hit = tisect.intersect(ts, _t(o), _t(d), torch.full((n,), 1e7), device="cpu")
    sg_t = tint._apply_bump(ts, tm, tgeom.shading_geometry(ts, hit, _t(o), _t(d)))
    jhit = {k: jnp.asarray(v.numpy()) for k, v in hit.items()}
    sg_j = jax.jit(lambda h, o, d: jint._apply_bump(
        js, jm, jgeom.shading_geometry(js, h, o, d)))(jhit, jnp.asarray(o), jnp.asarray(d))
    bumped = ts["materials"]["bump"][sg_t["mat"]].numpy() >= 0
    on = hit["prim"].numpy() >= 0
    assert (bumped & on).sum() > 200 and (~bumped & on).sum() > 200
    for k in ("ns", "ss", "ts"):
        _close(sg_t[k], sg_j[k], k, rtol=0, atol=1e-5)
    # the bump tilts the sphere's frames and leaves the floor's
    plain = tgeom.shading_geometry(ts, hit, _t(o), _t(d))
    tilt = np.abs(sg_t["ns"].numpy() - plain["ns"].numpy()).max(1)
    assert tilt[bumped & on].max() > 0.05 and tilt[~bumped].max() == 0


@pytest.fixture(scope="module")
def alpha_case(scene_dir):
    (js, jm, _), (ts, tm, _) = _parsed(scene_dir, "alphacut", 40)
    o, d = _camera_rays(js, jm, 40)
    # shadow rays toward the light from the floor's camera hits
    hit = tisect.intersect(ts, _t(o), _t(d), torch.full((o.shape[0],), 1e7),
                           device="cpu")
    p = o + np.minimum(hit["t"].numpy(), 1e7)[:, None] * d
    light = ts["lights"]["l2w"][0, :3, 3].numpy()
    vec = light - p
    dist = np.linalg.norm(vec, axis=1)
    wi = (vec / dist[:, None]).astype(np.float32)
    so = (p + 1e-3 * wi).astype(np.float32)
    return js, jm, ts, tm, (o, d), (so, wi, (dist - 2e-3).astype(np.float32))


@pytest.mark.parametrize("wave", ("camera", "shadow"))
def test_alpha_retrace_matches_reference(alpha_case, wave):
    js, jm, ts, tm, cam_rays, shadow = alpha_case
    assert tm.alpha_rows == jm.alpha_rows and len(tm.alpha_rows) == 1
    o, d = cam_rays if wave == "camera" else shadow[:2]
    tmax = np.full(o.shape[0], 1e7, np.float32) if wave == "camera" else shadow[2]
    ref = jax.jit(lambda o, d, tm_: jint.scene_intersect(js, jm, o, d, tm_))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    for k in tint.WAVES:
        tint.WAVES[k] = 0
    got = tint.scene_intersect(ts, tm, _t(o), _t(d), _t(tmax))
    assert tint.WAVES["alpha"] == tint.ALPHA_MAX_REJECT
    np.testing.assert_array_equal(got["prim"].numpy(), np.asarray(ref["prim"]))
    _close(got["t"], ref["t"], "t", rtol=1e-6, atol=1e-6)
    plain = tisect.intersect(ts, _t(o), _t(d), _t(tmax), device="cpu")
    plain_ref = jax.jit(lambda o, d, tm_: jisect.intersect(js, o, d, tm_))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    for k in ("b1", "b2"):
        assert np.abs(plain[k].numpy() - np.asarray(plain_ref[k])).max() < 4e-6, k
        _close(got[k], ref[k], k, rtol=0, atol=4e-6)
    # the cutout let rays through: without it the quad stops more of them
    quad = ts["tri_alpha"][plain["prim"].clamp_min(0)].numpy() >= 0
    through = quad & (plain["prim"].numpy() >= 0) & (got["prim"].numpy() != plain["prim"].numpy())
    assert through.sum() > 20
    occ_ref = jax.jit(lambda o, d, tm_: jint.scene_intersect_p(js, jm, o, d, tm_))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    occ = tint.scene_intersect_p(ts, tm, _t(o), _t(d), _t(tmax))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))


# ----------------------------------------------------------------- assets
def test_gen_assets_match_reference(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "reference_gen_assets", os.path.join(REPO, "scenes", "gen_assets.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(ref, "OUT", str(tmp_path / "ref"))
    ref.main()
    ours = gen_assets.write_assets(str(tmp_path / "ours"))
    assert [os.path.basename(p) for p in ours] == ["slide.pfm", "gonio.pfm", "bumps.pfm"]
    for path in ours:
        name = os.path.basename(path)
        got, want = read_image(path), read_image(str(tmp_path / "ref" / name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError, match="scenes/assets"):
        gen_assets.write_assets(os.path.join(REPO, "scenes", "assets"))
