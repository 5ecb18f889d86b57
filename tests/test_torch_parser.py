"""The port's host-side scene compiler against the reference's.

Every scene of scenes/ goes through both parsers and builds leaf for leaf
the scene that scene_from_numpy carries across from the reference's
(integers exact, floats to rtol 1e-6, the BVH tables bit for bit: both
build on the host in numpy, so they hold the same bits), with the same
SceneMeta, integrator settings and renderer settings. Scenes
are read from a copy of scenes/ that holds the image assets git leaves out
(grail_torch/tools/gen_assets.py; bump.pbrt and projgonio.pbrt read them).
The world blocks of more scenes are held the same way with their
integrator line rewritten to "path"; every world block builds. Snippets
that use an alpha cutout, a bump map, a goniometric light, a uv texture, a
non-uv image mapping, a Volume of each kind, or the substrate,
translucent, subsurface and kdsubsurface materials build leaf for leaf too
(the subsurface media with the reference's integrator settings), as do
the options of SurfaceIntegrator "igi" and "glossyprt" and of Renderer
"createprobes" and "surfacepoints", and those that use a directive the
port still lacks raise. Below the parser: the tokenizer, ParamSet's spectrum
conversions, every shape tessellator (bitwise) and the EXR and PFM codecs;
above it, the command line.
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax

import jax.numpy as jnp

from grail.core import spectrum as jspec
from grail.engine import imageio as jio
from grail.scene import paramset as jps
from grail.scene import parser as jparser
from grail.scene import shapes as jshapes
from grail_torch.cli.main import main as cli_main
from grail_torch.core import spectrum as tspec
from grail_torch.engine import imageio as tio
from grail_torch.scene import paramset as tps
from grail_torch.scene import parser as tparser
from grail_torch.scene import shapes as tshapes
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.tools import gen_assets

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), os.pardir, "scenes")
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")

# every scene: leaf for leaf the reference's
MATCHING = ("ao", "bump", "cornell", "dipole", "dof", "envlight", "glossy",
            "heightfield", "instances", "irradcache", "measured", "mlt", "nurbs",
            "orthodisk", "photon", "proctex", "projgonio", "prtteapot", "spotfog",
            "subdiv", "useprobes", "whittedigi")
# the preprocessed integrators' scenes
PREPROCESSED = ("irradcache", "photon", "prtteapot", "useprobes")
# the scenes of the orthographic camera, procedural textures, projection
# and goniometric lights and bump maps, which the port renders whole
MAPS = ("bump", "orthodisk", "proctex", "projgonio")
# the scenes whose world block the port builds once the integrator (or
# renderer) line reads "path": PREPROCESSED (quadrics, glass and mirror,
# plastic, point and infinite lights), MAPS, and mlt, whose Renderer line
# then gives the path integrator's settings
WORLD_MATCHING = ("bump", "irradcache", "mlt", "orthodisk", "photon", "proctex",
                  "projgonio", "prtteapot", "useprobes")
# ... and where the rest then stop: nowhere, every world block builds
WORLD_REFUSED = {}


def test_lists_cover_every_scene():
    names = {f[:-5] for f in os.listdir(SCENES) if f.endswith(".pbrt")}
    assert set(MATCHING) == names and set(PREPROCESSED) <= names
    assert set(WORLD_MATCHING) | set(WORLD_REFUSED) == set(PREPROCESSED) | set(MAPS) | {"mlt"}
    assert not set(WORLD_MATCHING) & set(WORLD_REFUSED) and set(MAPS) <= set(MATCHING)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """A copy of scenes/ with the image assets that git leaves out (ROADMAP
    C.1), written by grail_torch/tools/gen_assets.py."""
    return gen_assets.scene_copy(str(tmp_path_factory.mktemp("parser") / "scenes"))


def _scene_path(name, scenes=SCENES):
    return os.path.join(scenes, name + ".pbrt")


def _path_text(name, scenes=SCENES):
    """The scene's text with its integrator (or renderer) line reading path."""
    with open(_scene_path(name, scenes)) as f:
        text = f.read()
    return re.sub(r'^(SurfaceIntegrator|Renderer) "\w+"', 'SurfaceIntegrator "path"',
                  text, flags=re.M)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        elif isinstance(v, tuple):
            for i, x in enumerate(v):
                yield from _leaves(x if isinstance(x, dict) else {"": x},
                                   f"{prefix}{k}/{i}/")
        else:
            yield prefix + k, v


def assert_same_scene(ported, reference):
    """The port's parse (scene, meta, api) against the reference's."""
    ts, tm, tapi = ported
    js, jm, japi = reference
    bs, bm = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), jm, device="cpu")
    got, ref = dict(_leaves(ts)), dict(_leaves(bs))
    assert got.keys() == ref.keys()
    for name, g in got.items():
        if not isinstance(g, torch.Tensor):                 # a pyramid's level count
            assert g == ref[name], name
            continue
        g, r = g.numpy(), ref[name].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if name.endswith(("bvh4_nodes", "bvh4_tris")):     # int words in float rows
            g, r = g.view(np.int32), r.view(np.int32)
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)
    for field in dataclasses.fields(tm):
        assert getattr(tm, field.name) == getattr(bm, field.name), field.name
    for field in dataclasses.fields(tapi.integrator_config):
        assert (getattr(tapi.integrator_config, field.name)
                == getattr(japi.integrator_config, field.name)), field.name
    # the renderer's and the adaptive sampler's settings
    assert tapi.adaptive == getattr(japi, "adaptive", None)
    assert tapi.mlt_spp == getattr(japi, "mlt_spp", None)
    ref_mlt = japi.mlt_config
    assert (tapi.mlt_config is None if ref_mlt is None
            else dataclasses.asdict(tapi.mlt_config) == dataclasses.asdict(ref_mlt))
    assert tapi.probe_bake == getattr(japi, "probe_bake", None)
    assert tapi.surfacepoints_out == getattr(japi, "surfacepoints_out", None)
    assert tapi.transform_times_range == getattr(japi, "transform_times_range", None)


@pytest.mark.parametrize("name", MATCHING)
def test_scene_matches_reference(name, scene_dir):
    path = _scene_path(name, scene_dir)
    assert_same_scene(tparser.parse_file(path, device="cpu"), jparser.parse_file(path))


@pytest.mark.parametrize("name", WORLD_MATCHING)
def test_world_block_matches_reference(name, scene_dir):
    text = _path_text(name, scene_dir)
    assert_same_scene(tparser.parse_string(text, device="cpu", search_path=scene_dir),
                      jparser.parse_string(text, search_path=scene_dir))


_HEADER = """LookAt 0 1 3  0 1 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [8] "integer yresolution" [8] {film}
Sampler "{sampler}" "integer pixelsamples" [1]
SurfaceIntegrator "path"
WorldBegin
"""
_QUAD = ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
         '"point P" [-1 0 1  1 0 1  1 0 -1  -1 0 -1] {extra}\n')
# parameters and directives of the cutouts, bump maps, goniometric lights
# and textures, each in a scene that uses it
PORTED_SNIPPETS = {
    "alpha": 'LightSource "point"\n' + _QUAD.format(extra='"float alpha" [0.5]'),
    "bumpmap": ('Texture "b" "float" "constant" "float value" [1]\n'
                'Material "matte" "texture bumpmap" "b"\n' + _QUAD.format(extra="")),
    "goniometric": 'LightSource "goniometric"\n' + _QUAD.format(extra=""),
    "uv_texture": ('Texture "t" "color" "uv"\nMaterial "matte" "texture Kd" "t"\n'
                   + _QUAD.format(extra="")),
    "mapping": ('Texture "t" "color" "imagemap" "string mapping" "spherical" '
                '"string filename" "assets/slide.pfm"\n'
                'Material "matte" "texture Kd" "t"\nLightSource "point"\n'
                + _QUAD.format(extra="")),
    # the media regions, in a moved frame, and the new materials (the
    # subsurface ones record their medium in the integrator settings)
    "volume": ('Translate 0.5 0 0\nRotate 30 0 1 0\nVolume "homogeneous" '
               '"rgb sigma_a" [0.1 0.2 0.3] "float g" [0.4] "point p0" [-1 0 -1] '
               '"point p1" [1 2 1]\n' + _QUAD.format(extra="")),
    "volumegrid": ('Volume "volumegrid" "integer nx" [2] "integer ny" [1] '
                   '"integer nz" [2] "float density" [0.1 0.2 0.3 0.4] '
                   '"rgb Le" [0.5 0.5 0.5]\nVolume "exponential" "float a" [2] '
                   '"float b" [3] "vector updir" [0 0 1]\n' + _QUAD.format(extra="")),
    "substrate": ('Material "substrate" "float uroughness" [0.05]\n'
                  + _QUAD.format(extra="")),
    "translucent": ('Material "translucent" "rgb transmit" [0.3 0.4 0.5]\n'
                    + _QUAD.format(extra="")),
    "subsurface": ('Material "subsurface" "string name" ["Ketchup"] "float index" [1.4]\n'
                   + _QUAD.format(extra="")),
    "subsurface_sigma": ('Material "subsurface" "rgb sigma_a" [0.1 0.2 0.3] '
                         '"float scale" [2]\n' + _QUAD.format(extra="")),
    "kdsubsurface": ('Material "kdsubsurface" "rgb Kd" [0.7 0.5 0.3] '
                     '"float meanfreepath" [0.4]\n' + _QUAD.format(extra="")),
}
# the Film's crop window (clamped and ordered, as image.cpp) and the
# adaptive sampler's settings, parsed to the reference's meta
OPTION_SNIPPETS = {
    "cropwindow": _HEADER.format(film='"float cropwindow" [0.75 -0.2 0.5 0.125]',
                                 sampler="lowdiscrepancy"),
    "adaptive": _HEADER.format(film="", sampler="adaptive").replace(
        '"integer pixelsamples" [1]', '"integer minsamples" [2] "integer maxsamples" [8]'),
    "transform_times": _HEADER.format(film="", sampler="lowdiscrepancy").replace(
        "WorldBegin", "TransformTimes 0.25 0.75\nWorldBegin"),
}


@pytest.mark.parametrize("case", sorted(PORTED_SNIPPETS))
def test_ported_snippet_matches_reference(case, scene_dir):
    text = (_HEADER.format(film="", sampler="lowdiscrepancy") + PORTED_SNIPPETS[case]
            + "WorldEnd\n")
    assert_same_scene(tparser.parse_string(text, device="cpu", search_path=scene_dir),
                      jparser.parse_string(text, search_path=scene_dir))


# the options of the integrators and renderers with a preprocess, each in
# place of the header's integrator line ("nsamples" above 256 is capped)
INTEGRATOR_SNIPPETS = {
    "igi": 'SurfaceIntegrator "igi" "integer nlights" [16] "integer nsets" [2] '
           '"float glimit" [5]',
    "glossyprt": 'SurfaceIntegrator "glossyprt" "integer lmax" [3] "integer nsamples" [300]',
    "createprobes": 'Renderer "createprobes" "integer lmax" [2] "integer directsamples" [16] '
                    '"float samplespacing" [0.5] "string filename" "grid.probes"',
    "surfacepoints": 'Renderer "surfacepoints" "string filename" "points.txt"',
}


@pytest.mark.parametrize("case", sorted(INTEGRATOR_SNIPPETS))
def test_integrator_snippet_matches_reference(case):
    text = (_HEADER.format(film="", sampler="lowdiscrepancy").replace(
        'SurfaceIntegrator "path"', INTEGRATOR_SNIPPETS[case])
        + 'LightSource "point"\n' + _QUAD.format(extra="") + "WorldEnd\n")
    ported = tparser.parse_string(text, device="cpu")
    assert_same_scene(ported, jparser.parse_string(text))
    if case == "createprobes":
        assert ported[2].probe_bake == {"lmax": 2, "nsamples": 16, "filename": "grid.probes",
                                        "spacing": 0.5}
    elif case == "surfacepoints":
        assert ported[2].surfacepoints_out == {"filename": "points.txt", "npoints": 4096}
    else:
        assert ported[2].integrator_config.kind == case


@pytest.mark.parametrize("case", sorted(OPTION_SNIPPETS))
def test_option_snippet_matches_reference(case):
    text = OPTION_SNIPPETS[case] + 'LightSource "point"\n' + _QUAD.format(extra="") + "WorldEnd\n"
    ported, reference = tparser.parse_string(text, device="cpu"), jparser.parse_string(text)
    assert_same_scene(ported, reference)
    if case == "cropwindow":
        assert ported[1].crop == (0.0, 0.75, 0.125, 0.5)
    elif case == "transform_times":
        assert ported[2].transform_times_range == (0.25, 0.75)
    else:
        assert ported[2].adaptive == {"min": 2, "max": 8} and ported[1].sampler.spp == 8


# parameters and directives that the port refuses where they are used
UNPORTED_SNIPPETS = {
    "area": ("", "lowdiscrepancy", 'AreaLightSource "other"\n', 'AreaLightSource "other"'),
}


@pytest.mark.parametrize("case", sorted(UNPORTED_SNIPPETS))
def test_unported_parameter_raises(case):
    film, sampler, world, what = UNPORTED_SNIPPETS[case]
    text = _HEADER.format(film=film, sampler=sampler) + world + "WorldEnd\n"
    with pytest.raises(NotImplementedError, match=re.escape(what)):
        tparser.parse_string(text, device="cpu")


# ------------------------------------------------------------ tokens and params
def test_tokenize_matches_reference():
    text = ('# a comment\nShape "sphere" "float radius" [0.5] # trailing\n'
            'Translate 1 -2.5e-1 3\nInclude "x.pbrt"\n"bool on" "true" [ 1 2 ]\n'
            'Texture "t" "color" "scale"\n')
    assert list(tparser.tokenize(text)) == list(jparser.tokenize(text))


@pytest.mark.parametrize("values", ("wide", "unit"))
def test_color_matrix_matches_reference_bitwise(values):
    """numpy's multiply-add chain rounds as the reference's float32 einsum
    on the CPU (the parser's xyz parameters go through xyz_to_rgb), over
    six decades and over colours in [0, 1]."""
    rng = np.random.default_rng(2)
    if values == "wide":
        v = rng.uniform(-1, 3, (20000, 3)) * np.logspace(-3, 3, 20000)[:, None]
    else:
        v = rng.random((20000, 3))
    v = v.astype(np.float32)
    np.testing.assert_array_equal(tspec.xyz_to_rgb(v),
                                  np.asarray(jspec.xyz_to_rgb(jnp.asarray(v))))


def test_spectra_match_reference_bitwise():
    lam = np.linspace(380, 780, 41)
    vals = np.random.default_rng(3).random(41)
    np.testing.assert_array_equal(tspec.spd_to_rgb(lam, vals), jspec.spd_to_rgb(lam, vals))
    for temp, scale in ((2700.0, 1.0), (6500.0, 3.0)):
        np.testing.assert_array_equal(tspec.blackbody_rgb(temp, scale),
                                      jspec.blackbody_rgb(temp, scale))


def test_paramset_matches_reference(tmp_path):
    spd = tmp_path / "metal.spd"
    spd.write_text("# lambda value\n400 0.2\n500 0.5 # mid\n600 0.8\n700 0.3\n")
    decls = [("float fov", [39.0]), ("integer n", [3, 4]), ("point P", [0, 1, 2, 3, 4, 5]),
             ("rgb Kd", [0.1, 0.2, 0.3]), ("color Ks", [0.5, 0.5, 0.5]),
             ("xyz L", [0.3, 0.7, 0.2, 1.5, 0.1, 0.9]),
             ("blackbody B", [5500.0, 2.0]), ("blackbody B1", [3000.0]),
             ("spectrum S", [400, 0.1, 500, 0.9, 600, 0.4, 700, 0.2]),
             ("spectrum F", [str(spd)]), ("bool b", ["true"]), ("bool c", ["false"]),
             ("texture Kd_tex", ["checks"]), ("string filename", ["out.exr"])]
    got, ref = tps.ParamSet(decls), jps.ParamSet(decls)
    assert got.items.keys() == ref.items.keys()
    for name, (ptype, vals) in ref.items.items():
        assert got.items[name][0] == ptype, name
        if ptype in ("string", "texture"):
            assert got.items[name][1] == vals, name
        else:
            np.testing.assert_array_equal(got.items[name][1], vals, err_msg=name)
            assert got.items[name][1].dtype == vals.dtype, name
    assert got.find_one_bool("b", False) and not got.find_one_bool("c", True)
    assert got.find_texture("Kd_tex") == "checks"
    np.testing.assert_array_equal(got.find_one_rgb("L", (0, 0, 0)),
                                  ref.find_one_rgb("L", (0, 0, 0)))


def test_spectrum_file_resolves_against_scene_dir(tmp_path):
    """A relative .spd name reads from the scene's directory, as pbrt does
    (the reference reads it from the working directory: ROADMAP C.6)."""
    (tmp_path / "kd.spd").write_text("400 0.2\n550 0.6\n700 0.9\n")
    text = (_HEADER.format(film="", sampler="lowdiscrepancy")
            + 'Material "matte" "spectrum Kd" "kd.spd"\n' + _QUAD.format(extra="")
            + "WorldEnd\n")
    scene, _, _ = tparser.parse_string(text, device="cpu", search_path=str(tmp_path))
    kd = scene["tex_data"]["const"][int(scene["materials"]["s0"][0, 0])].numpy()
    np.testing.assert_array_equal(kd, jps.ParamSet(
        [("spectrum Kd", [str(tmp_path / "kd.spd")])]).find_one_rgb("Kd", (0, 0, 0)))


# ------------------------------------------------------------------- shapes
_SHAPES = {
    "sphere": (("sphere",), (0.7, -0.3, 0.5, 270.0)),
    "cylinder": (("cylinder",), (0.5, -0.2, 0.8, 300.0)),
    "disk": (("disk",), (0.1, 1.0, 0.25, 180.0)),
    "cone": (("cone",), (1.5, 0.6, 360.0)),
    "paraboloid": (("paraboloid",), (0.8, 0.0, 1.3, 360.0)),
    "hyperboloid": (("hyperboloid",), ((0.2, -0.5, -1.0), (0.9, 0.3, 1.0), 330.0)),
    "heightfield": (("heightfield",), (5, 4, np.linspace(0, 1, 20) ** 2)),
    "loopsubdiv": (("loop_subdivide",), (
        np.asarray([[0, 0, 1], [1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0],
                    [0, 0, -1]], np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1],
                    [5, 2, 1], [5, 3, 2], [5, 4, 3], [5, 1, 4]], np.int64), 2)),
    "loopsubdiv_open": (("loop_subdivide",), (
        np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0.2], [0, 1, 0]], np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int64), 2)),
    "nurbs": (("nurbs",), (4, 3, [0, 0, 0, 0.5, 1, 1, 1], 0.0, 1.0,
                           3, 3, [0, 0, 0, 1, 1, 1], 0.0, 1.0,
                           np.random.default_rng(3).random(36), False, 12, 10)),
    "nurbs_rational": (("nurbs",), (3, 2, [0, 0, 0.5, 1, 1], 0.0, 1.0,
                                    3, 3, [0, 0, 0, 1, 1, 1], 0.0, 1.0,
                                    np.random.default_rng(4).random(36) + 0.5, True,
                                    9, 7)),
}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_shape_matches_reference_bitwise(shape):
    (fn,), args = _SHAPES[shape]
    got = getattr(tshapes, fn)(*args)
    ref = getattr(jshapes, fn)(*args)
    assert len(got) == len(ref) == 4
    for part, g, r in zip(("verts", "idx", "normals", "uvs"), got, ref):
        if r is None:
            assert g is None, part
        else:
            assert g.dtype == r.dtype and g.shape == r.shape, part
            np.testing.assert_array_equal(g, r, err_msg=part)


# ----------------------------------------------------------------- image I/O
@pytest.mark.parametrize("half", (True, False))
def test_exr_round_trip(tmp_path, half):
    img = (np.random.default_rng(5).random((37, 21, 3)) * 4).astype(np.float32)
    path, ref_path = str(tmp_path / "a.exr"), str(tmp_path / "b.exr")
    tio.write_exr(path, img, half=half)
    jio.write_exr(ref_path, img, half=half)
    with open(path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()
    back = tio.read_image(path)
    np.testing.assert_array_equal(back, img.astype(np.float16).astype(np.float32)
                                  if half else img)
    tio.write_image(str(tmp_path / "c.pfm"), img)
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / "c.pfm")), img)


def test_golden_exr_reads_as_reference():
    path = os.path.join(GOLDENS, "cornell.exr")
    img = tio.read_image(path)
    assert img.shape == (128, 128, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(img, jio.read_image(path))


# ---------------------------------------------------------------------- CLI
def test_cli_renders_and_refuses(tmp_path):
    out = str(tmp_path / "env.exr")
    assert cli_main([_scene_path("envlight"), "--cpu", "--spp", "1", "--quiet",
                     "--outfile", out]) == 0
    img = tio.read_image(out)
    assert img.shape == (64, 64, 3) and np.isfinite(img).all() and img.mean() > 0
    refused = tmp_path / "refused.pbrt"
    refused.write_text(_HEADER.format(film="", sampler="lowdiscrepancy")
                       + 'AreaLightSource "other"\n' + "WorldEnd\n")
    assert cli_main([str(refused), "--cpu", "--quiet"]) == 1
    # the reference's --checkpoint option renders (no file yet: from sample 0)
    assert cli_main([_scene_path("envlight"), "--cpu", "--spp", "1", "--quiet",
                     "--outfile", out, "--checkpoint", str(tmp_path / "ck")]) == 0
    np.testing.assert_array_equal(tio.read_image(out), img)
