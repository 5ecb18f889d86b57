"""The port's material-sorted shading (grail_torch/shade/megabatch.py and
IntegratorConfig.mat_sort) against its own unsorted path and against the
reference's grail/shade/megabatch.py.

Held:
- megabatch_shade on one camera wave's inputs from the Cornell preset
  (16x16), scenes/glossy.pbrt and scenes/envlight.pbrt (64x64), made by
  the port's bounce body (shading records, local directions, light samples
  and draws), against the reference's megabatch_shade on the same inputs
  (blocks of 64; only it is compiled) on the live lanes: spec and valid bitwise, the floats within rtol 1e-5, atol
  1e-6 (the port's bound for float stages: XLA and PyTorch round some
  float32 sums differently); the port's dead lanes are zeros (the
  reference's are zeros only in its blocks with no live lane: ROADMAP
  C.14);
- renders with mat_sort on and off (mat_sort_min 0): the Cornell preset,
  glossy and envlight as tests/test_megabatch.py, and the straddling case
  (mat_block 96, 256 lanes: a material's range ends inside a chunk and the
  last chunk is short), and glossy with its mirror's material "none" (a
  material with no lobe, on which the reference's sorted pass raises:
  ROADMAP C.14), each bitwise equal, with the sorted visits counted
  (megabatch.STATS): one a bounce;
- the gating (the reference's use_mb): no visit below mat_sort_min, under
  light strategy "all", or for kinds other than path;
- one mat_sort render of the Cornell preset against the reference's
  (relative MAE below 1e-3, tests/test_torch_render.py's bound);
- the gradient of the mean image with respect to tex_data["const"]
  through the sorted pass: finite, non-zero, and within rtol 1e-5, atol
  1e-7 of the unsorted pass's (the backward sums the lanes' contributions
  in another order);
- the new IntegratorConfig fields: the reference's names and defaults.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.engine import integrator as jint
from grail.engine.render import render as jrender
from grail.scene import parser as jparser
from grail.scene.presets import cornell_box as jcornell
from grail.shade import megabatch as jmb
from grail_torch.engine import film as flm
from grail_torch.engine import integrator as tint
from grail_torch.engine.render import _wave_pixels, camera_rays, render, render_wave
from grail_torch.scene import parser as tparser
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.presets import cornell_box
from grail_torch.shade import geometry as tgeom
from grail_torch.shade import lights as tlt
from grail_torch.shade import megabatch as tmb
from tests.test_torch_photon import tree_np

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")
WAVE_SCENES = ("cornell", "glossy", "envlight")
BLOCK = 64


def reference_scene(name):
    if name == "cornell":
        js, jm, _ = jcornell(16, 16, 2)
        return js, jm
    return jparser.parse_file(os.path.join(SCENES, name + ".pbrt"))[:2]


def camera_wave_inputs(ts, tm):
    """megabatch_shade's inputs on the port's camera wave (sample 0 of
    every pixel), as the bounce body makes them."""
    pix, _ = _wave_pixels(tm, torch.device("cpu"))
    samp = torch.zeros_like(pix)
    rays = camera_rays(ts, tm, pix, samp)[0]
    o, d = rays["o"], rays["d"]
    hit = tint.scene_intersect(ts, tm, o, d, torch.full_like(o[:, 0], tint.BIG))
    sg = tint._shade_geom(ts, tm, hit, o, d)
    u_dir = tint._sample_2d(tm, pix, samp, 0, tint._D_BSDF_DIR)
    u_comp = tint._sample_1d(tm, pix, samp, 0, tint._D_BSDF_COMP)
    lidx, _ = tint._pick_light(ts, tm, tint.IntegratorConfig(), pix, samp, 0)
    u2d = tint._sample_2d(tm, pix, samp, 0, tint._D_LIGHT_POS)
    ls = tlt.sample_li(ts, lidx, sg["p"], u2d[0], u2d[1],
                       tint._sample_1d(tm, pix, samp, 0, tint._D_LIGHT_TRI),
                       tm.light_types, tm.light_image_rows)
    return (sg, tgeom.world_to_local(sg, -d), tgeom.world_to_local(sg, ls["wi"]),
            u_dir[0], u_dir[1], u_comp, hit["prim"] >= 0)


@pytest.fixture(scope="module")
def waves():
    """{scene: (port scene, meta, inputs, the reference's outputs)}: the
    reference's megabatch_shade (blocks of BLOCK) on the same inputs."""
    out = {}
    for name in WAVE_SCENES:
        js, jm = reference_scene(name)
        ts, tm = scene_from_numpy(tree_np(js), jm, device="cpu")
        inputs = camera_wave_inputs(ts, tm)
        jin = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), inputs)
        ref = jax.jit(lambda *a: jmb.megabatch_shade(js, jm, *a, block=BLOCK))(*jin)
        out[name] = (ts, tm, inputs, tree_np(ref))
    return out


@pytest.mark.parametrize("name", WAVE_SCENES)
def test_megabatch_shade_matches_reference(waves, name):
    ts, tm, inputs, ref = waves[name]
    assert tm.mat_specs and len(tm.mat_specs) == ts["materials"]["lobe_type"].shape[0]
    tmb.STATS.update(dict.fromkeys(tmb.STATS, 0))
    got = tmb.megabatch_shade(ts, tm, *inputs, block=BLOCK)
    live = (inputs[-1] & (inputs[0]["mat"] >= 0)).numpy()
    assert tmb.STATS["visits"] == 1 and tmb.STATS["lanes"] == live.sum() > 0
    assert got.keys() == ref.keys()
    # dead lanes: zeros (the reference's are zeros only in a block with no
    # live lane, material 0's values elsewhere; nothing reads them)
    for key, v in got.items():
        assert not v[~live].any(), key
    for key in ("spec", "valid"):
        np.testing.assert_array_equal(got[key].numpy()[live], ref[key][live], err_msg=key)
    for key in ("f_l", "pdf_l", "wi_w", "f", "pdf", "pdf_prev_nospec"):
        np.testing.assert_allclose(got[key].numpy()[live], ref[key][live], rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def parsed(name):
    if name in ("cornell", "straddle"):
        scene, meta, _ = cornell_box(16, 16, 4, device="cpu")
        depth = 4 if name == "cornell" else 3
        return scene, meta, tint.IntegratorConfig(kind="path", max_depth=depth)
    with open(os.path.join(SCENES, ("glossy" if name == "none" else name) + ".pbrt")) as f:
        text = f.read()
    if name == "none":   # a material with no lobe: an empty slot tuple
        text = text.replace('Material "mirror" "rgb Kr" [0.9 0.9 0.9]', 'Material "none"')
        assert 'Material "none"' in text
    scene, meta, api = tparser.parse_string(text, device="cpu")
    return scene, meta, dataclasses.replace(api.integrator_config, kind="path", max_depth=3)


@pytest.mark.parametrize("name", ["cornell", "glossy", "envlight", "straddle", "none"])
def test_sorted_render_equals_unsorted_bitwise(name):
    scene, meta, cfg = parsed(name)
    block = 96 if name == "straddle" else 256
    off = render(scene, meta, dataclasses.replace(cfg, mat_sort=False), spp=2,
                 device="cpu")[0].numpy()
    tmb.STATS.update(dict.fromkeys(tmb.STATS, 0))
    on = render(scene, meta, dataclasses.replace(cfg, mat_sort=True, mat_sort_min=0,
                                                 mat_block=block), spp=2,
                device="cpu")[0].numpy()
    # one megawave of 2 spp; every bounce takes the sorted pass
    assert tmb.STATS["visits"] == cfg.max_depth + 1
    if name == "straddle":
        assert tmb.STATS["chunks"] > tmb.STATS["visits"] * len(meta.mat_specs)
    if name == "none":
        assert () in meta.mat_specs
    assert off.mean() > 1e-4
    np.testing.assert_array_equal(on, off)


@pytest.mark.parametrize("case", ["min", "all", "direct"])
def test_sorted_pass_gating(case):
    scene, meta, _ = cornell_box(8, 8, 1, device="cpu")
    cfg = tint.IntegratorConfig(kind="path", max_depth=2, mat_sort=True, mat_sort_min=0)
    cfg = {"min": dataclasses.replace(cfg, mat_sort_min=65),
           "all": dataclasses.replace(cfg, light_strategy="all"),
           "direct": dataclasses.replace(cfg, kind="direct")}[case]
    tmb.STATS.update(dict.fromkeys(tmb.STATS, 0))
    render(scene, meta, cfg, spp=1, device="cpu")
    assert tmb.STATS["visits"] == 0
    render(scene, meta, dataclasses.replace(cfg, mat_sort_min=64, light_strategy="one",
                                            kind="path"), spp=1, device="cpu")
    assert tmb.STATS["visits"] == cfg.max_depth + 1


def test_sorted_render_matches_reference():
    js, jm, _ = jcornell(16, 16, 2)
    jcfg = jint.IntegratorConfig(kind="path", max_depth=3, mat_sort=True, mat_sort_min=0,
                                 mat_block=256)
    ref = np.asarray(jrender(js, jm, jcfg, spp=2)[0])
    ts, tm = scene_from_numpy(tree_np(js), jm, device="cpu")
    cfg = tint.IntegratorConfig(kind="path", max_depth=3, mat_sort=True, mat_sort_min=0,
                                mat_block=256)
    img = render(ts, tm, cfg, spp=2, device="cpu")[0].numpy()
    err = float(np.mean(np.abs(img - ref)) / np.mean(np.abs(ref)))
    assert np.isfinite(img).all() and img.mean() > 0.01 and err < 1e-3, err


def test_sorted_gradient_matches_unsorted():
    scene, meta, _ = cornell_box(8, 8, 1, device="cpu")
    base = tint.IntegratorConfig(kind="path", max_depth=3, mat_sort_min=0, mat_block=32)
    grads = {}
    for sort in (False, True):
        c = scene["tex_data"]["const"].clone().requires_grad_(True)
        s = dict(scene, tex_data=dict(scene["tex_data"], const=c))
        cfg = dataclasses.replace(base, mat_sort=sort)
        f = render_wave(s, meta, cfg, flm.new_film(8, 8, torch.device("cpu")), 0,
                        device="cpu")
        flm.develop(f).mean().backward()
        grads[sort] = c.grad.numpy()
    assert np.isfinite(grads[True]).all() and np.abs(grads[True]).sum() > 0.0
    np.testing.assert_allclose(grads[True], grads[False], rtol=1e-5, atol=1e-7)


def test_config_fields_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(jint.IntegratorConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tint.IntegratorConfig)}
    assert got == ref
    assert got["mat_sort"] is False and got["mat_sort_min"] == 16384 \
        and got["mat_block"] == 8192
