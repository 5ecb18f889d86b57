"""The port's render loop beyond the plain uniform render
(grail_torch/engine/render.py, engine/checkpoint.py) against the
reference's, on the Cornell box.

- Resume: a render continued from a checkpoint written after 2 of 4
  samples, and one handed the film and start_wave, are bitwise the
  uninterrupted render (the film accumulates sample by sample in order);
  the checkpoint goes when the render completes; a fingerprint of another
  configuration raises; a checkpoint written by either package loads in the
  other, arrays and fingerprint exact.
- Adaptive sampling: the twins of tests/test_checkpoint.py's, at their
  settings. At threshold -1 every pixel takes every sample, so the image is
  a uniform render at max_spp's (rtol 1e-5, atol 1e-6: the flagged waves
  scatter, the uniform ones add densely); at 0.25 spp_map stays within
  [min_spp, max_spp].
- A crop window: cornell_small with a crop, against the reference's render
  of the same scene (allclose at rtol 1e-5, atol 1e-6, the adaptive
  check's bound: the same samples scattered in lane order, which differ by
  float rounding of their radiance; every pixel outside the window zero in
  both).
- occupancy_probe per bounce within 0.005 of the reference's, on the 32x32
  box at 1,024 lanes with compaction lowered to run at that width (the
  port counts across the compaction split), and the same counts without it.
- The command line: --metrics writes the occupancy line and one JSONL
  record a megawave; --checkpoint on an existing file resumes, and the
  image is bitwise the uninterrupted one.
"""
from concurrent.futures import ThreadPoolExecutor
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.engine import checkpoint as jckpt
from grail.engine import film as jfilm
from grail.engine.integrator import IntegratorConfig as JConfig
from grail.engine.render import occupancy_probe as j_occupancy
from grail.engine.render import render as jrender
from grail.scene.presets import cornell_box as jcornell
from grail_torch.cli.main import main as cli_main
from grail_torch.engine import checkpoint as tckpt
from grail_torch.engine import film as tfilm
from grail_torch.engine.imageio import read_image
from grail_torch.engine.integrator import IntegratorConfig
from grail_torch.engine.render import (auto_spp_chunk, occupancy_probe, render,
                                       render_adaptive, render_wave)
from grail_torch.scene import parser as tparser
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.presets import cornell_box as tcornell

torch.set_num_threads(2)

CROP = (0.25, 0.8125, 0.125, 0.5)
OCC_CFG = dict(kind="path", max_depth=5, compact_min=1024)


@pytest.fixture(scope="module")
def small():
    """The port's cornell_small (16x16, 4 spp)."""
    return tcornell(xres=16, yres=16, spp=4, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The reference's cropped cornell_small render and occupancy probe, run
    on threads (each compiles the reference's li), with the scenes carried
    across."""
    cs, cm, _ = jcornell(xres=16, yres=16, spp=4)
    cm_crop = dataclasses.replace(cm, crop=CROP)
    os_, om, _ = jcornell(xres=32, yres=32, spp=1)
    with ThreadPoolExecutor(2) as pool:
        crop = pool.submit(jrender, cs, cm_crop, JConfig(kind="path", max_depth=3), 2)
        occ = pool.submit(j_occupancy, os_, om, JConfig(**OCC_CFG))
        crop_img = np.asarray(crop.result()[0])
        occ = occ.result()
    to_port = lambda s, m: scene_from_numpy(jax.tree_util.tree_map(np.asarray, s), m,
                                            device="cpu")
    return {"crop": (to_port(cs, cm_crop), crop_img), "occupancy": (to_port(os_, om), occ)}


def test_checkpoint_resume_bitwise(small, tmp_path):
    scene, meta, _ = small
    cfg = IntegratorConfig(kind="path", max_depth=3)
    path = str(tmp_path / "ck.npz")
    img_full, _ = render(scene, meta, cfg, spp=4, device="cpu")
    film = tfilm.new_film(meta.xres, meta.yres, "cpu")
    for s in range(2):                     # killed after sample 2
        film = render_wave(scene, meta, cfg, film, s, device="cpu")
    tckpt.save(path, film, 2, meta, cfg)
    img_resumed, _ = render(scene, meta, cfg, spp=4, checkpoint_path=path, device="cpu")
    np.testing.assert_array_equal(img_resumed.numpy(), img_full.numpy())
    assert not os.path.exists(path)        # completed: no stale checkpoint
    img_film, _ = render(scene, meta, cfg, spp=4, film=film, start_wave=2, device="cpu")
    np.testing.assert_array_equal(img_film.numpy(), img_full.numpy())
    # written every 2 samples of a render in megawaves of 1 sample: the
    # last one at sample 2, then removed
    writes = []
    save = tckpt.save
    tckpt.save = lambda *a, **k: (writes.append(a[2]), save(*a, **k))
    try:
        img_every, _ = render(scene, meta, cfg, spp=4, checkpoint_path=path,
                              checkpoint_every=2, spp_chunk=1, device="cpu")
    finally:
        tckpt.save = save
    assert writes == [2] and not os.path.exists(path)
    np.testing.assert_array_equal(img_every.numpy(), img_full.numpy())


def test_checkpoint_fingerprint_mismatch(small, tmp_path):
    scene, meta, _ = small
    path = str(tmp_path / "ck.npz")
    tckpt.save(path, tfilm.new_film(meta.xres, meta.yres, "cpu"), 1, meta,
               IntegratorConfig(kind="path", max_depth=3))
    with pytest.raises(ValueError, match="fingerprint"):
        tckpt.load(path, meta, IntegratorConfig(kind="path", max_depth=7))


def test_checkpoint_loads_across_packages(tmp_path):
    cs, cm, _ = jcornell(xres=16, yres=16, spp=4)
    ts, tm = scene_from_numpy(jax.tree_util.tree_map(np.asarray, cs), cm, device="cpu")
    jcfg, tcfg = JConfig(kind="path", max_depth=3), IntegratorConfig(kind="path", max_depth=3)
    assert tckpt.scene_fingerprint(tm, tcfg) == jckpt.scene_fingerprint(cm, jcfg)
    rng = np.random.default_rng(4)
    film = {k: rng.random(v.shape).astype(np.float32)
            for k, v in jfilm.new_film(16, 16).items()}
    extra = {"spp_map": np.arange(256, dtype=np.int32)}
    jckpt.save(tmp_path / "ref.npz", {k: jnp.asarray(v) for k, v in film.items()}, 3, cm, jcfg,
               extra=extra)
    got, wave, ext = tckpt.load(str(tmp_path / "ref.npz"), tm, tcfg)
    tckpt.save(str(tmp_path / "port.npz"), {k: torch.tensor(v) for k, v in film.items()}, 3,
               tm, tcfg, extra=extra)
    ref, wave_ref, ext_ref = jckpt.load(tmp_path / "port.npz", cm, jcfg)
    assert wave == wave_ref == 3
    for k, v in film.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(ref[k]), v)
    np.testing.assert_array_equal(ext["spp_map"], ext_ref["spp_map"])


def test_adaptive_matches_uniform_at_max(small):
    scene, meta, _ = small
    cfg = IntegratorConfig(kind="path", max_depth=2)
    img_u, _ = render(scene, meta, cfg, spp=6, device="cpu")
    img_a, (_, _, spp_map) = render_adaptive(scene, meta, cfg, min_spp=4, max_spp=6,
                                             threshold=-1.0, device="cpu")
    assert int(spp_map.min()) == 6
    np.testing.assert_allclose(img_u.numpy(), img_a.numpy(), rtol=1e-5, atol=1e-6)


def test_adaptive_concentrates_samples(small):
    scene, meta, _ = small
    cfg = IntegratorConfig(kind="path", max_depth=3)
    img, (_, _, spp_map) = render_adaptive(scene, meta, cfg, min_spp=4, max_spp=8,
                                           threshold=0.25, device="cpu")
    assert np.isfinite(img.numpy()).all()
    assert spp_map.min() >= 4 and spp_map.max() <= 8 and spp_map.max() > 4


def test_crop_matches_reference(reference):
    (ts, tm), img_ref = reference["crop"]
    assert tm.crop == CROP
    img, film = render(ts, tm, IntegratorConfig(kind="path", max_depth=3), spp=2, device="cpu")
    img = img.numpy()
    inside = np.zeros((16, 16), bool)
    inside[2:8, 4:13] = True               # ceil(16 * crop): x 4..12, y 2..7
    assert not img[~inside].any() and not img_ref[~inside].any()
    assert img[inside].mean() > 0.01
    np.testing.assert_allclose(img, img_ref, rtol=1e-5, atol=1e-6)
    assert float(film["weight"][inside].min()) > 0


def test_occupancy_probe_matches_reference(reference):
    (ts, tm), occ_ref = reference["occupancy"]
    occ = occupancy_probe(ts, tm, IntegratorConfig(**OCC_CFG), device="cpu")
    assert len(occ) == len(occ_ref) == 6 and occ[0] == 1.0
    np.testing.assert_allclose(occ, occ_ref, atol=0.005)
    assert occ[-1] < 0.5
    assert occupancy_probe(ts, tm, IntegratorConfig(kind="path", max_depth=5),
                           device="cpu") == occ
    assert occupancy_probe(ts, tm, IntegratorConfig(kind="ao"), device="cpu") is None


_SCENE = """LookAt 0 1 3  0 1 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "lowdiscrepancy" "integer pixelsamples" [4]
SurfaceIntegrator "path" "integer maxdepth" [2]
WorldBegin
LightSource "point" "point from" [0 2 1] "rgb I" [3 3 3]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-1 0 1  1 0 1  1 0 -1  -1 0 -1]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-1 0 -1  1 0 -1  1 2 -1  -1 2 -1]
WorldEnd
"""


def test_cli_metrics_and_checkpoint(tmp_path):
    scene_path = str(tmp_path / "quad.pbrt")
    with open(scene_path, "w") as f:
        f.write(_SCENE)
    full, metrics = str(tmp_path / "full.exr"), str(tmp_path / "m.jsonl")
    assert cli_main([scene_path, "--cpu", "--quiet", "--outfile", full,
                     "--metrics", metrics]) == 0
    with open(metrics) as f:
        lines = [json.loads(line) for line in f]
    scene, meta, api = tparser.parse_file(scene_path, device="cpu")
    chunk = auto_spp_chunk(meta, 4)
    assert lines[0] == {"occupancy_per_bounce": occupancy_probe(
        scene, meta, api.integrator_config, device="cpu")}
    assert [r["wave"] for r in lines[1:]] == list(range(chunk, 5, chunk))
    assert all(r["camera_rays_per_sec"] > 0 for r in lines[1:])

    # a checkpoint after 2 of the 4 samples, resumed by the command line
    cfg = api.integrator_config
    film = tfilm.new_film(meta.xres, meta.yres, "cpu")
    for s in range(2):
        film = render_wave(scene, meta, cfg, film, s, device="cpu")
    ck, resumed = str(tmp_path / "ck.npz"), str(tmp_path / "resumed.exr")
    tckpt.save(ck, film, 2, meta, cfg)
    assert cli_main([scene_path, "--cpu", "--quiet", "--outfile", resumed,
                     "--checkpoint", ck, "--checkpoint-every", "1"]) == 0
    assert not os.path.exists(ck)
    np.testing.assert_array_equal(read_image(resumed), read_image(full))
