"""The goldens of the preprocessed integrators through the port's own parser
and command line, on the CPU (each under 15 s here).

scenes/photon.pbrt, irradcache.pbrt, prtteapot.pbrt and useprobes.pbrt
rendered by `python -m grail_torch.cli.main SCENE --cpu` at their authored
settings, each within tests/test_golden.py's relative MAE (0.02) of its
golden; the photon render also against the long path-traced reference
(tests/test_render.py's check: the energy ratio within 0.18 and a median
8x8-block error under 0.3). Then Renderer "createprobes" through the
command line (its grid from the scene's extent and "samplespacing"), read
back by SurfaceIntegrator "useprobes" through its "filename": the image
equals, bitwise, a render given the grid baked in process at the file's
resolution, samples and lmax; and Renderer "surfacepoints" writes its
4,096 points, the reference's bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from grail.engine import subsurface as jsss
from grail.scene import parser as jparser
from grail_torch.cli.main import main as cli_main
from grail_torch.engine import prt as tprt
from grail_torch.engine import render as trender
from grail_torch.engine.imageio import read_image
from grail_torch.scene import parser as tparser
from tests.test_torch_goldens import GOLDEN_RELMAE, GOLDENS, SCENES, relative_mae
from tests.test_torch_photon import scene_text

torch.set_num_threads(2)

PREPROCESSED_GOLDENS = ("irradcache", "photon", "prtteapot", "useprobes")


def photon_blocks(img, ref, k=8):
    """tests/test_render.py's photon check: (energy ratio - 1, median
    relative error of the 8x8 block means, floored at 0.02)."""
    def blocks(a):
        h, w, _ = a.shape
        return a[:h // k * k, :w // k * k].reshape(h // k, k, w // k, k, 3).mean((1, 3))
    rel = np.abs(blocks(img) - blocks(ref)) / np.maximum(blocks(ref), 0.02)
    return abs(img.mean() / ref.mean() - 1.0), float(np.median(rel))


@pytest.mark.parametrize("name", PREPROCESSED_GOLDENS)
def test_golden_through_the_command_line(tmp_path, name):
    out = str(tmp_path / (name + ".exr"))
    assert cli_main([os.path.join(SCENES, name + ".pbrt"), "--cpu", "--quiet",
                     "--outfile", out]) == 0
    img = read_image(out)
    gold = read_image(os.path.join(GOLDENS, name + ".exr"))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert relative_mae(img, gold) < GOLDEN_RELMAE
    if name == "photon":
        energy, median = photon_blocks(
            img, read_image(os.path.join(GOLDENS, "photon_path_reference.exr")))
        assert energy < 0.18 and median < 0.3, (energy, median)


_BAKE = ('Renderer "createprobes" "integer lmax" [2] "integer directsamples" [4] '
         '"float samplespacing" [0.8] "string filename" "{out}"\n')


def test_createprobes_then_useprobes(tmp_path, monkeypatch):
    probes = str(tmp_path / "grid.probes")
    bake = tmp_path / "bake.pbrt"
    bake.write_text(_BAKE.format(out=probes) + scene_text("useprobes", 16))
    assert cli_main([str(bake), "--cpu", "--quiet"]) == 0
    use = tmp_path / "use.pbrt"
    use.write_text(scene_text("useprobes", 16).replace(
        'SurfaceIntegrator "useprobes" "integer lmax" [3]',
        f'SurfaceIntegrator "useprobes" "string filename" "{probes}" "integer lmax" [2]'))
    out = str(tmp_path / "use.pfm")        # float32, where the EXR is half
    assert cli_main([str(use), "--cpu", "--quiet", "--outfile", out]) == 0
    img = read_image(out)

    scene, meta, api = tparser.parse_file(str(use), device="cpu")
    cfg = api.integrator_config
    grid = tprt.read_probes(probes, "cpu")
    # the extent 2 x 2 x 2 at a spacing of 0.8 gives ceil(2.5) = 3 cells an axis
    assert grid["coeffs"].shape == (3, 3, 3, 9, 3) and grid["lmax"] == 2
    baked = tprt.bake_probes(scene, meta, cfg, 3, 3, 3, n_samples=4, lmax=2)
    monkeypatch.setattr(trender, "preprocess", lambda *a: {"probes": baked})
    ref = trender.render(scene, meta, cfg, device="cpu")[0].numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01
    np.testing.assert_array_equal(img, ref)


def test_surfacepoints_writes_the_reference_points(tmp_path):
    out = tmp_path / "points.txt"
    path = tmp_path / "sp.pbrt"
    text = scene_text("dipole", 16)
    path.write_text(f'Renderer "surfacepoints" "string filename" "{out}"\n' + text)
    assert cli_main([str(path), "--cpu", "--quiet"]) == 0
    lines = out.read_text().splitlines()
    assert lines[0].startswith("#") and len(lines) == 4097
    got = np.asarray([[float(x) for x in ln.split()] for ln in lines[1:]], np.float32)
    js, _, _ = jparser.parse_string(text, search_path=SCENES)
    p, n, area = jsss.sample_surface_points(js, 4096)
    want = np.concatenate([np.asarray(p), np.asarray(n), np.asarray(area)[:, None]], axis=1)
    np.testing.assert_array_equal(got, want)
