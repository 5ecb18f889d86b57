"""The goldens of the orthographic camera, the procedural textures, bump
mapping and the projection and goniometric lights through the port's own
parser and command line, and the alpha-cutout scene.

li per lane against the reference on orthodisk (orthographic camera, disk
and hyperboloid, a mapless goniometric light), proctex (checkerboard,
marble, wrinkled and dots), bump (a bump-mapped plastic sphere), projgonio
(projection and goniometric lights with image maps) and alphacut (a
checkerboard cutout, grail_torch/tools/gen_assets.py), each parsed by both
packages from the same text at 16x16 and sample index 0 (>= 99% of lanes
within rtol 1e-4, atol 1e-6, as tests/test_torch_direct_goldens.py); the
reference's programs are traced in turn and compiled on threads. Then the
four goldens rendered by the command line at their authored settings
against tests/goldens at tests/test_golden.py's relative MAE. bump and
projgonio read image assets that git leaves out (ROADMAP C.1): every scene
here is read from a copy of scenes/ that gen_assets.scene_copy writes them
into.
"""
from concurrent.futures import ThreadPoolExecutor
from functools import partial
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import rng as jrng
from grail.engine import camera as jcam, film as jfilm
from grail.engine import integrator as jint
from grail.scene import parser as jparser
from grail_torch.cli.main import main as cli_main
from grail_torch.engine import integrator as tint
from grail_torch.engine.imageio import read_image
from grail_torch.scene import parser as tparser
from grail_torch.tools import gen_assets
from tests.test_torch_goldens import GOLDEN_RELMAE, GOLDENS, relative_mae

torch.set_num_threads(2)

MAPS_GOLDENS = ("orthodisk", "proctex", "bump", "projgonio")
LI_SCENES = MAPS_GOLDENS + ("alphacut",)
RES = 16


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return gen_assets.scene_copy(str(tmp_path_factory.mktemp("maps") / "scenes"))


def _case(scene_dir, name):
    """Both packages' parse of the scene at RES x RES, and the reference's
    camera rays for sample index 0 of every pixel in tile order (as
    tests/test_torch_direct_goldens.py)."""
    with open(os.path.join(scene_dir, name + ".pbrt")) as f:
        text = re.sub(r'"integer xresolution" \[\d+\] "integer yresolution" \[\d+\]',
                      f'"integer xresolution" [{RES}] "integer yresolution" [{RES}]',
                      f.read())
    js, jm, japi = jparser.parse_string(text, search_path=scene_dir)
    ported = tparser.parse_string(text, device="cpu", search_path=scene_dir)
    px_t, py_t = jfilm.lane_pixel(jnp.arange(RES * RES, dtype=jnp.uint32), RES)
    pix = py_t.astype(jnp.uint32) * RES + px_t.astype(jnp.uint32)
    samp = jnp.zeros_like(pix)
    ufx, ufy = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_FILM)
    ul1, ul2 = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_LENS)
    ut = jrng.sample_1d(jm.sampler, pix, samp, jint.SLOT_TIME)
    rays = jcam.generate_rays(js["camera"], (pix % RES).astype(jnp.int32),
                              (pix // RES).astype(jnp.int32), ufx, ufy, ul1, ul2, ut,
                              jm.cam_kind)
    rays = {k: rays[k] for k in ("o", "d", "weight")}
    return (js, jm, japi), ported, (rays, pix, samp)


@pytest.fixture(scope="module")
def cases(scene_dir):
    """{name: (port parse, rays, pix, samp, the reference's L)}, each scene
    read from the asset copy."""
    with ThreadPoolExecutor(len(LI_SCENES)) as pool:
        jobs = {}
        for name in LI_SCENES:
            (js, jm, japi), ported, args = _case(scene_dir, name)
            fn = jax.jit(partial(jint.li, js, jm, japi.integrator_config))
            jobs[name] = (pool.submit(fn.lower(*args).compile), ported, args)
        yield {name: (ported,) + args + (np.asarray(job.result()(*args)),)
               for name, (job, ported, args) in jobs.items()}


@pytest.mark.parametrize("name", LI_SCENES)
def test_li_matches_reference_per_lane(cases, name):
    (ts, tm, tapi), rays, pix, samp, L_ref = cases[name]
    assert tapi.integrator_config.kind == "direct"
    for k in tint.WAVES:
        tint.WAVES[k] = 0
    L = tint.li(ts, tm, tapi.integrator_config,
                {k: torch.tensor(np.asarray(v)) for k, v in rays.items()},
                torch.tensor(np.asarray(pix).astype(np.int64)),
                torch.tensor(np.asarray(samp).astype(np.int64))).numpy()
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"
    # the cutout's re-traces: ALPHA_MAX_REJECT a closest-hit wave, and every
    # shadow test a closest-hit loop of its own
    depth = tapi.integrator_config.max_depth + 1
    waves = depth * (1 + tm.n_lights)
    assert tint.WAVES["alpha"] == (tint.ALPHA_MAX_REJECT * waves if tm.alpha_rows else 0)


@pytest.mark.parametrize("name", MAPS_GOLDENS)
def test_golden_through_the_command_line(scene_dir, tmp_path, name):
    out = str(tmp_path / (name + ".exr"))
    assert cli_main([os.path.join(scene_dir, name + ".pbrt"), "--cpu", "--quiet",
                     "--outfile", out]) == 0
    img = read_image(out)
    gold = read_image(os.path.join(GOLDENS, name + ".exr"))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert relative_mae(img, gold) < GOLDEN_RELMAE
