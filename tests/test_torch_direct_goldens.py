"""The seven goldens of the direct-lighting, Whitted and ambient-occlusion
integrators through the port's own parser.

li per lane against the reference on nurbs and dof (directlighting under a
point and a distant light), whittedigi and subdiv (whitted: mirror, glass,
shinymetal, two point lights) and ao, each parsed by both packages from the
same text at 16x16 and sample index 0 (>= 99% of lanes within rtol 1e-4,
atol 1e-6, as tests/test_torch_goldens.py); the reference's programs are
traced in turn and compiled on threads (XLA compiles without the GIL). Then
each of the seven scenes rendered at its authored settings against its
golden at tests/test_golden.py's relative MAE.
"""
from concurrent.futures import ThreadPoolExecutor
from functools import partial
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import rng as jrng
from grail.engine import camera as jcam, film as jfilm
from grail.engine import integrator as jint
from grail.scene import parser as jparser
from grail_torch.engine import integrator as tint
from grail_torch.engine.imageio import read_image
from grail_torch.engine.render import render
from grail_torch.scene import parser as tparser
from tests.test_torch_goldens import GOLDEN_RELMAE, GOLDENS, SCENES, _scene_text, relative_mae

torch.set_num_threads(2)

DIRECT_GOLDENS = ("nurbs", "instances", "dof", "heightfield", "whittedigi", "subdiv", "ao")
LI_SCENES = ("nurbs", "dof", "whittedigi", "subdiv", "ao")
RES = 16


def _case(name):
    """Both packages' parse of the scene at RES x RES, and the reference's
    camera rays for sample index 0 of every pixel in tile order."""
    text = _scene_text(name, RES)
    js, jm, japi = jparser.parse_string(text, search_path=SCENES)
    ts, tm, tapi = tparser.parse_string(text, device="cpu", search_path=SCENES)
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
    return (js, jm, japi), (ts, tm, tapi), (rays, pix, samp)


@pytest.fixture(scope="module")
def cases():
    """{name: (port parse, rays, pix, samp, the reference's L)}."""
    with ThreadPoolExecutor(4) as pool:
        jobs = {}
        for name in LI_SCENES:
            (js, jm, japi), ported, args = _case(name)
            fn = jax.jit(partial(jint.li, js, jm, japi.integrator_config))
            jobs[name] = (pool.submit(fn.lower(*args).compile), ported, args)
        yield {name: (ported,) + args + (np.asarray(job.result()(*args)),)
               for name, (job, ported, args) in jobs.items()}


@pytest.mark.parametrize("name", LI_SCENES)
def test_li_matches_reference_per_lane(cases, name):
    (ts, tm, tapi), rays, pix, samp, L_ref = cases[name]
    assert tapi.integrator_config.kind in ("direct", "whitted", "ao")
    L = tint.li(ts, tm, tapi.integrator_config,
                {k: torch.tensor(np.asarray(v)) for k, v in rays.items()},
                torch.tensor(np.asarray(pix).astype(np.int64)),
                torch.tensor(np.asarray(samp).astype(np.int64))).numpy()
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


@pytest.mark.parametrize("name", DIRECT_GOLDENS)
def test_golden_at_authored_settings(name):
    scene, meta, api = tparser.parse_file(os.path.join(SCENES, name + ".pbrt"),
                                          device="cpu")
    img, _ = render(scene, meta, api.integrator_config, device="cpu")
    img = img.numpy()
    gold = read_image(os.path.join(GOLDENS, name + ".exr"))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert relative_mae(img, gold) < GOLDEN_RELMAE
