"""The goldens of participating media, measured BRDFs and the dipole
integrator through the port's own parser and command line.

li per lane against the reference on spotfog (a spot light through a
homogeneous fog under VolumeIntegrator "single") and measured (the
redglossy.brdf table over a sphere), each parsed by both packages from the
same text at 16x16 and sample index 0 (>= 99% of lanes within rtol 1e-4,
atol 1e-6, as tests/test_torch_direct_goldens.py; measured's lanes whose
half-angle cell moves by one, tests/test_torch_lobes.py, are among the
1%); the reference's programs are traced in turn and compiled on threads.
scenes/dipole.pbrt's li is held in tests/test_torch_dipole.py. Then the
three goldens rendered by the command line at their authored settings
against tests/goldens at tests/test_golden.py's relative MAE.
"""
from concurrent.futures import ThreadPoolExecutor
from functools import partial
import os
import re

import numpy as np
import pytest
import torch

import jax

from grail.engine import integrator as jint
from grail.scene import parser as jparser
from grail_torch.cli.main import main as cli_main
from grail_torch.engine import integrator as tint
from grail_torch.engine.imageio import read_image
from grail_torch.scene import parser as tparser
from tests.test_torch_goldens import GOLDEN_RELMAE, GOLDENS, SCENES, relative_mae
from tests.test_torch_media import RES, reference_rays, to_torch

torch.set_num_threads(2)

MEDIA_GOLDENS = ("spotfog", "measured", "dipole")
LI_SCENES = ("spotfog", "measured")


@pytest.fixture(scope="module")
def cases():
    """{name: (port parse, rays, pix, samp, the reference's L)}."""
    with ThreadPoolExecutor(len(LI_SCENES)) as pool:
        jobs = {}
        for name in LI_SCENES:
            with open(os.path.join(SCENES, name + ".pbrt")) as f:
                text = re.sub(
                    r'"integer xresolution" \[\d+\] "integer yresolution" \[\d+\]',
                    f'"integer xresolution" [{RES}] "integer yresolution" [{RES}]',
                    f.read())
            js, jm, japi = jparser.parse_string(text, search_path=SCENES)
            args = reference_rays(js, jm)
            fn = jax.jit(partial(jint.li, js, jm, japi.integrator_config))
            jobs[name] = (pool.submit(fn.lower(*args).compile),
                          tparser.parse_string(text, device="cpu", search_path=SCENES),
                          args)
        yield {name: (ported,) + args + (np.asarray(job.result()(*args)),)
               for name, (job, ported, args) in jobs.items()}


@pytest.mark.parametrize("name", LI_SCENES)
def test_li_matches_reference_per_lane(cases, name):
    (ts, tm, tapi), rays, pix, samp, L_ref = cases[name]
    cfg = tapi.integrator_config
    assert cfg.kind == "direct" and tm.n_tris > 64         # the 4-wide route
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    L = tint.li(ts, tm, cfg, *to_torch(rays, pix, samp)).numpy()
    # spotfog's camera segment marches its one region: 32 "medium" waves
    assert tint.WAVES["medium"] == (32 if name == "spotfog" else 0)
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


@pytest.mark.parametrize("name", MEDIA_GOLDENS)
def test_golden_through_the_command_line(tmp_path, name):
    out = str(tmp_path / (name + ".exr"))
    assert cli_main([os.path.join(SCENES, name + ".pbrt"), "--cpu", "--quiet",
                     "--outfile", out]) == 0
    img = read_image(out)
    gold = read_image(os.path.join(GOLDENS, name + ".exr"))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert relative_mae(img, gold) < GOLDEN_RELMAE
