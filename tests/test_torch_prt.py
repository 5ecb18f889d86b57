"""The port's precomputed radiance transfer and radiance probes
(grail_torch/engine/prt.py) against the reference's grail/engine/prt.py.

scenes/prtteapot.pbrt (diffuseprt under an infinite light) and
scenes/useprobes.pbrt at 16x16, parsed by both packages (the integrator's
settings equal), with prt_nsamples 8 in place of the scenes' 64 and 32 (the
reference unrolls every sample into one XLA program; its programs are
compiled on threads). Held within rtol 1e-5, atol 1e-6 (the port's
tolerance for float stages): prt_preprocess's windowed expansion c_in and
bake_probes's coefficients (4x4x4 cells, its 8 "probe_bake" waves);
per lane, >= 99% of lanes within rtol 1e-4, atol 1e-6, as
tests/test_torch_media_goldens.py: diffuseprt_li, glossyprt_li (prtteapot
with its integrator line swapped) given the reference's c_in, each with its
8 "prt_transfer" waves, and useprobes_li given the reference's probes. A
probe file written by each package holds the same bytes, and each package
reads the other's back to the same values.
"""
from concurrent.futures import ThreadPoolExecutor
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.engine import prt as jprt
from grail.scene import parser as jparser
from grail_torch.engine import integrator as tint
from grail_torch.engine import prt as tprt
from grail_torch.scene import parser as tparser
from grail_torch.scene.bridge import aux_from_numpy
from tests.test_torch_goldens import _close
from tests.test_torch_media import reference_rays, to_torch
from tests.test_torch_photon import lanes_close, scene_text, tree_np

torch.set_num_threads(2)

NSAMPLES = 8
PROBES_RES = (4, 4, 4)


def _texts():
    diffuse = scene_text("prtteapot")
    return {"diffuseprt": diffuse,
            "glossyprt": diffuse.replace('SurfaceIntegrator "diffuseprt"',
                                         'SurfaceIntegrator "glossyprt"'),
            "useprobes": scene_text("useprobes")}


@pytest.fixture(scope="module")
def prt():
    """{kind: (port parse, reference cfg, rays, aux, reference L)}."""
    refs = {}
    for kind, text in _texts().items():
        js, jm, japi = jparser.parse_string(text)
        refs[kind] = (js, jm, japi.integrator_config, reference_rays(js, jm))
    js, jm, jcfg, _ = refs["diffuseprt"]
    jcfg = dataclasses.replace(jcfg, prt_nsamples=NSAMPLES)
    c_in = jax.jit(lambda: jprt.prt_preprocess(js, jm, jcfg))()
    ju, jmu, jcfg_u, _ = refs["useprobes"]
    jcfg_u = dataclasses.replace(jcfg_u, prt_nsamples=NSAMPLES)
    probes = jax.jit(lambda: jprt.bake_probes(ju, jmu, jcfg_u, *PROBES_RES,
                                              n_samples=NSAMPLES))()
    auxes = {"diffuseprt": c_in, "glossyprt": c_in, "useprobes": {"probes": probes}}
    fns = {"diffuseprt": jprt.diffuseprt_li, "glossyprt": jprt.glossyprt_li,
           "useprobes": jprt.useprobes_li}
    with ThreadPoolExecutor(3) as pool:
        jobs = {}
        for kind, (js, jm, jcfg, args) in refs.items():
            jcfg = dataclasses.replace(jcfg, prt_nsamples=NSAMPLES)
            fn = jax.jit(lambda r, p, s, a, js=js, jm=jm, jcfg=jcfg, f=fns[kind]:
                         f(js, jm, jcfg, r, p, s, a))
            jobs[kind] = (jcfg, pool.submit(fn.lower(*args, auxes[kind]).compile))
        out = {}
        for kind, (jcfg, job) in jobs.items():
            args = refs[kind][3]
            out[kind] = (tparser.parse_string(_texts()[kind], device="cpu"),
                         refs[kind][2], jcfg, args, tree_np(auxes[kind]),
                         np.asarray(job.result()(*args, auxes[kind])))
    yield out


@pytest.mark.parametrize("kind", ("diffuseprt", "glossyprt", "useprobes"))
def test_config_matches_reference(prt, kind):
    (_, _, tapi), jcfg = prt[kind][0], prt[kind][1]
    tcfg = tapi.integrator_config
    assert tcfg.kind == kind
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name


def test_preprocess_and_bake_match_reference(prt):
    (ts, tm, tapi), _, jcfg, _, aux, _ = prt["diffuseprt"]
    cfg = dataclasses.replace(tapi.integrator_config, prt_nsamples=NSAMPLES)
    c_in = tprt.prt_preprocess(ts, tm, cfg)["c_in"]
    assert c_in.shape == (25, 3)
    _close(c_in, aux["c_in"], "c_in")
    (ts, tm, tapi), _, _, _, aux, _ = prt["useprobes"]
    cfg = dataclasses.replace(tapi.integrator_config, prt_nsamples=NSAMPLES)
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    probes = tprt.bake_probes(ts, tm, cfg, *PROBES_RES, n_samples=NSAMPLES)
    assert {k: v for k, v in tint.WAVES.items() if v} == {"probe_bake": NSAMPLES}
    ref = aux["probes"]
    assert probes["coeffs"].shape == (4, 4, 4, 16, 3) and probes["lmax"] == 3
    for key in ("bmin", "bmax"):
        np.testing.assert_array_equal(probes[key].numpy(), ref[key], err_msg=key)
    _close(probes["coeffs"], ref["coeffs"], "coeffs")


@pytest.mark.parametrize("kind", ("diffuseprt", "glossyprt", "useprobes"))
def test_li_matches_reference_per_lane(prt, kind):
    (ts, tm, _), _, jcfg, args, aux, L_ref = prt[kind]
    fn = {"diffuseprt": tprt.diffuseprt_li, "glossyprt": tprt.glossyprt_li,
          "useprobes": tprt.useprobes_li}[kind]
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    L = fn(ts, tm, jcfg, *to_torch(*args), aux_from_numpy(aux, device="cpu")).numpy()
    want = {"camera": 1} if kind == "useprobes" else {"camera": 1, "prt_transfer": NSAMPLES}
    assert {k: v for k, v in tint.WAVES.items() if v} == want
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = lanes_close(L, L_ref)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


def test_probe_files_cross_read(prt, tmp_path):
    ref = prt["useprobes"][4]["probes"]
    port_path, ref_path = str(tmp_path / "port.out"), str(tmp_path / "ref.out")
    tprt.write_probes(port_path, aux_from_numpy(ref, device="cpu"))
    jprt.write_probes(ref_path, {k: jnp.asarray(v) for k, v in ref.items()})
    with open(port_path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()
    back = tprt.read_probes(ref_path, "cpu")
    theirs = jprt.read_probes(port_path)
    for key in ("coeffs", "bmin", "bmax"):
        np.testing.assert_array_equal(back[key].numpy(), ref[key], err_msg=key)
        np.testing.assert_array_equal(np.asarray(theirs[key]), ref[key], err_msg=key)
    assert back["lmax"] == theirs["lmax"] == 3
