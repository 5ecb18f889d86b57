"""The port's dipole subsurface integrator against the reference's.

The host-side pieces are numpy in both packages and agree exactly: the
Fresnel moment, the dipole albedo and its inversion
(subsurface_from_diffuse), and the surface points, drawn from the same
numpy generator (bitwise, on the reference's own scene arrays and on the
port's parse of scenes/dipole.pbrt). The diffusion profile Rd over seeded
distances and media (allclose rtol 1e-5, atol 1e-6, the port's
tolerance for float stages). On scenes/dipole.pbrt at 16x16: the
irradiance at the 1,024 points (rtol 1e-4: 8 shadow-ray samples summed,
every point's light samples as the reference's), and dipole_li per lane
with the reference's preprocess fed to both (>= 99% of lanes within rtol
1e-4, atol 1e-6, as tests/test_torch_render.py) and with the port's own
(the same share): the dense Mo contraction sums 1,024 points a lane, in
the reference's chunks of 512, and the port's lane chunks do not change a
lane's sum. The medium name "marble" is not in the case-sensitive measured
table, so both keep the skin1 coefficients.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.engine import subsurface as jsss
from grail.scene import parser as jparser
from grail_torch.engine import integrator as tint
from grail_torch.engine import subsurface as tsss
from grail_torch.scene import parser as tparser
from tests.test_torch_goldens import _close
from tests.test_torch_media import RES, reference_rays, to_torch

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), os.pardir, "scenes")


def test_host_pieces_match_reference():
    for eta in (0.7, 1.0, 1.3, 1.5, 2.2):
        assert tsss.fresnel_diffuse_reflectance(eta) == jsss.fresnel_diffuse_reflectance(eta)
    alphap = np.linspace(0.0, 1.0, 101)
    np.testing.assert_array_equal(tsss.rd_integral(alphap, 2.5),
                                  jsss.rd_integral(alphap, 2.5))
    for kd, mfp, eta in (((0.5, 0.5, 0.5), 1.0, 1.3), ((0.8, 0.3, 0.1), 0.2, 1.5)):
        got = tsss.subsurface_from_diffuse(kd, mfp, eta)
        assert got == jsss.subsurface_from_diffuse(kd, mfp, eta)
        # the inversion gives back kd's albedo
        fdr = tsss.fresnel_diffuse_reflectance(eta)
        sa, sps = map(np.asarray, got)
        np.testing.assert_allclose(
            tsss.rd_integral(sps / (sa + sps), (1 + fdr) / (1 - fdr)), kd, rtol=1e-6)


def test_dipole_rd_matches_reference():
    rng = np.random.default_rng(60)
    d2 = (rng.uniform(0.0, 2.0, (4096, 1)) ** 2).astype(np.float32)
    for sa, sps, eta in (((0.0011, 0.0024, 0.014), (2.55, 3.21, 3.77), 1.3),
                         ((0.032, 0.17, 0.48), (0.74, 0.88, 1.01), 1.5)):
        sa, sps = np.asarray(sa, np.float32), np.asarray(sps, np.float32)
        _close(tsss.dipole_rd(torch.tensor(d2), torch.tensor(sa), torch.tensor(sps), eta),
               jsss.dipole_rd(jnp.asarray(d2), jnp.asarray(sa), jnp.asarray(sps), eta),
               "Rd")


@pytest.fixture(scope="module")
def dipole():
    """Both packages' parse of scenes/dipole.pbrt at RES x RES, and the
    reference's preprocess."""
    with open(os.path.join(SCENES, "dipole.pbrt")) as f:
        text = re.sub(r'"integer xresolution" \[\d+\] "integer yresolution" \[\d+\]',
                      f'"integer xresolution" [{RES}] "integer yresolution" [{RES}]',
                      f.read())
    js, jm, japi = jparser.parse_string(text)
    ts, tm, tapi = tparser.parse_string(text, device="cpu")
    aux = jsss.dipole_preprocess(js, jm, japi.integrator_config)
    return js, jm, japi.integrator_config, ts, tm, tapi.integrator_config, aux


def test_surface_points_match_reference_bitwise(dipole):
    js, jm, jcfg, ts, tm, tcfg, aux = dipole
    fields = ("sss_npoints", "sss_sigma_a", "sss_sigma_s", "sss_eta", "sss_maxerror")
    assert [getattr(tcfg, f) for f in fields] == [getattr(jcfg, f) for f in fields]
    # "marble" is not "Marble": the skin1 defaults stay
    assert tcfg.sss_sigma_a == (0.0011, 0.0024, 0.014) and tcfg.sss_eta == 1.5
    ref = {"verts": torch.tensor(np.asarray(js["verts"])),
           "tri_idx": torch.tensor(np.asarray(js["tri_idx"]))}
    for scene in (ref, ts):
        p, n, area = tsss.sample_surface_points(scene, tcfg.sss_npoints)
        for got, want in zip((p, n, area), (aux["p"], aux["n"], aux["area"])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_irradiance_at_points_matches_reference(dipole):
    js, jm, jcfg, ts, tm, tcfg, aux = dipole
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    E = tsss.irradiance_at_points(ts, tm, torch.tensor(np.asarray(aux["p"])),
                                  torch.tensor(np.asarray(aux["n"])))
    assert tint.WAVES["irradiance"] == tm.n_lights * 4 == 8
    ref = np.asarray(aux["E"])
    assert (ref > 0).any(axis=-1).mean() > 0.3
    _close(E, ref, "E", rtol=1e-4)


def test_dipole_li_matches_reference_per_lane(dipole):
    js, jm, jcfg, ts, tm, tcfg, aux = dipole
    rays, pix, samp = reference_rays(js, jm)
    L_ref = np.asarray(jax.jit(lambda r, p, s: jsss.dipole_li(js, jm, jcfg, r, p, s, aux))(
        rays, pix, samp))
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    taux = {k: torch.tensor(np.asarray(v)) for k, v in aux.items()}
    own = tsss.dipole_preprocess(ts, tm, tcfg)
    for pre in (taux, own):
        L = tsss.dipole_li(ts, tm, tcfg, *to_torch(rays, pix, samp), pre).numpy()
        assert np.isfinite(L).all() and L.mean() > 0.01
        close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
        assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"
    # the camera wave, one light's shadow wave and its BSDF branch a call
    assert (tint.WAVES["camera"], tint.WAVES["shadow"], tint.WAVES["bsdf"]) == (2, 2, 2)


def test_lane_chunks_leave_each_sum(dipole, monkeypatch):
    """Mo over lane chunks of 100 equals Mo in one chunk, bitwise."""
    *_, aux = dipole
    taux = {k: torch.tensor(np.asarray(v)) for k, v in aux.items()}
    p = torch.tensor(np.random.default_rng(61).uniform(-1, 1, (1000, 3)).astype(np.float32))
    args = (torch.tensor([0.0011, 0.0024, 0.014]), torch.tensor([2.55, 3.21, 3.77]), 1.5)
    whole = tsss._mo(p, taux, *args)
    monkeypatch.setattr(tsss, "LANE_CHUNK", 100)
    assert torch.equal(tsss._mo(p, taux, *args), whole)
