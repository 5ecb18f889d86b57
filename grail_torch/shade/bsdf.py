"""BSDF lobe stack (port of grail/shade/bsdf.py: the stack dispatch, the
LAMBERT and OREN_NAYAR diffuse lobes, the BLINN microfacet lobe with its
Fresnel terms, and the delta lobes SPEC_REFL and SPEC_TRANS).

A BSDF is a static-length stack of lobe slots evaluated in the local shading
frame (z up). As in the reference, only the lobe types present in the scene
(`present`, a static tuple) are evaluated, each under its type mask. Delta
lobes have no f or pdf: they enter only through bsdf_sample, whose pick of
one carries its delta value and pdf 1/n_match. Other lobe types are not
ported yet and raise.
"""
from __future__ import annotations

import torch

from ..core.vecmath import INV_PI, INV_TWOPI, PI, dot, normalize, safe_sqrt
from ..core import montecarlo as mc

# lobe type tags (same values as grail)
NONE = 0
LAMBERT = 1
OREN_NAYAR = 2
BLINN = 3
ANISO = 4
SPEC_REFL = 5
SPEC_TRANS = 6
FRESNEL_BLEND = 7
LAMBERT_T = 8
BLINN_T = 9
MEASURED = 10

# fresnel type tags
FR_NOOP = 0
FR_DIELECTRIC = 1
FR_CONDUCTOR = 2

PORTED_TYPES = (LAMBERT, OREN_NAYAR, BLINN, SPEC_REFL, SPEC_TRANS)


def _check_present(present):
    missing = sorted(set(present) - set(PORTED_TYPES))
    if missing:
        raise NotImplementedError(f"lobe types {missing} are not ported yet "
                                  "(LAMBERT, OREN_NAYAR, BLINN, SPEC_REFL, SPEC_TRANS)")


def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


# ------------------------------------------------------------------------- Fresnel
def fr_dielectric(cosi, eta_i, eta_t):
    """Exact dielectric Fresnel with total internal reflection; cosi signed,
    the indices swap when exiting. Returns the scalar reflectance."""
    cosi = torch.clamp(cosi, -1.0, 1.0)
    entering = cosi > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    sint = ei / et * safe_sqrt(1.0 - cosi * cosi)
    cost = safe_sqrt(1.0 - sint * sint)
    aci = torch.abs(cosi)
    rparl = (et * aci - ei * cost) / torch.clamp_min(et * aci + ei * cost, 1e-12)
    rperp = (ei * aci - et * cost) / torch.clamp_min(ei * aci + et * cost, 1e-12)
    fr = 0.5 * (rparl * rparl + rperp * rperp)
    return torch.where(sint >= 1.0, 1.0, fr)


def fr_conductor(cosi, eta, k):
    """Conductor Fresnel; eta, k RGB (...,3), cosi (...)."""
    cosi = torch.abs(cosi)[..., None]
    tmp = (eta * eta + k * k) * cosi * cosi
    rparl2 = (tmp - 2.0 * eta * cosi + 1.0) / torch.clamp_min(
        tmp + 2.0 * eta * cosi + 1.0, 1e-12)
    tmp_f = eta * eta + k * k
    rperp2 = (tmp_f - 2.0 * eta * cosi + cosi * cosi) / torch.clamp_min(
        tmp_f + 2.0 * eta * cosi + cosi * cosi, 1e-12)
    return (rparl2 + rperp2) / 2.0


def lobe_fresnel(fr_type, cosi, eta_f, eta_s, k_s):
    """Masked dispatch over the Fresnel type: RGB reflectance (...,3)."""
    one = torch.ones(cosi.shape + (3,), dtype=torch.float32, device=cosi.device)
    f_diel = fr_dielectric(cosi, torch.ones_like(eta_f), eta_f)[..., None] * one
    return torch.where((fr_type == FR_DIELECTRIC)[..., None], f_diel,
                       torch.where((fr_type == FR_CONDUCTOR)[..., None],
                                   fr_conductor(cosi, eta_s, k_s), one))


# ------------------------------------------------------------------ Blinn microfacets
def blinn_d(wh, exponent):
    return (exponent + 2.0) * INV_TWOPI * torch.pow(
        torch.clamp_min(abs_cos_theta(wh), 1e-6), exponent)


def blinn_sample_wh(wo, u1, u2, exponent):
    """Half vector distributed as the Blinn D (pbrt Blinn::Sample_f)."""
    costheta = torch.pow(torch.clamp_min(u1, 1e-12), 1.0 / (exponent + 1.0))
    sintheta = safe_sqrt(1.0 - costheta * costheta)
    phi = u2 * 2.0 * PI
    wh = torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi),
                      costheta], dim=-1)
    return torch.where(same_hemisphere(wo, wh)[..., None], wh, -wh)


def blinn_pdf_wh_to_wi(wo, wh, exponent):
    """pdf of wi under Blinn sampling (with the dwh/dwi Jacobian)."""
    pdf_wh = ((exponent + 1.0) * torch.pow(
        torch.clamp_min(abs_cos_theta(wh), 1e-6), exponent) * INV_TWOPI)
    return pdf_wh / (4.0 * torch.clamp_min(torch.abs(dot(wo, wh)), 1e-6))


def torrance_sparrow_g(wo, wi, wh):
    ndotwh = abs_cos_theta(wh)
    wodotwh = torch.clamp_min(torch.abs(dot(wo, wh)), 1e-6)
    return torch.clamp_max(torch.minimum(
        2.0 * ndotwh * abs_cos_theta(wo) / wodotwh,
        2.0 * ndotwh * abs_cos_theta(wi) / wodotwh), 1.0)


def _half_vector(wo, wi):
    wh = normalize(wi + wo)
    wh_ok = torch.sum(torch.abs(wi + wo), dim=-1) > 1e-9
    return wh, wh_ok


# --------------------------------------------------------------------- one lobe slot
def oren_nayar_f(wo, wi, R, sigma):
    """OrenNayar::f with sigma in radians (A and B from sigma^2, the cosine
    of the azimuth difference from the normalized xy projections)."""
    sigma2 = sigma * sigma
    A = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    B = 0.45 * sigma2 / (sigma2 + 0.09)
    sinthetai = safe_sqrt(1.0 - wi[..., 2] ** 2)
    sinthetao = safe_sqrt(1.0 - wo[..., 2] ** 2)
    ok_i = sinthetai > 1e-4
    ok_o = sinthetao > 1e-4
    cosdphi = ((wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
               / (torch.where(ok_i, sinthetai, 1.0) * torch.where(ok_o, sinthetao, 1.0)))
    maxcos = torch.where(ok_i & ok_o, torch.clamp_min(cosdphi, 0.0), 0.0)
    sinalpha = torch.maximum(sinthetai, sinthetao)
    tanbeta = torch.minimum(sinthetai, sinthetao) / torch.clamp_min(
        torch.minimum(abs_cos_theta(wi), abs_cos_theta(wo)), 1e-6)
    return R * INV_PI * (A + B * maxcos * sinalpha * tanbeta)[..., None]


def lobe_f(lobe_type, wo, wi, R, S1, S2, f0, f2, fr_type, present):
    """One lobe slot's BRDF value (masked by type). Delta lobes return 0."""
    _check_present(present)
    result = wo.new_zeros((wo.shape[0], 3))
    reflect = same_hemisphere(wo, wi)
    if LAMBERT in present:
        m = (lobe_type == LAMBERT) & reflect
        result = result + torch.where(m[..., None], R * INV_PI, 0.0)
    if OREN_NAYAR in present:
        result = result + torch.where(((lobe_type == OREN_NAYAR) & reflect)[..., None],
                                      oren_nayar_f(wo, wi, R, f0), 0.0)
    if BLINN in present:
        aci, aco = abs_cos_theta(wi), abs_cos_theta(wo)
        wh, wh_ok = _half_vector(wo, wi)
        F = lobe_fresnel(fr_type, dot(wi, wh), f2, S1, S2)
        G = torrance_sparrow_g(wo, wi, wh)
        denom = torch.clamp_min(4.0 * aci * aco, 1e-6)
        val = R * F * (blinn_d(wh, f0) * G / denom)[..., None]
        m = ((lobe_type == BLINN) & reflect & wh_ok & (aci > 1e-6) & (aco > 1e-6))
        result = result + torch.where(m[..., None], val, 0.0)
    return result


def lobe_pdf(lobe_type, wo, wi, f0, present):
    """pdf of one lobe slot's sampling strategy."""
    _check_present(present)
    pdf = wo.new_zeros(wo.shape[:-1])
    reflect = same_hemisphere(wo, wi)
    diffuse = [t for t in (LAMBERT, OREN_NAYAR) if t in present]
    if diffuse:
        cos_pdf = abs_cos_theta(wi) * INV_PI
        for t in diffuse:
            pdf = pdf + torch.where((lobe_type == t) & reflect, cos_pdf, 0.0)
    if BLINN in present:
        wh, wh_ok = _half_vector(wo, wi)
        pdf = pdf + torch.where((lobe_type == BLINN) & reflect & wh_ok,
                                blinn_pdf_wh_to_wi(wo, wh, f0), 0.0)
    return pdf


def lobe_sample_wi(lobe_type, wo, u1, u2, f0, f2, present):
    """Sample an incident direction from one lobe slot's strategy; returns
    (wi, is_valid). Delta lobes give their one direction: SPEC_REFL mirrors
    wo about +z, SPEC_TRANS refracts it with ior f2 (the indices swap when
    wo is inside, and total internal reflection is an invalid sample); f2
    is read only when SPEC_TRANS is present, and may be None otherwise."""
    _check_present(present)
    wi = wo.new_zeros(wo.shape[:-1] + (3,))
    valid = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)

    def put(t, cand, ok):
        m = lobe_type == t
        return torch.where(m[..., None], cand, wi), torch.where(m, ok, valid)

    diffuse = [t for t in (LAMBERT, OREN_NAYAR) if t in present]
    if diffuse:
        entering_sign = torch.where(cos_theta(wo) > 0.0, 1.0, -1.0)
        one = torch.ones_like(entering_sign)
        cand = mc.cosine_sample_hemisphere(u1, u2) * torch.stack(
            [one, one, entering_sign], dim=-1)
        for t in diffuse:
            wi, valid = put(t, cand, True)
    if BLINN in present:
        wh = blinn_sample_wh(wo, u1, u2, f0)
        cand = -wo + 2.0 * dot(wo, wh)[..., None] * wh
        wi, valid = put(BLINN, cand, same_hemisphere(wo, cand))
    if SPEC_REFL in present:
        cand = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
        wi, valid = put(SPEC_REFL, cand, True)
    if SPEC_TRANS in present:
        entering = cos_theta(wo) > 0.0
        eta = torch.where(entering, 1.0, f2) / torch.where(entering, f2, 1.0)
        sint2 = eta * eta * torch.clamp_min(1.0 - cos_theta(wo) ** 2, 0.0)
        cost = safe_sqrt(1.0 - sint2)
        cand = torch.stack([eta * -wo[..., 0], eta * -wo[..., 1],
                            torch.where(entering, -cost, cost)], dim=-1)
        wi, valid = put(SPEC_TRANS, cand, sint2 < 1.0)
    return wi, valid


def lobe_specular_value(lobe_type, wo, wi, R, S1, S2, f2, fr_type, present):
    """A delta lobe's value as pbrt's Sample_f returns it: F·R/|cosθi| for
    SPEC_REFL, (1−F)·T·(ηi/ηt)²/|cosθi| for SPEC_TRANS; zero elsewhere."""
    aci = torch.clamp_min(abs_cos_theta(wi), 1e-6)[..., None]
    out = wo.new_zeros(wo.shape)
    if SPEC_REFL in present:
        F = lobe_fresnel(fr_type, cos_theta(wo), f2, S1, S2)
        out = torch.where((lobe_type == SPEC_REFL)[..., None], F * R / aci, out)
    if SPEC_TRANS in present:
        Fr = fr_dielectric(cos_theta(wo), torch.ones_like(f2), f2)
        entering = cos_theta(wo) > 0.0
        ei = torch.where(entering, 1.0, f2)
        et = torch.where(entering, f2, 1.0)
        val = ((ei * ei) / (et * et) * (1.0 - Fr))[..., None] * R / aci
        out = torch.where((lobe_type == SPEC_TRANS)[..., None], val, out)
    return out


# ------------------------------------------------------------------- BSDF stack API
def _matching_mask(lobes, include_specular):
    """(N,K) bool mask of lobes that match the requested flags."""
    t = lobes["type"]
    m = t != NONE
    if not include_specular:
        m = m & (t != SPEC_REFL) & (t != SPEC_TRANS)
    return m


def bsdf_f(lobes, wo, wi, present, include_specular=True):
    """Sum over lobe slots of lobe_f (pbrt BSDF::f)."""
    total = wo.new_zeros(wo.shape)
    for k in range(lobes["type"].shape[1]):
        total = total + lobe_f(lobes["type"][:, k], wo, wi, lobes["R"][:, k],
                               lobes["S1"][:, k], lobes["S2"][:, k],
                               lobes["f0"][:, k], lobes["f2"][:, k],
                               lobes["fr"][:, k], present)
    return total


def bsdf_pdf(lobes, wo, wi, present, include_specular=False):
    """Average pdf over matching lobes (pbrt BSDF::Pdf)."""
    match = _matching_mask(lobes, include_specular)
    total = wo.new_zeros(wo.shape[:-1])
    for k in range(lobes["type"].shape[1]):
        total = total + torch.where(
            match[:, k], lobe_pdf(lobes["type"][:, k], wo, wi, lobes["f0"][:, k],
                                  present), 0.0)
    n = torch.sum(match.to(torch.float32), dim=-1)
    return torch.where(n > 0, total / torch.clamp_min(n, 1.0), 0.0)


def bsdf_sample(lobes, wo, u1, u2, u_comp, present, include_specular=True):
    """pbrt BSDF::Sample_f over the lobe stack. Returns dict: wi (N,3),
    f (N,3), pdf (N,), specular (N,) bool, valid (N,) bool."""
    match = _matching_mask(lobes, include_specular)
    n_match = torch.sum(match.to(torch.int32), dim=-1)
    # pick the `which`-th matching slot
    which = torch.minimum((u_comp * n_match.to(torch.float32)).to(torch.int32),
                          torch.clamp_min(n_match - 1, 0))
    cum = torch.cumsum(match.to(torch.int32), dim=-1)
    slot_sel = torch.argmax(((cum == (which + 1)[:, None]) & match).to(torch.int32),
                            dim=-1)
    specular = [t for t in (SPEC_REFL, SPEC_TRANS) if t in present]
    lane = torch.arange(wo.shape[0], device=wo.device)
    # the delta lobes' fields are gathered only when one is present
    keys = ("type", "f0") + (("R", "S1", "S2", "f2", "fr") if specular else ())
    ch = {key: lobes[key][lane, slot_sel] for key in keys}

    wi, valid = lobe_sample_wi(ch["type"], wo, u1, u2, ch["f0"], ch.get("f2"), present)
    valid = valid & (n_match > 0)
    f = bsdf_f(lobes, wo, wi, present, include_specular)
    pdf = bsdf_pdf(lobes, wo, wi, present, include_specular)
    chosen_specular = (ch["type"] == SPEC_REFL) | (ch["type"] == SPEC_TRANS)
    if specular:
        # a specular pick carries the chosen lobe's delta value and pdf
        # 1/n_match, and no f of the other lobes
        f_spec = lobe_specular_value(ch["type"], wo, wi, ch["R"], ch["S1"], ch["S2"],
                                     ch["f2"], ch["fr"], present)
        inv_n = 1.0 / torch.clamp_min(n_match.to(torch.float32), 1.0)
        f = torch.where(chosen_specular[:, None], f_spec, f)
        pdf = torch.where(chosen_specular, inv_n, pdf)
    return {"wi": wi, "f": f, "pdf": pdf, "specular": chosen_specular,
            "valid": valid & (pdf > 0.0)}
