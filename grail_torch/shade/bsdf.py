"""BSDF lobe stack (port of grail/shade/bsdf.py): the stack dispatch and
every lobe type of the reference. LAMBERT and OREN_NAYAR (diffuse); BLINN
(a Blinn microfacet with a dielectric, conductor or no Fresnel term) and
ANISO (Ashikhmin-Shirley microfacets); FRESNEL_BLEND (Ashikhmin-Shirley's
coupled diffuse and glossy layers); LAMBERT_T and BLINN_T, the transmission
sides of LAMBERT and BLINN (pbrt BRDFToBTDF); MEASURED, a half-angle table
(shade/measured.py) sampled like a cosine lobe; and the delta lobes
SPEC_REFL and SPEC_TRANS.

A BSDF is a static-length stack of lobe slots evaluated in the local shading
frame (z up). As in the reference, only the lobe types present in the scene
(`present`, a static tuple) are evaluated, each under its type mask. Delta
lobes have no f or pdf: they enter only through bsdf_sample, whose pick of
one carries its delta value and pdf 1/n_match. A slot's f1 (the second
exponent of ANISO and FRESNEL_BLEND, the table row of MEASURED) is read only
where one of those types is present, and may be None elsewhere.

bsdf_f, bsdf_pdf and bsdf_sample are one launch of the card's kernel
(kernels/bsdf.py, csrc/bsdf.cu) a call on CUDA tensors, and one more in
backward where the call records a gradient, with the bits of bsdf_f_plain,
bsdf_pdf_plain and bsdf_sample_plain: the PyTorch version, which CPU
tensors take.
"""
from __future__ import annotations

import torch

from .. import telemetry
from ..core.vecmath import INV_PI, INV_TWOPI, PI, dot, normalize, safe_sqrt
from ..core import montecarlo as mc
from ..kernels import bsdf as kbsdf
from . import measured

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

# the lobes sampled like a cosine lobe (FRESNEL_BLEND for half its samples)
_COSINE = (LAMBERT, OREN_NAYAR, MEASURED)
_FLIP_Z = (1.0, 1.0, -1.0)     # BRDFToBTDF's mirror into the other hemisphere


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


def schlick_fresnel(rs, costheta):
    """Schlick's approximation (FresnelBlend's SchlickFresnel); rs (...,3)."""
    c = torch.clamp(1.0 - costheta, 0.0, 1.0)
    return rs + (c ** 5)[..., None] * (1.0 - rs)


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


def aniso_d(wh, ex, ey):
    """The Ashikhmin-Shirley anisotropic distribution (pbrt Anisotropic::D)."""
    ct = abs_cos_theta(wh)
    d = torch.clamp_min(1.0 - ct * ct, 0.0)
    e = (ex * wh[..., 0] * wh[..., 0] + ey * wh[..., 1] * wh[..., 1]) / torch.where(
        d == 0.0, 1.0, d)
    val = torch.sqrt((ex + 2.0) * (ey + 2.0)) * INV_TWOPI * torch.pow(
        torch.clamp_min(ct, 1e-6), e)
    return torch.where(d == 0.0, 0.0, val)


def aniso_sample_wh(wo, u1, u2, ex, ey):
    """Half vector distributed as the anisotropic D, quadrant by quadrant
    (pbrt Anisotropic::Sample_f)."""
    q = torch.floor(u1 * 4.0)
    phi_q = torch.arctan(torch.sqrt((ex + 1.0) / (ey + 1.0))
                         * torch.tan(PI * (u1 * 4.0 - q) * 0.5))
    cosphi, sinphi = torch.cos(phi_q), torch.sin(phi_q)
    costheta = torch.pow(torch.clamp_min(u2, 1e-12), 1.0 / (
        ex * cosphi * cosphi + ey * sinphi * sinphi + 1.0))
    phi = torch.where(q == 0, phi_q,
                      torch.where(q == 1, PI - phi_q,
                                  torch.where(q == 2, PI + phi_q, 2.0 * PI - phi_q)))
    sintheta = safe_sqrt(1.0 - costheta * costheta)
    wh = torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi),
                      costheta], dim=-1)
    return torch.where(same_hemisphere(wo, wh)[..., None], wh, -wh)


def aniso_pdf_wh_to_wi(wo, wh, ex, ey):
    return aniso_d(wh, ex, ey) / (4.0 * torch.clamp_min(torch.abs(dot(wo, wh)), 1e-6))


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


def _typed(lobe_type, t, cond, val):
    """val on the lanes of lobe type t where cond holds, 0 elsewhere."""
    m = (lobe_type == t) & cond
    return torch.where(m[..., None] if val.dim() > m.dim() else m, val, 0.0)


def lobe_f(lobe_type, wo, wi, R, S1, S2, f0, f2, fr_type, present, f1=None,
           tables=()):
    """One lobe slot's BRDF value (masked by type). Delta lobes return 0.
    tables: the scene's measured half-angle tables (MEASURED reads row f1;
    without tables it shades as a matte lobe of its albedo estimate S1)."""
    result = wo.new_zeros((wo.shape[0], 3))
    reflect = same_hemisphere(wo, wi)
    aci, aco = abs_cos_theta(wi), abs_cos_theta(wo)
    if LAMBERT in present:
        result = result + _typed(lobe_type, LAMBERT, reflect, R * INV_PI)
    if MEASURED in present:
        if tables:
            mv = R * measured.lookup(tables, f1.to(torch.int32), wo,
                                     torch.where(reflect[..., None], wi, -wi))
        else:
            mv = S1 * INV_PI
        result = result + _typed(lobe_type, MEASURED, reflect, mv)
    if LAMBERT_T in present:
        result = result + _typed(lobe_type, LAMBERT_T, ~reflect, R * INV_PI)
    if OREN_NAYAR in present:
        result = result + _typed(lobe_type, OREN_NAYAR, reflect, oren_nayar_f(wo, wi, R, f0))
    if {BLINN, ANISO, FRESNEL_BLEND} & set(present):
        wh, wh_ok = _half_vector(wo, wi)
        cosh = dot(wi, wh)
        denom = torch.clamp_min(4.0 * aci * aco, 1e-6)
        micro_ok = reflect & wh_ok & (aci > 1e-6) & (aco > 1e-6)
        if BLINN in present or ANISO in present:
            F = lobe_fresnel(fr_type, cosh, f2, S1, S2)
            G = torrance_sparrow_g(wo, wi, wh)
        if BLINN in present:
            result = result + _typed(lobe_type, BLINN, micro_ok,
                                     R * F * (blinn_d(wh, f0) * G / denom)[..., None])
        if ANISO in present:
            result = result + _typed(lobe_type, ANISO, micro_ok,
                                     R * F * (aniso_d(wh, f0, f1) * G / denom)[..., None])
        if FRESNEL_BLEND in present:
            # Ashikhmin-Shirley: a diffuse base under a glossy coat
            Rd, Rs = R, S1
            diffuse = (28.0 / (23.0 * PI)) * Rd * (1.0 - Rs) * (
                (1.0 - (1.0 - 0.5 * aci) ** 5) * (1.0 - (1.0 - 0.5 * aco) ** 5))[..., None]
            spec_denom = torch.clamp_min(
                4.0 * torch.abs(cosh) * torch.maximum(aci, aco), 1e-6)
            specular = ((aniso_d(wh, f0, f1) / spec_denom)[..., None]
                        * schlick_fresnel(Rs, cosh))
            result = result + _typed(lobe_type, FRESNEL_BLEND, micro_ok,
                                     diffuse + specular)
    if BLINN_T in present:
        # the BRDF at wi mirrored into wo's hemisphere (BRDFToBTDF)
        wi_m = wi * wi.new_tensor(_FLIP_Z)
        wh_t, wh_t_ok = _half_vector(wo, wi_m)
        F_t = lobe_fresnel(fr_type, dot(wi_m, wh_t), f2, S1, S2)
        G_t = torrance_sparrow_g(wo, wi_m, wh_t)
        denom_t = torch.clamp_min(4.0 * aci * aco, 1e-6)
        result = result + _typed(
            lobe_type, BLINN_T, ~reflect & wh_t_ok & (aci > 1e-6) & (aco > 1e-6),
            R * F_t * (blinn_d(wh_t, f0) * G_t / denom_t)[..., None])
    return result


def lobe_pdf(lobe_type, wo, wi, f0, present, f1=None):
    """pdf of one lobe slot's sampling strategy."""
    pdf = wo.new_zeros(wo.shape[:-1])
    reflect = same_hemisphere(wo, wi)
    cos_pdf = abs_cos_theta(wi) * INV_PI
    for t in _COSINE:
        if t in present:
            pdf = pdf + _typed(lobe_type, t, reflect, cos_pdf)
    if LAMBERT_T in present:
        pdf = pdf + _typed(lobe_type, LAMBERT_T, ~reflect, cos_pdf)
    if {BLINN, ANISO, FRESNEL_BLEND} & set(present):
        wh, wh_ok = _half_vector(wo, wi)
        ok = reflect & wh_ok
        if BLINN in present:
            pdf = pdf + _typed(lobe_type, BLINN, ok, blinn_pdf_wh_to_wi(wo, wh, f0))
        if ANISO in present:
            pdf = pdf + _typed(lobe_type, ANISO, ok, aniso_pdf_wh_to_wi(wo, wh, f0, f1))
        if FRESNEL_BLEND in present:
            # FresnelBlend::Pdf: the mean of the cosine and distribution pdfs
            pdf = pdf + _typed(lobe_type, FRESNEL_BLEND, ok, 0.5 * (
                cos_pdf + aniso_pdf_wh_to_wi(wo, wh, f0, f1)))
    if BLINN_T in present:
        wh_t, wh_t_ok = _half_vector(wo, wi * wi.new_tensor(_FLIP_Z))
        pdf = pdf + _typed(lobe_type, BLINN_T, ~reflect & wh_t_ok,
                           blinn_pdf_wh_to_wi(wo, wh_t, f0))
    return pdf


def lobe_sample_wi(lobe_type, wo, u1, u2, f0, f2, present, f1=None):
    """Sample an incident direction from one lobe slot's strategy; returns
    (wi, is_valid). The cosine lobes sample wo's hemisphere (LAMBERT_T the
    other one); FRESNEL_BLEND takes the cosine for u1 < 0.5 and its
    distribution otherwise, u1 stretched back over [0, 1); BLINN_T mirrors
    a Blinn sample into the other hemisphere. Delta lobes give their one
    direction: SPEC_REFL mirrors wo about +z, SPEC_TRANS refracts it with
    ior f2 (the indices swap when wo is inside, and total internal
    reflection is an invalid sample); f2 is read only when SPEC_TRANS is
    present."""
    wi = wo.new_zeros(wo.shape[:-1] + (3,))
    valid = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)

    def put(t, cand, ok):
        m = lobe_type == t
        return torch.where(m[..., None], cand, wi), torch.where(m, ok, valid)

    entering_sign = torch.where(cos_theta(wo) > 0.0, 1.0, -1.0)
    one = torch.ones_like(entering_sign)
    to_wo_side = torch.stack([one, one, entering_sign], dim=-1)
    if {LAMBERT_T, *_COSINE} & set(present):
        cand = mc.cosine_sample_hemisphere(u1, u2) * to_wo_side
        for t in _COSINE:
            if t in present:
                wi, valid = put(t, cand, True)
        if LAMBERT_T in present:
            wi, valid = put(LAMBERT_T, -cand, True)
    if BLINN in present:
        wh = blinn_sample_wh(wo, u1, u2, f0)
        cand = -wo + 2.0 * dot(wo, wh)[..., None] * wh
        wi, valid = put(BLINN, cand, same_hemisphere(wo, cand))
    if ANISO in present:
        wh = aniso_sample_wh(wo, u1, u2, f0, f1)
        cand = -wo + 2.0 * dot(wo, wh)[..., None] * wh
        wi, valid = put(ANISO, cand, same_hemisphere(wo, cand))
    if FRESNEL_BLEND in present:
        use_cos = u1 < 0.5
        u1r = torch.where(use_cos, 2.0 * u1, 2.0 * (u1 - 0.5))
        wi_c = mc.cosine_sample_hemisphere(u1r, u2) * to_wo_side
        wh = aniso_sample_wh(wo, u1r, u2, f0, f1)
        wi_g = -wo + 2.0 * dot(wo, wh)[..., None] * wh
        wi, valid = put(FRESNEL_BLEND, torch.where(use_cos[..., None], wi_c, wi_g),
                        use_cos | same_hemisphere(wo, wi_g))
    if BLINN_T in present:
        wh = blinn_sample_wh(wo, u1, u2, f0)
        cand = -wo + 2.0 * dot(wo, wh)[..., None] * wh
        wi, valid = put(BLINN_T, cand * cand.new_tensor(_FLIP_Z), same_hemisphere(wo, cand))
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


def bsdf_num_components(lobes, include_specular=True):
    """The lobes of each lane's stack that match the flags (pbrt
    BSDF::NumComponents), int32 (N,)."""
    return torch.sum(_matching_mask(lobes, include_specular).to(torch.int32), dim=-1,
                     dtype=torch.int32)


def diffuse_albedo(lobes):
    """The sum of the Lambertian and Oren-Nayar lobes' reflectances, slot by
    slot (the reference's analog of BSDF::rho, which PRT, the irradiance
    cache and instant GI's lights shade by)."""
    diffuse = (lobes["type"] == LAMBERT) | (lobes["type"] == OREN_NAYAR)
    rho = torch.where(diffuse[:, 0, None], lobes["R"][:, 0], 0.0)
    for k in range(1, diffuse.shape[1]):
        rho = rho + torch.where(diffuse[:, k, None], lobes["R"][:, k], 0.0)
    return rho


def _reads_f1(present):
    return bool({ANISO, FRESNEL_BLEND, MEASURED} & set(present))


# The slot fields each lobe type reads besides its tag: in bsdf_f (and in
# bsdf_sample, which also reads a delta lobe's), and in bsdf_pdf. The card's
# kernel is handed the present types' fields alone, so a field no present
# type reads gets no gradient, as in the plain version.
_FRESNEL = ("fr", "S1", "S2", "f2")
_F_READS = {LAMBERT: ("R",), LAMBERT_T: ("R",), OREN_NAYAR: ("R", "f0"),
            BLINN: ("R", "f0") + _FRESNEL, BLINN_T: ("R", "f0") + _FRESNEL,
            ANISO: ("R", "f0", "f1") + _FRESNEL, FRESNEL_BLEND: ("R", "S1", "f0", "f1"),
            MEASURED: ("R", "S1", "f1")}
_SAMPLE_READS = {**_F_READS, SPEC_REFL: ("R",) + _FRESNEL, SPEC_TRANS: ("R", "f2")}
_PDF_READS = {BLINN: ("f0",), BLINN_T: ("f0",), ANISO: ("f0", "f1"),
              FRESNEL_BLEND: ("f0", "f1")}


def _kernel_fields(lobes, present, reads, directions, uniforms=(), tables=()):
    """The slot fields the present lobe types read (`reads`: a type's
    fields) where the card's kernel takes the call (kernels/bsdf.py::plan:
    CUDA tensors), None where the plain version does."""
    keys = {"type"}.union(*(reads.get(t, ()) for t in present))
    fields = {key: lobes[key] for key in sorted(keys)}
    return fields if kbsdf.plan(fields, directions, uniforms, tables) == "kernel" else None


@telemetry.spanned("bsdf_eval")
def bsdf_f(lobes, wo, wi, present, include_specular=True, tables=()):
    """Sum over lobe slots of lobe_f (pbrt BSDF::f); tables: the scene's
    measured BRDF tables. On CUDA tensors one launch of the card's kernel
    (kernels/bsdf.py), which gives bsdf_f_plain's bits."""
    fields = _kernel_fields(lobes, present, _F_READS, (wo, wi), tables=tables)
    if fields is not None:
        return kbsdf.launch("f", fields, present, wo, wi=wi, tables=tables)
    return bsdf_f_plain(lobes, wo, wi, present, include_specular, tables)


@telemetry.spanned("bsdf_eval")
def bsdf_pdf(lobes, wo, wi, present, include_specular=False):
    """Average pdf over matching lobes (pbrt BSDF::Pdf). On CUDA tensors one
    launch of the card's kernel, which gives bsdf_pdf_plain's bits."""
    fields = _kernel_fields(lobes, present, _PDF_READS, (wo, wi))
    if fields is not None:
        return kbsdf.launch("pdf", fields, present, wo, wi=wi,
                            include_specular=include_specular)
    return bsdf_pdf_plain(lobes, wo, wi, present, include_specular)


@telemetry.spanned("bsdf_sample")
def bsdf_sample(lobes, wo, u1, u2, u_comp, present, include_specular=True, tables=()):
    """pbrt BSDF::Sample_f over the lobe stack. Returns dict: wi (N,3),
    f (N,3), pdf (N,), specular (N,) bool, valid (N,) bool. On CUDA tensors
    one launch of the card's kernel, which gives bsdf_sample_plain's bits."""
    uniforms = (u1, u2, u_comp)
    fields = _kernel_fields(lobes, present, _SAMPLE_READS, (wo,), uniforms, tables)
    if fields is not None:
        return kbsdf.launch("sample", fields, present, wo, uniforms=uniforms,
                            include_specular=include_specular, tables=tables)
    return bsdf_sample_plain(lobes, wo, u1, u2, u_comp, present, include_specular, tables)


def bsdf_f_plain(lobes, wo, wi, present, include_specular=True, tables=()):
    """bsdf_f in PyTorch operations: the CPU's version, and the card
    kernel's reference."""
    total = wo.new_zeros(wo.shape)
    f1 = _reads_f1(present)
    for k in range(lobes["type"].shape[1]):
        total = total + lobe_f(lobes["type"][:, k], wo, wi, lobes["R"][:, k],
                               lobes["S1"][:, k], lobes["S2"][:, k],
                               lobes["f0"][:, k], lobes["f2"][:, k],
                               lobes["fr"][:, k], present,
                               lobes["f1"][:, k] if f1 else None, tables)
    return total


def bsdf_pdf_plain(lobes, wo, wi, present, include_specular=False):
    """bsdf_pdf in PyTorch operations."""
    match = _matching_mask(lobes, include_specular)
    total = wo.new_zeros(wo.shape[:-1])
    f1 = _reads_f1(present)
    for k in range(lobes["type"].shape[1]):
        total = total + torch.where(
            match[:, k], lobe_pdf(lobes["type"][:, k], wo, wi, lobes["f0"][:, k],
                                  present, lobes["f1"][:, k] if f1 else None), 0.0)
    n = torch.sum(match.to(torch.float32), dim=-1)
    return torch.where(n > 0, total / torch.clamp_min(n, 1.0), 0.0)


def bsdf_sample_plain(lobes, wo, u1, u2, u_comp, present, include_specular=True,
                      tables=()):
    """bsdf_sample in PyTorch operations."""
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
    # the delta lobes' fields are gathered only when one is present, f1 only
    # when a lobe that reads it is
    keys = (("type", "f0") + (("f1",) if _reads_f1(present) else ())
            + (("R", "S1", "S2", "f2", "fr") if specular else ()))
    ch = {key: lobes[key][lane, slot_sel] for key in keys}

    wi, valid = lobe_sample_wi(ch["type"], wo, u1, u2, ch["f0"], ch.get("f2"), present,
                               ch.get("f1"))
    valid = valid & (n_match > 0)
    with telemetry.span("bsdf_eval"):
        f = bsdf_f_plain(lobes, wo, wi, present, include_specular, tables)
    with telemetry.span("bsdf_eval"):
        pdf = bsdf_pdf_plain(lobes, wo, wi, present, include_specular)
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
