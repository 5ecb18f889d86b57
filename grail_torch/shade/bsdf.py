"""BSDF lobe stack (port of grail/shade/bsdf.py: the stack dispatch and the
LAMBERT lobe).

A BSDF is a static-length stack of lobe slots evaluated in the local shading
frame (z up). As in the reference, only the lobe types present in the scene
(`present`, a static tuple) are evaluated, each under its type mask. Lobe
types other than LAMBERT are not ported yet and raise.
"""
from __future__ import annotations

import torch

from ..core.vecmath import INV_PI
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

FR_NOOP = 0

PORTED_TYPES = (LAMBERT,)


def _check_present(present):
    missing = sorted(set(present) - set(PORTED_TYPES))
    if missing:
        raise NotImplementedError(f"lobe types {missing} are not ported yet "
                                  "(LAMBERT only)")


def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


# --------------------------------------------------------------------- one lobe slot
def lobe_f(lobe_type, wo, wi, R, present):
    """One lobe slot's BRDF value (masked by type). Delta lobes return 0."""
    _check_present(present)
    result = wo.new_zeros((wo.shape[0], 3))
    if LAMBERT in present:
        reflect = same_hemisphere(wo, wi)
        m = (lobe_type == LAMBERT) & reflect
        result = result + torch.where(m[..., None], R * INV_PI, 0.0)
    return result


def lobe_pdf(lobe_type, wo, wi, present):
    """pdf of one lobe slot's sampling strategy."""
    _check_present(present)
    pdf = wo.new_zeros(wo.shape[:-1])
    if LAMBERT in present:
        reflect = same_hemisphere(wo, wi)
        cos_pdf = abs_cos_theta(wi) * INV_PI
        pdf = pdf + torch.where((lobe_type == LAMBERT) & reflect, cos_pdf, 0.0)
    return pdf


def lobe_sample_wi(lobe_type, wo, u1, u2, present):
    """Sample an incident direction from one lobe slot's strategy; returns
    (wi, is_valid)."""
    _check_present(present)
    wi = wo.new_zeros(wo.shape[:-1] + (3,))
    valid = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    if LAMBERT in present:
        entering_sign = torch.where(cos_theta(wo) > 0.0, 1.0, -1.0)
        one = torch.ones_like(entering_sign)
        wi_cos = mc.cosine_sample_hemisphere(u1, u2)
        cand = wi_cos * torch.stack([one, one, entering_sign], dim=-1)
        m = lobe_type == LAMBERT
        wi = torch.where(m[..., None], cand, wi)
        valid = torch.where(m, True, valid)
    return wi, valid


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
                               present)
    return total


def bsdf_pdf(lobes, wo, wi, present, include_specular=False):
    """Average pdf over matching lobes (pbrt BSDF::Pdf)."""
    match = _matching_mask(lobes, include_specular)
    total = wo.new_zeros(wo.shape[:-1])
    for k in range(lobes["type"].shape[1]):
        total = total + torch.where(
            match[:, k], lobe_pdf(lobes["type"][:, k], wo, wi, present), 0.0)
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
    lane = torch.arange(wo.shape[0], device=wo.device)
    ch_type = lobes["type"][lane, slot_sel]

    wi, valid = lobe_sample_wi(ch_type, wo, u1, u2, present)
    chosen_specular = (ch_type == SPEC_REFL) | (ch_type == SPEC_TRANS)
    valid = valid & (n_match > 0)

    f_all = bsdf_f(lobes, wo, wi, present, include_specular)
    pdf_all = bsdf_pdf(lobes, wo, wi, present, include_specular)
    # specular picks carry the delta value and pdf 1/n_match; no specular
    # lobe is ported yet, so their value is zero
    inv_n = 1.0 / torch.clamp_min(n_match.to(torch.float32), 1.0)
    f = torch.where(chosen_specular[:, None], 0.0, f_all)
    pdf = torch.where(chosen_specular, inv_n, pdf_all)
    return {"wi": wi, "f": f, "pdf": pdf, "specular": chosen_specular,
            "valid": valid & (pdf > 0.0)}
