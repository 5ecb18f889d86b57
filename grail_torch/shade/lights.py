"""Light sampling (port of grail/shade/lights.py, AREA lights only).

Area lights pick a triangle from a per-light area CDF, then a uniform
barycentric point, and convert to solid angle with the per-point pdf
r^2/(|cos|·totalArea) — the area-domain MIS form the reference documents.
The static `present_types` branching is kept; light types other than AREA
are not ported yet and raise.
"""
from __future__ import annotations

import torch

from ..core.vecmath import dot, normalize, length_sq, cross
from ..core import montecarlo as mc

POINT = 0
SPOT = 1
DISTANT = 2
AREA = 3
INFINITE = 4
PROJECTION = 5
GONIOMETRIC = 6

WORLD_BIG = 1.0e7


def is_delta(light_type):
    return ((light_type == POINT) | (light_type == SPOT) | (light_type == DISTANT)
            | (light_type == PROJECTION) | (light_type == GONIOMETRIC))


def _area_sample(scene, li, p, u1, u2, u3):
    """Sample a point on area light li: tri via area CDF, uniform barycentric.
    Returns (wi, n_l, cos_l, pdf_solidangle, dist)."""
    lights = scene["lights"]
    tri_slot = mc.searchsorted_rows(lights["acdf"], li, u3)      # (N,)
    at = lights["av0"].shape[1]
    flat = li.to(torch.int64) * at + tri_slot
    v0 = lights["av0"].reshape(-1, 3)[flat]
    v1 = lights["av1"].reshape(-1, 3)[flat]
    v2 = lights["av2"].reshape(-1, 3)[flat]
    b0, b1 = mc.uniform_sample_triangle(u1, u2)
    pl = b0[..., None] * v0 + b1[..., None] * v1 + (1.0 - b0 - b1)[..., None] * v2
    n_l = normalize(cross(v1 - v0, v2 - v0))
    flip = lights["aflip"].reshape(-1)[flat] != 0
    n_l = torch.where(flip[..., None], -n_l, n_l)

    vec = pl - p
    dist2 = length_sq(vec)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
    wi = vec / dist[..., None]
    cos_l = dot(n_l, -wi)
    pdf = dist2 / torch.clamp_min(torch.abs(cos_l) * lights["area"][li], 1e-12)
    return wi, n_l, cos_l, pdf, dist


def sample_li(scene, li, p, u1, u2, u3, present_types):
    """Light::Sample_L(p) masked over the present light types.

    li (N,) light row per shade point; (u1, u2) 2D sample; u3 picks the area
    light's triangle. Returns dict: wi (N,3), radiance (N,3), pdf (N,),
    dist (N,) shadow-ray length, delta (N,) bool."""
    unported = sorted(set(present_types) - {AREA})
    if unported:
        raise NotImplementedError(f"light types {unported} are not ported yet "
                                  "(AREA only)")
    lights = scene["lights"]
    lt = lights["type"][li]
    n = p.shape[0]
    wi = p.new_zeros((n, 3))
    radiance = p.new_zeros((n, 3))
    pdf = p.new_zeros((n,))
    dist = p.new_full((n,), WORLD_BIG)
    emit = lights["emit"][li]

    if AREA in present_types:
        wi_a, _, cos_l, pdf_a, dist_a = _area_sample(scene, li, p, u1, u2, u3)
        rad_a = torch.where((cos_l > 0.0)[..., None], emit, 0.0)
        m = lt == AREA
        wi = torch.where(m[..., None], wi_a, wi)
        radiance = torch.where(m[..., None], rad_a, radiance)
        pdf = torch.where(m, pdf_a, pdf)
        dist = torch.where(m, dist_a * (1.0 - 1e-3), dist)

    return {"wi": wi, "radiance": radiance, "pdf": pdf, "dist": dist,
            "delta": is_delta(lt)}


def area_light_emitted(scene, sg, wo_world):
    """Intersection::Le — emitted radiance at a hit on an area-light triangle
    (DiffuseAreaLight::L: Lemit if dot(n, w) > 0)."""
    lights = scene["lights"]
    emit = lights["emit"][torch.clamp_min(sg["light"], 0)]
    mask = (sg["light"] >= 0) & (dot(sg["ng"], wo_world) > 0.0)
    return torch.where(mask[..., None], emit, 0.0)


def area_light_pdf_dir(scene, li, p, wi, hit_t, cos_at_light):
    """Per-point solid-angle pdf at a BSDF-sampled hit on the light:
    r^2/(|cos|·totalArea), the same function the light branch divides by."""
    return (hit_t * hit_t) / torch.clamp_min(
        torch.abs(cos_at_light) * scene["lights"]["area"][li], 1e-12)
