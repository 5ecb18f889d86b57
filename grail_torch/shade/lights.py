"""Light sampling (port of grail/shade/lights.py: POINT, SPOT, DISTANT, AREA,
INFINITE, PROJECTION and GONIOMETRIC lights).

Area lights pick a triangle from a per-light area CDF, then a uniform
barycentric point, and convert to solid angle with the per-point pdf
r^2/(|cos|·totalArea) — the area-domain MIS form the reference documents.
The infinite light samples its lat-long map through a Distribution2D of
luminance·sinθ (infinite.cpp). A point light is a delta light at the
translation of its light-to-world matrix with radiance I/d²; a spot light
is one whose intensity falls off smoothly between its cone angles around the
light's +z (spot.cpp); a distant light is a delta direction toward the light
with radiance L and the world-size shadow ray. A projection light is a
point light whose intensity is its image seen through a perspective frustum
along the light's +z (projection.cpp), zero outside the frustum; a
goniometric light is a point light whose intensity is scaled by its
lat-long image at the light-space direction (goniometric.cpp, with the
reference's axes: no y/z swap, ROADMAP C). The static `present_types`
branching is kept. `light_power` is the power that the `power` light
strategy samples lights by (a projection or goniometric light counts as a
point light, as in the reference).
"""
from __future__ import annotations

import functools
import operator

import torch

from .. import telemetry
from ..core.vecmath import (PI, TWO_PI, cross, dot, length_sq, normalize,
                            spherical_direction, spherical_phi, spherical_theta)
from ..core import montecarlo as mc
from ..core import transform as tr
from ..core.spectrum import luminance
from .textures import image_bilinear

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


def _spot_falloff(lights, li, w_world):
    """SpotLight::Falloff (spot.cpp): 1 inside the falloff cone, 0 outside
    the total cone, delta^4 between."""
    wl = tr.xform_v(lights["w2l"][li], w_world)
    costheta = wl[..., 2] / torch.clamp_min(torch.sqrt(length_sq(wl)), 1e-12)
    cos_total = lights["cos_total"][li]
    cos_fall = lights["cos_falloff"][li]
    delta = torch.clamp((costheta - cos_total)
                        / torch.clamp_min(cos_fall - cos_total, 1e-6), 0.0, 1.0)
    d2 = delta * delta
    return torch.where(costheta < cos_total, 0.0,
                       torch.where(costheta > cos_fall, 1.0, d2 * d2))


def _projection_factor(lights, li, w_world, images, light_image_rows):
    """ProjectionLight::Projection (projection.cpp): the light-space direction
    through the light's perspective matrix onto its screen window; outside
    the frustum 0, inside the image bilinearly or, for a light with no image,
    1 (as pbrt: the reference crashes there, ROADMAP C.2)."""
    wl = tr.xform_v(lights["w2l"][li], w_world)
    behind = wl[..., 2] < lights["proj_hither"][li]
    pw = tr.xform_p(lights["proj"][li], wl)
    scr = lights["screen"][li]
    s = (pw[..., 0] - scr[:, 0]) / (scr[:, 1] - scr[:, 0])
    t = (pw[..., 1] - scr[:, 2]) / (scr[:, 3] - scr[:, 2])
    inside = (~behind) & (s >= 0) & (s <= 1) & (t >= 0) & (t <= 1)
    val = w_world.new_ones(w_world.shape)
    for row, img in light_image_rows:
        m = lights["image_row"][li] == row
        val = torch.where(m[..., None], image_bilinear(images[img], s, t), val)
    return torch.where(inside[..., None], val, 0.0)


def _gonio_factor(lights, li, w_world, images, light_image_rows):
    """GonioPhotometricLight::Scale (goniometric.cpp): the light's lat-long
    image at the light-space direction; 1 for a light with no image."""
    val = w_world.new_ones(w_world.shape)
    if not light_image_rows:
        return val
    wl = normalize(tr.xform_v(lights["w2l"][li], w_world))
    s = spherical_phi(wl) / TWO_PI
    t = spherical_theta(wl) / PI
    for row, img in light_image_rows:
        m = lights["image_row"][li] == row
        val = torch.where(m[..., None], image_bilinear(images[img], s, t), val)
    return val


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


@telemetry.spanned("sample_li")
def sample_li(scene, li, p, u1, u2, u3, present_types, light_image_rows=()):
    """Light::Sample_L(p) masked over the present light types.

    li (N,) light row per shade point; (u1, u2) 2D sample; u3 picks the area
    light's triangle; light_image_rows: SceneMeta.light_image_rows, the
    (light row, image id) of each projection or goniometric light's map.
    Returns dict: wi (N,3), radiance (N,3), pdf (N,), dist (N,) shadow-ray
    length, delta (N,) bool."""
    lights = scene["lights"]
    lt = lights["type"][li]
    n = p.shape[0]
    wi = p.new_zeros((n, 3))
    radiance = p.new_zeros((n, 3))
    pdf = p.new_zeros((n,))
    dist = p.new_full((n,), WORLD_BIG)
    emit = lights["emit"][li]

    positional = {POINT, SPOT, PROJECTION, GONIOMETRIC} & set(present_types)
    if positional:
        vec = lights["l2w"][:, :3, 3][li] - p
        d2 = torch.clamp_min(length_sq(vec), 1e-20)
        dd = torch.sqrt(d2)
        wi_p = vec / dd[..., None]
        base = emit / d2[..., None]
        images = scene.get("images", ())
        if SPOT in positional:
            fall = _spot_falloff(lights, li, -wi_p)
            base = torch.where((lt == SPOT)[..., None], base * fall[..., None], base)
        if PROJECTION in positional:
            proj = _projection_factor(lights, li, -wi_p, images, light_image_rows)
            base = torch.where((lt == PROJECTION)[..., None], base * proj, base)
        if GONIOMETRIC in positional:
            gon = _gonio_factor(lights, li, -wi_p, images, light_image_rows)
            base = torch.where((lt == GONIOMETRIC)[..., None], base * gon, base)
        m = functools.reduce(operator.or_, (lt == t for t in sorted(positional)))
        wi = torch.where(m[..., None], wi_p, wi)
        radiance = torch.where(m[..., None], base, radiance)
        pdf = torch.where(m, 1.0, pdf)
        dist = torch.where(m, dd, dist)

    if DISTANT in present_types:
        m = lt == DISTANT           # world_dir points toward the light
        wi = torch.where(m[..., None], lights["world_dir"][li], wi)
        radiance = torch.where(m[..., None], emit, radiance)
        pdf = torch.where(m, 1.0, pdf)

    if AREA in present_types:
        wi_a, _, cos_l, pdf_a, dist_a = _area_sample(scene, li, p, u1, u2, u3)
        rad_a = torch.where((cos_l > 0.0)[..., None], emit, 0.0)
        m = lt == AREA
        wi = torch.where(m[..., None], wi_a, wi)
        radiance = torch.where(m[..., None], rad_a, radiance)
        pdf = torch.where(m, pdf_a, pdf)
        dist = torch.where(m, dist_a * (1.0 - 1e-3), dist)

    if INFINITE in present_types:
        u, v, map_pdf = mc.sample_distribution_2d(scene["env_dist"], u1, u2)
        theta = v * PI
        phi = u * TWO_PI
        sintheta = torch.sin(theta)
        wl = spherical_direction(sintheta, torch.cos(theta), phi)
        wi_e = tr.xform_v(lights["l2w"][li], wl)
        pdf_e = map_pdf / torch.clamp_min(2.0 * PI * PI * sintheta, 1e-9)
        m = lt == INFINITE
        wi = torch.where(m[..., None], wi_e, wi)
        radiance = torch.where(m[..., None], env_radiance(scene, li, wi_e), radiance)
        pdf = torch.where(m, pdf_e, pdf)

    return {"wi": wi, "radiance": radiance, "pdf": pdf, "dist": dist,
            "delta": is_delta(lt)}


def env_radiance(scene, li, w_world):
    """InfiniteAreaLight::Le for directions: a lat-long map lookup."""
    lights = scene["lights"]
    wl = normalize(tr.xform_v(lights["w2l"][li], w_world))
    s = spherical_phi(wl) / TWO_PI
    t = spherical_theta(wl) / PI
    emit = lights["emit"][li]
    if scene.get("env_map") is None:
        return emit
    return emit * image_bilinear(scene["env_map"], s, t)


@telemetry.spanned("environment")
def escaped_radiance(scene, d, present_types):
    """Sum of the lights' Le for escaped rays (pbrt Light::Le)."""
    if INFINITE not in present_types:
        return d.new_zeros(d.shape)
    li = scene["env_row"].expand(d.shape[0])
    return env_radiance(scene, li, d)


@telemetry.spanned("environment")
def env_pdf(scene, li, w_world):
    """InfiniteAreaLight::Pdf(p, wi): map pdf over the lat-long Jacobian."""
    wl = normalize(tr.xform_v(scene["lights"]["w2l"][li], w_world))
    theta = spherical_theta(wl)
    phi = spherical_phi(wl)
    sintheta = torch.clamp_min(torch.sin(theta), 1e-6)
    p2 = mc.distribution_2d_pdf(scene["env_dist"], phi / TWO_PI, theta / PI)
    return p2 / (2.0 * PI * PI * sintheta)


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


def light_power(lights, world_radius):
    """Approximate emitted power per light (pbrt Light::Power): the weights
    of the power-weighted light distribution (ComputeLightSamplingCDF).
    lights: the scene's light table; world_radius: the scene's bounding
    sphere's radius (distant and infinite lights)."""
    lt = lights["type"]
    emit_y = luminance(lights["emit"])
    p_point = 4.0 * PI * emit_y
    p_spot = emit_y * 2.0 * PI * (1.0 - 0.5 * (lights["cos_falloff"]
                                               + lights["cos_total"]))
    p_dist = emit_y * PI * world_radius * world_radius
    p_area = emit_y * lights["area"] * PI
    power = torch.where(lt == SPOT, p_spot,
                        torch.where((lt == DISTANT) | (lt == INFINITE), p_dist,
                                    torch.where(lt == AREA, p_area, p_point)))
    return torch.clamp_min(power, 1e-9)
