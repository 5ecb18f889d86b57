"""Instant global illumination (port of grail/engine/igi.py; pbrt
src/integrators/igi.{h,cpp}) as the reference's two-phase wavefront
program.

generate_vpls shoots one set of n_paths light paths (a light picked by
power, an emission point and direction sampled from it, BSDF-sampled
continuations with Russian roulette) and keeps a virtual point light
{p, n, contrib} at each non-specular hit, in fixed-capacity arrays with a
validity mask (depth-major, igi_max_depth slots a path); its closest hits
are "vpl_path" waves. A VPL's contrib is pbrt's, the path's throughput
alpha times rho/pi at the VPL (rho the diffuse lobes' reflectance, the
reference's own analog of bsdf->rho); the reference keeps alpha alone,
which makes each VPL pi/rho times too bright (ROADMAP C.13), and keeps it
as "alpha" here. vpl_radiance sums f(wo, wi) G contrib over every slot
of the set, G clamped to igi_g_limit, each behind a visibility ray of the
full wave's width (a "vpl_shadow" wave, any hit, a dead lane for an empty
slot), as the reference's fori_loop does. The visibility ray stops 2
ray_eps short of the VPL, as a light's shadow ray stops short of the light;
the reference's stops at 0.999 of the distance from an origin already
moved ray_eps toward the VPL, so it reaches the VPL's own surface wherever
the VPL is nearer than 1,000 ray_eps and drops most of the indirect light
(ROADMAP C.12). The glossy re-trace of igi.cpp is
folded into the clamp, as in the reference. integrator.li draws one set a
wave (the wave's first lane's sample index modulo igi_n_sets) and adds
vpl_radiance at every bounce, after the emission and before direct
lighting.

_light_emission_sample is Light::Sample_L(scene): photon shooting
(engine/photonmap.py) shares it. The distant and infinite lights shoot from
a disk of the world radius about the origin (the reference's scene carries
no world centre).
"""
from __future__ import annotations

import torch

from .. import telemetry
from ..core import montecarlo as mc
from ..core import rng as rngmod
from ..core import transform as tr
from ..core.spectrum import luminance
from ..core.vecmath import PI, absdot, coordinate_system, cross, dot, length_sq, normalize
from ..shade import bsdf as bx
from ..shade import geometry as geom
from ..shade import lights as lt
from ..shade import materials as mtl
from ..shade.textures import eval_textures
from . import integrator as integ

_VPL_DIM_BASE = 50000
VPL_BATCH = 16       # VPLs shaded together in vpl_radiance


def _light_emission_sample(scene, meta, li, u1, u2, u3, u4):
    """Light::Sample_L(scene): an emission point and direction of light li
    for each lane. Area lights: a uniform point on the light's triangles
    and a cosine direction about their normal; point and spot lights: the
    light's position and a uniform (sphere or cone) direction;
    distant and infinite lights: a disk at the world boundary shooting
    inward. Returns (p, dir, alpha = L/pdf)."""
    lights = scene["lights"]
    ltype = lights["type"][li]
    n = li.shape[0]
    emit = lights["emit"][li]
    wr = scene["world_radius"]
    dev = emit.device
    p = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    d = torch.zeros_like(p)
    alpha = torch.zeros_like(p)

    def put(mask, p_c, d_c, a_c):
        nonlocal p, d, alpha
        p = torch.where(mask[..., None], p_c, p)
        d = torch.where(mask[..., None], d_c, d)
        alpha = torch.where(mask[..., None], a_c, alpha)

    types = meta.light_types
    if lt.POINT in types or lt.SPOT in types:
        lpos = lights["l2w"][li, :3, 3]
        if lt.POINT in types:
            put(ltype == lt.POINT, lpos, mc.uniform_sample_sphere(u3, u4),
                emit / mc.uniform_sphere_pdf())
        if lt.SPOT in types:
            cos_total = lights["cos_total"][li]
            wl = mc.uniform_sample_cone(u3, u4, cos_total)
            fall = torch.clamp((wl[..., 2] - cos_total)
                               / torch.clamp_min(lights["cos_falloff"][li] - cos_total,
                                                 1e-6), 0.0, 1.0) ** 4
            pdf_cone = mc.uniform_cone_pdf(cos_total)
            put(ltype == lt.SPOT, lpos, tr.xform_v(lights["l2w"][li], wl),
                emit * (fall / torch.clamp_min(pdf_cone, 1e-9))[..., None])

    if lt.AREA in types:
        # the reference gathers the triangle through the mesh; the light
        # table's pre-gathered rows hold the same values
        cnt = torch.sum((lights["acdf"][li][..., 1:-1] <= u3[..., None]).to(torch.int64),
                        dim=-1)
        slot = torch.clamp(cnt, 0, lights["acdf"].shape[-1] - 2)
        flat = li.to(torch.int64) * lights["av0"].shape[1] + slot
        v0 = lights["av0"].reshape(-1, 3)[flat]
        v1 = lights["av1"].reshape(-1, 3)[flat]
        v2 = lights["av2"].reshape(-1, 3)[flat]
        b0, b1 = mc.uniform_sample_triangle(u1, u2)
        pl = b0[..., None] * v0 + b1[..., None] * v1 + (1.0 - b0 - b1)[..., None] * v2
        nl = normalize(cross(v1 - v0, v2 - v0))
        nl = torch.where((lights["aflip"].reshape(-1)[flat] != 0)[..., None], -nl, nl)
        wl = mc.cosine_sample_hemisphere(u4, torch.remainder(u3 * 7919.0, 1.0))
        s1, s2 = coordinate_system(nl)
        wd = wl[..., 0:1] * s1 + wl[..., 1:2] * s2 + wl[..., 2:3] * nl
        put(ltype == lt.AREA, pl + nl * 1e-4, wd,
            emit * (lights["area"][li] * PI)[..., None])

    if lt.DISTANT in types or lt.INFINITE in types:
        dx, dy = mc.concentric_sample_disk(u1, u2)
        wdir = torch.where((ltype == lt.DISTANT)[..., None], -lights["world_dir"][li],
                           -mc.uniform_sample_sphere(u3, u4))
        v1b, v2b = coordinate_system(wdir)
        pdisk = wr * (dx[..., None] * v1b + dy[..., None] * v2b) - wr * wdir
        put((ltype == lt.DISTANT) | (ltype == lt.INFINITE), pdisk, wdir,
            emit * (PI * wr * wr))
    return p, d, alpha


def light_paths_start(scene, meta, pix, samp, dim_base, n_paths):
    """The first segment of n_paths light paths: a light picked by power,
    its emission sample, alpha divided by the pick's pmf and n_paths.
    Returns (o, d, alpha)."""
    u_pick = rngmod.sample_1d(meta.sampler, pix, samp, dim_base)
    li, pmf = mc.sample_distribution_1d_discrete(scene["light_power_dist"], u_pick)
    us = [rngmod.sample_1d(meta.sampler, pix, samp, dim_base + 1 + k) for k in range(4)]
    p0, d0, alpha = _light_emission_sample(scene, meta, li.to(torch.int32), *us)
    alpha = alpha / torch.clamp_min(pmf, 1e-9)[..., None] / n_paths
    return p0 + d0 * 1e-4, d0, alpha


def light_path_vertex(scene, meta, o, d, active, role):
    """One closest-hit wave of light paths and the shading at its hits, as
    the reference shades them (no bump, image textures read bilinearly).
    Returns (live, sg, lobes, wo_local)."""
    hit = integ._trace(scene, o, d, torch.where(active, integ.BIG, 0.0), role=role)
    live = active & (hit["prim"] >= 0)
    sg = geom.shading_geometry(scene, hit, o, d)
    tex_values = eval_textures(meta.tex_specs, scene["tex_data"], sg, scene.get("images", ()))
    lobes = mtl.gather_lobes(scene, sg, tex_values)
    return live, sg, lobes, geom.world_to_local(sg, -d)


def light_path_continue(meta, pix, samp, dim, sg, lobes, wo_l, throughput):
    """The BSDF-sampled continuation of a light path with Russian roulette
    on the throughput's luminance ratio (igi.cpp Preprocess), draws at
    dimensions dim .. dim+3. Returns (bs, wi_w, throughput, survive)."""
    u1 = rngmod.sample_1d(meta.sampler, pix, samp, dim)
    u2 = rngmod.sample_1d(meta.sampler, pix, samp, dim + 1)
    uc = rngmod.sample_1d(meta.sampler, pix, samp, dim + 2)
    bs = bx.bsdf_sample(lobes, wo_l, u1, u2, uc, meta.lobe_types, True)
    wi_w = geom.local_to_world(sg, bs["wi"])
    contrib = bs["f"] * (absdot(wi_w, sg["ns"])
                         / torch.clamp_min(bs["pdf"], 1e-9))[..., None]
    new_tp = throughput * contrib
    q = torch.clamp_max(luminance(new_tp) / torch.clamp_min(luminance(throughput), 1e-9),
                        1.0)
    survive = rngmod.sample_1d(meta.sampler, pix, samp, dim + 3) < q
    return bs, wi_w, new_tp / torch.clamp_min(q, 1e-6)[..., None], survive


@telemetry.spanned("vpl")
def generate_vpls(scene, meta, cfg, set_idx):
    """One VPL set: igi_n_paths x igi_max_depth candidate lights (depth-major)
    as {p, n, contrib, alpha, valid}."""
    n_paths = cfg.igi_n_paths
    device = scene["verts"].device
    pix = torch.full((n_paths,), 0x9e37 + int(set_idx), dtype=torch.int64, device=device)
    samp = torch.arange(n_paths, dtype=torch.int64, device=device)
    o, d, alpha = light_paths_start(scene, meta, pix, samp, _VPL_DIM_BASE, n_paths)
    active = torch.any(alpha > 0, dim=-1)
    throughput = alpha
    vpl_p, vpl_n, vpl_a, vpl_rho, vpl_ok = [], [], [], [], []
    for depth in range(cfg.igi_max_depth):
        live, sg, lobes, wo_l = light_path_vertex(scene, meta, o, d, active, "vpl_path")
        dep = live & (bx.bsdf_num_components(lobes, include_specular=False) > 0)
        vpl_p.append(sg["p"])
        vpl_n.append(torch.where((dot(sg["ns"], -d) < 0)[..., None], -sg["ns"], sg["ns"]))
        vpl_a.append(torch.where(dep[..., None], throughput, 0.0))
        vpl_rho.append(bx.diffuse_albedo(lobes))
        vpl_ok.append(dep)
        bs, wi_w, throughput, survive = light_path_continue(
            meta, pix, samp, _VPL_DIM_BASE + 10 + depth * 4, sg, lobes, wo_l, throughput)
        active = live & bs["valid"] & survive
        o = sg["p"] + wi_w * sg["ray_eps"][..., None]
        d = wi_w
    alpha = torch.cat(vpl_a)
    return {"p": torch.cat(vpl_p), "n": torch.cat(vpl_n),
            "contrib": alpha * torch.cat(vpl_rho) / PI, "alpha": alpha,
            "valid": torch.cat(vpl_ok)}


@telemetry.spanned("vpl")
def vpl_radiance(scene, meta, cfg, sg, lobes, wo_local, vpls, active):
    """The sum over the set's VPLs of f G contrib, G clamped to igi_g_limit,
    each behind a "vpl_shadow" visibility wave of the full width (igi.cpp
    Li). The live lanes of VPL_BATCH VPLs are shaded together; the waves
    are traced and the terms added one VPL at a time, in the set's order
    (a dead lane's ray is inert and its term zero)."""
    n = sg["p"].shape[0]
    eps = sg["ray_eps"]
    lanes = torch.nonzero(active).squeeze(1)
    p, ns = sg["p"][lanes], sg["ns"][lanes]
    L = sg["p"].new_zeros(sg["p"].shape)
    for v0 in range(0, vpls["p"].shape[0], VPL_BATCH):
        vp = {k: x[v0:v0 + VPL_BATCH] for k, x in vpls.items()}
        m = vp["p"].shape[0]
        vec = vp["p"][None] - p[:, None]                           # (lanes, m, 3)
        d2 = torch.clamp_min(length_sq(vec), 1e-12)
        wi = vec * torch.rsqrt(d2)[..., None]
        G = torch.clamp_max(absdot(wi, ns[:, None]) * absdot(wi, vp["n"][None]) / d2,
                            cfg.igi_g_limit)
        frame = {k: sg[k][lanes].repeat_interleave(m, dim=0) for k in ("ss", "ts", "ns")}
        f = bx.bsdf_f({k: x[lanes].repeat_interleave(m, dim=0) for k, x in lobes.items()},
                      wo_local[lanes].repeat_interleave(m, dim=0),
                      geom.world_to_local(frame, wi.reshape(-1, 3)), meta.lobe_types,
                      include_specular=False).reshape(-1, m, 3)
        can = vp["valid"][None] & (G > 0) & torch.any(f > 0, dim=-1)
        # the full width again: dead lanes get no direction, no length, no term
        wi_all = sg["p"].new_zeros((n, m, 3)).index_put_((lanes,), wi)
        tmax = sg["p"].new_zeros((n, m)).index_put_(
            (lanes,), torch.where(can, torch.sqrt(d2) - 2.0 * eps[lanes, None], 0.0))
        can_all = torch.zeros((n, m), dtype=torch.bool, device=p.device).index_put_(
            (lanes,), can)
        term = sg["p"].new_zeros((n, m, 3)).index_put_(
            (lanes,), f * vp["contrib"][None] * G[..., None])
        for k in range(m):
            occ = integ._trace(scene, sg["p"] + wi_all[:, k] * eps[..., None], wi_all[:, k],
                               tmax[:, k], any_hit=True, role="vpl_shadow")
            L = L + torch.where((can_all[:, k] & ~occ)[..., None], term[:, k], 0.0)
    return L
