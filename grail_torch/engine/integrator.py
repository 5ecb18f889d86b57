"""Path integrator as a masked wavefront loop (port of grail/engine/integrator.py
for kind="path" with the uniform one-light strategy).

Each bounce is one stage over the whole ray batch with an `active` mask:
intersect -> environment escape -> shade (texture eval + lobe gather) ->
direct lighting (light branch; the continuation ray doubles as the MIS-BSDF
strategy, "path-vertex reuse") -> sample the continuation -> Russian
roulette. Bounce 0 is peeled, as in the reference: only it reads the camera
differentials (texture filtering) and its camera wave skips ray binning.
Survivors are repacked into narrower waves at static split points
(multi-split compaction), exactly as the reference does. The bounce loop is
a Python loop; the reference's `lax.cond` on the survivor count is a Python
`if` on the count read back from the device. On a scene with instances the
camera rays' time rides along with every lane (secondary and shadow rays
keep their camera ray's time), to pick the animated instance transforms;
elsewhere no stage reads it and it is not carried.

Not ported yet: the other integrator kinds, light_strategy "power"/"all",
alpha cutouts, bump mapping, media and material-sorted shading.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.vecmath import absdot, dot
from ..core import rng as rngmod
from ..core import montecarlo as mc
from ..core.spectrum import luminance
from ..kernels import intersect as isect
from ..shade import bsdf as bx
from ..shade import lights as lt
from ..shade import geometry as geom
from ..shade import materials as mtl
from ..shade.textures import eval_textures

BIG = 1.0e7

# sampler dimension slots (static layout, as the reference)
SLOT_FILM = 0
SLOT_LENS = 1
SLOT_TIME = 2
_BOUNCE_BASE = 4
_BOUNCE_STRIDE = 8
_D_LIGHT_SEL = 0
_D_LIGHT_POS = 1   # 2D
_D_LIGHT_TRI = 2
_D_BSDF_COMP = 3
_D_BSDF_DIR = 4    # 2D
_D_RR = 5
_D_MIS_COMP = 6
_D_MIS_DIR = 7     # 2D


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    """The fields kind="path" reads (names and defaults as the reference)."""
    kind: str = "path"
    max_depth: int = 5
    rr_depth: int = 3             # Russian roulette after this many bounces
    # wavefront compaction: after the first Russian-roulette bounce, repack
    # surviving lanes into a compact_frac-width wave (a wave whose survivors
    # exceed the capacity stays at full width, so the estimator is exact)
    compact: bool = True
    compact_frac: float = 0.25
    compact_min: int = 8192       # lane count below which compaction is skipped
    light_strategy: str = "one"


def _bdim(bounce, off):
    return _BOUNCE_BASE + bounce * _BOUNCE_STRIDE + off


def _sample_1d(meta, pix, samp, bounce, off):
    """A bounce slot's 1D draw. The reference peels bounce 0 with a concrete
    index and runs later bounces inside lax.fori_loop, where the dimension is
    traced and the HALTON sampler takes base 2 for it (rng.sample_1d)."""
    return rngmod.sample_1d(meta.sampler, pix, samp, _bdim(bounce, off),
                            traced=bounce > 0)


def scene_intersect(scene, meta, o, d, tmax, sort=None, time=None):
    """Scene::Intersect (no alpha cutouts in the ported scenes). sort: the
    ray-binning hint (False for camera waves, already in tile order); time:
    the rays' times (animated instances)."""
    return isect.intersect(scene, o, d, tmax, device=o.device, sort=sort, time=time)


def scene_intersect_p(scene, meta, o, d, tmax, time=None):
    """Scene::IntersectP."""
    return isect.intersect_p(scene, o, d, tmax, device=o.device, time=time)


def _shade_context(scene, meta, hit, o, d, camdiff=None, time=None):
    """Post-hit work: shading geometry (with uv screen derivatives from the
    camera differential rays when given), textures, lobes, local wo."""
    sg = geom.shading_geometry(scene, hit, o, d, time=time)
    if camdiff is not None:
        sg["duvdx"], sg["duvdy"] = geom.uv_differentials(sg, *camdiff)
    tex_values = eval_textures(meta.tex_specs, scene["tex_data"], sg,
                               scene.get("images", ()), scene.get("mipmaps", ()))
    lobes = mtl.gather_lobes(scene, sg, tex_values)
    wo_local = geom.world_to_local(sg, -d)
    return sg, lobes, wo_local


def _detach(x):
    """The reference's stop-gradient on what divides the estimator or decides
    a path (sampling pdfs, the light pmf, the partner pdf of MIS, Russian
    roulette): the gradient is that of the estimator with the samples held
    fixed."""
    return x.detach()


def estimate_direct(scene, meta, sg, lobes, wo_local, light_idx, light_pmf,
                    u_light, u_tri, active, time=None):
    """One-light direct lighting, light-sampling branch with the power
    heuristic against the BSDF pdf (pbrt EstimateDirect part 1). The BSDF
    branch is the next bounce's continuation ray (path-vertex reuse), which
    is the only form kind="path" runs. Returns Ld (N,3) / light_pmf."""
    present = meta.lobe_types
    p = sg["p"]
    eps = sg["ray_eps"]
    ls = lt.sample_li(scene, light_idx, p, u_light[0], u_light[1], u_tri,
                      meta.light_types)
    wi_l = geom.world_to_local(sg, ls["wi"])
    f_l = bx.bsdf_f(lobes, wo_local, wi_l, present, include_specular=False)
    cos_l = absdot(ls["wi"], sg["ns"])
    contrib_possible = (active & (ls["pdf"] > 0.0) & (cos_l > 0.0)
                        & torch.any(ls["radiance"] > 0.0, dim=-1)
                        & torch.any(f_l > 0.0, dim=-1))
    occluded = scene_intersect_p(
        scene, meta, p + ls["wi"] * eps[..., None], ls["wi"],
        torch.where(contrib_possible, ls["dist"] - 2.0 * eps, 0.0), time=time)
    bsdf_pdf_l = bx.bsdf_pdf(lobes, wo_local, wi_l, present, include_specular=False)
    w_l = torch.where(ls["delta"], 1.0,
                      mc.power_heuristic(1.0, ls["pdf"], 1.0, bsdf_pdf_l))
    Ld = torch.where(
        (contrib_possible & ~occluded)[..., None],
        f_l * ls["radiance"]
        * (cos_l * w_l / _detach(torch.clamp_min(ls["pdf"], 1e-12)))[..., None],
        0.0)
    return Ld / _detach(torch.clamp_min(light_pmf, 1e-12))[..., None]


def _pick_light(meta, pix, samp, bounce):
    """UniformSampleOneLight light choice."""
    n_lights = meta.n_lights
    u = _sample_1d(meta, pix, samp, bounce, _D_LIGHT_SEL)
    idx = torch.clamp_max((u * n_lights).to(torch.int32), n_lights - 1)
    pmf = torch.full(u.shape, 1.0 / n_lights, dtype=torch.float32, device=u.device)
    return idx, pmf


def _make_bounce_body(scene, meta, cfg, pix, samp, camdiff=None, time=None):
    """The per-bounce stage over the lanes of `pix`/`samp` (the compacted
    tail instantiates it again at a narrower width). camdiff: the camera
    differential rays, passed to the peeled bounce 0 only; time: the lanes'
    ray times, or None."""

    def bounce_body(bounce, state):
        o, d, L, throughput, active, spec_bounce, pdf_prev = state
        # the camera wave arrives in tile order: no ray binning for it
        hit = scene_intersect(scene, meta, o, d, torch.where(active, BIG, 0.0),
                              sort=False if bounce == 0 else None, time=time)
        miss = hit["prim"] < 0
        # escaped rays take the environment's radiance: camera and specular
        # rays unweighted, other continuations MIS-weighted against the
        # light strategy's env pdf (path-vertex reuse)
        if lt.INFINITE in meta.light_types:
            env_row = scene["env_row"].expand(o.shape[0])
            w_env = torch.where(spec_bounce, 1.0, mc.power_heuristic(
                1.0, pdf_prev, 1.0, lt.env_pdf(scene, env_row, d)))
            L = L + torch.where((active & miss)[..., None],
                                throughput * w_env[..., None]
                                * lt.escaped_radiance(scene, d, meta.light_types),
                                0.0)
        active = active & ~miss

        sg, lobes, wo_local = _shade_context(scene, meta, hit, o, d, camdiff, time)

        # emitted at hit: camera/specular vertices unweighted, other vertices
        # MIS-weighted by the light strategy's per-point pdf at this hit
        if lt.AREA in meta.light_types:
            cos_at = dot(sg["ng"], -d)
            on_light = sg["light"] >= 0
            # the pdf is read on light hits only; elsewhere t may be the miss
            # sentinel, whose square overflows and would turn the gradient
            # into NaN (the reference's fault, ROADMAP C.4)
            lp = lt.area_light_pdf_dir(scene, torch.clamp_min(sg["light"], 0), o, d,
                                       torch.where(on_light, hit["t"], 0.0), cos_at)
            w_em = torch.where(spec_bounce | ~on_light, 1.0,
                               mc.power_heuristic(1.0, pdf_prev, 1.0, lp))
            L = L + torch.where(active[..., None],
                                throughput * w_em[..., None]
                                * lt.area_light_emitted(scene, sg, -d), 0.0)

        if meta.n_lights > 0:
            lidx, pmf = _pick_light(meta, pix, samp, bounce)
            Ld = estimate_direct(
                scene, meta, sg, lobes, wo_local, lidx, pmf,
                rngmod.sample_2d(meta.sampler, pix, samp, _bdim(bounce, _D_LIGHT_POS)),
                _sample_1d(meta, pix, samp, bounce, _D_LIGHT_TRI),
                active, time)
            L = L + torch.where(active[..., None], throughput * Ld, 0.0)

        # continuation: sample the BSDF (dead work on the final bounce, as in
        # the reference, whose loop exits before the next intersect)
        u_dir = rngmod.sample_2d(meta.sampler, pix, samp, _bdim(bounce, _D_BSDF_DIR))
        u_comp = _sample_1d(meta, pix, samp, bounce, _D_BSDF_COMP)
        bs = bx.bsdf_sample(lobes, wo_local, u_dir[0], u_dir[1], u_comp,
                            meta.lobe_types, include_specular=True)
        wi_w = geom.local_to_world(sg, bs["wi"])
        cos_c = absdot(wi_w, sg["ns"])
        contrib = bs["f"] * (cos_c
                             / _detach(torch.clamp_min(bs["pdf"], 1e-12)))[..., None]
        cont_ok = bs["valid"] & torch.any(bs["f"] != 0.0, dim=-1)
        throughput = torch.where(cont_ok[..., None], throughput * contrib, throughput)
        active = active & cont_ok
        spec_bounce = bs["specular"]
        # the light strategy's partner pdf for the next hit's emission
        pdf_prev = torch.where(
            bs["specular"], 0.0,
            _detach(bx.bsdf_pdf(lobes, wo_local, geom.world_to_local(sg, wi_w),
                                meta.lobe_types, include_specular=False)))

        # Russian roulette (path.cpp: after rr_depth bounces)
        if bounce >= cfg.rr_depth:
            q = torch.clamp_max(luminance(_detach(throughput)), 0.5)
        else:
            q = torch.ones_like(pdf_prev)
        u_rr = _sample_1d(meta, pix, samp, bounce, _D_RR)
        active = active & (u_rr < q)
        throughput = throughput / _detach(torch.clamp_min(q, 1e-6))[..., None]

        o = sg["p"] + wi_w * sg["ray_eps"][..., None]
        return (o, wi_w, L, throughput, active, spec_bounce, pdf_prev)

    return bounce_body


def _compaction_take(active, cap):
    """Indices of the first `cap` active lanes, in lane order (stable
    compaction): one cumsum and a binary search. Entries past the live count
    are n (out of range). Returns (take, count)."""
    csum = torch.cumsum(active.to(torch.int32), dim=0)        # int64
    targets = torch.arange(1, cap + 1, dtype=csum.dtype, device=csum.device)
    take = torch.searchsorted(csum, targets, side="left")
    return take, csum[-1]


def li(scene, meta, cfg: IntegratorConfig, rays, pix, samp):
    """Radiance for a batch of camera rays: the wavefront bounce loop.
    rays: dict from camera.generate_rays; pix, samp: sampler coordinates.
    Returns L (N,3)."""
    if cfg.kind != "path":
        raise NotImplementedError(f"integrator kind {cfg.kind!r} is not ported "
                                  "yet (path only)")
    if cfg.light_strategy != "one":
        raise NotImplementedError(f"light_strategy {cfg.light_strategy!r} is not "
                                  "ported yet (one only)")
    o, d = rays["o"], rays["d"]
    n = o.shape[0]
    max_depth = cfg.max_depth
    L = torch.zeros_like(o)
    throughput = torch.ones_like(o)
    active = torch.ones(n, dtype=torch.bool, device=o.device)
    spec_bounce = active                       # bounce-0 emission counts
    pdf_prev = torch.ones(n, dtype=torch.float32, device=o.device)
    state = (o, d, L, throughput, active, spec_bounce, pdf_prev)
    # only instances read the time (a moving camera has used it already)
    time = rays.get("time") if scene.get("inst") is not None else None
    state = _make_bounce_body(scene, meta, cfg, pix, samp,
                              rays.get("camdiff"), time)(0, state)

    # multi-split compaction: the tail repacks survivors at static split
    # points, each with an overflow guard (a wave whose live count exceeds a
    # split's capacity skips it). The pre-RR split at bounce 2 runs for
    # scenes with a BVH (the reference's stream-route scenes: open scenes
    # whose wavefront goes dark early), the post-RR split for every scene.
    k = min(cfg.rr_depth + 1, max_depth + 1)
    splits = []
    if cfg.compact and n >= cfg.compact_min:
        if k > 2 and max_depth + 1 > 2 and scene.get("bvh") is not None:
            early = (int(n * min(0.5, 4.0 * cfg.compact_frac)) // 1024) * 1024
            if early >= 1024:
                splits.append((2, early))
        if k < max_depth + 1:
            cap = (int(n * cfg.compact_frac) // 1024) * 1024
            if cap >= 1024:
                splits.append((k, cap))

    def tail(st, pix_t, samp_t, time_t, width, from_b, splits):
        bodyw = _make_bounce_body(scene, meta, cfg, pix_t, samp_t, time=time_t)

        def run(st, b0, b1):
            for b in range(b0, b1):
                st = bodyw(b, st)
            return st

        # next applicable split (its capacity must shrink the width)
        while splits and (splits[0][0] < from_b or splits[0][1] >= width):
            splits = splits[1:]
        if not splits:
            return run(st, from_b, max_depth + 1)[2]
        sb, cap = splits[0]
        st = run(st, from_b, sb)
        take, count = _compaction_take(st[4], cap)
        count = int(count)
        if count > cap:
            return tail(st, pix_t, samp_t, time_t, width, sb, splits[1:])
        gidx = torch.clamp_max(take, width - 1)
        live = torch.arange(cap, device=take.device) < count
        sub = tuple(a[gidx] for a in st)
        sub = sub[:4] + (sub[4] & live,) + sub[5:]
        subL = tail(sub, pix_t[gidx], samp_t[gidx],
                    None if time_t is None else time_t[gidx], cap, sb, splits[1:])
        # only the first `count` take entries name live lanes; the rest would
        # fall outside the wave (the reference drops them in its scatter).
        # Out of place, so gradients reach both waves.
        return st[2].index_put((take[:count],), subL[:count])

    L = tail(state, pix, samp, time, n, 1, splits)
    return L * rays["weight"][..., None]
