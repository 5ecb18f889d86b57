"""Surface integrators as a masked wavefront loop (port of
grail/engine/integrator.py for the kinds "path", "direct", "whitted" and
"ao", with the light strategies "one", "power" and "all").

Each bounce is one stage over the whole ray batch with an `active` mask:
intersect -> environment escape -> shade (texture eval + lobe gather) ->
direct lighting -> sample the continuation -> Russian roulette (path only).
Bounce 0 is peeled, as in the reference: only it reads the camera
differentials (texture filtering) and its camera wave skips ray binning.

kind="path" takes direct lighting's BSDF strategy from its continuation ray
("path-vertex reuse": emission found at the next hit or escape is
MIS-weighted against the light strategy), and repacks survivors into
narrower waves at static split points (multi-split compaction), exactly as
the reference does; the reference's `lax.cond` on the survivor count is a
Python `if` on the count read back from the device. kind="direct"
(directlighting.cpp) runs both branches of EstimateDirect, each BSDF sample
traced by its own closest-hit wave, and kind="whitted" (whitted.cpp) samples
every light once without MIS; both follow only specular continuations, add
emission and escaped radiance only after a specular bounce, run no Russian
roulette and, like the reference, run every bounce at full width (dead lanes
get tmax = 0). kind="ao" (ambientocclusion.cpp) shoots ao_samples cosine
rays from the first hit. On a scene with instances the camera rays' time
rides along with every lane (secondary and shadow rays keep their camera
ray's time), to pick the animated instance transforms; elsewhere no stage
reads it and it is not carried. WAVES counts the waves each stage hands the
intersect dispatch, by role.

Alpha cutouts (pbrt tests the alpha texture inside Triangle::Intersect) are
the reference's wavefront form: intersect, evaluate the alpha texture at the
hit, and re-trace the lanes that landed on a zero-alpha point with tmin
pushed past the hit, ALPHA_MAX_REJECT rounds, every other lane dead; on a
scene with cutouts IntersectP is that closest-hit loop. Bump mapping
(Material::Bump) shears every shading pass's frame by the finite
differences of the displacement texture at the reference's fixed offset.

Participating media (shade/media.py) enter the shared bounce loop as the
reference's renderer does: the camera segment (bounce 0, a Python int here
where the reference takes a lax.cond) adds the volume integrator's Lv and
multiplies the throughput by its transmittance ("emission", or "single",
whose march traces a "medium" wave a step), later segments only attenuate;
estimate_direct multiplies each light sample by the transmittance to the
light. kind="dipole" (engine/subsurface.py) has its own Li, which
render.py dispatches to.

Not ported yet: the other integrator kinds (igi, photon mapping, PRT, the
irradiance cache) and material-sorted shading; they raise.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.vecmath import absdot, cross, dot, normalize
from ..core import rng as rngmod
from ..core import montecarlo as mc
from ..core.spectrum import luminance
from ..kernels import intersect as isect
from ..shade import bsdf as bx
from ..shade import lights as lt
from ..shade import geometry as geom
from ..shade import materials as mtl
from ..shade import media as med
from ..shade.textures import eval_texture_rows, eval_textures

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
_LIGHT_STRIDE = 100   # the dimension offset of each light row (strategy "all", whitted)

KINDS = ("path", "direct", "whitted", "ao")
STRATEGIES = ("one", "power", "all")
# the reference's other integrator kinds
UNPORTED_KINDS = ("igi", "photon", "diffuseprt", "glossyprt", "useprobes",
                  "irradiancecache")

# waves handed to the intersect dispatch, by role: closest hit on the camera
# wave (or AO's and the dipole's first hit), on specular or path
# continuations, and on the BSDF branch of estimate_direct; any hit on light
# shadow rays and AO occlusion rays (closest hit on a scene with alpha
# cutouts); the alpha cutouts' re-traces; any hit on the single-scattering
# march's shadow rays ("medium") and on the dipole preprocess's rays from its
# surface points to the lights ("irradiance"); Metropolis's (metropolis.py)
# closest hits on its camera and light subpaths ("mlt_camera", "mlt_light")
# and its visibility tests, any hit ("mlt_connect")
WAVES = {"camera": 0, "continuation": 0, "bsdf": 0, "shadow": 0, "occlusion": 0,
         "alpha": 0, "medium": 0, "irradiance": 0, "mlt_camera": 0, "mlt_light": 0,
         "mlt_connect": 0}
# alpha cutout re-trace rounds a wave (the reference's ALPHA_MAX_REJECT)
ALPHA_MAX_REJECT = 4
BUMP_DU = 0.01      # Material::Bump's offset: the reference's fixed fallback


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    """The fields the ported kinds read (names and defaults as the
    reference)."""
    kind: str = "path"            # path | direct | whitted | ao
    max_depth: int = 5
    rr_depth: int = 3             # Russian roulette after this many bounces
    # wavefront compaction: after the first Russian-roulette bounce, repack
    # surviving lanes into a compact_frac-width wave (a wave whose survivors
    # exceed the capacity stays at full width, so the estimator is exact)
    compact: bool = True
    compact_frac: float = 0.25
    compact_min: int = 8192       # lane count below which compaction is skipped
    light_strategy: str = "one"   # one (uniform) | power | all
    ao_samples: int = 1
    ao_maxdist: float = 1.0e7
    vol: str = "emission"         # volume integrator: emission | single
    vol_stepsize: float = 0.1     # read by nothing: the march is 32 fixed steps
    # dipole subsurface (dipolesubsurface.cpp)
    sss_npoints: int = 1024       # surface sample points (surfacepoints.cpp)
    sss_maxerror: float = 0.05    # read by nothing: the contraction is dense
    sss_sigma_a: tuple = (0.0011, 0.0024, 0.014)    # the skin1 defaults (volume.cpp)
    sss_sigma_s: tuple = (2.55, 3.21, 3.77)
    sss_eta: float = 1.3


def _bdim(bounce, off):
    return _BOUNCE_BASE + bounce * _BOUNCE_STRIDE + off


def _sample_1d(meta, pix, samp, bounce, off, lrow=0):
    """A bounce slot's 1D draw (light row lrow's, for the per-light slots).
    The reference peels bounce 0 with a concrete index and runs later
    bounces inside lax.fori_loop, where the dimension is traced and the
    HALTON sampler takes base 2 for it (rng.sample_1d)."""
    return rngmod.sample_1d(meta.sampler, pix, samp,
                            _bdim(bounce, off) + _LIGHT_STRIDE * lrow,
                            traced=bounce > 0)


def _sample_2d(meta, pix, samp, bounce, off, lrow=0):
    return rngmod.sample_2d(meta.sampler, pix, samp,
                            _bdim(bounce, off) + _LIGHT_STRIDE * lrow)


def _trace(scene, o, d, tmax, tmin=None, sort=None, time=None, any_hit=False,
           role="continuation"):
    """One wave handed to the intersect dispatch, counted in WAVES[role]:
    the hit record, or (any_hit) the occlusion bools."""
    if o.shape[0]:
        WAVES[role] += 1
    if any_hit:
        return isect.intersect_p(scene, o, d, tmax, tmin, device=o.device, time=time)
    return isect.intersect(scene, o, d, tmax, tmin, device=o.device, sort=sort,
                           time=time)


def _alpha_at(scene, meta, hit, o, d):
    """The alpha texture's value at each hit (1 for misses and triangles
    without a cutout), as the reference evaluates it: shading geometry at
    the shutter-open transforms, image rows bilinear."""
    sg = geom.shading_geometry(scene, hit, o, d)
    vals = eval_texture_rows(meta.tex_specs, scene["tex_data"], sg, meta.alpha_rows,
                             scene.get("images", ()))
    row = scene["tri_alpha"][torch.clamp_min(hit["prim"], 0)]
    a = torch.ones_like(hit["t"])
    for r in meta.alpha_rows:
        a = torch.where(row == r, vals[r][:, 0], a)
    return torch.where((hit["prim"] >= 0) & (row >= 0), a, 1.0)


def scene_intersect(scene, meta, o, d, tmax, sort=None, time=None, role="continuation"):
    """Scene::Intersect, with the alpha cutouts' re-traces where the scene
    has cutouts (meta.alpha_rows). sort: the ray-binning hint (False for
    camera waves, already in tile order); time: the rays' times (animated
    instances); role: the WAVES entry of the first wave (re-traces count as
    "alpha" and are binned as any other wave of their size)."""
    hit = _trace(scene, o, d, tmax, sort=sort, time=time, role=role)
    if not meta.alpha_rows:
        return hit
    for _ in range(ALPHA_MAX_REJECT):
        cut = (hit["prim"] >= 0) & (_alpha_at(scene, meta, hit, o, d) <= 0.0)
        # the cut lanes resume just past their hit; every other lane is dead
        t2min = torch.where(cut, hit["t"] * (1.0 + 1e-4) + 1e-5, 3.0e37)
        t2max = torch.where(cut, tmax, -3.0e37)
        hit2 = _trace(scene, o, d, t2max, t2min, time=time, role="alpha")
        hit = {k: torch.where(cut, hit2[k], hit[k]) for k in hit}
    # still on a cutout after the last round: a miss
    cut = (hit["prim"] >= 0) & (_alpha_at(scene, meta, hit, o, d) <= 0.0)
    out = dict(hit, t=torch.where(cut, isect.BIG_T, hit["t"]),
               prim=torch.where(cut, -1, hit["prim"]))
    if "inst" in out:       # no instance id on a rejected hit
        out["inst"] = torch.where(cut, -1, hit["inst"])
    return out


def scene_intersect_p(scene, meta, o, d, tmax, time=None, role="shadow"):
    """Scene::IntersectP: any hit, or the closest-hit loop of the cutouts
    where the scene has them."""
    if not meta.alpha_rows:
        return _trace(scene, o, d, tmax, time=time, any_hit=True, role=role)
    return scene_intersect(scene, meta, o, d, tmax, time=time, role=role)["prim"] >= 0


def _apply_bump(scene, meta, sg):
    """Material::Bump (material.cpp): finite differences of the displacement
    texture along dpdu and dpdv at the reference's fixed offset BUMP_DU
    (pbrt takes it from the differentials) shear the shading frame; lanes
    whose material has no bump keep theirs."""
    bump_tex = scene["materials"]["bump"][torch.clamp_min(sg["mat"], 0)]
    has = (bump_tex >= 0)[..., None]

    def displacement(sg_eval):
        vals = eval_texture_rows(meta.tex_specs, scene["tex_data"], sg_eval,
                                 meta.bump_rows, scene.get("images", ()))
        d = torch.zeros_like(sg_eval["p"][..., 0])
        for r in meta.bump_rows:
            d = torch.where(bump_tex == r, vals[r][:, 0], d)
        return d

    du = BUMP_DU
    d0 = displacement(sg)
    d_u = displacement(dict(sg, p=sg["p"] + du * sg["dpdu"],
                            uv=sg["uv"] + sg["uv"].new_tensor([du, 0.0])))
    d_v = displacement(dict(sg, p=sg["p"] + du * sg["dpdv"],
                            uv=sg["uv"] + sg["uv"].new_tensor([0.0, du])))
    dpdu_b = sg["dpdu"] + ((d_u - d0) / du)[..., None] * sg["ns"]
    dpdv_b = sg["dpdv"] + ((d_v - d0) / du)[..., None] * sg["ns"]
    ns_b = normalize(cross(dpdu_b, dpdv_b))
    # keep the orientation of the original shading normal
    ns_b = torch.where((dot(ns_b, sg["ns"]) < 0.0)[..., None], -ns_b, ns_b)
    ss_b = normalize(dpdu_b - ns_b * dot(ns_b, dpdu_b)[..., None])
    ts_b = cross(ns_b, ss_b)
    return dict(sg, ns=torch.where(has, ns_b, sg["ns"]),
                ss=torch.where(has, ss_b, sg["ss"]),
                ts=torch.where(has, ts_b, sg["ts"]))


def _shade_context(scene, meta, hit, o, d, camdiff=None, time=None):
    """Post-hit work: shading geometry (with uv screen derivatives from the
    camera differential rays when given), bump, textures, lobes, local wo."""
    sg = geom.shading_geometry(scene, hit, o, d, time=time)
    if camdiff is not None:
        sg["duvdx"], sg["duvdy"] = geom.uv_differentials(sg, *camdiff)
    if meta.bump_rows:
        sg = _apply_bump(scene, meta, sg)
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
                    u_light, u_tri, u_comp, u_dir, active, time=None,
                    bsdf_branch=True):
    """One-light direct lighting with MIS (pbrt EstimateDirect): the
    light-sampling branch with the power heuristic against the BSDF pdf,
    then, where the scene has an area or infinite light and the chosen
    light is not a delta light, the BSDF-sampling branch (a non-specular
    BSDF sample traced by a closest-hit wave, MIS-weighted against the
    chosen light's pdf in that direction). bsdf_branch=False drops the BSDF
    branch and its wave: kind="path" takes that strategy from its
    continuation ray (path-vertex reuse). Returns Ld (N,3) / light_pmf."""
    present = meta.lobe_types
    p = sg["p"]
    eps = sg["ray_eps"]
    ls = lt.sample_li(scene, light_idx, p, u_light[0], u_light[1], u_tri,
                      meta.light_types, meta.light_image_rows)
    wi_l = geom.world_to_local(sg, ls["wi"])
    tables = scene.get("brdf_tables", ())
    f_l = bx.bsdf_f(lobes, wo_local, wi_l, present, include_specular=False, tables=tables)
    cos_l = absdot(ls["wi"], sg["ns"])
    contrib_possible = (active & (ls["pdf"] > 0.0) & (cos_l > 0.0)
                        & torch.any(ls["radiance"] > 0.0, dim=-1)
                        & torch.any(f_l > 0.0, dim=-1))
    occluded = scene_intersect_p(
        scene, meta, p + ls["wi"] * eps[..., None], ls["wi"],
        torch.where(contrib_possible, ls["dist"] - 2.0 * eps, 0.0), time=time)
    radiance = ls["radiance"]
    if scene.get("media") is not None:
        # VisibilityTester::Transmittance through the media
        radiance = radiance * med.transmittance(scene, meta, p, ls["wi"], ls["dist"],
                                                torch.full_like(cos_l, 0.5))
    bsdf_pdf_l = bx.bsdf_pdf(lobes, wo_local, wi_l, present, include_specular=False)
    w_l = torch.where(ls["delta"], 1.0,
                      mc.power_heuristic(1.0, ls["pdf"], 1.0, bsdf_pdf_l))
    Ld = torch.where(
        (contrib_possible & ~occluded)[..., None],
        f_l * radiance
        * (cos_l * w_l / _detach(torch.clamp_min(ls["pdf"], 1e-12)))[..., None],
        0.0)

    if bsdf_branch and (lt.AREA in meta.light_types or lt.INFINITE in meta.light_types):
        bs = bx.bsdf_sample(lobes, wo_local, u_dir[0], u_dir[1], u_comp, present,
                            include_specular=False, tables=tables)
        wi_w = geom.local_to_world(sg, bs["wi"])
        cos_b = absdot(wi_w, sg["ns"])
        ltype = scene["lights"]["type"][light_idx]
        can = active & bs["valid"] & (bs["pdf"] > 0.0) & ~lt.is_delta(ltype)
        hit2 = scene_intersect(scene, meta, p + wi_w * eps[..., None], wi_w,
                               torch.where(can, BIG, 0.0), time=time, role="bsdf")
        light_pdf_dir = torch.zeros_like(bs["pdf"])
        Li2 = torch.zeros_like(Ld)
        hit_light = torch.zeros_like(can)
        if lt.AREA in meta.light_types:
            hg2 = geom.hit_geometric(scene, hit2)
            chosen = (hit2["prim"] >= 0) & (hg2["light"] == light_idx)
            # t is read on hits of the chosen light only; elsewhere it may be
            # the miss sentinel, whose square overflows and would turn the
            # gradient into NaN (the reference's fault, ROADMAP C.4)
            lp = lt.area_light_pdf_dir(scene, light_idx, p, wi_w,
                                       torch.where(chosen, hit2["t"], 0.0),
                                       dot(hg2["ng"], -wi_w))
            light_pdf_dir = torch.where(chosen, lp, light_pdf_dir)
            Li2 = torch.where(chosen[..., None],
                              lt.area_light_emitted(scene, hg2, -wi_w), Li2)
            hit_light = hit_light | chosen
        if lt.INFINITE in meta.light_types:
            m = (ltype == lt.INFINITE) & (hit2["prim"] < 0)
            light_pdf_dir = torch.where(m, lt.env_pdf(scene, light_idx, wi_w),
                                        light_pdf_dir)
            Li2 = torch.where(m[..., None], lt.env_radiance(scene, light_idx, wi_w), Li2)
            hit_light = hit_light | m
        w_b = mc.power_heuristic(1.0, bs["pdf"], 1.0, light_pdf_dir)
        Ld = Ld + torch.where(
            (can & hit_light & (light_pdf_dir > 0.0))[..., None],
            bs["f"] * Li2
            * (cos_b * w_b / _detach(torch.clamp_min(bs["pdf"], 1e-12)))[..., None],
            0.0)
    return Ld / _detach(torch.clamp_min(light_pmf, 1e-12))[..., None]


def _pick_light(scene, meta, cfg, pix, samp, bounce):
    """UniformSampleOneLight's light choice, or by power."""
    u = _sample_1d(meta, pix, samp, bounce, _D_LIGHT_SEL)
    if cfg.light_strategy == "power":
        idx, pmf = mc.sample_distribution_1d_discrete(scene["light_power_dist"], u)
        return idx.to(torch.int32), pmf
    n_lights = meta.n_lights
    idx = torch.clamp_max((u * n_lights).to(torch.int32), n_lights - 1)
    pmf = torch.full(u.shape, 1.0 / n_lights, dtype=torch.float32, device=u.device)
    return idx, pmf


def _direct_light(scene, meta, cfg, pix, samp, bounce, sg, lobes, wo_local,
                  active, time, path_reuse):
    """Direct lighting at the bounce's hits, before the throughput: one
    light (by the strategy), or every light ("all", pmf 1, each light row
    with its own dimensions). With path-vertex reuse no BSDF branch runs,
    whatever the strategy: the reference runs it under "all" besides the
    reuse, which counts the BSDF strategy twice (ROADMAP C.7)."""
    # the BSDF branch's draws only where it runs
    mis = not path_reuse and (lt.AREA in meta.light_types
                              or lt.INFINITE in meta.light_types)

    def one(lidx, pmf, lrow=0):
        return estimate_direct(
            scene, meta, sg, lobes, wo_local, lidx, pmf,
            _sample_2d(meta, pix, samp, bounce, _D_LIGHT_POS, lrow),
            _sample_1d(meta, pix, samp, bounce, _D_LIGHT_TRI, lrow),
            _sample_1d(meta, pix, samp, bounce, _D_MIS_COMP, lrow) if mis else None,
            _sample_2d(meta, pix, samp, bounce, _D_MIS_DIR, lrow) if mis else None,
            active, time, bsdf_branch=mis)

    if cfg.light_strategy != "all":
        return one(*_pick_light(scene, meta, cfg, pix, samp, bounce))
    n = active.shape[0]
    pmf = torch.ones(n, dtype=torch.float32, device=active.device)
    Ld = sg["p"].new_zeros((n, 3))
    for lrow in range(meta.n_lights):
        Ld = Ld + one(torch.full((n,), lrow, dtype=torch.int32, device=active.device),
                      pmf, lrow)
    return Ld


def _whitted_light(scene, meta, pix, samp, bounce, sg, lobes, wo_local, active, time):
    """whitted.cpp: every light sampled once, no MIS and no BSDF branch."""
    eps = sg["ray_eps"]
    Ld = sg["p"].new_zeros(sg["p"].shape)
    for lrow in range(meta.n_lights):
        lidx = torch.full(active.shape, lrow, dtype=torch.int32, device=active.device)
        u2d = _sample_2d(meta, pix, samp, bounce, _D_LIGHT_POS, lrow)
        ls = lt.sample_li(scene, lidx, sg["p"], u2d[0], u2d[1],
                          _sample_1d(meta, pix, samp, bounce, _D_LIGHT_TRI, lrow),
                          meta.light_types, meta.light_image_rows)
        f_l = bx.bsdf_f(lobes, wo_local, geom.world_to_local(sg, ls["wi"]),
                        meta.lobe_types, include_specular=False,
                        tables=scene.get("brdf_tables", ()))
        cos_l = absdot(ls["wi"], sg["ns"])
        ok = active & (ls["pdf"] > 0.0) & (cos_l > 0.0)
        occluded = scene_intersect_p(
            scene, meta, sg["p"] + ls["wi"] * eps[..., None], ls["wi"],
            torch.where(ok, ls["dist"] - 2.0 * eps, 0.0), time=time)
        Ld = Ld + torch.where(
            (ok & ~occluded)[..., None],
            f_l * ls["radiance"]
            * (cos_l / _detach(torch.clamp_min(ls["pdf"], 1e-12)))[..., None],
            0.0)
    return Ld


def _segment_media(scene, meta, cfg, o, d, seg_t, pix, samp, bounce):
    """The media's (Lv, T) on a bounce's segments: on the camera segment the
    volume integrator's (samplerrenderer.cpp: T Lsurf + Lv), "single" with
    its march's shadow rays as "medium" waves; later segments only
    attenuate (Renderer::Transmittance), with a jitter drawn at a traced
    dimension in the reference (HALTON's base 2)."""
    if bounce == 0:
        if cfg.vol == "single" and meta.n_lights > 0:
            def trace(o_s, d_s, tmax):
                return _trace(scene, o_s, d_s, tmax, any_hit=True, role="medium")
            return med.single_scatter_li(scene, meta, o, d, seg_t, pix, samp, trace)
        return med.emission_li(scene, meta, o, d, seg_t, pix, samp)
    u_j = rngmod.sample_1d(meta.sampler, pix, samp,
                           med.MEDIA_DIM + 1 + med.SEGMENT_STRIDE * bounce, traced=True)
    return o.new_zeros((o.shape[0], 3)), med.transmittance(scene, meta, o, d, seg_t, u_j)


def _make_bounce_body(scene, meta, cfg, pix, samp, camdiff=None, time=None):
    """The per-bounce stage over the lanes of `pix`/`samp` (the compacted
    tail instantiates it again at a narrower width). camdiff: the camera
    differential rays, passed to the peeled bounce 0 only; time: the lanes'
    ray times, or None."""
    path_reuse = cfg.kind == "path"
    has_media = scene.get("media") is not None

    def bounce_body(bounce, state):
        o, d, L, throughput, active, spec_bounce, pdf_prev = state
        # the camera wave arrives in tile order: no ray binning for it
        hit = scene_intersect(scene, meta, o, d, torch.where(active, BIG, 0.0),
                              sort=False if bounce == 0 else None, time=time,
                              role="camera" if bounce == 0 else "continuation")
        miss = hit["prim"] < 0
        if has_media:
            Lv, T_seg = _segment_media(scene, meta, cfg, o, d,
                                       torch.where(miss, BIG, hit["t"]), pix, samp, bounce)
            L = L + torch.where(active[..., None], Lv, 0.0)
            throughput = throughput * torch.where(active[..., None], T_seg, 1.0)
        # escaped rays take the environment's radiance: camera and specular
        # rays unweighted; with path-vertex reuse, other continuations
        # MIS-weighted against the light strategy's env pdf
        if lt.INFINITE in meta.light_types:
            Le = lt.escaped_radiance(scene, d, meta.light_types)
            if path_reuse:
                env_row = scene["env_row"].expand(o.shape[0])
                w_env = torch.where(spec_bounce, 1.0, mc.power_heuristic(
                    1.0, pdf_prev, 1.0, lt.env_pdf(scene, env_row, d)))
                L = L + torch.where((active & miss)[..., None],
                                    throughput * w_env[..., None] * Le, 0.0)
            else:
                L = L + torch.where((active & miss & spec_bounce)[..., None],
                                    throughput * Le, 0.0)
        active = active & ~miss

        sg, lobes, wo_local = _shade_context(scene, meta, hit, o, d, camdiff, time)

        # emitted at hit: camera/specular vertices unweighted; with
        # path-vertex reuse, other vertices MIS-weighted by the light
        # strategy's per-point pdf at this hit
        if lt.AREA in meta.light_types:
            Le = lt.area_light_emitted(scene, sg, -d)
            if path_reuse:
                cos_at = dot(sg["ng"], -d)
                on_light = sg["light"] >= 0
                # the pdf is read on light hits only; elsewhere t may be the
                # miss sentinel, whose square overflows and would turn the
                # gradient into NaN (the reference's fault, ROADMAP C.4)
                lp = lt.area_light_pdf_dir(scene, torch.clamp_min(sg["light"], 0), o, d,
                                           torch.where(on_light, hit["t"], 0.0), cos_at)
                w_em = torch.where(spec_bounce | ~on_light, 1.0,
                                   mc.power_heuristic(1.0, pdf_prev, 1.0, lp))
                L = L + torch.where(active[..., None],
                                    throughput * w_em[..., None] * Le, 0.0)
            else:
                L = L + torch.where((active & spec_bounce)[..., None],
                                    throughput * Le, 0.0)

        if meta.n_lights > 0:
            if cfg.kind == "whitted":
                Ld = _whitted_light(scene, meta, pix, samp, bounce, sg, lobes,
                                    wo_local, active, time)
            else:
                Ld = _direct_light(scene, meta, cfg, pix, samp, bounce, sg, lobes,
                                   wo_local, active, time, path_reuse)
            L = L + torch.where(active[..., None], throughput * Ld, 0.0)

        # continuation: sample the BSDF (dead work on the final bounce, as in
        # the reference, whose loop exits before the next intersect)
        u_dir = _sample_2d(meta, pix, samp, bounce, _D_BSDF_DIR)
        u_comp = _sample_1d(meta, pix, samp, bounce, _D_BSDF_COMP)
        bs = bx.bsdf_sample(lobes, wo_local, u_dir[0], u_dir[1], u_comp,
                            meta.lobe_types, include_specular=True,
                            tables=scene.get("brdf_tables", ()))
        wi_w = geom.local_to_world(sg, bs["wi"])
        cos_c = absdot(wi_w, sg["ns"])
        contrib = bs["f"] * (cos_c
                             / _detach(torch.clamp_min(bs["pdf"], 1e-12)))[..., None]
        cont_ok = bs["valid"] & torch.any(bs["f"] != 0.0, dim=-1)
        if not path_reuse:
            cont_ok = cont_ok & bs["specular"]     # only specular recursion
        throughput = torch.where(cont_ok[..., None], throughput * contrib, throughput)
        active = active & cont_ok
        spec_bounce = bs["specular"]
        if path_reuse:
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


def li(scene, meta, cfg: IntegratorConfig, rays, pix, samp, with_stats=False):
    """Radiance for a batch of camera rays: the wavefront bounce loop.
    rays: dict from camera.generate_rays; pix, samp: sampler coordinates.
    Returns L (N,3); with_stats=True returns (L, occ), occ (max_depth+1,)
    float32 on the device: the live lanes entering each bounce, counted
    across the compaction splits (the wavefront occupancy signal; no host
    sync of its own)."""
    if cfg.kind in UNPORTED_KINDS:
        raise NotImplementedError(f"integrator kind {cfg.kind!r} is not ported yet "
                                  f"(ported: {', '.join(KINDS)}, dipole)")
    if cfg.kind == "dipole":
        raise ValueError("kind 'dipole' needs its preprocess: render it through "
                         "engine.render (subsurface.dipole_li)")
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown integrator kind {cfg.kind!r}; expected one of "
                         f"{', '.join(KINDS)}")
    if cfg.light_strategy not in STRATEGIES:
        raise ValueError(f"unknown light_strategy {cfg.light_strategy!r}; expected "
                         f"one of {', '.join(STRATEGIES)}")
    # only instances read the time (a moving camera has used it already)
    time = rays.get("time") if scene.get("inst") is not None else None
    if cfg.kind == "ao":
        if with_stats:
            raise ValueError("kind 'ao' has no bounce loop to count")
        return _ao_li(scene, meta, cfg, rays, pix, samp, time)
    o, d = rays["o"], rays["d"]
    n = o.shape[0]
    max_depth = cfg.max_depth
    L = torch.zeros_like(o)
    throughput = torch.ones_like(o)
    active = torch.ones(n, dtype=torch.bool, device=o.device)
    spec_bounce = active                       # bounce-0 emission counts
    pdf_prev = torch.ones(n, dtype=torch.float32, device=o.device)
    state = (o, d, L, throughput, active, spec_bounce, pdf_prev)
    occ = [None] * (max_depth + 1)       # live lanes entering each bounce

    def tally(b, st):
        if with_stats:
            occ[b] = torch.sum(st[4].to(torch.float32))

    tally(0, state)
    state = _make_bounce_body(scene, meta, cfg, pix, samp,
                              rays.get("camdiff"), time)(0, state)

    # multi-split compaction (kind="path" only, as the reference: the other
    # kinds run every bounce at full width): the tail repacks survivors at
    # static split points, each with an overflow guard (a wave whose live
    # count exceeds a split's capacity skips it). The pre-RR split at bounce
    # 2 runs for scenes with a BVH (the reference's stream-route scenes: open
    # scenes whose wavefront goes dark early), the post-RR split for every
    # scene.
    k = min(cfg.rr_depth + 1, max_depth + 1)
    splits = []
    if cfg.compact and cfg.kind == "path" and n >= cfg.compact_min:
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
                tally(b, st)
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

    L = tail(state, pix, samp, time, n, 1, splits) * rays["weight"][..., None]
    if with_stats:
        return L, torch.stack(occ)
    return L


def _ao_li(scene, meta, cfg, rays, pix, samp, time):
    """ambientocclusion.cpp: the fraction of ao_samples cosine-sampled rays
    from the first hit, flipped to the side of the geometric normal, that
    nothing occludes within ao_maxdist, in grey, times the ray weight. The
    first hit takes the binned route, as in the reference. Lanes that miss
    count nothing, and their occlusion rays are made inert (tmax 0)."""
    o, d = rays["o"], rays["d"]
    n = o.shape[0]
    hit = scene_intersect(scene, meta, o, d, o.new_full((n,), BIG), time=time,
                          role="camera")
    sg = geom.shading_geometry(scene, hit, o, d, time=time)
    active = hit["prim"] >= 0
    tmax = torch.where(active, cfg.ao_maxdist, 0.0)
    total = o.new_zeros(n)
    for s in range(cfg.ao_samples):
        u = rngmod.sample_2d(meta.sampler, pix, samp, _BOUNCE_BASE + s)
        w = geom.local_to_world(sg, mc.cosine_sample_hemisphere(u[0], u[1]))
        w = torch.where((dot(w, sg["ng"]) < 0.0)[..., None], -w, w)
        occluded = scene_intersect_p(scene, meta, sg["p"] + w * sg["ray_eps"][..., None],
                                     w, tmax, time=time, role="occlusion")
        total = total + torch.where(active & ~occluded, 1.0, 0.0)
    ao = total / cfg.ao_samples
    return ao[:, None].expand(n, 3) * rays["weight"][..., None]
