"""Metropolis light transport (port of grail/engine/metropolis.py; pbrt
src/renderers/metropolis.cpp re-shaped as batched primary-sample-space
(Kelemen) MLT).

Thousands of chains advance in lockstep as one batch. A chain's state is its
primary-sample vector u in [0,1)^D; a mutation is a large step (a fresh
uniform vector) or Kelemen's exponential small step (MutateValue); the
path radiance of the whole batch is evaluated again, and acceptance, the
Kelemen-weighted splats of both states and the bootstrap normalization b
follow the reference. eval_path is the unidirectional estimator;
eval_path_bidir builds a camera and a light subpath per chain and connects
every (t, s) pair, with balance-heuristic MIS over the area-measure pdfs of
every split of the same vertex chain, and direct_separate drops the paths
of length <= 2, which a direct-lighting render adds.

The reference departs from pbrt and the port follows it: its MIS, its
u-vector layout (_HDR, _PB, _LHDR, _LPB), light subpaths from area lights
only, no bump map, alpha cutout or ray time in MLT's shading, and eval_path
evaluating BSDFs without the measured tables where eval_path_bidir passes
them. The reference's lax.scan over a wave's mutations is a Python loop; the
chain state (u, L, y) stays on the device. The mutation streams are keyed
by the global chain id, the wave and the step (the reference's keys and
sampler dimensions, bitwise), and the small step's exp is computed as the
reference's compiled exp computes it, so a mutation is bitwise the
reference's on the CPU and the same on the card. eval_path_bidir evaluates
each vertex's BSDF terms toward all its connections in one call on their
lanes stacked (the same arithmetic a lane as a call a connection, half the
launches of an evaluation); each visibility test stays its own wave.

The waves it hands the intersect dispatch count in integrator.WAVES as
"mlt_camera" (the camera subpath's closest hits, and eval_path's),
"mlt_light" (the light subpath's) and "mlt_connect" (every visibility test,
any hit). render_mlt_sharded splits the chains over the ranks of a
dist/sharding.py Mesh: the same chains advance as in render_mlt, each rank
splats into its own film, and one all-reduce merges them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import montecarlo as mc
from ..core import rng as rngmod
from ..core.spectrum import luminance
from ..core.vecmath import absdot, coordinate_system, cross, dot, normalize
from ..device import check_on, resolve_device
from ..shade import bsdf as bx
from ..shade import geometry as geom
from ..shade import lights as lt
from ..shade import materials as mtl
from ..shade.textures import eval_textures
from . import film as flm
from . import integrator as integ
from .camera import generate_rays

BIG = 1.0e7

# u-vector layout: [img_x, img_y, lens_u, lens_v, time] + a block a bounce
_HDR = 5
_PB = 9     # light_sel, light_u, light_v, light_tri, mis_comp, mis_u, mis_v, bsdf_comp, dir
_LHDR = 6   # light subpath header: light_sel, tri, bary u1, u2, dir u1, u2
_LPB = 3    # a light bounce: bsdf u1, u2, u_comp

_RANDOM = rngmod.SamplerConfig(kind=rngmod.RANDOM)


@dataclasses.dataclass(frozen=True)
class MLTConfig:
    max_depth: int = 5
    n_chains: int = 4096
    n_bootstrap: int = 4096
    mutations_per_wave: int = 16
    large_step_prob: float = 0.25
    small_step_s1: float = 1.0 / 1024.0
    small_step_s2: float = 1.0 / 16.0
    bidirectional: bool = False     # metropolis.cpp "bidirectional"
    direct_separate: bool = False   # "dodirectseparately"

    @property
    def s_max(self):
        """Light subpath surface vertices y1..y_smax (y0 on the light): the
        full depth, as the reference's maxDepth light paths."""
        return self.max_depth

    @property
    def dim(self):
        d = _HDR + (self.max_depth + 1) * _PB
        if self.bidirectional:
            d += _LHDR + self.s_max * _LPB
        return d


def _col(u, i):
    return u[:, i]


def _camera_rays(scene, meta, u):
    px = _col(u, 0) * meta.xres
    py = _col(u, 1) * meta.yres
    fx, fy = torch.floor(px), torch.floor(py)
    rays = generate_rays(scene["camera"], fx.to(torch.int32), fy.to(torch.int32),
                         px - fx, py - fy, _col(u, 2), _col(u, 3), _col(u, 4),
                         meta.cam_kind)
    return rays, px, py


def _shade(scene, meta, hit, o, d):
    """Shading geometry, textures and lobes at the hits (no bump, no ray
    time: the reference's MLT shades so)."""
    sg = geom.shading_geometry(scene, hit, o, d)
    tex_values = eval_textures(meta.tex_specs, scene["tex_data"], sg,
                               scene.get("images", ()))
    return sg, mtl.gather_lobes(scene, sg, tex_values)


def eval_path(scene, meta, cfg: MLTConfig, u):
    """Path radiance of primary-sample vectors u (N,D): the path integrator
    with its samples read from u's columns. Returns (L (N,3), raster x, y)."""
    n = u.shape[0]
    rays, px, py = _camera_rays(scene, meta, u)
    o, d = rays["o"], rays["d"]
    L = u.new_zeros((n, 3))
    throughput = u.new_ones((n, 3))
    active = torch.ones(n, dtype=torch.bool, device=u.device)
    spec = active
    n_lights = meta.n_lights
    present = meta.lobe_types

    for bounce in range(cfg.max_depth + 1):
        base = _HDR + bounce * _PB
        hit = integ._trace(scene, o, d, torch.where(active, BIG, 0.0), role="mlt_camera")
        miss = hit["prim"] < 0
        L = L + torch.where((active & miss & spec)[..., None],
                            throughput * lt.escaped_radiance(scene, d, meta.light_types),
                            0.0)
        active = active & ~miss
        sg, lobes = _shade(scene, meta, hit, o, d)
        wo_l = geom.world_to_local(sg, -d)
        if lt.AREA in meta.light_types:
            L = L + torch.where((active & spec)[..., None],
                                throughput * lt.area_light_emitted(scene, sg, -d), 0.0)
        if n_lights > 0:
            lidx = torch.clamp_max((_col(u, base) * n_lights).to(torch.int32), n_lights - 1)
            ls = lt.sample_li(scene, lidx, sg["p"], _col(u, base + 1), _col(u, base + 2),
                              _col(u, base + 3), meta.light_types, meta.light_image_rows)
            wi_l = geom.world_to_local(sg, ls["wi"])
            f_l = bx.bsdf_f(lobes, wo_l, wi_l, present, False)
            cos_l = absdot(ls["wi"], sg["ns"])
            ok = active & (ls["pdf"] > 0) & (cos_l > 0)
            occ = integ._trace(scene, sg["p"] + ls["wi"] * sg["ray_eps"][..., None],
                               ls["wi"], torch.where(ok, ls["dist"] - 2 * sg["ray_eps"], 0.0),
                               any_hit=True, role="mlt_connect")
            bpdf = bx.bsdf_pdf(lobes, wo_l, wi_l, present, False)
            w = torch.where(ls["delta"], 1.0, mc.power_heuristic(1.0, ls["pdf"], 1.0, bpdf))
            Ld = torch.where((ok & ~occ)[..., None],
                             f_l * ls["radiance"]
                             * (cos_l * w * n_lights
                                / torch.clamp_min(ls["pdf"], 1e-12))[..., None], 0.0)
            L = L + torch.where(active[..., None], throughput * Ld, 0.0)

        if bounce == cfg.max_depth:
            break
        bs = bx.bsdf_sample(lobes, wo_l, _col(u, base + 4), _col(u, base + 5),
                            _col(u, base + 6), present, True)
        wi_w = geom.local_to_world(sg, bs["wi"])
        cosc = absdot(wi_w, sg["ns"])
        contrib = bs["f"] * (cosc / torch.clamp_min(bs["pdf"], 1e-12))[..., None]
        ok = bs["valid"] & torch.any(bs["f"] != 0, dim=-1)
        throughput = torch.where(ok[..., None], throughput * contrib, throughput)
        active = active & ok
        spec = bs["specular"]
        o = sg["p"] + wi_w * sg["ray_eps"][..., None]
        d = wi_w

    L = torch.where(torch.isfinite(L), L, 0.0)
    return L, px, py


def _area_light_point(scene, meta, u_sel, u_tri, ub1, ub2):
    """A uniform light pick and a uniform point on its triangles (area
    lights). Returns dict p, nl, Le (one-sided), pdfA (pmf / area), li, ok."""
    n_lights = meta.n_lights
    li = torch.clamp_max((u_sel * n_lights).to(torch.int32), n_lights - 1)
    lights = scene["lights"]
    slot = mc.searchsorted_rows(lights["acdf"], li, u_tri)
    at = lights["av0"].shape[1]
    flat = li.to(torch.int64) * at + slot.to(torch.int64)
    v0 = lights["av0"].reshape(-1, 3)[flat]
    v1 = lights["av1"].reshape(-1, 3)[flat]
    v2 = lights["av2"].reshape(-1, 3)[flat]
    b0, b1 = mc.uniform_sample_triangle(ub1, ub2)
    p = b0[..., None] * v0 + b1[..., None] * v1 + (1.0 - b0 - b1)[..., None] * v2
    nl = normalize(cross(v1 - v0, v2 - v0))
    flip = lights["aflip"].reshape(-1)[flat] != 0
    nl = torch.where(flip[..., None], -nl, nl)
    is_area = lights["type"][li] == lt.AREA
    Le = torch.where(is_area[..., None], lights["emit"][li], 0.0)
    pdfA = (1.0 / n_lights) / torch.clamp_min(lights["area"][li], 1e-12)
    return {"p": p, "nl": nl, "Le": Le, "pdfA": pdfA, "li": li, "ok": is_area}


def eval_path_bidir(scene, meta, cfg: MLTConfig, u):
    """Bidirectional path radiance of primary-sample vectors u (N,D) (pbrt
    metropolis.cpp GeneratePath/Lbidir in the reference's batched form).

    A camera subpath z1..zT (from the pixel ray, no Russian roulette) and a
    full-depth light subpath (y0 on an area light, y1..y_smax by BSDF
    sampling) per chain; every (t, s) pair adds
        Tc_t * f_z(zt) * G(zt, y) * [f_y(yj) * Tl_j] * V,
    s=0 being the camera path on an emitter and s=1 next-event estimation
    to an area-light point. The strategies are combined by the balance
    heuristic over the area-measure pdfs of every (t', s') split of the same
    vertex chain; a split counts where both its endpoints can connect, and
    the pdfs of delta-sampled segments are stored as 1 so they cancel in the
    ratios. direct_separate drops the strategies of length <= 2."""
    n = u.shape[0]
    T_MAX = cfg.max_depth + 1          # camera surface vertices z1..zT
    S_MAX = cfg.s_max                  # light surface vertices y1..yS
    present = meta.lobe_types
    tables = scene.get("brdf_tables", ())
    rays, px, py = _camera_rays(scene, meta, u)

    def surface_vertex(o, d, active, role):
        hit = integ._trace(scene, o, d, torch.where(active, BIG, 0.0), role=role)
        ok = active & (hit["prim"] >= 0)
        sg, lobes = _shade(scene, meta, hit, o, d)
        conn = ok & (bx.bsdf_num_components(lobes, False) > 0)
        return {"ok": ok, "sg": sg, "lobes": lobes, "p": sg["p"], "ns": sg["ns"],
                "ng": sg["ng"], "conn": conn, "wo_world": -d, "t": hit["t"],
                "light": sg["light"]}

    def pdf_solid(v, wo_world, wi_world):
        return bx.bsdf_pdf(v["lobes"], geom.world_to_local(v["sg"], wo_world),
                           geom.world_to_local(v["sg"], wi_world), present, False)

    def f_eval(v, wo_world, wi_world):
        return bx.bsdf_f(v["lobes"], geom.world_to_local(v["sg"], wo_world),
                         geom.world_to_local(v["sg"], wi_world), present, False,
                         tables=tables)

    def walk_step(v, ub1, ub2, ucomp, thr):
        """Sample the BSDF at vertex v: (throughput, pdf, specular, active,
        next origin, next direction)."""
        bs = bx.bsdf_sample(v["lobes"], geom.world_to_local(v["sg"], v["wo_world"]),
                            ub1, ub2, ucomp, present, True)
        wi_w = geom.local_to_world(v["sg"], bs["wi"])
        cosc = absdot(wi_w, v["ns"])
        contrib = bs["f"] * (cosc / torch.clamp_min(bs["pdf"], 1e-12))[..., None]
        ok = v["ok"] & bs["valid"] & torch.any(bs["f"] != 0, dim=-1)
        thr = torch.where(ok[..., None], thr * contrib, thr)
        return (thr, bs["pdf"], bs["specular"], ok,
                v["p"] + wi_w * v["sg"]["ray_eps"][..., None], wi_w)

    ones = u.new_ones(n)

    # ---------------------------------------------------------- camera walk
    cam_v = []          # z1..zT
    Tc = []             # throughput up to the vertex (camera side)
    pdfA_cam = [None]   # [t]: area pdf of generating z_t from z_{t-1}
    in_dir_cam = [None]  # [t]: direction of travel z_{t-1} -> z_t
    seg2_cam = [None]   # [t]: squared length of that segment
    o, d = rays["o"], rays["d"]
    active = torch.ones(n, dtype=torch.bool, device=u.device)
    thr = u.new_ones((n, 3))
    prev_pdf_solid = ones
    prev_delta = torch.zeros(n, dtype=torch.bool, device=u.device)
    for t in range(T_MAX):
        v = surface_vertex(o, d, active, "mlt_camera")
        seg2 = torch.clamp_min(v["t"] * v["t"], 1e-12)
        cosv = absdot(d, v["ns"])
        pdfA_cam.append(torch.where(prev_delta, 1.0, prev_pdf_solid * cosv / seg2)
                        if t else ones)
        in_dir_cam.append(d)
        seg2_cam.append(seg2)
        cam_v.append(v)
        Tc.append(thr)
        base = _HDR + t * _PB
        thr, prev_pdf_solid, prev_delta, active, o, d = walk_step(
            v, _col(u, base + 4), _col(u, base + 5), _col(u, base + 6), thr)

    # ----------------------------------------------------------- light walk
    lb = _HDR + (cfg.max_depth + 1) * _PB
    y0 = _area_light_point(scene, meta, _col(u, lb), _col(u, lb + 1), _col(u, lb + 2),
                           _col(u, lb + 3))
    t1v, t2v = coordinate_system(y0["nl"])
    wl = mc.cosine_sample_hemisphere(_col(u, lb + 4), _col(u, lb + 5))
    d0 = wl[:, 0:1] * t1v + wl[:, 1:2] * t2v + wl[:, 2:3] * y0["nl"]
    cos0 = torch.clamp_min(wl[:, 2], 0.0)
    pdf_dir0 = cos0 * (1.0 / math.pi)
    light_v = [None]     # [j]: y_j
    Tl = [None]          # [j]: throughput for a connection at y_j
    pdfA_light = [None]  # [j]: area pdf of generating y_j from y_{j-1}
    in_dir_light = [None]  # [j]: direction y_{j-1} -> y_j
    seg2_light = [None]
    Tl0 = y0["Le"] / torch.clamp_min(y0["pdfA"], 1e-12)[..., None]
    l_thr = Tl0 * (cos0 / torch.clamp_min(pdf_dir0, 1e-9))[..., None]
    l_active = y0["ok"] & (cos0 > 1e-6) & torch.any(y0["Le"] > 0, dim=-1)
    lo, ld = y0["p"] + d0 * 1e-4, d0
    l_prev_pdf_solid = pdf_dir0
    l_prev_delta = torch.zeros(n, dtype=torch.bool, device=u.device)
    for s in range(S_MAX):
        v = surface_vertex(lo, ld, l_active, "mlt_light")
        seg2 = torch.clamp_min(v["t"] * v["t"], 1e-12)
        cosv = absdot(ld, v["ns"])
        pdfA_light.append(torch.where(l_prev_delta, 1.0, l_prev_pdf_solid * cosv / seg2))
        in_dir_light.append(ld)
        seg2_light.append(seg2)
        light_v.append(v)
        Tl.append(l_thr)
        lbb = lb + _LHDR + s * _LPB
        l_thr, l_prev_pdf_solid, l_prev_delta, l_active, lo, ld = walk_step(
            v, _col(u, lbb), _col(u, lbb + 1), _col(u, lbb + 2), l_thr)

    # ---------------------------------- connection-independent reverse pdfs
    # revA_cam[i] (i <= T-2): area pdf of z_i generated from z_{i+1} when the
    # light side owns the suffix (BSDF at z_{i+1}, incoming from z_{i+2})
    revA_cam = {}
    for i in range(1, T_MAX - 1):
        pdfS = pdf_solid(cam_v[i], in_dir_cam[i + 2], -in_dir_cam[i + 1])
        revA_cam[i] = pdfS * absdot(in_dir_cam[i + 1], cam_v[i - 1]["ns"]) / seg2_cam[i + 1]
    # camA_light[j] (1 <= j <= S-1): area pdf of y_{j-1} generated from y_j
    # when the camera side owns y_j (BSDF at y_j, incoming from y_{j+1})
    camA_light = {}
    for j in range(1, S_MAX):
        pdfS = pdf_solid(light_v[j], in_dir_light[j + 1], -in_dir_light[j])
        if j >= 2:
            cos_tgt = absdot(in_dir_light[j], light_v[j - 1]["ns"])
        else:
            cos_tgt = torch.abs(dot(in_dir_light[1], y0["nl"]))
        camA_light[j] = pdfS * cos_tgt / seg2_light[j]

    # ------------------------------------------------- connections + MIS
    def seg(a, b):
        vec = b - a
        d2 = torch.clamp_min(torch.sum(vec * vec, dim=-1), 1e-12)
        dist = torch.sqrt(d2)
        return vec / dist[..., None], dist, d2

    def visible(pa, eps_a, w, dist):
        # both ends are surfaces: the segment pulled in by the origin's ray
        # epsilon at each end (EstimateDirect's convention)
        return ~integ._trace(scene, pa + w * eps_a[..., None], w,
                             dist * (1.0 - 1e-3) - 2.0 * eps_a, any_hit=True,
                             role="mlt_connect")

    remapped = {}       # the MIS chains share most entries: each remapped once

    def remap(x):
        if id(x) not in remapped:
            remapped[id(x)] = (x, torch.where(x > 0, x, 1.0))
        return remapped[id(x)][1]

    def full_mis(t, k, fwdA, revA, conn, emissive_k):
        """Balance weight of strategy t (t camera-generated vertices) among
        every split of the k-vertex chain; fwdA, revA, conn: dicts over the
        chain's positions 1..k; emissive_k: whether the c=k (s'=0) strategy
        is valid. The light side makes at most S_MAX+1 vertices, the camera
        side at most T_MAX."""
        inv_w = ones
        r = ones
        for c in range(t, 1, -1):        # candidate c-1
            r = r * remap(revA[c]) / remap(fwdA[c])
            if k - (c - 1) <= S_MAX + 1:
                inv_w = inv_w + torch.where(conn[c - 1] & conn[c], r, 0.0)
        r = ones
        for c in range(t, k):            # candidate c+1
            r = r * remap(fwdA[c + 1]) / remap(revA[c + 1])
            if c + 1 <= T_MAX:
                valid = emissive_k if c + 1 == k else conn[c + 1] & conn[c + 2]
                inv_w = inv_w + torch.where(valid, r, 0.0)
        return 1.0 / torch.clamp_min(inv_w, 1.0)

    min_len = 3 if cfg.direct_separate else 1

    tilings = {}

    def tiled(v, k):
        """Vertex v's shading frame and lobes, its lanes repeated k times."""
        if (id(v), k) not in tilings:
            tilings[id(v), k] = {
                "sg": {key: v["sg"][key].repeat(k, 1) for key in ("ss", "ts", "ns")},
                "lobes": {key: x.repeat((k,) + (1,) * (x.dim() - 1))
                          for key, x in v["lobes"].items()}}
        return tilings[id(v), k]

    def at_once(fn, v, wos, wis):
        """fn(v, wo, wi) for each pair of world directions (wos[i], wis[i]),
        in one call on the pairs' lanes stacked: the same arithmetic a lane
        as a call a pair, a fraction of the launches."""
        if len(wis) == 1:
            return [fn(v, wos[0], wis[0])]
        return list(fn(tiled(v, len(wis)), torch.cat(wos), torch.cat(wis)).split(n))

    # every connection's segment: (t, 0) to the s = 1 strategy's light
    # point of z_t, (t, j) to the light subpath's y_j
    light_pt, segs = {}, {}
    for t in range(1, T_MAX + 1):
        z = cam_v[t - 1]
        if meta.n_lights > 0 and t + 1 >= min_len:
            base = _HDR + (t - 1) * _PB
            light_pt[t] = _area_light_point(scene, meta, _col(u, base + 0), _col(u, base + 3),
                                            _col(u, base + 1), _col(u, base + 2))
            segs[t, 0] = seg(z["p"], light_pt[t]["p"])
        for j in range(1, S_MAX + 1):
            if t + j + 2 >= min_len:
                segs[t, j] = seg(z["p"], light_v[j]["p"])

    # the BSDF terms of each vertex toward all its connections: at z_t f and
    # the pdf toward the connection, and (t >= 2) the reverse pdf from it
    # toward z_{t-1}; at y_j f toward z_t, the pdf from z_t toward y_{j-1}
    # and the pdf of its own incoming direction toward z_t
    z_f, z_fwd, z_rev, y_f, y_fwd, y_rev = {}, {}, {}, {}, {}, {}
    for t in range(1, T_MAX + 1):
        keys = [key for key in segs if key[0] == t]
        if not keys:
            continue
        z, ws = cam_v[t - 1], [segs[key][0] for key in keys]
        wos = [z["wo_world"]] * len(ws)
        z_f.update(zip(keys, at_once(f_eval, z, wos, ws)))
        z_fwd.update(zip(keys, at_once(pdf_solid, z, wos, ws)))
        if t >= 2:
            z_rev.update(zip(keys, at_once(pdf_solid, z, ws, [-in_dir_cam[t]] * len(ws))))
    for j in range(1, S_MAX + 1):
        keys = [key for key in segs if key[1] == j]
        if not keys:
            continue
        y, back = light_v[j], [-segs[key][0] for key in keys]
        wos = [y["wo_world"]] * len(back)
        y_f.update(zip(keys, at_once(f_eval, y, wos, back)))
        y_fwd.update(zip(keys, at_once(pdf_solid, y, back, [-in_dir_light[j]] * len(back))))
        y_rev.update(zip(keys, at_once(pdf_solid, y, wos, back)))

    def rev_camera_end(t, key):
        """revA[t-1] for t >= 2: z_{t-1} generated from z_t by the BSDF at
        z_t, incoming from the connection."""
        return z_rev[key] * absdot(in_dir_cam[t], cam_v[t - 2]["ns"]) / seg2_cam[t]

    L = u.new_zeros((n, 3))
    for t in range(1, T_MAX + 1):
        z = cam_v[t - 1]
        zc = Tc[t - 1]
        conn_base = {i: cam_v[i - 1]["conn"] for i in range(1, t + 1)}
        fwd_base = {i: pdfA_cam[i] for i in range(1, t + 1)}

        # ---- s = 0: z_t lies on an emitter (chain x_1..x_t, x_t the light)
        if lt.AREA in meta.light_types and t >= min_len:
            Le_hit = lt.area_light_emitted(scene, z["sg"], z["wo_world"])
            emit_ok = z["ok"] & torch.any(Le_hit > 0, dim=-1)
            li_row = torch.clamp_min(z["light"], 0)
            revA = dict(revA_cam)
            revA[t] = (1.0 / meta.n_lights) / torch.clamp_min(
                scene["lights"]["area"][li_row], 1e-12)
            if t >= 2:
                cos_e = torch.clamp_min(dot(z["ng"], -in_dir_cam[t]), 0.0)
                cos_r = absdot(in_dir_cam[t], cam_v[t - 2]["ns"])
                revA[t - 1] = (cos_e / math.pi) * cos_r / seg2_cam[t]
            # the chain's last vertex is the light point: light-side
            # strategies connect to it whatever its surface BSDF
            conn = dict(conn_base)
            conn[t] = emit_ok
            w_mis = full_mis(t, t, fwd_base, revA, conn, emit_ok)
            L = L + torch.where(emit_ok[..., None], zc * Le_hit * w_mis[..., None], 0.0)

        # ---- s = 1: next-event estimation to an area-light point
        #      (chain x_1..x_{t+1}, x_{t+1} = y0)
        if (t, 0) in segs:
            y = light_pt[t]
            w_zy, dist, d2 = segs[t, 0]
            cos_z = absdot(w_zy, z["ns"])
            cos_y = dot(y["nl"], -w_zy)
            f_z = z_f[t, 0]
            can = z["conn"] & y["ok"] & (cos_y > 0) & torch.any(f_z > 0, dim=-1)
            V = visible(z["p"], z["sg"]["ray_eps"], w_zy, dist)
            G = cos_z * torch.abs(cos_y) / d2
            C = zc * f_z * y["Le"] * (G / torch.clamp_min(y["pdfA"], 1e-12))[..., None]
            fwdA = dict(fwd_base)
            fwdA[t + 1] = z_fwd[t, 0] * torch.abs(cos_y) / d2
            revA = dict(revA_cam)
            revA[t + 1] = y["pdfA"]
            revA[t] = (torch.clamp_min(cos_y, 0.0) / math.pi) * cos_z / d2
            if t >= 2:
                revA[t - 1] = rev_camera_end(t, (t, 0))
            conn = dict(conn_base)
            conn[t + 1] = y["ok"]
            w_mis = full_mis(t, t + 1, fwdA, revA, conn, torch.any(y["Le"] > 0, dim=-1))
            L = L + torch.where((can & V)[..., None], C * w_mis[..., None], 0.0)

        # ---- s >= 2: connect z_t to the light subpath's vertex y_j
        #      (chain x_1..x_k, k = t + j + 1; x_{t+1} = y_j ... x_k = y0)
        for j in range(1, S_MAX + 1):
            if (t, j) not in segs:
                continue
            k = t + j + 1
            y = light_v[j]
            w_zy, dist, d2 = segs[t, j]
            cos_z = absdot(w_zy, z["ns"])
            cos_y = absdot(w_zy, y["ns"])
            f_z, f_y = z_f[t, j], y_f[t, j]
            can = (z["conn"] & y["conn"] & torch.any(f_z > 0, dim=-1)
                   & torch.any(f_y > 0, dim=-1))
            V = visible(z["p"], z["sg"]["ray_eps"], w_zy, dist)
            G = cos_z * cos_y / d2
            C = zc * f_z * G[..., None] * f_y * Tl[j]

            fwdA = dict(fwd_base)
            fwdA[t + 1] = z_fwd[t, j] * cos_y / d2
            if j >= 2:
                cos_tgt = absdot(in_dir_light[j], light_v[j - 1]["ns"])
            else:
                cos_tgt = torch.abs(dot(in_dir_light[1], y0["nl"]))
            fwdA[t + 2] = y_fwd[t, j] * cos_tgt / seg2_light[j]
            for i in range(t + 3, k + 1):
                fwdA[i] = camA_light[j - (i - t - 2)]
            revA = dict(revA_cam)
            for i in range(t + 1, k):
                revA[i] = pdfA_light[j - (i - t - 1)]
            revA[k] = y0["pdfA"]
            revA[t] = y_rev[t, j] * cos_z / d2
            if t >= 2:
                revA[t - 1] = rev_camera_end(t, (t, j))
            conn = dict(conn_base)
            for i in range(t + 1, k):
                conn[i] = light_v[j - (i - t - 1)]["conn"]
            conn[k] = y0["ok"]
            w_mis = full_mis(t, k, fwdA, revA, conn, torch.any(y0["Le"] > 0, dim=-1))
            L = L + torch.where((can & V)[..., None], C * w_mis[..., None], 0.0)

    L = torch.where(torch.isfinite(L), L, 0.0)
    return L, px, py


def _fma(a, b, c):
    """a*b + c rounded once to float32, as a fused multiply-add: the float64
    product of two float32 values is exact, and the sum rounds to float64
    before float32 (a second rounding that can differ from one only at a
    float32 tie)."""
    return (a.double() * b + (c.double() if isinstance(c, torch.Tensor) else c)).float()


def _exp(x):
    """exp(x) in float32 as the reference's compiled exp computes it on the
    CPU: a Cephes range reduction and degree-5 polynomial whose multiply-adds
    the compiler fuses. The same elementwise operations give the same bits
    on the card."""
    x = torch.clamp(x, -87.80000305175781, 88.80000305175781)
    fx = torch.floor(_fma(x, 1.4426950216293335, 0.5)).clamp(-127.0, 127.0)
    r = _fma(-fx, 0.693359375, x)
    r = _fma(-fx, -0.00021219444170128554, r)
    p = _fma(r, 0.00019875691214110702, 0.001398199936375022)
    for c in (0.008333452045917511, 0.04166579619050026, 0.1666666567325592, 0.5):
        p = _fma(p, r, c)
    y = _fma(p, r * r, r) + 1.0
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * scale


def _mutate(u, key_pix, step_idx, cfg: MLTConfig):
    """One Metropolis mutation of the batch: a large step or Kelemen's small
    step (MutateValue: exponential magnitude, random sign). Returns (u,
    large)."""
    n, D = u.shape
    samp = torch.full((n, 1), step_idx, dtype=torch.int64, device=u.device)
    key = key_pix[:, None]
    large = rngmod.sample_1d(_RANDOM, key, samp, 999999)[:, 0] < cfg.large_step_prob
    # the reference's float32 -log(s2/s1)
    neg_log = -torch.log(torch.tensor(cfg.small_step_s2 / cfg.small_step_s1,
                                      dtype=torch.float32)).item()
    # every column at once: column d draws dimensions 2d and 2d+1
    dims = 2 * torch.arange(D, dtype=torch.int64, device=u.device)[None, :]
    r1 = rngmod.sample_1d(_RANDOM, key, samp, dims)
    r2 = rngmod.sample_1d(_RANDOM, key, samp, dims + 1)
    mag = cfg.small_step_s2 * _exp(neg_log * r1)
    delta = torch.where(r2 < 0.5, mag, -mag)
    small = torch.remainder(u + delta, 1.0)
    return torch.where(large[:, None], r1, small), large


def _bootstrap(scene, meta, cfg: MLTConfig, evalf, seed):
    """The bootstrap: the luminances of n_bootstrap fresh paths give the
    normalization b and the chain starts, resampled in proportion to
    luminance. Returns (u (n_chains, D), b as a 0-d tensor)."""
    device = scene["verts"].device
    pix = torch.arange(cfg.n_bootstrap, dtype=torch.int64, device=device) ^ (seed & 0xFFFFFFFF)
    samp = torch.zeros(cfg.n_bootstrap, dtype=torch.int64, device=device)
    u = rngmod.sample_1d(_RANDOM, pix[:, None], samp[:, None],
                         torch.arange(cfg.dim, dtype=torch.int64, device=device)[None, :])
    Lb, _, _ = evalf(scene, meta, cfg, u)
    y = luminance(Lb)
    b = torch.mean(y)
    dist = mc.build_distribution_1d(torch.clamp_min(y, 1e-12))
    n = cfg.n_chains
    u_pick = rngmod.sample_1d(_RANDOM, pix[:n], samp[:n], 777777)
    idx, _ = mc.sample_distribution_1d_discrete(dist, u_pick)
    return u[idx], b


def _mlt_wave(scene, meta, cfg: MLTConfig, evalf, film, u, wave_idx, chain_base=0):
    """One wave of mutations_per_wave Metropolis steps for a batch of chains.
    chain_base: the batch's first global chain id (the mutation streams are
    keyed by the global id). Returns (film, u)."""
    n = u.shape[0]
    L_cur, _, _ = evalf(scene, meta, cfg, u)
    y_cur = luminance(L_cur)
    chain = chain_base + torch.arange(n, dtype=torch.int64, device=u.device)
    for k in range(cfg.mutations_per_wave):
        key_pix = (chain ^ ((wave_idx * 7919) & 0xFFFFFFFF) ^ ((k * 104729) & 0xFFFFFFFF)) \
            & 0xFFFFFFFF
        u_prop, _ = _mutate(u, key_pix, k, cfg)
        L_prop, px_p, py_p = evalf(scene, meta, cfg, u_prop)
        y_prop = luminance(L_prop)
        a = torch.clamp_max(y_prop / torch.clamp_min(y_cur, 1e-12), 1.0)
        # Kelemen's weighted splats of both states
        w_cur = (1.0 - a) / torch.clamp_min(y_cur, 1e-12)
        w_prop = a / torch.clamp_min(y_prop, 1e-12)
        film = flm.splat(film, _col(u, 0) * meta.xres, _col(u, 1) * meta.yres,
                         L_cur * w_cur[..., None])
        film = flm.splat(film, px_p, py_p, L_prop * w_prop[..., None])
        # accept or reject
        u_acc = rngmod.sample_1d(_RANDOM, key_pix,
                                 torch.full((n,), k, dtype=torch.int64, device=u.device),
                                 555555)
        accept = u_acc < a
        u = torch.where(accept[:, None], u_prop, u)
        L_cur = torch.where(accept[:, None], L_prop, L_cur)
        y_cur = torch.where(accept, y_prop, y_cur)
    return film, u


@torch.no_grad()
def render_mlt(scene, meta, cfg: MLTConfig, n_waves=8, seed=0, device=None):
    """The Metropolis render: bootstrap, n_waves waves of every chain,
    splats; returns (image, film). bidirectional picks eval_path_bidir;
    direct_separate adds a direct-lighting render of the paths of length
    <= 2 (metropolis.cpp doDirectSeparately), which the chains then skip."""
    device = resolve_device(device)
    check_on(scene["verts"], device, "the scene")
    evalf = eval_path_bidir if cfg.bidirectional else eval_path
    u, b = _bootstrap(scene, meta, cfg, evalf, seed)
    film = flm.new_film(meta.xres, meta.yres, device)
    total_mutations = 0
    for wv in range(n_waves):
        film, u = _mlt_wave(scene, meta, cfg, evalf, film, u, wv)
        total_mutations += cfg.mutations_per_wave * cfg.n_chains
    # splat normalization: E[image] = b * splat / mutations * pixels
    splat_scale = float(b) * meta.xres * meta.yres / total_mutations
    img = flm.develop(film, splat_scale=splat_scale)
    return _maybe_direct(scene, meta, cfg, img, device), film


@torch.no_grad()
def render_mlt_sharded(scene, meta, cfg: MLTConfig, n_waves, mesh, seed=0):
    """Metropolis with the chains split over the ranks of `mesh`: the
    bootstrap runs on every rank (one normalization and one set of chain
    starts), rank k advances chains [k*per, (k+1)*per) keyed by their global
    ids, so every chain follows render_mlt's trajectory, into a film of its
    own; one all-reduce merges the films. Returns (image, film), the same on
    every rank; the film differs from render_mlt's only by the order of its
    float sums."""
    device = mesh.device
    check_on(scene["verts"], device, "the scene")
    n = cfg.n_chains
    if n % mesh.world_size:
        raise ValueError(f"n_chains={n} must divide over {mesh.world_size} ranks")
    per = n // mesh.world_size
    evalf = eval_path_bidir if cfg.bidirectional else eval_path
    u, b = _bootstrap(scene, meta, cfg, evalf, seed)
    u = u[mesh.rank * per:(mesh.rank + 1) * per]
    film = flm.new_film(meta.xres, meta.yres, device)
    for wv in range(n_waves):
        film, u = _mlt_wave(scene, meta, cfg, evalf, film, u, wv, chain_base=mesh.rank * per)
    film = mesh.reduce(film)
    splat_scale = float(b) * meta.xres * meta.yres / (n_waves * cfg.mutations_per_wave * n)
    img = flm.develop(film, splat_scale=splat_scale)
    return _maybe_direct(scene, meta, cfg, img, device), film


def _maybe_direct(scene, meta, cfg, img, device):
    if cfg.direct_separate:
        from .render import render
        img_d, _ = render(scene, meta, integ.IntegratorConfig(kind="direct", max_depth=0,
                                                              light_strategy="all"),
                          spp=8, device=device)
        img = img + img_d
    return img
