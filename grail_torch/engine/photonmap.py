"""Photon mapping (port of grail/engine/photonmap.py; pbrt
src/integrators/photonmap.{h,cpp}) as the reference reshapes it for a
wavefront.

Shooting: n_paths light paths (engine/igi.py's light pick and emission
sample, BSDF-sampled continuations with Russian roulette), each leaving a
photon {p, alpha, wi} at every non-specular hit after the first, caustic
where every earlier bounce was specular; the closest hits are
"photon_shoot" waves. The photons live in fixed-capacity arrays with a
validity mask (depth-major), sorted by the id of their cell in a uniform
grid of cell edge `radius` (a stable sort: a query reads the first
max_per_cell photons of a cell in that order).

Lookup: a query scans the 27 cells about its point, the first
max_per_cell photons of each, a cell at a time (the reference loops over
the photons of a cell too, a fori_loop; the port shades a cell's photons
together and adds them in the same order). The density-estimate radius shrinks to the nlookup-th nearest
photon's, read from a knn_bins-bin histogram of squared distances, and the
estimate takes pbrt's Simpson kernel. Li is direct lighting, the caustic
estimate at the first hit, and a final gather of two strategies (a BSDF
sample and a cone about a nearby indirect photon's direction, combined by
the power heuristic), each gather ray a "final_gather" wave whose hit is
shaded by the indirect map. shoot_photons_sharded splits the shoot over the
ranks of a dist/sharding.py Mesh: each shoots its slice of the counter
stream, and the gathered photons, laid out depth-major again, give the
replicated shoot's grid bitwise.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import telemetry
from ..core import montecarlo as mc
from ..core import rng as rngmod
from ..core.vecmath import PI, absdot, cross, normalize
from ..shade import bsdf as bx
from ..shade import geometry as geom
from ..shade import lights as lt
from . import integrator as integ
from .igi import light_path_continue, light_path_vertex, light_paths_start

_PH_DIM = 70000
_RES = 1024          # cells an axis in the id packing (the grid itself is virtual)
_INVALID_CELL = 2 ** 30


@dataclasses.dataclass(frozen=True)
class PhotonConfig:
    n_paths: int = 4096           # light paths to shoot
    max_depth: int = 5
    radius: float = 0.15          # search radius cap (pbrt "maxdist")
    max_per_cell: int = 16        # photons examined per grid cell
    final_gather: bool = True
    gather_samples: int = 1       # read by nothing, as in the reference
    nlookup: int = 32             # pbrt "nlookup": the k of the k-NN radius
    knn_bins: int = 16
    n_sample_dirs: int = 8        # photon directions gathered a point
    cos_gather_angle: float = 0.9848077  # cos(10 degrees)


@telemetry.spanned("photon_shoot")
def _shoot_block(scene, meta, cfg: PhotonConfig, samp0, count, seed=0):
    """Trace `count` light paths with sample indices samp0 .. samp0+count-1;
    returns the raw depth-major photon arrays."""
    device = scene["verts"].device
    pix = torch.full((count,), 0xC0FFEE ^ seed, dtype=torch.int64, device=device)
    samp = samp0 + torch.arange(count, dtype=torch.int64, device=device)
    o, d, throughput = light_paths_start(scene, meta, pix, samp, _PH_DIM, cfg.n_paths)
    active = torch.any(throughput > 0, dim=-1)
    specular_only = torch.ones(count, dtype=torch.bool, device=device)
    pts, alphas, wis, valid, caustic = [], [], [], [], []
    for depth in range(cfg.max_depth):
        live, sg, lobes, wo_l = light_path_vertex(scene, meta, o, d, active, "photon_shoot")
        # the first hit is direct lighting's: no photon there
        dep = live & (bx.bsdf_num_components(lobes, include_specular=False) > 0) & (depth > 0)
        pts.append(sg["p"])
        alphas.append(torch.where(dep[..., None], throughput, 0.0))
        wis.append(-d)
        valid.append(dep)
        caustic.append(dep & specular_only)
        bs, wi_w, throughput, survive = light_path_continue(
            meta, pix, samp, _PH_DIM + 10 + depth * 4, sg, lobes, wo_l, throughput)
        specular_only = specular_only & bs["specular"]
        active = live & bs["valid"] & survive
        o = sg["p"] + wi_w * sg["ray_eps"][..., None]
        d = wi_w
    return {"p": torch.cat(pts), "alpha": torch.cat(alphas), "wi": torch.cat(wis),
            "valid": torch.cat(valid), "caustic": torch.cat(caustic)}


def shoot_photons(scene, meta, cfg: PhotonConfig, seed=0):
    """Shoot every path and return the photon grid."""
    return build_photon_grid(_shoot_block(scene, meta, cfg, 0, cfg.n_paths, seed), cfg)


def gather_photons(scene, meta, cfg: PhotonConfig, mesh, seed=0):
    """The raw photons of every path, shot over the ranks: rank k traces
    paths [k*per, (k+1)*per) and the blocks, all-gathered, are laid out
    depth-major, (max_depth, rank, per), as _shoot_block(0, n_paths) lays
    them out. Requires n_paths divisible by the world size."""
    n_dev = mesh.world_size
    if cfg.n_paths % n_dev:
        raise ValueError(f"n_paths={cfg.n_paths} must divide over {n_dev} ranks")
    per = cfg.n_paths // n_dev
    block = _shoot_block(scene, meta, cfg, mesh.rank * per, per, seed)

    def regather(x):
        g = mesh.all_gather(x).reshape((n_dev, cfg.max_depth, per) + x.shape[1:])
        return g.transpose(0, 1).reshape((cfg.max_depth * n_dev * per,) + x.shape[1:])

    return {k: regather(v) for k, v in block.items()}


def shoot_photons_sharded(scene, meta, cfg: PhotonConfig, mesh, seed=0):
    """The photon grid, shot over the ranks of `mesh` (gather_photons): the
    same on every rank, and bitwise the replicated shoot_photons'."""
    return build_photon_grid(gather_photons(scene, meta, cfg, mesh, seed), cfg)


def _cell_of(p, radius):
    """The integer cell of each point, int32."""
    return torch.floor(p / radius).to(torch.int32)


def _cell_id(cell):
    """The packed id of int32 cells (..., 3), each axis masked to 10 bits
    in int32 two's-complement arithmetic."""
    cell = cell & (_RES - 1)
    return (cell[..., 0] * _RES + cell[..., 1]) * _RES + cell[..., 2]


@telemetry.spanned("photon_grid")
def build_photon_grid(photons, cfg):
    """Photons sorted by cell id (stable; invalid photons last, with id
    2^30 and their fields zeroed)."""
    ok = photons["valid"]
    cid = torch.where(ok, _cell_id(_cell_of(photons["p"], cfg.radius)), _INVALID_CELL)
    order = torch.argsort(cid, stable=True)

    def z3(a):
        return torch.where(ok[..., None], a, 0.0)[order]
    return {"p": z3(photons["p"]), "alpha": z3(photons["alpha"]), "wi": z3(photons["wi"]),
            "valid": ok[order], "caustic": (photons["caustic"] & ok)[order],
            "cid": cid[order]}


@telemetry.spanned("photon_scan")
def _neighbor_scan(cfg, pmap, p, use_caustic, active, fn, carry):
    """Fold fn(carry, idx, ok, d2) over the 27 cells about each lane's point
    p (N,3), a cell at a time: idx, ok and d2 are (N, max_per_cell), the
    cell's first photons in sorted order, and each fn folds that axis in
    order, as the reference's loop over them does."""
    r2 = cfg.radius * cfg.radius
    base = _cell_of(p, cfg.radius)
    cid_sorted = pmap["cid"].to(torch.int64)
    last = cid_sorted.shape[0] - 1
    kind = pmap["caustic"] if use_caustic else ~pmap["caustic"]
    usable = pmap["valid"] & kind
    ks = torch.arange(cfg.max_per_cell, device=p.device)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                off = torch.tensor([ox, oy, oz], dtype=torch.int32, device=p.device)
                cid = _cell_id(base + off).to(torch.int64)
                start = torch.searchsorted(cid_sorted, cid)
                end = torch.minimum(torch.searchsorted(cid_sorted, cid, right=True),
                                    start + cfg.max_per_cell)
                slot = start[:, None] + ks
                idx = torch.clamp_max(slot, last)
                ok = (slot < end[:, None]) & usable[idx] & active[:, None]
                diff = pmap["p"][idx] - p[:, None, :]
                d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
                carry = fn(carry, idx, ok & (d2 < r2), d2)
    return carry


def knn_radius2(cfg, pmap, p, use_caustic, active):
    """The squared k-NN radius (pbrt LookupProc: maxdist^2 shrinks to the
    nlookup-th nearest photon's), read from a knn_bins-bin histogram of d^2:
    the upper edge of the first bin where the running count reaches
    nlookup, or the full radius when fewer photons are in range."""
    r2 = cfg.radius * cfg.radius
    B = cfg.knn_bins
    bins = torch.arange(B, dtype=torch.int32, device=p.device)

    def acc(hist, idx, ok, d2):
        # whole counts: the order of the sum does not matter
        b = torch.clamp_max((d2 / r2 * B).to(torch.int32), B - 1)
        return hist + torch.sum((b[..., None] == bins) & ok[..., None], dim=1,
                                dtype=torch.float32)

    hist = _neighbor_scan(cfg, pmap, p, use_caustic, active, acc,
                          p.new_zeros((p.shape[0], B)))
    reach = torch.cumsum(hist, dim=-1) >= cfg.nlookup
    kbin = torch.argmax(reach.to(torch.int32), dim=-1)      # the first bin reaching k
    rk2 = (kbin + 1).to(torch.float32) / B * r2
    return torch.where(torch.any(reach, dim=-1), rk2, r2)


def radiance_estimate(meta, cfg, pmap, sg, lobes, wo_local, use_caustic, active):
    """The photon density estimate over the 27 cells: with nlookup > 0 the
    k-NN radius and the Simpson kernel 3/(pi r^2) (1 - d^2/r^2)^2, else the
    fixed-radius box kernel. Only a cell's photons within the radius are
    shaded (the others add zero); they are added in scan order."""
    p = sg["p"]
    if cfg.nlookup > 0:
        rk2 = knn_radius2(cfg, pmap, p, use_caustic, active)
    else:
        rk2 = torch.full(p.shape[:1], cfg.radius * cfg.radius, device=p.device)

    def acc(L, idx, ok, d2):
        lane, slot = torch.nonzero(ok & (d2 < rk2[:, None]), as_tuple=True)
        C = p.new_zeros(idx.shape + (3,))
        if lane.numel():
            d2s, rk = d2[lane, slot], rk2[lane]
            if cfg.nlookup > 0:
                s = 1.0 - d2s / torch.clamp_min(rk, 1e-12)
                kern = 3.0 / (PI * torch.clamp_min(rk, 1e-12)) * s * s
            else:
                kern = torch.full_like(d2s, 1.0 / (PI * cfg.radius * cfg.radius))
            ph = idx[lane, slot]
            frame = {k: sg[k][lane] for k in ("ss", "ts", "ns")}
            f = bx.bsdf_f({k: v[lane] for k, v in lobes.items()}, wo_local[lane],
                          geom.world_to_local(frame, pmap["wi"][ph]), meta.lobe_types,
                          include_specular=False)
            C[lane, slot] = f * pmap["alpha"][ph] * kern[..., None]
        for k in range(idx.shape[1]):
            L = L + C[:, k]
        return L

    return _neighbor_scan(cfg, pmap, p, use_caustic, active, acc, p.new_zeros(p.shape))


def gather_photon_dirs(cfg, pmap, p, active):
    """The incident directions of up to n_sample_dirs nearby indirect
    photons a point, in scan order: (dirs (N,K,3), count (N,) int32)."""
    K = cfg.n_sample_dirs
    slots = torch.arange(K, dtype=torch.int32, device=p.device)

    def acc(carry, idx, ok, d2):
        dirs, cnt = carry
        wi = pmap["wi"][idx]
        for k in range(idx.shape[1]):
            take = ok[:, k] & (cnt < K)
            into = (slots == torch.clamp_max(cnt, K - 1)[..., None]) & take[..., None]
            dirs = torch.where(into[..., None], dirs + wi[:, k, None, :], dirs)
            cnt = cnt + take.to(torch.int32)
        return dirs, cnt

    n = p.shape[0]
    return _neighbor_scan(cfg, pmap, p, False, active, acc,
                          (p.new_zeros((n, K, 3)),
                           torch.zeros(n, dtype=torch.int32, device=p.device)))


def photon_pdf(cfg, dirs, cnt, w):
    """The photon-direction strategy's pdf at w: the average of the cones'
    uniform pdfs over the gathered directions."""
    cone_pdf = 1.0 / (2.0 * PI * (1.0 - cfg.cos_gather_angle))
    cos = (dirs[..., 0] * w[:, None, 0] + dirs[..., 1] * w[:, None, 1]
           + dirs[..., 2] * w[:, None, 2])
    slot_ok = torch.arange(dirs.shape[1], device=w.device)[None, :] < cnt[:, None]
    hits = torch.sum(((cos > cfg.cos_gather_angle) & slot_ok).to(torch.float32), dim=-1)
    return torch.where(cnt > 0, hits * cone_pdf / torch.clamp_min(cnt.to(torch.float32), 1.0),
                       0.0)


def sample_photon_dir(cfg, dirs, cnt, u_pick, u1, u2):
    """A gathered direction picked by u_pick, then a uniform direction in
    its cone. Returns (w, cnt > 0)."""
    j = torch.minimum((u_pick * torch.clamp_min(cnt, 1).to(torch.float32)).to(torch.int32),
                      torch.clamp_min(cnt - 1, 0))
    axis = normalize(dirs[torch.arange(dirs.shape[0], device=dirs.device), j.to(torch.int64)])
    costheta = 1.0 - u1 * (1.0 - cfg.cos_gather_angle)
    sintheta = torch.sqrt(torch.clamp_min(1.0 - costheta * costheta, 0.0))
    phi = 2.0 * PI * u2
    up = torch.where(torch.abs(axis[..., 2:3]) < 0.9, axis.new_tensor([0.0, 0.0, 1.0]),
                     axis.new_tensor([1.0, 0.0, 0.0]))
    t1 = normalize(cross(up, axis))
    t2 = cross(axis, t1)
    w = (t1 * (sintheta * torch.cos(phi))[..., None]
         + t2 * (sintheta * torch.sin(phi))[..., None] + axis * costheta[..., None])
    return w, cnt > 0


def photon_li(scene, meta, cfg: PhotonConfig, icfg, rays, pix, samp, pmap):
    """PhotonIntegrator::Li: emission, direct lighting, the caustic estimate
    at the first hit, and the two-strategy final gather (or, without it,
    the indirect estimate at the first hit). Returns L (N,3) times the ray
    weight."""
    o, d = rays["o"], rays["d"]
    n = o.shape[0]
    hit = integ._trace(scene, o, d, o.new_full((n,), integ.BIG), role="camera")
    active = hit["prim"] >= 0
    L = torch.where((~active)[..., None], lt.escaped_radiance(scene, d, meta.light_types),
                    0.0)
    sg, lobes, wo_local = integ._shade_context(scene, meta, hit, o, d)
    if lt.AREA in meta.light_types:
        L = L + torch.where(active[..., None], lt.area_light_emitted(scene, sg, -d), 0.0)
    if meta.n_lights > 0:
        lidx, pmf = integ._pick_light(scene, meta, icfg, pix, samp, 0)
        Ld = integ.estimate_direct(
            scene, meta, sg, lobes, wo_local, lidx, pmf,
            rngmod.sample_2d(meta.sampler, pix, samp, _PH_DIM + 100),
            rngmod.sample_1d(meta.sampler, pix, samp, _PH_DIM + 101),
            rngmod.sample_1d(meta.sampler, pix, samp, _PH_DIM + 102),
            rngmod.sample_2d(meta.sampler, pix, samp, _PH_DIM + 103), active)
        L = L + torch.where(active[..., None], Ld, 0.0)
    L = L + torch.where(active[..., None],
                        radiance_estimate(meta, cfg, pmap, sg, lobes, wo_local, True, active),
                        0.0)
    if not cfg.final_gather:
        L = L + torch.where(active[..., None], radiance_estimate(
            meta, cfg, pmap, sg, lobes, wo_local, False, active), 0.0)
        return L * rays["weight"][..., None]

    tables = scene.get("brdf_tables", ())
    pdirs, pcnt = gather_photon_dirs(cfg, pmap, sg["p"], active)

    def gather_ray(w_world, pdf, strat_active):
        o2 = sg["p"] + w_world * sg["ray_eps"][..., None]
        ghit = integ._trace(scene, o2, w_world, torch.where(strat_active, integ.BIG, 0.0),
                            role="final_gather")
        gactive = strat_active & (ghit["prim"] >= 0)
        sg2, lobes2, wo2 = integ._shade_context(scene, meta, ghit, o2, w_world)
        Lg = radiance_estimate(meta, cfg, pmap, sg2, lobes2, wo2, False, gactive)
        f = bx.bsdf_f(lobes, wo_local, geom.world_to_local(sg, w_world), meta.lobe_types,
                      False, tables=tables)
        est = f * Lg * (absdot(w_world, sg["ns"]) / torch.clamp_min(pdf, 1e-9))[..., None]
        return torch.where(gactive[..., None], est, 0.0)

    # strategy A: a BSDF sample, weighted against the photon strategy's pdf
    # (weight 1 where no photon direction was gathered)
    uA = rngmod.sample_2d(meta.sampler, pix, samp, _PH_DIM + 110)
    uAc = rngmod.sample_1d(meta.sampler, pix, samp, _PH_DIM + 112)
    bs = bx.bsdf_sample(lobes, wo_local, uA[0], uA[1], uAc, meta.lobe_types,
                        include_specular=False, tables=tables)
    wA = geom.local_to_world(sg, bs["wi"])
    actA = active & bs["valid"] & (bs["pdf"] > 0.0)
    wMISA = torch.where(pcnt > 0, mc.power_heuristic(1.0, bs["pdf"], 1.0,
                                                     photon_pdf(cfg, pdirs, pcnt, wA)), 1.0)
    L = L + wMISA[..., None] * gather_ray(wA, bs["pdf"], actA)

    # strategy B: a cone about a gathered photon direction
    uB = rngmod.sample_2d(meta.sampler, pix, samp, _PH_DIM + 113)
    uBp = rngmod.sample_1d(meta.sampler, pix, samp, _PH_DIM + 115)
    wB, okB = sample_photon_dir(cfg, pdirs, pcnt, uBp, uB[0], uB[1])
    pdfB = photon_pdf(cfg, pdirs, pcnt, wB)
    actB = active & okB & (pdfB > 0.0)
    pdfB_bsdf = bx.bsdf_pdf(lobes, wo_local, geom.world_to_local(sg, wB), meta.lobe_types,
                            include_specular=False)
    wMISB = mc.power_heuristic(1.0, pdfB, 1.0, pdfB_bsdf)
    L = L + wMISB[..., None] * gather_ray(wB, pdfB, actB)
    return L * rays["weight"][..., None]
