"""The plain reference renderer: the same estimators as the system under test,
written again lane by lane in plain PyTorch over brute-force ray casting, from
the scene description the benchmark made (it imports nothing of the system).

A scene description (a configuration's `reference_scene`) is a dict of numpy
arrays and plain values:

- "meshes": [{"verts" (V, 3), "idx" (T, 3), "uvs" (V, 2) or None,
  "material": name, "emit": rgb or None}], world-space triangles; a mesh with
  "emit" is one diffuse area light;
- "materials": {name: [lobe, ...]}, a lobe {"kind": "lambert", "kd": rgb or
  {"image": name, "su": .., "sv": ..}} or {"kind": "blinn", "ks": rgb,
  "roughness": r, "ior": eta} (exponent 1/roughness, dielectric Fresnel);
- "images": {name: (H, W, 3)}; "env_map": (H, W, 3) or absent;
- "camera": {"pos", "look", "up", "fov"}; "xres", "yres"; "seed".

Sampler dimensions: the film offset is slot 0; bounce b's draws start at
4 + 8·b (light choice, light position (2D), light triangle, BSDF component,
BSDF direction (2D), Russian roulette, the direct kind's BSDF-branch component
and direction (2D)); light row r of the "all" strategy adds 100·r.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import (Camera, RAY_TMAX, closest_hit, cross, dot, frame_of,
                       normalize, occluded)
from .sampler import Sampler
from .shading import (BLINN, LAMBERT, AreaLight, Bsdf, EnvLight, ewa, bilinear,
                      luminance, power_heuristic, pyramid)

SLOT_FILM, BOUNCE_BASE, BOUNCE_STRIDE, LIGHT_STRIDE = 0, 4, 8, 100
D_LIGHT_POS, D_LIGHT_TRI, D_COMP, D_DIR, D_RR, D_MIS_COMP, D_MIS_DIR = 1, 2, 3, 4, 5, 6, 7


class Scene:
    """The description's tensors on `device` in float type `dt`. albedo:
    optional {material: (3,) tensor} overriding a Lambertian lobe's constant
    kd (the training cell's parameters, which may require grad)."""

    def __init__(self, desc, device, dt=torch.float32, albedo=None):
        self.dt, self.device = dt, device
        self.xres, self.yres = desc["xres"], desc["yres"]
        self.sampler = Sampler(desc["seed"], dt)
        self.camera = Camera(desc["camera"], self.xres, self.yres, device, dt)

        def tens(a):
            return torch.as_tensor(a, device=device).to(dt)

        names = list(desc["materials"])
        verts, idx, uvs, has_uv, mat, light_tri = [], [], [], [], [], []
        base, lights = 0, []
        for m in desc["meshes"]:
            v = m["verts"]
            verts.append(v)
            idx.append(m["idx"] + base)
            uvs.append(m["uvs"] if m.get("uvs") is not None else v[:, :2] * 0)
            nt = len(m["idx"])
            has_uv.append(torch.full((nt,), m.get("uvs") is not None))
            mat.append(torch.full((nt,), names.index(m["material"])))
            light_tri.append(torch.full((nt,), m.get("emit") is not None))
            if m.get("emit") is not None:
                tv = tens(v[m["idx"]])
                lights.append(AreaLight(tv[:, 0], tv[:, 1], tv[:, 2], tens(m["emit"])))
            base += len(v)
        vt = tens(np.concatenate(verts))
        self.idx = torch.as_tensor(np.concatenate(idx), device=device)
        self.uv = tens(np.concatenate(uvs))
        self.has_uv = torch.cat(has_uv).to(device)
        self.mat = torch.cat(mat).to(device)
        self.is_light = torch.cat(light_tri).to(device)
        v0, v1, v2 = (vt[self.idx[:, k]] for k in range(3))
        self.tri = (v0, v1 - v0, v2 - v0)
        if len(lights) > 1:
            raise ValueError("the reference takes at most one area light")
        self.area = lights[0] if lights else None
        self.env = (EnvLight(np.asarray(desc["env_map"], np.float32), tens([1.0, 1.0, 1.0]), dt)
                    if desc.get("env_map") is not None else None)
        self.images = {k: pyramid(tens(v)) for k, v in desc.get("images", {}).items()}

        # the lobe stack: one slot per lobe position, kinds by material
        self.materials = []
        for name in names:
            lobes = []
            for lb in desc["materials"][name]:
                if lb["kind"] == LAMBERT:
                    kd = lb["kd"]
                    if albedo is not None and name in albedo:
                        kd = albedo[name]
                    elif not isinstance(kd, dict):
                        kd = tens(kd)
                    lobes.append((LAMBERT, kd, None, None))
                else:
                    lobes.append((BLINN, tens(lb["ks"]), 1.0 / max(lb["roughness"], 1e-5),
                                  lb["ior"]))
            self.materials.append(lobes)
        self.n_slots = max(len(m) for m in self.materials)

    # ----------------------------------------------------------- shading
    def shade(self, o, d, t, prim, b1, b2, camdiff=None):
        """The hit's shading record: p, ng (= ns), the frame (ss, ts), uv,
        the material's Bsdf and the ray epsilon."""
        prim = torch.clamp_min(prim, 0)
        idx = self.idx[prim]
        v0, e1, e2 = (a[prim] for a in self.tri)
        ts = torch.clamp_max(t, RAY_TMAX)
        p = o + ts[..., None] * d
        ng = normalize(cross(e1, e2))
        has_uv = self.has_uv[prim]
        uv0, uv1, uv2 = (self.uv[idx[:, k]] for k in range(3))
        bb0 = (1.0 - b1 - b2)[..., None]
        uv = torch.where(has_uv[..., None], bb0 * uv0 + b1[..., None] * uv1 + b2[..., None] * uv2,
                         torch.stack([b1 + b2, b2], dim=-1))
        one, zero = torch.ones_like(b1), torch.zeros_like(b1)
        du1 = torch.where(has_uv, uv1[:, 0] - uv0[:, 0], one)
        du2 = torch.where(has_uv, uv2[:, 0] - uv0[:, 0], one)
        dv1 = torch.where(has_uv, uv1[:, 1] - uv0[:, 1], zero)
        dv2 = torch.where(has_uv, uv2[:, 1] - uv0[:, 1], one)
        det = du1 * dv2 - dv1 * du2
        degen = torch.abs(det) < 1e-12
        inv = 1.0 / torch.where(degen, 1.0, det)
        dpdu = (dv2[..., None] * e1 - dv1[..., None] * e2) * inv[..., None]
        dpdv = (-du2[..., None] * e1 + du1[..., None] * e2) * inv[..., None]
        f1, f2 = frame_of(ng)
        dpdu = torch.where(degen[..., None], f1, dpdu)
        dpdv = torch.where(degen[..., None], f2, dpdv)
        ss = normalize(dpdu - ng * dot(ng, dpdu)[..., None])
        bad = torch.abs(ss).sum(-1) < 1e-9
        ss = torch.where(bad[..., None], frame_of(ng)[0], ss)
        sg = {"p": p, "n": ng, "ss": ss, "ts": cross(ng, ss), "uv": uv, "dpdu": dpdu,
              "dpdv": dpdv, "eps": 1e-3 * ts, "mat": self.mat[prim],
              "light": self.is_light[prim]}
        if camdiff is not None:
            sg["duv"] = self._uv_differentials(sg, *camdiff)
        sg["bsdf"] = self._bsdf(sg)
        return sg

    def _uv_differentials(self, sg, rxo, rxd, ryo, ryd):
        p, n = sg["p"], sg["n"]
        dist = dot(n, p)

        def plane(o, d):
            den = dot(n, d)
            ok = torch.abs(den) >= 1e-9
            return o + ((dist - dot(n, o)) / torch.where(ok, den, 1.0))[..., None] * d, ok

        px, okx = plane(rxo, rxd)
        py, oky = plane(ryo, ryd)
        drop = torch.argmax(torch.abs(n), dim=-1)
        a0 = torch.where(drop == 0, 1, 0)[..., None]
        a1 = torch.where(drop == 2, 1, 2)[..., None]

        def pick(v, a):
            return torch.gather(v, -1, a)[..., 0]

        m00, m01 = pick(sg["dpdu"], a0), pick(sg["dpdv"], a0)
        m10, m11 = pick(sg["dpdu"], a1), pick(sg["dpdv"], a1)
        det = m00 * m11 - m01 * m10
        ok = torch.abs(det) >= 1e-12
        inv = 1.0 / torch.where(ok, det, 1.0)

        def solve(b, good):
            c0, c1 = pick(b, a0), pick(b, a1)
            du, dv = (m11 * c0 - m01 * c1) * inv, (m00 * c1 - m10 * c0) * inv
            good = good & ok
            return torch.where(good, du, 0.0), torch.where(good, dv, 0.0)

        return solve(px - p, okx) + solve(py - p, oky)

    def _texture(self, kd, sg):
        if not isinstance(kd, dict):
            return kd.expand(sg["p"].shape)
        s = kd["su"] * sg["uv"][:, 0]
        t = kd["sv"] * sg["uv"][:, 1]
        levels = self.images[kd["image"]]
        if "duv" not in sg:
            return bilinear(levels[0], s, t)
        dudx, dvdx, dudy, dvdy = sg["duv"]
        return ewa(levels, s, t, kd["su"] * dudx, kd["sv"] * dvdx, kd["su"] * dudy,
                   kd["sv"] * dvdy)

    def _bsdf(self, sg):
        n = sg["p"].shape[0]
        present = torch.zeros((n, self.n_slots), dtype=torch.bool, device=self.device)
        slots = []
        for k in range(self.n_slots):
            kind, R, e, eta = None, None, None, None
            for mi, lobes in enumerate(self.materials):
                if k >= len(lobes):
                    continue
                on = sg["mat"] == mi
                present[:, k] |= on
                lk, lR, le, leta = lobes[k]
                val = (self._texture(lR, sg) if lk == LAMBERT else lR.expand(sg["p"].shape))
                R = val if R is None else torch.where(on[..., None], val, R)
                if lk == BLINN:
                    e = torch.where(on, le, self._full(on, 0.0) if e is None else e)
                    eta = torch.where(on, leta, self._full(on, 1.0) if eta is None else eta)
                if kind is not None and kind != lk:
                    raise ValueError("the reference's lobe slots take one kind each")
                kind = lk
            slots.append((kind, R, e, eta))
        return Bsdf(slots, present)

    # ------------------------------------------------------------- helpers
    def _full(self, like, v):
        return torch.full(like.shape, v, dtype=self.dt, device=self.device)

    def _tmax(self, live, v=RAY_TMAX):
        return torch.where(live, self._full(live, v), self._full(live, 0.0))

    def draws(self, pix, samp, bounce, off, lrow=0, two=False):
        dim = BOUNCE_BASE + BOUNCE_STRIDE * bounce + off + LIGHT_STRIDE * lrow
        return (self.sampler.get2d if two else self.sampler.get1d)(pix, samp, dim)

    @staticmethod
    def to_local(sg, w):
        return torch.stack([dot(w, sg["ss"]), dot(w, sg["ts"]), dot(w, sg["n"])], dim=-1)

    @staticmethod
    def to_world(sg, w):
        return w[..., 0:1] * sg["ss"] + w[..., 1:2] * sg["ts"] + w[..., 2:3] * sg["n"]

    def light_sample(self, p, u_pos, u_tri):
        if self.area is not None:
            return self.area.sample(p, u_pos[0], u_pos[1], u_tri)
        return self.env.sample(p, u_pos[0], u_pos[1])

    # -------------------------------------------------------------- direct
    def direct(self, sg, wo, active, pix, samp, b, bsdf_branch):
        """One light's estimate with MIS (EstimateDirect): the light sample,
        and with bsdf_branch the BSDF sample traced to the light."""
        p, eps, bsdf, n = sg["p"], sg["eps"], sg["bsdf"], sg["n"]
        wi, rad, pdf, dist = self.light_sample(
            p, self.draws(pix, samp, b, D_LIGHT_POS, two=True),
            self.draws(pix, samp, b, D_LIGHT_TRI))
        wil = self.to_local(sg, wi)
        f = bsdf.f(wo, wil)
        cos = torch.abs(dot(wi, n))
        can = (active & (pdf > 0.0) & (cos > 0.0) & torch.any(rad > 0.0, -1)
               & torch.any(f > 0.0, -1))
        with torch.no_grad():
            blocked = occluded(self.tri, p + wi * eps[..., None], wi,
                               torch.where(can, dist - 2.0 * eps, 0.0))
        w = power_heuristic(pdf, bsdf.pdf(wo, wil).detach())
        Ld = torch.where((can & ~blocked)[..., None],
                         f * rad * (cos * w / torch.clamp_min(pdf, 1e-12).detach())[..., None],
                         0.0)
        if not bsdf_branch:
            return Ld
        uc = self.draws(pix, samp, b, D_MIS_COMP)
        u1, u2 = self.draws(pix, samp, b, D_MIS_DIR, two=True)
        bwi, bf, bpdf, valid = bsdf.sample(wo, u1, u2, uc)
        wiw = self.to_world(sg, bwi)
        cosb = torch.abs(dot(wiw, n))
        ok = active & valid & (bpdf > 0.0)
        with torch.no_grad():
            t2, prim2, _, _ = closest_hit(self.tri, p + wiw * eps[..., None], wiw,
                                          self._tmax(ok))
        if self.env is not None:
            hit = prim2 < 0
            lpdf = self.env.pdf(wiw)
            Li = self.env.radiance(wiw)
        else:
            hit = (prim2 >= 0) & self.is_light[torch.clamp_min(prim2, 0)]
            ng2 = normalize(cross(self.tri[1][torch.clamp_min(prim2, 0)],
                                  self.tri[2][torch.clamp_min(prim2, 0)]))
            cos_at = dot(ng2, -wiw)
            lpdf = self.area.pdf(torch.where(hit, t2, 0.0), cos_at)
            Li = torch.where((hit & (cos_at > 0.0))[..., None], self.area.emit, 0.0)
        wb = power_heuristic(bpdf.detach(), lpdf)
        return Ld + torch.where((ok & hit & (lpdf > 0.0))[..., None],
                                bf * Li * (cosb * wb / torch.clamp_min(bpdf, 1e-12).detach())[..., None],
                                0.0)

    # -------------------------------------------------------------- li
    def li(self, pix, samp, kind="path", max_depth=5, rr_depth=3):
        """Radiance of the camera sample (pix, samp) of each lane, and its raster
        position: (L (N, 3), sx, sy)."""
        px, py = (pix % self.xres), (pix // self.xres)
        ufx, ufy = self.sampler.get2d(pix, samp, SLOT_FILM)
        sx, sy = px.to(self.dt) + ufx, py.to(self.dt) + ufy
        o, d = self.camera.rays(sx, sy)
        camdiff = None
        if self.images:
            # the same sample one pixel over in x and in y
            camdiff = (self.camera.rays((px + 1).to(self.dt) + ufx, sy)
                       + self.camera.rays(sx, (py + 1).to(self.dt) + ufy))
        n = pix.shape[0]
        L = torch.zeros((n, 3), dtype=self.dt, device=self.device)
        beta = torch.ones_like(L)
        active = torch.ones((n,), dtype=torch.bool, device=self.device)
        spec = active.clone()
        pdf_prev = torch.ones((n,), dtype=self.dt, device=self.device)
        reuse = kind == "path"
        for b in range(max_depth + 1):
            if not bool(active.any()):
                break
            with torch.no_grad():
                t, prim, b1, b2 = closest_hit(self.tri, o, d,
                                              self._tmax(active))
            miss = prim < 0
            if self.env is not None:
                Le = self.env.radiance(d)
                if reuse:
                    w = torch.where(spec, 1.0, power_heuristic(pdf_prev, self.env.pdf(d)))
                    L = L + torch.where((active & miss)[..., None], beta * w[..., None] * Le, 0.0)
                else:
                    L = L + torch.where((active & miss & spec)[..., None], beta * Le, 0.0)
            active = active & ~miss
            sg = self.shade(o, d, t, prim, b1, b2, camdiff if b == 0 else None)
            wo = self.to_local(sg, -d)
            if self.area is not None:
                cos_at = dot(sg["n"], -d)
                on = sg["light"] & ~miss
                Le = torch.where((on & (cos_at > 0.0))[..., None], self.area.emit, 0.0)
                if reuse:
                    lp = self.area.pdf(torch.where(on, t, 0.0), cos_at)
                    w = torch.where(spec | ~on, 1.0, power_heuristic(pdf_prev, lp))
                    L = L + torch.where(active[..., None], beta * w[..., None] * Le, 0.0)
                else:
                    L = L + torch.where((active & spec)[..., None], beta * Le, 0.0)
            Ld = self.direct(sg, wo, active, pix, samp, b, bsdf_branch=not reuse)
            L = L + torch.where(active[..., None], beta * Ld, 0.0)

            u1, u2 = self.draws(pix, samp, b, D_DIR, two=True)
            wi, f, pdf, valid = sg["bsdf"].sample(wo, u1, u2, self.draws(pix, samp, b, D_COMP))
            wiw = self.to_world(sg, wi)
            ok = valid & torch.any(f != 0.0, dim=-1)
            if not reuse:
                break               # no specular lobe: nothing continues
            contrib = f * (torch.abs(dot(wiw, sg["n"]))
                           / torch.clamp_min(pdf, 1e-12).detach())[..., None]
            beta = torch.where(ok[..., None], beta * contrib, beta)
            active = active & ok
            spec = torch.zeros_like(active)
            pdf_prev = sg["bsdf"].pdf(wo, self.to_local(sg, wiw)).detach()
            q = (torch.clamp_max(luminance(beta.detach()), 0.5) if b >= rr_depth
                 else torch.ones_like(pdf_prev))
            active = active & (self.draws(pix, samp, b, D_RR) < q)
            beta = beta / torch.clamp_min(q, 1e-6).detach()[..., None]
            o = sg["p"] + wiw * sg["eps"][..., None]
            d = wiw
        L = torch.where(torch.any(~torch.isfinite(L), dim=-1)[..., None], 0.0, L)
        return L, sx, sy


def pixel_means(scene, pixels, samples, kind, max_depth, block=1 << 16):
    """Each pixel's mean over the sample indices `samples` (its box-filtered
    value on the film), float64 on the host; lanes in blocks of `block`."""
    dev = scene.device
    pix = torch.as_tensor(pixels, dtype=torch.int64, device=dev)
    s = torch.as_tensor(samples, dtype=torch.int64, device=dev)
    lanes_pix = pix.repeat_interleave(s.numel())
    lanes_samp = s.repeat(pix.numel())
    out = []
    with torch.no_grad():
        for a in range(0, lanes_pix.numel(), block):
            L, _, _ = scene.li(lanes_pix[a:a + block], lanes_samp[a:a + block], kind, max_depth)
            out.append(L.double().cpu())
    return torch.cat(out).reshape(pix.numel(), s.numel(), 3).mean(1).numpy()
