"""Plain vector math, the pinhole camera and brute-force ray casting for the
reference renderer. Every float tensor is in the caller's dtype `dt`."""
from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
BIG_T = 3.0e37          # a miss's t
RAY_TMAX = 1.0e7        # a live ray's extent


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(v):
    return v * torch.rsqrt(torch.clamp_min(dot(v, v), 1e-30))[..., None]


def frame_of(n):
    """Two unit vectors completing unit n to an orthonormal basis (Duff et
    al.'s branch-free construction)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + z)
    b = x * y * a
    return (torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], dim=-1),
            torch.stack([b, sign + y * y * a, -y], dim=-1))


# ------------------------------------------------------------------ camera
def look_at(pos, look, up):
    """Camera-to-world of pbrt's LookAt, in float64."""
    pos, look, up = (np.asarray(v, np.float64) for v in (pos, look, up))
    d = (look - pos) / np.linalg.norm(look - pos)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, np.cross(d, right), d, pos
    return m


def raster_to_camera(xres, yres, fov, near=1e-2, far=1000.0):
    """pbrt's perspective camera: raster -> screen -> camera, in float64."""
    aspect = xres / yres
    x0, x1, y0, y1 = ((-aspect, aspect, -1.0, 1.0) if aspect > 1.0
                      else (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect))
    screen_to_raster = (np.diag([xres, yres, 1.0, 1.0])
                        @ np.diag([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0, 1.0]))
    screen_to_raster[:2, 3] = screen_to_raster[:2, :2] @ np.array([-x0, -y1])
    inv_tan = 1.0 / math.tan(math.radians(fov) / 2.0)
    persp = np.array([[inv_tan, 0, 0, 0], [0, inv_tan, 0, 0],
                      [0, 0, far / (far - near), -far * near / (far - near)],
                      [0, 0, 1, 0]])
    return np.linalg.inv(screen_to_raster @ persp)


class Camera:
    def __init__(self, desc, xres, yres, device, dt):
        c2w = look_at(desc["pos"], desc["look"], desc["up"])
        r2c = raster_to_camera(xres, yres, desc["fov"])
        self.r2c = torch.tensor(r2c.astype(np.float32), device=device).to(dt)
        self.c2w = torch.tensor(c2w.astype(np.float32), device=device).to(dt)

    def rays(self, fx, fy):
        """World rays through continuous raster points (fx, fy)."""
        m = self.r2c
        p = [m[i, 0] * fx + m[i, 1] * fy + m[i, 3] for i in range(4)]
        d = normalize(torch.stack([p[0] / p[3], p[1] / p[3], p[2] / p[3]], dim=-1))
        c = self.c2w
        dw = normalize(torch.stack([c[i, 0] * d[..., 0] + c[i, 1] * d[..., 1]
                                    + c[i, 2] * d[..., 2] for i in range(3)], dim=-1))
        return c[:3, 3].expand(dw.shape), dw


# ------------------------------------------------------------- ray casting
def _pairs(o, d, v0, e1, e2):
    """Moller-Trumbore over every (ray, triangle) pair: (b1, b2, t, ok)."""
    s1 = cross(d[:, None, :], e2[None])
    div = dot(s1, e1[None])
    inv = 1.0 / torch.where(div == 0.0, 1.0, div)
    s = o[:, None, :] - v0[None]
    b1 = dot(s, s1) * inv
    s2 = cross(s, e1[None])
    b2 = dot(d[:, None, :], s2) * inv
    t = dot(e2[None], s2) * inv
    ok = (div != 0.0) & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    return b1, b2, t, ok


def _chunks(n_rays, n_tris, budget=1 << 25):
    rays = max(1, min(n_rays, budget // max(n_tris, 1)))
    tris = max(1, min(n_tris, budget // rays))
    return rays, tris


def closest_hit(tri, o, d, tmax):
    """The nearest hit in (0, tmax) of each ray over all triangles, the lower
    index among equal t. Returns (t, prim, b1, b2): BIG_T, -1, 0, 0 on a miss."""
    v0, e1, e2 = tri
    n, nt = o.shape[0], v0.shape[0]
    t_out = torch.full((n,), BIG_T, dtype=o.dtype, device=o.device)
    prim = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    b1_out = torch.zeros_like(t_out)
    b2_out = torch.zeros_like(t_out)
    live = torch.nonzero(tmax > 0.0)[:, 0]
    cr, ct = _chunks(live.numel(), nt)
    for a in range(0, live.numel(), cr):
        idx = live[a:a + cr]
        ro, rd, rt = o[idx], d[idx], tmax[idx]
        best = torch.full((idx.numel(),), BIG_T, dtype=o.dtype, device=o.device)
        bp = torch.full((idx.numel(),), -1, dtype=torch.int64, device=o.device)
        bb1 = torch.zeros_like(best)
        bb2 = torch.zeros_like(best)
        for c in range(0, nt, ct):
            b1, b2, t, ok = _pairs(ro, rd, v0[c:c + ct], e1[c:c + ct], e2[c:c + ct])
            ok = ok & (t > 0.0) & (t < rt[:, None])
            tm = torch.where(ok, t, torch.inf)
            k = torch.argmin(tm, dim=1)
            tk = tm.gather(1, k[:, None])[:, 0]
            better = tk < best
            best = torch.where(better, tk, best)
            bp = torch.where(better, k + c, bp)
            bb1 = torch.where(better, b1.gather(1, k[:, None])[:, 0], bb1)
            bb2 = torch.where(better, b2.gather(1, k[:, None])[:, 0], bb2)
        t_out[idx] = best
        prim[idx] = bp
        b1_out[idx] = bb1
        b2_out[idx] = bb2
    return t_out, prim, b1_out, b2_out


def occluded(tri, o, d, tmax):
    """Whether anything lies in (0, tmax) along each ray."""
    v0, e1, e2 = tri
    n, nt = o.shape[0], v0.shape[0]
    out = torch.zeros((n,), dtype=torch.bool, device=o.device)
    live = torch.nonzero(tmax > 0.0)[:, 0]
    cr, ct = _chunks(live.numel(), nt)
    for a in range(0, live.numel(), cr):
        idx = live[a:a + cr]
        ro, rd, rt = o[idx], d[idx], tmax[idx]
        hit = torch.zeros((idx.numel(),), dtype=torch.bool, device=o.device)
        for c in range(0, nt, ct):
            _, _, t, ok = _pairs(ro, rd, v0[c:c + ct], e1[c:c + ct], e2[c:c + ct])
            hit = hit | torch.any(ok & (t > 0.0) & (t < rt[:, None]), dim=1)
        out[idx] = hit
    return out
