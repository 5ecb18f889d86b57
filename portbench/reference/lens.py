"""The thin-lens, moving camera of pbrt-v2, worked out again in plain PyTorch
for the reference renderer (it imports nothing of the system).

- Thin lens (src/cameras/perspective.cpp, PerspectiveCamera::GenerateRay):
  the ray through the raster point leaves the camera-space origin; where the
  lens radius is above 0, ConcentricSampleDisk (src/core/montecarlo.cpp) maps
  the lens draw to a point on the disk, scaled by the radius, and the ray
  leaves that point towards where the pinhole ray meets the plane of focus,
  at focal_distance / d.z along it.
- Moving camera (src/core/transform.cpp, AnimatedTransform): each pose's
  camera-to-world M is decomposed on the host, in float64, into its
  translation T and the polar decomposition of its upper 3x3, M = R S, by
  SVD (M = U W V^T gives R = U V^T, S = V W V^T: the factors that pbrt's
  averaging iteration converges to); R becomes a quaternion. At time
  t = lerp(time draw, open, close), T and S are lerped and R slerped (pbrt's
  Slerp, linear above a cosine of 0.9995), and the ray is carried by the
  matrix T R(t) S(t).
- The draws are the system's sampler slots 1 (the lens, 2D) and 2 (the
  time), which the reference's bounce layout (from slot 4) leaves free. The
  differential rays one pixel over in x and in y take the same lens point
  and time (GenerateRayDifferential).

The camera description: "pos0", "pos1" (the poses at shutter open and
close), "look", "up", "fov", "lens_radius", "focal_distance", "shutter".
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import look_at, normalize, raster_to_camera
from .render import Scene

SLOT_LENS, SLOT_TIME = 1, 2
SLERP_LINEAR_COS = 0.9995


def concentric_sample_disk(u1, u2):
    """pbrt-v2's ConcentricSampleDisk: the square's four wedges, by region."""
    sx, sy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    upper = sx >= -sy
    right = sx > sy
    left = sx <= sy
    r = torch.where(upper, torch.where(right, sx, sy), torch.where(left, -sx, -sy))
    rs = torch.where(r == 0.0, torch.ones_like(r), r)
    theta = torch.where(
        upper,
        torch.where(right, torch.where(sy > 0.0, sy / rs, 8.0 + sy / rs), 2.0 - sx / rs),
        torch.where(left, 4.0 - sy / rs, 6.0 + sx / rs))
    theta = theta * (math.pi / 4.0)
    zero = (sx == 0.0) & (sy == 0.0)
    return (torch.where(zero, 0.0, r * torch.cos(theta)),
            torch.where(zero, 0.0, r * torch.sin(theta)))


def decompose(m):
    """(T, quaternion [x, y, z, w] of R, S) of a 4x4 camera-to-world, float64."""
    m = np.asarray(m, np.float64)
    u, w, vt = np.linalg.svd(m[:3, :3])
    r = u @ vt
    s = vt.T @ np.diag(w) @ vt
    return m[:3, 3].copy(), quat_of(r), s


def quat_of(r):
    """The unit quaternion of a rotation matrix (Shoemake's)."""
    tr = r[0, 0] + r[1, 1] + r[2, 2]
    if tr > 0.0:
        s = math.sqrt(tr + 1.0) * 2.0
        q = [(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s, s / 4.0]
    else:
        i = int(np.argmax([r[0, 0], r[1, 1], r[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k]) * 2.0
        q = [0.0, 0.0, 0.0, (r[k, j] - r[j, k]) / s]
        q[i] = s / 4.0
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
    return np.asarray(q, np.float64)


def quat_matrix(q):
    """(N, 3, 3) rotation matrices of unit quaternions q (N, 4) [x, y, z, w]."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def slerp(t, q0, q1):
    """pbrt's Slerp at times t (N,) between unit quaternions q0, q1 (4,), q1's
    sign chosen for the shorter arc (as pbrt-v3's AnimatedTransform does):
    linear and renormalised above a cosine of 0.9995, else along the arc
    from q0 towards the unit quaternion perpendicular to it."""
    cos = float((q0 * q1).sum())
    if cos < 0.0:
        q1, cos = -q1, -cos
    t = t[:, None]
    if cos > SLERP_LINEAR_COS:
        return normalize4((1.0 - t) * q0 + t * q1)
    theta = math.acos(min(cos, 1.0))
    perp = normalize4((q1 - q0 * cos)[None])
    return q0 * torch.cos(theta * t) + perp * torch.sin(theta * t)


def normalize4(q):
    return q * torch.rsqrt((q * q).sum(-1, keepdim=True))


class LensCamera:
    """The thin-lens, moving perspective camera. `draws` holds each lane's
    (lens u1, lens u2, time draw), set before the lanes' rays are made."""

    def __init__(self, desc, xres, yres, device, dt):
        self.lens_radius = float(desc["lens_radius"])
        self.focal_distance = float(desc["focal_distance"])
        self.shutter = tuple(float(s) for s in desc["shutter"])
        r2c = raster_to_camera(xres, yres, desc["fov"])
        self.r2c = torch.tensor(r2c.astype(np.float32), device=device).to(dt)
        poses = [decompose(look_at(desc[k], desc["look"], desc["up"])) for k in ("pos0", "pos1")]

        def tens(a):
            return torch.tensor(np.asarray(a, np.float32), device=device).to(dt)

        self.t = [tens(p[0]) for p in poses]
        self.q = [tens(p[1]) for p in poses]
        self.s = [tens(p[2]) for p in poses]
        self.draws = None

    def rays(self, fx, fy):
        """World rays through continuous raster points (fx, fy) of the lanes
        whose draws are set."""
        u1, u2, ut = self.draws
        m = self.r2c
        p = [m[i, 0] * fx + m[i, 1] * fy + m[i, 3] for i in range(4)]
        d = normalize(torch.stack([p[0] / p[3], p[1] / p[3], p[2] / p[3]], dim=-1))
        o = torch.zeros_like(d)
        if self.lens_radius > 0.0:
            lx, ly = concentric_sample_disk(u1, u2)
            ft = self.focal_distance / d[..., 2]
            focus = ft[..., None] * d
            o = torch.stack([lx * self.lens_radius, ly * self.lens_radius,
                             torch.zeros_like(lx)], dim=-1)
            d = normalize(focus - o)
        t = (1.0 - ut) * self.shutter[0] + ut * self.shutter[1]
        tt = t[:, None, None]
        s = (1.0 - tt) * self.s[0] + tt * self.s[1]
        # R(t) S(t), and its products with o and d, by elementwise sums (no
        # matrix multiply, which the card may round to TF32)
        rs = (quat_matrix(slerp(t, self.q[0], self.q[1]))[..., None] * s[:, None]).sum(-2)
        ow = ((rs * o[:, None]).sum(-1)
              + (1.0 - t[:, None]) * self.t[0] + t[:, None] * self.t[1])
        return ow, normalize((rs * d[:, None]).sum(-1))


class LensScene(Scene):
    """The reference scene seen through the lens camera: before `li` runs,
    each lane's lens and time draws go to the camera."""

    def __init__(self, desc, device, dt=torch.float32, albedo=None):
        c = desc["camera"]
        # the base class makes a still pinhole at the open pose; it is replaced
        pinhole = {"pos": c["pos0"], "look": c["look"], "up": c["up"], "fov": c["fov"]}
        super().__init__(dict(desc, camera=pinhole), device, dt, albedo)
        self.camera = LensCamera(c, self.xres, self.yres, device, dt)

    def li(self, pix, samp, kind="path", max_depth=5, rr_depth=3):
        u1, u2 = self.sampler.get2d(pix, samp, SLOT_LENS)
        self.camera.draws = (u1, u2, self.sampler.get1d(pix, samp, SLOT_TIME))
        return super().li(pix, samp, kind, max_depth, rr_depth)
