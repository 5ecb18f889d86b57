"""4x4 transforms and animated transforms (port of grail/core/transform.py).

Host-side constructors are numpy, kept as the reference has them so a scene
built here holds the same bits; device application is torch with explicit
arithmetic (fixed summation order on every device).
"""
from __future__ import annotations

import numpy as np
import torch

from .vecmath import cross


# --------------------------------------------------------------- host-side constructors
def identity():
    return np.eye(4, dtype=np.float32)


def translate(delta):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = delta
    return m


def scale(sx, sy, sz):
    return np.diag([sx, sy, sz, 1.0]).astype(np.float32)


def rotate_x(deg):
    t = np.radians(deg)
    c, s = np.cos(t), np.sin(t)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotate_y(deg):
    t = np.radians(deg)
    c, s = np.cos(t), np.sin(t)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotate(deg, axis):
    """Rotation about an arbitrary axis (pbrt transform.cpp Rotate)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    t = np.radians(deg)
    c, s = np.cos(t), np.sin(t)
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return m.astype(np.float32)


def look_at(pos, look, up):
    """world-from-camera matrix (pbrt transform.cpp LookAt)."""
    pos = np.asarray(pos, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - pos
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    nr = np.linalg.norm(right)
    if nr < 1e-10:
        raise ValueError("LookAt: up and view direction are parallel")
    right /= nr
    new_up = np.cross(d, right)
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = pos
    return m.astype(np.float32)


def orthographic(znear, zfar):
    """Orthographic camera-to-screen (pbrt transform.cpp Orthographic)."""
    m = np.eye(4, dtype=np.float32)
    m[2, 2] = 1.0 / (zfar - znear)
    m[2, 3] = -znear / (zfar - znear)
    return m


def perspective(fov_deg, n, f):
    """Projective camera-to-screen (pbrt transform.cpp Perspective)."""
    persp = np.array(
        [[1, 0, 0, 0],
         [0, 1, 0, 0],
         [0, 0, f / (f - n), -f * n / (f - n)],
         [0, 0, 1, 0]], dtype=np.float32)
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    return scale(inv_tan, inv_tan, 1.0) @ persp


def inverse(m):
    return np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)


def swaps_handedness(m):
    return np.linalg.det(np.asarray(m)[:3, :3]) < 0.0


def xform_p_np(m, p):
    """Host: apply a 4x4 to points (...,3) in numpy (scene build)."""
    m = np.asarray(m, np.float64)
    p = np.asarray(p, np.float64)
    r = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3].T + m[3, 3]
    return (r / w[..., None]).astype(np.float32)


def xform_n_np(m_inv, n):
    """Host: transform normals (...,3) by the inverse transpose, given the
    inverse matrix."""
    m_inv = np.asarray(m_inv, np.float64)
    return (np.asarray(n, np.float64) @ m_inv[:3, :3]).astype(np.float32)


# ------------------------------------------------------------------ device application
def xform_p(m, p):
    """Apply a 4x4 to points (...,3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = torch.stack([
        m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z + m[..., 0, 3],
        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z + m[..., 1, 3],
        m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z + m[..., 2, 3],
    ], dim=-1)
    w = m[..., 3, 0] * x + m[..., 3, 1] * y + m[..., 3, 2] * z + m[..., 3, 3]
    return r / w[..., None]


def xform_v(m, v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
        m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z,
    ], dim=-1)


# ----------------------------------------------------------------------- quaternions
def mat_to_quat(m):
    """Rotation matrix (3x3 block) -> quaternion [x,y,z,w] (host, numpy)."""
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w], dtype=np.float32)


def slerp(t, q0, q1):
    """Spherical lerp of quaternions, batched over t (pbrt Slerp)."""
    cos_theta = (q0[..., 0] * q1[..., 0] + q0[..., 1] * q1[..., 1]
                 + q0[..., 2] * q1[..., 2] + q0[..., 3] * q1[..., 3])
    q1 = torch.where(cos_theta[..., None] < 0.0, -q1, q1)
    cos_theta = torch.abs(cos_theta)
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = cos_theta > 0.9995
    safe_sin = torch.where(near, 1.0, sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe_sin)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# ------------------------------------------------------------------ animated transform
def decompose(m):
    """M -> (T, R quaternion, S 3x3) polar decomposition (pbrt
    AnimatedTransform::Decompose)."""
    m = np.asarray(m, np.float64)
    T = m[:3, 3].astype(np.float32)
    M = m[:3, :3].copy()
    R = M.copy()
    for _ in range(100):
        Rnext = 0.5 * (R + np.linalg.inv(R.T))
        if np.abs(Rnext - R).sum() < 1e-8:
            R = Rnext
            break
        R = Rnext
    S = (np.linalg.inv(R) @ M).astype(np.float32)
    return T, mat_to_quat(R), S


def animated_pack(m_start, m_end):
    """Host: pack an animated transform into a dict of arrays."""
    t0, q0, s0 = decompose(m_start)
    t1, q1, s1 = decompose(m_end)
    return {
        "t": np.stack([t0, t1]).astype(np.float32),       # (2,3)
        "q": np.stack([q0, q1]).astype(np.float32),       # (2,4)
        "s": np.stack([s0, s1]).astype(np.float32),       # (2,3,3)
        "animated": np.array(not np.allclose(m_start, m_end), dtype=np.bool_),
        "m0": np.asarray(m_start, np.float32),
    }


def quat_rotate(q, v):
    """Rotate vectors v (...,3) by unit quaternions q (...,4) [x,y,z,w]."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    c1 = cross(xyz, v) + w * v
    return v + 2.0 * cross(xyz, c1)


def animated_apply(packed, time, v, is_point=True):
    """Apply the transform interpolated at `time` (...,) to v (...,3), TRS
    order as AnimatedTransform::Interpolate. The caller reads the pack's
    `animated` flag on the host and takes `still_apply` where it is clear
    (the reference selects the same branch with a `where`)."""
    S = ((1.0 - time)[..., None, None] * packed["s"][0]
         + time[..., None, None] * packed["s"][1])
    shape = time.shape + (4,)
    q = slerp(time, packed["q"][0].expand(shape), packed["q"][1].expand(shape))
    out = quat_rotate(q, xform_v(S, v))
    if is_point:
        tt = time[..., None]
        out = out + ((1.0 - tt) * packed["t"][0] + tt * packed["t"][1])
    return out


def still_apply(packed, v, is_point=True):
    """Apply a still transform's one matrix to v (...,3)."""
    m0 = packed["m0"]
    fixed = xform_v(m0, v)
    if is_point:
        fixed = fixed + m0[:3, 3]
    return fixed
