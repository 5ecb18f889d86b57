"""Vector math over SoA tensors with trailing dim 3 (port of grail/core/vecmath.py).

Dots and crosses are written component by component so the summation order is
fixed (x, then y, then z) on every device.
"""
from __future__ import annotations

import torch

INV_PI = 0.31830988618379067154
INV_TWOPI = 0.15915494309189533577
PI = 3.14159265358979323846
INV_FOURPI = 0.07957747154594766788
TWO_PI = 6.28318530717958647692


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0],
                       dim=-1)


def length_sq(v):
    return dot(v, v)


class _SqrtClamped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(torch.clamp_min(x, 0.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        pos = y > 0.0
        return torch.where(pos, g / (2.0 * torch.where(pos, y, 1.0)), 0.0)


def safe_sqrt(x):
    """sqrt(max(x, 0)), whose gradient where the result is 0 is 0, not the
    infinite slope of sqrt at 0 (which, times a masked lane's zero
    cotangent, makes a NaN)."""
    return _SqrtClamped.apply(x)


def normalize(v):
    return v * torch.rsqrt(torch.clamp_min(length_sq(v), 1e-30))[..., None]


def face_forward(n, v):
    """Flip n to lie in the hemisphere of v (pbrt geometry.h Faceforward)."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1):
    """Orthonormal basis around unit v1 (branch-free Duff et al., as grail)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    v2 = torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], dim=-1)
    v3 = torch.stack([b, sign + y * y * a, -y], dim=-1)
    return v2, v3


def spherical_direction(sintheta, costheta, phi):
    return torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi),
                        costheta], dim=-1)


def spherical_theta(v):
    return torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + TWO_PI, p)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b
