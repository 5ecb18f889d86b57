"""Shape tessellation on the host (port of the part of grail/scene/shapes.py
that instanced scenes use): the sphere, with the reference's grid, so that
both packages hold the same vertices and indices. Returns (verts (V,3),
idx (T,3), normals (V,3), uvs (V,2)) in object space.
"""
from __future__ import annotations

import numpy as np


def _grid_mesh(nu, nv, point_fn, normal_fn=None):
    """Tessellate parametric (u,v) in [0,1]^2 on an (nu+1)x(nv+1) grid."""
    us = np.linspace(0.0, 1.0, nu + 1)
    vs = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")   # (nu+1, nv+1)
    pts = point_fn(uu.ravel(), vv.ravel()).astype(np.float32)
    nrm = (normal_fn(uu.ravel(), vv.ravel()).astype(np.float32)
           if normal_fn else None)
    uvs = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)

    cols = nv + 1
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * cols + j
            b = (i + 1) * cols + j
            faces.append([a, b, b + 1])
            faces.append([a, b + 1, a + 1])
    return pts, np.asarray(faces, np.int64), nrm, uvs


def sphere(radius=1.0, zmin=None, zmax=None, phimax=360.0, nu=64, nv=32):
    """sphere.cpp parameterization: phi = u·phimax, theta = lerp(v,
    thetaMin, thetaMax)."""
    zmin = -radius if zmin is None else max(-radius, zmin)
    zmax = radius if zmax is None else min(radius, zmax)
    theta_min = np.arccos(np.clip(zmin / radius, -1, 1))
    theta_max = np.arccos(np.clip(zmax / radius, -1, 1))
    phimax_r = np.radians(np.clip(phimax, 0.0, 360.0))

    def pt(u, v):
        phi = u * phimax_r
        theta = theta_min + v * (theta_max - theta_min)
        return np.stack([radius * np.sin(theta) * np.cos(phi),
                         radius * np.sin(theta) * np.sin(phi),
                         radius * np.cos(theta)], -1)

    def nm(u, v):
        return pt(u, v) / radius

    return _grid_mesh(nu, nv, pt, nm)
