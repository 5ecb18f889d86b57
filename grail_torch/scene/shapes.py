"""Shape tessellation on the host (port of grail/scene/shapes.py; pbrt
src/shapes/*): every shape becomes triangles in object space, with the
reference's grids, parametric clipping (zmin/zmax/phimax), analytic normals
and uvs, Loop subdivision with limit-surface projection, and NURBS
evaluation, so that both packages hold the same vertices and indices. Each
function returns (verts (V,3), idx (T,3), normals (V,3) | None,
uvs (V,2) | None).
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


def cylinder(radius=1.0, zmin=-1.0, zmax=1.0, phimax=360.0, nu=64, nv=8):
    phimax_r = np.radians(np.clip(phimax, 0.0, 360.0))

    def pt(u, v):
        phi = u * phimax_r
        return np.stack([radius * np.cos(phi), radius * np.sin(phi),
                         zmin + v * (zmax - zmin)], -1)

    def nm(u, v):
        phi = u * phimax_r
        return np.stack([np.cos(phi), np.sin(phi), np.zeros_like(phi)], -1)

    return _grid_mesh(nu, nv, pt, nm)


def disk(height=0.0, radius=1.0, innerradius=0.0, phimax=360.0, nu=64, nv=4):
    phimax_r = np.radians(np.clip(phimax, 0.0, 360.0))

    def pt(u, v):
        phi = u * phimax_r
        r = radius + v * (innerradius - radius)   # v=0 at rim (disk.cpp)
        return np.stack([r * np.cos(phi), r * np.sin(phi),
                         np.full_like(phi, height)], -1)

    def nm(u, v):
        z = np.ones_like(u)
        return np.stack([0 * u, 0 * u, z], -1)

    return _grid_mesh(nu, nv, pt, nm)


def cone(height=1.0, radius=1.0, phimax=360.0, nu=64, nv=16):
    phimax_r = np.radians(np.clip(phimax, 0.0, 360.0))

    def pt(u, v):
        phi = u * phimax_r
        r = radius * (1.0 - v)
        return np.stack([r * np.cos(phi), r * np.sin(phi), v * height], -1)

    def nm(u, v):
        phi = u * phimax_r
        inv_len = 1.0 / np.sqrt(height * height + radius * radius)
        return np.stack([np.cos(phi) * height * inv_len,
                         np.sin(phi) * height * inv_len,
                         np.full_like(phi, radius * inv_len)], -1)

    return _grid_mesh(nu, nv, pt, nm)


def paraboloid(radius=1.0, zmin=0.0, zmax=1.0, phimax=360.0, nu=64, nv=16):
    phimax_r = np.radians(np.clip(phimax, 0.0, 360.0))
    zmin = max(zmin, 1e-4 * zmax)

    def pt(u, v):
        phi = u * phimax_r
        z = zmin + v * (zmax - zmin)
        r = radius * np.sqrt(z / zmax)
        return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)

    return _grid_mesh(nu, nv, pt)


def hyperboloid(p1=(0.0, 0.0, 0.0), p2=(1.0, 1.0, 1.0), phimax=360.0,
                nu=64, nv=16):
    """hyperboloid.cpp: surface swept by rotating the segment p1→p2 about z."""
    phimax_r = np.radians(np.clip(phimax, 0.0, 360.0))
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)

    def pt(u, v):
        phi = u * phimax_r
        p = p1[None] + v[..., None] * (p2 - p1)[None]
        x = p[..., 0] * np.cos(phi) - p[..., 1] * np.sin(phi)
        y = p[..., 0] * np.sin(phi) + p[..., 1] * np.cos(phi)
        return np.stack([x, y, p[..., 2]], -1)

    return _grid_mesh(nu, nv, pt)


def heightfield(nu, nv, z):
    """heightfield.cpp Refine: regular grid over [0,1]², z from the nu×nv array."""
    z = np.asarray(z, np.float32).reshape(nv, nu)  # pbrt stores x-major rows
    us = np.linspace(0, 1, nu)
    vs = np.linspace(0, 1, nv)
    uu, vv = np.meshgrid(us, vs, indexing="xy")
    verts = np.stack([uu.ravel(), vv.ravel(), z.ravel()], -1).astype(np.float32)
    uvs = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)
    faces = []
    for j in range(nv - 1):
        for i in range(nu - 1):
            a = j * nu + i
            b = j * nu + i + 1
            c = (j + 1) * nu + i + 1
            d = (j + 1) * nu + i
            faces.append([a, b, c])
            faces.append([a, c, d])
    return verts, np.asarray(faces, np.int64), None, uvs


# ------------------------------------------------------------------ loop subdivision
def loop_subdivide(verts, faces, nlevels):
    """Loop subdivision with limit-surface projection + limit normals
    (pbrt src/shapes/loopsubdiv.cpp: beta weights, boundary rules)."""
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)

    for _ in range(max(0, int(nlevels))):
        v, f = _loop_once(v, f)
    v, normals = _loop_limit(v, f)
    return v.astype(np.float32), f, normals.astype(np.float32), None


def _mesh_topology(v, f):
    """Adjacency: per-vertex neighbor rings + boundary flags."""
    nvert = len(v)
    edges = {}
    for fi, tri in enumerate(f):
        for k in range(3):
            a, b = int(tri[k]), int(tri[(k + 1) % 3])
            key = (min(a, b), max(a, b))
            edges.setdefault(key, []).append(fi)
    neighbors = [set() for _ in range(nvert)]
    boundary_nbrs = [set() for _ in range(nvert)]
    is_boundary = np.zeros(nvert, bool)
    for (a, b), fs in edges.items():
        neighbors[a].add(b)
        neighbors[b].add(a)
        if len(fs) == 1:
            is_boundary[a] = is_boundary[b] = True
            boundary_nbrs[a].add(b)
            boundary_nbrs[b].add(a)
    return edges, neighbors, boundary_nbrs, is_boundary


def _loop_beta(valence):
    if valence == 3:
        return 3.0 / 16.0
    return 3.0 / (8.0 * valence)


def _loop_once(v, f):
    nvert = len(v)
    edges, neighbors, bnbrs, is_b = _mesh_topology(v, f)

    # even (existing) vertex update
    new_even = np.empty_like(v)
    for i in range(nvert):
        nbrs = sorted(neighbors[i])
        val = len(nbrs)
        if not is_b[i] and val > 0:
            beta = _loop_beta(val)
            new_even[i] = (1 - val * beta) * v[i] + beta * v[nbrs].sum(0)
        elif is_b[i] and len(bnbrs[i]) == 2:
            b0, b1 = sorted(bnbrs[i])
            new_even[i] = 0.75 * v[i] + 0.125 * (v[b0] + v[b1])
        else:
            new_even[i] = v[i]

    # odd (edge) vertices
    edge_list = list(edges.keys())
    edge_index = {e: nvert + k for k, e in enumerate(edge_list)}
    new_odd = np.empty((len(edge_list), 3))
    # opposite vertices per edge
    opp = {e: [] for e in edge_list}
    for tri in f:
        for k in range(3):
            a, b, c = int(tri[k]), int(tri[(k + 1) % 3]), int(tri[(k + 2) % 3])
            opp[(min(a, b), max(a, b))].append(c)
    for k, e in enumerate(edge_list):
        a, b = e
        fs = edges[e]
        if len(fs) == 2 and len(opp[e]) == 2:
            c0, c1 = opp[e]
            new_odd[k] = 0.375 * (v[a] + v[b]) + 0.125 * (v[c0] + v[c1])
        else:
            new_odd[k] = 0.5 * (v[a] + v[b])

    # 1:4 face split
    new_f = []
    for tri in f:
        a, b, c = (int(x) for x in tri)
        ab = edge_index[(min(a, b), max(a, b))]
        bc = edge_index[(min(b, c), max(b, c))]
        ca = edge_index[(min(c, a), max(c, a))]
        new_f += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.concatenate([new_even, new_odd]), np.asarray(new_f, np.int64)


def _loop_limit(v, f):
    """Project to the limit surface + limit normals (loopsubdiv.cpp end of Refine)."""
    nvert = len(v)
    _, neighbors, bnbrs, is_b = _mesh_topology(v, f)
    out = np.empty_like(v)
    normals = np.empty_like(v)
    for i in range(nvert):
        nbrs = sorted(neighbors[i])
        val = len(nbrs)
        if val == 0:
            out[i] = v[i]
            normals[i] = (0, 0, 1)
            continue
        if not is_b[i]:
            # limit mask: loopGamma = 1/(valence + 3/(8*beta))
            beta = _loop_beta(val)
            gamma = 1.0 / (val + 3.0 / (8.0 * beta))
            out[i] = (1 - val * gamma) * v[i] + gamma * v[nbrs].sum(0)
            # tangent ring
            ring = v[nbrs]
            k = np.arange(val)
            t1 = (np.cos(2 * np.pi * k / val)[:, None] * ring).sum(0)
            t2 = (np.sin(2 * np.pi * k / val)[:, None] * ring).sum(0)
        elif len(bnbrs[i]) == 2:
            b0, b1 = sorted(bnbrs[i])
            out[i] = 0.2 * v[i] + 0.4 * (v[b0] + v[b1])
            t1 = v[b1] - v[b0]
            interior = [n for n in nbrs if n not in (b0, b1)]
            t2 = (v[interior].mean(0) - v[i]) if interior else np.cross(
                t1, [0, 0, 1.0])
        else:
            out[i] = v[i]
            t1, t2 = np.array([1.0, 0, 0]), np.array([0, 1.0, 0])
        n = np.cross(t1, t2)
        ln = np.linalg.norm(n)
        normals[i] = n / ln if ln > 1e-12 else (0, 0, 1)
    return out, normals


# ---------------------------------------------------------------------------- NURBS
def nurbs(nu_ctl, uorder, uknots, u0, u1, nv_ctl, vorder, vknots, v0, v1,
          ctl_pts, is_homogeneous, tess_u=48, tess_v=48):
    """nurbs.cpp: evaluate the B-spline basis on a tessellation grid."""
    uknots = np.asarray(uknots, np.float64)
    vknots = np.asarray(vknots, np.float64)
    if is_homogeneous:
        P = np.asarray(ctl_pts, np.float64).reshape(nv_ctl, nu_ctl, 4)
    else:
        P3 = np.asarray(ctl_pts, np.float64).reshape(nv_ctl, nu_ctl, 3)
        P = np.concatenate([P3, np.ones((nv_ctl, nu_ctl, 1))], -1)

    def basis(knots, order, nctl, t):
        """Cox-de Boor basis values for all control points at parameter t."""
        # degree = order-1; use recursive definition on the padded knot vector
        N = np.zeros((len(knots) - 1,))
        for i in range(len(knots) - 1):
            N[i] = 1.0 if (knots[i] <= t < knots[i + 1]) else 0.0
        if t >= knots[-1]:
            # clamp at end
            for i in range(len(knots) - 2, -1, -1):
                if knots[i] < knots[-1]:
                    N[i] = 1.0
                    break
        for d in range(1, order):
            Nn = np.zeros_like(N)
            for i in range(len(N) - d):
                left = 0.0
                if knots[i + d] != knots[i]:
                    left = (t - knots[i]) / (knots[i + d] - knots[i]) * N[i]
                right = 0.0
                if i + d + 1 < len(knots) and knots[i + d + 1] != knots[i + 1]:
                    right = (knots[i + d + 1] - t) / \
                        (knots[i + d + 1] - knots[i + 1]) * N[i + 1]
                Nn[i] = left + right
            N = Nn
        return N[:nctl]

    us = np.linspace(u0, u1 - 1e-9, tess_u)
    vs = np.linspace(v0, v1 - 1e-9, tess_v)
    pts = np.zeros((tess_v, tess_u, 3))
    for j, tv in enumerate(vs):
        Nv = basis(vknots, vorder, nv_ctl, tv)
        for i, tu in enumerate(us):
            Nu = basis(uknots, uorder, nu_ctl, tu)
            p = np.einsum("v,u,vuk->k", Nv, Nu, P)
            w = p[3] if abs(p[3]) > 1e-12 else 1.0
            pts[j, i] = p[:3] / w
    verts = pts.reshape(-1, 3).astype(np.float32)
    uu, vv = np.meshgrid((us - u0) / max(u1 - u0, 1e-12),
                         (vs - v0) / max(v1 - v0, 1e-12), indexing="xy")
    uvs = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)
    faces = []
    for j in range(tess_v - 1):
        for i in range(tess_u - 1):
            a = j * tess_u + i
            b = j * tess_u + i + 1
            c = (j + 1) * tess_u + i + 1
            d = (j + 1) * tess_u + i
            faces.append([a, b, c])
            faces.append([a, c, d])
    return verts, np.asarray(faces, np.int64), None, uvs
