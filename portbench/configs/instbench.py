"""Instanced geometry: one sphere object (pbrt's sphere parameterization,
phi = 2 pi u, theta = pi (1 - v), from z = -r to z = r, tessellated on an (nu + 1) x (nv + 1) grid into
2 nu nv triangles, the poles' degenerate ones included) placed 100 times in
a 10 x 10 grid over a 2-triangle floor, under one point light. Each
instance's object-to-world transform is its grid translation after a
rotation drawn from the seed (a uniform angle about a uniform axis); the
transforms are rounded to float32, the precision both sides read them in.

Besides the keys the other configurations give, the description holds
"objects" ({name: {"verts", "idx", "material"}}, object space), "instances"
([{"object", "m0" (4, 4)}]) and "point_lights" ([{"pos", "intensity"}])."""
from __future__ import annotations

import math

import numpy as np


def sphere(radius, nu, nv):
    """(verts (V, 3) float32, idx (2 nu nv, 3) int64) of the sphere."""
    uu, vv = np.meshgrid(np.linspace(0.0, 1.0, nu + 1), np.linspace(0.0, 1.0, nv + 1),
                         indexing="ij")
    phi, theta = uu.ravel() * 2.0 * math.pi, (1.0 - vv.ravel()) * math.pi
    verts = np.stack([radius * np.sin(theta) * np.cos(phi),
                      radius * np.sin(theta) * np.sin(phi),
                      radius * np.cos(theta)], -1).astype(np.float32)
    cols = nv + 1
    a = (np.arange(nu)[:, None] * cols + np.arange(nv)[None]).ravel()
    b = a + cols
    idx = np.stack([np.stack([a, b, b + 1], -1), np.stack([a, b + 1, a + 1], -1)], 1)
    return verts, idx.reshape(-1, 3).astype(np.int64)


def rotation(axis, angle):
    """The 3x3 rotation by `angle` radians about the unit `axis` (Rodrigues)."""
    k = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    return np.eye(3) + math.sin(angle) * k + (1.0 - math.cos(angle)) * (k @ k)


def transforms(params, word):
    """(I, 4, 4) float32 object-to-world transforms, the grid row by row."""
    rng = np.random.default_rng(int(word))
    g, step, (x0, y0, z0) = params["grid"], params["spacing"], params["corner"]
    out = np.zeros((params["instances"], 4, 4))
    for k in range(params["instances"]):
        r, c = divmod(k, g)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        out[k, :3, :3] = rotation(axis, rng.uniform(0.0, 2.0 * math.pi))
        out[k, :3, 3] = (x0 + step * c, y0, z0 + step * r)
        out[k, 3, 3] = 1.0
    return out.astype(np.float32)


def scene_inputs(params, words):
    sp, ext, y = params["sphere"], params["floor"]["half_extent"], params["floor"]["y"]
    sv, si = sphere(sp["radius"], sp["nu"], sp["nv"])
    floor = np.array([[-ext, y, -ext], [ext, y, -ext], [ext, y, ext], [-ext, y, ext]],
                     np.float32)
    return {
        "meshes": [{"verts": floor, "idx": np.array([[0, 1, 2], [0, 2, 3]], np.int64),
                    "uvs": None, "material": "floor", "emit": None}],
        "materials": {"floor": [{"kind": "lambert", "kd": params["floor_matte"]["kd"]}],
                      "sphere": [{"kind": "lambert", "kd": params["sphere_matte"]["kd"]}]},
        "objects": {"sphere": {"verts": sv, "idx": si, "material": "sphere"}},
        "instances": [{"object": "sphere", "m0": m} for m in transforms(params, words[1])],
        "point_lights": [dict(params["point_light"])],
        "camera": params["camera"],
    }
