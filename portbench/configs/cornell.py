"""The Cornell box: five walls, two boxes and a ceiling light quad, all
Lambertian (36 triangles, the brute-force route), made from the numbers in
cornell.json. The seed sets the sampler's scramble; the geometry is fixed."""
from __future__ import annotations

import numpy as np


def _quad(p0, p1, p2, p3):
    return np.array([p0, p1, p2, p3], np.float32), np.array([[0, 1, 2], [0, 2, 3]], np.int64)


def _box(lo, hi):
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    faces = [((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0)),
             ((x1, y0, z1), (x0, y0, z1), (x0, y1, z1), (x1, y1, z1)),
             ((x0, y0, z1), (x0, y0, z0), (x0, y1, z0), (x0, y1, z1)),
             ((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0)),
             ((x0, y0, z1), (x1, y0, z1), (x1, y0, z0), (x0, y0, z0)),
             ((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1))]
    verts = np.array([p for f in faces for p in f], np.float32)
    idx = np.array([tri for k in range(6) for tri in ((4 * k, 4 * k + 1, 4 * k + 2),
                                                      (4 * k, 4 * k + 2, 4 * k + 3))],
                   np.int64)
    return verts, idx


def scene_inputs(params, words):
    """(meshes, materials, camera, env_map, images) of the reference's scene
    description, from the configuration's numbers."""
    ls = 0.25
    meshes = [
        _quad((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1)) + ("white",),       # floor
        _quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)) + ("white",),       # ceiling
        _quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)) + ("white",),     # back
        _quad((-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1)) + ("red",),       # left
        _quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)) + ("green",),         # right
        _box((-0.55, 0.0, -0.55), (-0.05, 1.2, -0.05)) + ("white",),
        _box((0.1, 0.0, 0.05), (0.6, 0.6, 0.55)) + ("white",),
        _quad((-ls, 2 - 1e-3, -ls), (ls, 2 - 1e-3, -ls), (ls, 2 - 1e-3, ls),
              (-ls, 2 - 1e-3, ls)) + ("light",),
    ]
    meshes = [{"verts": v, "idx": i, "uvs": None, "material": m,
               "emit": params["light_emit"] if m == "light" else None} for v, i, m in meshes]
    materials = {name: [{"kind": "lambert", "kd": params[key]}]
                 for name, key in (("white", "white_kd"), ("red", "red_kd"),
                                   ("green", "green_kd"))}
    materials["light"] = [{"kind": "lambert", "kd": [0.0, 0.0, 0.0]}]
    return {"meshes": meshes, "materials": materials, "camera": params["camera"]}
