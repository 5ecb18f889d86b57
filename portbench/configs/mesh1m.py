"""The 1M-triangle terrain under a sky, seen through a thin lens by a moving
camera: a height field of 2(grid-1)^2 triangles (fixed sines, no value
noise) with an image-mapped checker, a matte sphere, and a lat-long sky with
a sun disk whose azimuth the seed turns. The camera has two poses, open and
close of the shutter, a lens radius and a focal distance. Every size comes
from mesh1m.json and is the same for every seed; the sphere, checker and sky
are mesh100k's recipes (configs/mesh100k.py)."""
from __future__ import annotations

import os

import numpy as np

from portbench.scenes import load_module

_mesh100k = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "mesh100k.py"),
                        "portbench_config_mesh100k")


def _terrain(grid):
    xs = np.linspace(-4.0, 4.0, grid, dtype=np.float32)
    x, z = np.meshgrid(xs, xs)
    y = (0.35 * np.sin(1.7 * x) * np.cos(1.3 * z)
         + 0.18 * np.sin(4.1 * x + 1.0) * np.sin(3.7 * z)).astype(np.float32)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    uvs = np.stack([(x + 4.0) / 8.0, (z + 4.0) / 8.0], -1).reshape(-1, 2).astype(np.float32)
    i, j = np.meshgrid(np.arange(grid - 1), np.arange(grid - 1))
    a = (j * grid + i).ravel()
    idx = np.concatenate([np.stack([a, a + grid, a + 1], -1),
                          np.stack([a + 1, a + grid, a + grid + 1], -1)]).astype(np.int64)
    return verts, uvs, idx


def scene_inputs(params, words):
    verts, uvs, idx = _terrain(params["grid"])
    sp, ch = params["sphere"], params["checker"]
    sv, si = _mesh100k._sphere(sp["center"], sp["radius"], sp["nu"], sp["nv"])
    azimuth = (int(words[2]) / 2.0 ** 32 - 0.5) * 0.6
    return {
        "meshes": [{"verts": verts, "idx": idx, "uvs": uvs, "material": "terrain", "emit": None},
                   {"verts": sv, "idx": si, "uvs": None, "material": "matte", "emit": None}],
        "materials": {
            "terrain": [{"kind": "lambert",
                         "kd": {"image": "checker", "su": ch["su"], "sv": ch["sv"]}}],
            "matte": [{"kind": "lambert", "kd": params["matte"]["kd"]}]},
        "images": {"checker": _mesh100k._checker(ch)},
        "env_map": _mesh100k._sky(params["env_map"], azimuth),
        "camera": params["camera"],
    }
