"""The ~100k-triangle textured terrain under a sky: a height field of
2(grid-1)^2 triangles (fixed sines plus value noise on a 17x17 lattice drawn
from the seed) with an image-mapped checker, a glossy (Lambertian plus
Blinn) sphere, and a lat-long sky with a sun disk whose azimuth the seed
turns. Every size comes from mesh100k.json and is the same for every seed."""
from __future__ import annotations

import numpy as np


def _lattice_noise(x, z, rng):
    n = 17
    lattice = rng.random((n, n)).astype(np.float32)
    u = (x + 4.0) / 8.0 * (n - 1)
    v = (z + 4.0) / 8.0 * (n - 1)
    iu, iv = u.astype(np.int64), v.astype(np.int64)
    fu, fv = u - iu, v - iv
    fu, fv = fu * fu * (3 - 2 * fu), fv * fv * (3 - 2 * fv)
    iu1, iv1 = np.minimum(iu + 1, n - 1), np.minimum(iv + 1, n - 1)
    return (lattice[iv, iu] * (1 - fu) * (1 - fv) + lattice[iv, iu1] * fu * (1 - fv)
            + lattice[iv1, iu] * (1 - fu) * fv + lattice[iv1, iu1] * fu * fv)


def _terrain(grid, rng):
    xs = np.linspace(-4.0, 4.0, grid, dtype=np.float32)
    x, z = np.meshgrid(xs, xs)
    y = (0.35 * np.sin(1.7 * x) * np.cos(1.3 * z)
         + 0.18 * np.sin(4.1 * x + 1.0) * np.sin(3.7 * z)
         + 0.9 * _lattice_noise(x, z, rng)).astype(np.float32)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    uvs = np.stack([(x + 4.0) / 8.0, (z + 4.0) / 8.0], -1).reshape(-1, 2).astype(np.float32)
    i, j = np.meshgrid(np.arange(grid - 1), np.arange(grid - 1))
    a = (j * grid + i).ravel()
    idx = np.concatenate([np.stack([a, a + grid, a + 1], -1),
                          np.stack([a + 1, a + grid, a + grid + 1], -1)]).astype(np.int64)
    return verts, uvs, idx


def _sphere(center, radius, nu, nv):
    theta = np.pi * np.arange(nv + 1) / nv
    phi = 2 * np.pi * np.arange(nu) / nu
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    verts = np.stack([center[0] + radius * st * np.cos(phi), center[1] + radius * ct + 0 * phi,
                      center[2] + radius * st * np.sin(phi)], -1).reshape(-1, 3)
    tris = []
    for j in range(nv):
        for i in range(nu):
            a, b = j * nu + i, j * nu + (i + 1) % nu
            c, d = (j + 1) * nu + (i + 1) % nu, (j + 1) * nu + i
            if j > 0:
                tris.append((a, c, b))
            if j < nv - 1:
                tris.append((a, d, c))
    return verts.astype(np.float32), np.array(tris, np.int64)


def _checker(p):
    n, k = p["size"], p["checks"]
    m = ((np.indices((n, n)).sum(0) // (n // k)) % 2).astype(np.float32)[..., None]
    return (np.asarray(p["c0"]) * (1 - m) + np.asarray(p["c1"]) * m).astype(np.float32)


def _sky(p, azimuth):
    h, w = p["height"], p["width"]
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    dx = np.sin(theta)[:, None] * np.cos(phi)[None, :]
    dy = np.sin(theta)[:, None] * np.sin(phi)[None, :]
    dz = np.broadcast_to(np.cos(theta)[:, None], (h, w))
    sx, sy, sz = np.asarray(p["sun_dir"], np.float64)
    c, s = np.cos(azimuth), np.sin(azimuth)        # turned about world up (+y)
    sd = np.array([c * sx + s * sz, sy, -s * sx + c * sz])
    sd /= np.linalg.norm(sd)
    horizon = np.clip(1.0 - np.abs(dy), 0, 1) ** 3
    sky = (np.stack([0.25 + 0.5 * horizon, 0.45 + 0.35 * horizon, 0.9 - 0.1 * horizon], -1)
           * np.clip(dy + 0.35, 0.05, 1.0)[..., None])
    cos_sun = dx * sd[0] + dy * sd[1] + dz * sd[2]
    sun = (np.clip((cos_sun - 0.9995) / 0.0005, 0, 1)[..., None]
           * np.array([1.0, 0.9, 0.7]) * p["sun_power"])
    return (sky + sun).astype(np.float32)


def scene_inputs(params, words):
    rng = np.random.default_rng(int(words[1]))
    verts, uvs, idx = _terrain(params["grid"], rng)
    sp = params["sphere"]
    sv, si = _sphere(sp["center"], sp["radius"], sp["nu"], sp["nv"])
    gl, ch = params["glossy"], params["checker"]
    azimuth = (int(words[2]) / 2.0 ** 32 - 0.5) * 0.6
    return {
        "meshes": [{"verts": verts, "idx": idx, "uvs": uvs, "material": "terrain", "emit": None},
                   {"verts": sv, "idx": si, "uvs": None, "material": "glossy", "emit": None}],
        "materials": {
            "terrain": [{"kind": "lambert",
                         "kd": {"image": "checker", "su": ch["su"], "sv": ch["sv"]}}],
            "glossy": [{"kind": "lambert", "kd": gl["kd"]},
                       {"kind": "blinn", "ks": gl["ks"], "roughness": gl["roughness"],
                        "ior": gl["ior"]}]},
        "images": {"checker": _checker(ch)},
        "env_map": _sky(params["env_map"], azimuth),
        "camera": params["camera"],
    }
