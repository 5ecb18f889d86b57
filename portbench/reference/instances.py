"""Instanced geometry and point lights for the reference renderer, in plain
PyTorch (it imports nothing of the system).

- Instances (pbrt-v2's ObjectInstance, src/core/primitive.cpp,
  TransformedPrimitive): every instance's object-to-world transform is
  applied to its object's vertices on the host, in float64, and the world
  triangles join the scene's own; the base Scene's brute-force casting then
  runs over all of them. The reference never walks two levels, so it holds
  the system's sweep, its walk from each ray's BLAS root and its
  object-space hits to plain world geometry.
- Point lights (src/lights/point.cpp, PointLight::Sample_L): the light at
  distance r sends I / r^2 along the direction to it, with pdf 1; a delta
  light takes no MIS weight, and no BSDF-sampled ray can hit it. The
  shadow ray runs to the light's full distance, less the hit's epsilon at
  both ends, as the base Scene's.

The description adds "objects" ({name: {"verts", "idx", "material"}},
object space), "instances" ([{"object", "m0" (4, 4)}]) and "point_lights"
([{"pos", "intensity"}]) to the keys of reference/render.py.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import dot, occluded
from .render import Scene


def flatten(desc):
    """The world meshes of every instance: one mesh an object, its instances'
    triangles in instance order, vertices transformed in float64; each
    mesh's "inst" holds its triangles' instance (the index in
    desc["instances"])."""
    out = []
    for name, ob in desc.get("objects", {}).items():
        v = np.asarray(ob["verts"], np.float64)
        nt = len(ob["idx"])
        ks = [k for k, i in enumerate(desc["instances"]) if i["object"] == name]
        if not ks:
            continue
        ms = [np.asarray(desc["instances"][k]["m0"], np.float64) for k in ks]
        verts = np.concatenate([v @ m[:3, :3].T + m[:3, 3] for m in ms])
        idx = np.concatenate([np.asarray(ob["idx"], np.int64) + j * len(v)
                              for j in range(len(ms))])
        out.append({"verts": verts, "idx": idx, "uvs": None, "material": ob["material"],
                    "emit": None, "inst": np.repeat(np.asarray(ks, np.int64), nt)})
    return out


class InstancesScene(Scene):
    """The reference scene with the instances flattened into its triangles
    (tri_inst: each triangle's instance, -1 on the world's meshes) and its
    one point light in place of an area or environment light."""

    def __init__(self, desc, device, dt=torch.float32, albedo=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        flat = flatten(desc)
        super().__init__(dict(desc, meshes=list(desc["meshes"]) + flat), device, dt, albedo)
        # each triangle's instance, -1 on the world's own meshes
        self.tri_inst = torch.as_tensor(np.concatenate(
            [np.full(len(m["idx"]), -1, np.int64) for m in desc["meshes"]]
            + [m["inst"] for m in flat]), device=device)
        lights = desc.get("point_lights", [])
        if len(lights) != 1 or self.area is not None or self.env is not None:
            raise ValueError("the instanced reference takes one point light and no other")
        self.light_pos = torch.as_tensor(np.asarray(lights[0]["pos"], np.float32),
                                         device=device).to(dt)
        self.light_i = torch.as_tensor(np.asarray(lights[0]["intensity"], np.float32),
                                       device=device).to(dt)

    def direct(self, sg, wo, active, pix, samp, b, bsdf_branch):
        """The point light's estimate: f I / r^2 |cos| where the shadow ray
        is clear; no MIS weight and no BSDF branch (a delta light)."""
        p, eps, bsdf, n = sg["p"], sg["eps"], sg["bsdf"], sg["n"]
        vec = self.light_pos - p
        d2 = torch.clamp_min(dot(vec, vec), 1e-20)
        dist = torch.sqrt(d2)
        wi = vec / dist[..., None]
        rad = self.light_i / d2[..., None]
        f = bsdf.f(wo, self.to_local(sg, wi))
        cos = torch.abs(dot(wi, n))
        can = (active & (cos > 0.0) & torch.any(rad > 0.0, -1) & torch.any(f > 0.0, -1))
        with torch.no_grad():
            blocked = occluded(self.tri, p + wi * eps[..., None], wi,
                               torch.where(can, dist - 2.0 * eps, 0.0))
        return torch.where((can & ~blocked)[..., None], f * rad * cos[..., None], 0.0)
