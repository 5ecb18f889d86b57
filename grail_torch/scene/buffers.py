"""SceneBuilder -> (scene dict, SceneMeta) (port of grail/scene/buffers.py for
triangle-mesh scenes with area and environment lights).

The scene compiles to structure-of-arrays tensors: one world-space triangle
soup, a material lobe table, a texture table with its images and MIP
pyramids, a light table with per-light area CDFs, pre-gathered
light-triangle vertices and light transforms, the environment map and its
Distribution2D, the camera pack and, above 64 triangles, the BVH's 4-wide
node and triangle tables (its record table on request). Host-side work is
numpy, as in the reference, so both packages hold the same bits. Instances,
media, the other light types and the power-weighted light distribution are
not ported yet; a scene that would need them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core import montecarlo as mc
from ..core import transform as tr
from ..core.rng import SamplerConfig
from ..device import resolve_device
from ..engine.filters import FilterConfig
from ..kernels.bvh4 import build_bvh4_tables
from ..kernels.bvh_stream import build_stream_table, tree_depth
from ..native import build_bvh_native
from ..shade import bsdf as bx
from ..shade import geometry as geom
from ..shade import lights as lt
from ..shade.materials import CONV_ID, MAT_FIELDS
from ..shade.mipmap import build_pyramid, pack_pyramid
from ..shade.textures import TexSpec

BRUTE_MAX_TRIS = 64   # the reference builds a BVH above this many triangles


def binary_bvh(verts, tri_idx):
    """The binary SAH tree that a scene's BVH tables are built from (numpy
    arrays in the native builder's layout). force_leaf=4: a box record costs
    the record-stream traversal as much as a triangle record."""
    return build_bvh_native(verts, tri_idx, max_prims=4, force_leaf=4)


def attach_record_table(scene):
    """Add the 64-byte record table of the BVH ("stream") and the binary
    tree's depth ("depth") to a BVH scene, on the scene's device: the tables
    of the record-stream kernels (kernels/bvh_stream.py), which no main-path
    wave runs. Built from the same binary tree as the scene's 4-wide tables.
    Returns the scene."""
    verts, tri_idx = (scene[k].detach().cpu().numpy() for k in ("verts", "tri_idx"))
    tree = binary_bvh(verts, tri_idx)
    scene["bvh"]["stream"] = torch.as_tensor(build_stream_table(tree, verts, tri_idx),
                                             device=scene["verts"].device)
    scene["bvh"]["depth"] = tree_depth(tree)
    return scene


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static scene facts the port reads (field names as grail's SceneMeta)."""
    tex_specs: Tuple[TexSpec, ...]
    lobe_types: Tuple[int, ...]
    light_types: Tuple[int, ...]
    n_lights: int
    n_tris: int
    sampler: SamplerConfig
    cam_kind: int
    filter: FilterConfig
    xres: int
    yres: int
    has_env_map: bool = False
    n_images: int = 0


def to_torch(tree, device):
    """numpy leaves (arrays and numpy scalars) of nested dicts and tuples ->
    tensors on device; Python ints and None stay as they are."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(to_torch(v, device) for v in tree)
    if tree is None or type(tree) is int:
        return tree
    return torch.tensor(np.asarray(tree), device=device)


def env_distribution(env_map):
    """The infinite light's importance map, luminance·sinθ (infinite.cpp),
    as a Distribution2D of numpy arrays; a constant light gets a flat map."""
    if env_map is not None:
        lum = (0.212671 * env_map[..., 0] + 0.715160 * env_map[..., 1]
               + 0.072169 * env_map[..., 2])
    else:
        lum = np.ones((64, 128), np.float32)
    h = lum.shape[0]
    sint = np.sin((np.arange(h) + 0.5) / h * np.pi)
    dist = mc.build_distribution_2d(
        torch.tensor((lum * sint[:, None] + 1e-9).astype(np.float32)))
    return {part: {k: v.numpy() for k, v in d.items()} for part, d in dist.items()}


class SceneBuilder:
    def __init__(self):
        self.verts = []
        self.vnorm = []
        self.vuv = []
        self.tri_idx = []
        self.tri_mat = []
        self.tri_light = []
        self.tri_flags = []
        self.n_verts = 0
        self.tex_specs = []
        self.tex_const = []
        self.tex_w2t = []
        self.images = []
        self.mat_rows = []       # list of list-of-lobe dicts
        self.lights = []         # list of dicts
        self.env_map = None      # (H,W,3) lat-long map of the infinite light
        self.env_row = -1
        self.camera = None
        self.sampler = SamplerConfig()
        self.filter = FilterConfig()
        self.xres = 256
        self.yres = 256

    # ------------------------------------------------------------------- textures
    def add_texture(self, spec: TexSpec, const=(0.0, 0.0, 0.0), w2t=None):
        self.tex_specs.append(spec)
        self.tex_const.append(np.asarray(const, np.float32))
        self.tex_w2t.append(np.asarray(w2t if w2t is not None else tr.identity(),
                                       np.float32))
        return len(self.tex_specs) - 1

    def const_tex(self, value):
        """Constant texture row; scalar or rgb."""
        v = np.asarray(value, np.float32).reshape(-1)
        if v.size == 1:
            v = np.repeat(v, 3)
        return self.add_texture(TexSpec(kind="const"), v)

    def add_image(self, img):
        self.images.append(np.asarray(img, np.float32))
        return len(self.images) - 1

    # ------------------------------------------------------------------ materials
    def add_material(self, lobes):
        """lobes: list of dicts with keys type, fr, s0, s1, s2, f0, f1, f2,
        f0_conv, f1_conv (texture ids for s*/f*; missing keys defaulted)."""
        self.mat_rows.append(list(lobes))
        return len(self.mat_rows) - 1

    def matte(self, kd_tex=None, kd=(0.5, 0.5, 0.5)):
        """pbrt matte.cpp, Lambertian (OrenNayar is not ported yet)."""
        if kd_tex is None:
            kd_tex = self.const_tex(kd)
        return self.add_material([{"type": bx.LAMBERT, "s0": kd_tex}])

    # -------------------------------------------------------------------- geometry
    def add_mesh(self, verts, idx, material, normals=None, uvs=None,
                 reverse_orientation=False, swaps_handedness=False,
                 area_light_emit=None, n_samples=1):
        """Append a world-space triangle mesh. With area_light_emit every
        triangle becomes part of one DiffuseAreaLight."""
        verts = np.asarray(verts, np.float32).reshape(-1, 3)
        idx = np.asarray(idx, np.int64).reshape(-1, 3)
        nv = verts.shape[0]
        ntri = idx.shape[0]
        base = self.n_verts
        flags = 0
        if normals is not None:
            flags |= geom.HAS_NS
        if uvs is not None:
            flags |= geom.HAS_UV
        if reverse_orientation:
            flags |= geom.REVERSE_ORIENTATION
        if swaps_handedness:
            flags |= geom.XFORM_SWAPS_HANDEDNESS

        self.verts.append(verts)
        self.vnorm.append(np.asarray(normals, np.float32).reshape(-1, 3)
                          if normals is not None else np.zeros((nv, 3), np.float32))
        self.vuv.append(np.asarray(uvs, np.float32).reshape(-1, 2)
                        if uvs is not None else np.zeros((nv, 2), np.float32))
        self.n_verts += nv

        light_id = -1
        if area_light_emit is not None:
            light_id = len(self.lights)
            first = sum(len(t) for t in self.tri_idx)
            v0 = verts[idx[:, 0]]
            v1 = verts[idx[:, 1]]
            v2 = verts[idx[:, 2]]
            areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
            self.lights.append({
                "type": lt.AREA,
                "emit": np.asarray(area_light_emit, np.float32),
                "tris": list(range(first, first + ntri)), "tri_areas": areas,
                "n_samples": n_samples,
            })

        self.tri_idx.append(idx + base)
        self.tri_mat.append(np.full(ntri, material, np.int64))
        self.tri_light.append(np.full(ntri, light_id, np.int64))
        self.tri_flags.append(np.full(ntri, flags, np.int64))
        return light_id

    # ---------------------------------------------------------------------- lights
    def add_infinite_light(self, l2w=None, radiance=(1.0, 1.0, 1.0), env_map=None):
        """InfiniteAreaLight; env_map (H,W,3) lat-long, importance
        luminance·sinθ."""
        self.env_row = len(self.lights)
        self.lights.append({"type": lt.INFINITE,
                            "emit": np.asarray(radiance, np.float32),
                            "l2w": l2w if l2w is not None else tr.identity()})
        if env_map is not None:
            self.env_map = np.asarray(env_map, np.float32)

    # --------------------------------------------------------------------- finalize
    def finalize(self, device=None):
        """Compile to (scene, meta); tensors go to `device` (CUDA unless the
        caller passes another)."""
        device = resolve_device(device)
        n_tris = sum(len(t) for t in self.tri_idx)
        if n_tris == 0:
            raise ValueError("scene has no geometry")
        if self.camera is None:
            raise ValueError("scene has no camera")
        verts = np.concatenate(self.verts)
        tri_idx = np.concatenate(self.tri_idx)
        tri_flags = np.concatenate(self.tri_flags)
        scene = {
            "verts": verts,
            "vnorm": np.concatenate(self.vnorm),
            "vuv": np.concatenate(self.vuv),
            "tri_idx": tri_idx.astype(np.int32),
            "tri_mat": np.concatenate(self.tri_mat).astype(np.int32),
            "tri_light": np.concatenate(self.tri_light).astype(np.int32),
            "tri_flags": tri_flags.astype(np.int32),
        }

        # ---- materials table
        K = max(max((len(r) for r in self.mat_rows), default=1), 1)
        M = max(len(self.mat_rows), 1)
        zero_tex = 0 if self.tex_specs else self.const_tex((0.0, 0.0, 0.0))
        fields = {f: np.zeros((M, K), np.int32) for f in MAT_FIELDS}
        for mi, row in enumerate(self.mat_rows):
            for ki, lobe in enumerate(row):
                fields["lobe_type"][mi, ki] = lobe.get("type", bx.NONE)
                fields["fr"][mi, ki] = lobe.get("fr", bx.FR_NOOP)
                for slot in ("s0", "s1", "s2", "f0", "f1", "f2"):
                    fields[slot][mi, ki] = lobe.get(slot, zero_tex)
                fields["f0_conv"][mi, ki] = lobe.get("f0_conv", CONV_ID)
                fields["f1_conv"][mi, ki] = lobe.get("f1_conv", CONV_ID)
        scene["materials"] = fields
        lobe_types = tuple(sorted({int(t) for r in self.mat_rows
                                   for t in (lb.get("type", bx.NONE) for lb in r)}
                                  - {bx.NONE}))

        # ---- texture table
        scene["tex_data"] = {
            "const": (np.stack(self.tex_const) if self.tex_const
                      else np.zeros((1, 3), np.float32)),
            "w2t": (np.stack(self.tex_w2t) if self.tex_w2t
                    else np.zeros((1, 4, 4), np.float32)),
        }

        if self.images:
            scene["images"] = tuple(self.images)
            scene["mipmaps"] = tuple(pack_pyramid(build_pyramid(im))
                                     for im in self.images)

        # ---- light table (the columns area and infinite lights read)
        L = max(len(self.lights), 1)
        at_max = max(max((len(lg.get("tris", ())) for lg in self.lights), default=0), 1)
        larr = {
            "type": np.zeros(L, np.int32),
            "emit": np.zeros((L, 3), np.float32),
            "l2w": np.tile(tr.identity(), (L, 1, 1)),
            "w2l": np.tile(tr.identity(), (L, 1, 1)),
            "area": np.ones(L, np.float32),
            "av0": np.zeros((L, at_max, 3), np.float32),
            "av1": np.zeros((L, at_max, 3), np.float32),
            "av2": np.zeros((L, at_max, 3), np.float32),
            "aflip": np.zeros((L, at_max), np.int32),
            "acdf": np.tile(np.linspace(0, 1, at_max + 1, dtype=np.float32), (L, 1)),
        }
        for i, lg in enumerate(self.lights):
            larr["type"][i] = lg["type"]
            larr["emit"][i] = lg["emit"]
            larr["l2w"][i] = np.asarray(lg.get("l2w", tr.identity()), np.float32)
            larr["w2l"][i] = tr.inverse(lg.get("l2w", tr.identity()))
            if lg["type"] != lt.AREA:
                continue
            tris = lg["tris"]
            areas = lg["tri_areas"]
            total = float(areas.sum())
            larr["area"][i] = total
            tarr = np.asarray(tris, np.int64)
            i0 = tri_idx[tarr]
            larr["av0"][i, :len(tris)] = verts[i0[:, 0]]
            larr["av1"][i, :len(tris)] = verts[i0[:, 1]]
            larr["av2"][i, :len(tris)] = verts[i0[:, 2]]
            fl = tri_flags[tarr]
            larr["aflip"][i, :len(tris)] = (
                ((fl & geom.REVERSE_ORIENTATION) != 0)
                ^ ((fl & geom.XFORM_SWAPS_HANDEDNESS) != 0)).astype(np.int32)
            cdf = np.concatenate([[0.0], np.cumsum(areas) / max(total, 1e-12)])
            larr["acdf"][i, :len(cdf)] = cdf.astype(np.float32)
            larr["acdf"][i, len(cdf):] = 1.0
        scene["lights"] = larr
        if self.env_row >= 0:
            scene["env_row"] = np.int32(self.env_row)
            scene["env_dist"] = env_distribution(self.env_map)
            if self.env_map is not None:
                scene["env_map"] = self.env_map
        scene["camera"] = self.camera

        # ---- the BVH's 4-wide tables (the record table only on request:
        # attach_record_table)
        if n_tris > BRUTE_MAX_TRIS:
            nodes, tris4, stack = build_bvh4_tables(binary_bvh(verts, tri_idx),
                                                    verts, tri_idx)
            scene["bvh"] = {"bvh4_nodes": nodes, "bvh4_tris": tris4,
                            "bvh4_stack": stack}

        meta = SceneMeta(
            tex_specs=tuple(self.tex_specs),
            lobe_types=lobe_types,
            light_types=tuple(sorted({int(lg["type"]) for lg in self.lights})),
            n_lights=len(self.lights),
            n_tris=n_tris,
            sampler=self.sampler,
            cam_kind=int(self.camera["type"]),
            filter=self.filter,
            xres=self.xres,
            yres=self.yres,
            has_env_map=self.env_map is not None,
            n_images=len(self.images),
        )
        return to_torch(scene, device), meta
