"""SceneBuilder -> (scene dict, SceneMeta) (port of grail/scene/buffers.py for
triangle-mesh scenes with point, spot, distant, area, environment, projection
and goniometric lights, bump-mapped materials, alpha cutouts and instanced
objects).

The scene compiles to structure-of-arrays tensors: one world-space triangle
soup (each triangle with its alpha-cutout texture row, -1 for none), a
material lobe table with each material's bump texture row, a texture table
with its images and MIP pyramids, a light table with per-light area CDFs,
pre-gathered light-triangle vertices, light transforms, spot cones, distant
directions, the projection lights' frusta and the projection and
goniometric lights' image rows, the environment map and its
Distribution2D, the world radius and the power-weighted light
Distribution1D, the camera pack, the measured BRDF tables
("brdf_tables"), the participating-media regions ("media", with their
density grids) and, above 64 triangles, the BVH's 4-wide node and triangle
tables (its record table on request). Instanced objects
(pbrt's ObjectBegin/ObjectInstance) append their object-space triangles
once, after the base soup, and add the instance table ("inst"): one 4-wide
table of every object's BLAS with each instance's root, its decomposed
(possibly animated) transform and its motion-bound world box. Host-side
work is numpy, as in the reference, so both packages hold the same bits.
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
from ..kernels.bvh4 import build_bvh4_blas, build_bvh4_tables
from ..kernels.bvh_stream import build_stream_table, tree_depth
from ..shade import bsdf as bx
from ..shade import geometry as geom
from ..shade import lights as lt
from ..shade.materials import CONV_ID, MAT_FIELDS
from ..shade.mipmap import build_pyramid, pack_pyramid
from ..shade.textures import TexSpec
from .bvh import build_bvh_auto

BRUTE_MAX_TRIS = 64   # the reference builds a BVH above this many triangles
# the far micro-triangle an instanced-only scene gets as its base soup
SENTINEL_TRI = np.asarray([[1e30, 1e30, 1e30], [1e30, 1e30 + 1, 1e30],
                           [1e30, 1e30, 1e30 + 1]], np.float32)


def binary_bvh(verts, tri_idx):
    """The binary SAH tree that a scene's BVH tables are built from (numpy
    arrays in scene/bvh.py's layout), by the builder the reference picks for
    its size (bvh.build_bvh_auto). force_leaf=4: a box record costs the
    record-stream traversal as much as a triangle record."""
    return build_bvh_auto(verts, tri_idx, max_prims=4, force_leaf=4)


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
    has_bump: bool = False
    bump_rows: Tuple[int, ...] = ()
    light_image_rows: Tuple[Tuple[int, int], ...] = ()   # (light row, image id)
    alpha_rows: Tuple[int, ...] = ()    # the alpha-cutout texture rows in use
    media_kinds: Tuple[int, ...] = ()   # each media region's kind (shade/media.py)
    crop: Tuple[float, float, float, float] = (0.0, 1.0, 0.0, 1.0)   # film crop window
    # each material's lobe slots, as tuples in MAT_FIELDS order (the static
    # table the material-sorted pass and the spectral promotion read)
    mat_specs: Tuple[Tuple[Tuple[int, ...], ...], ...] = ()


def _motion_bounds(m0, m1, omin, omax, steps=16):
    """Conservative world box of an object box under an animated transform
    (pbrt AnimatedTransform::MotionBounds: the union of the boxes at steps
    interpolated times)."""
    corners = np.asarray([[omin[0] if i & 1 else omax[0],
                           omin[1] if i & 2 else omax[1],
                           omin[2] if i & 4 else omax[2]] for i in range(8)],
                         np.float32)
    m0 = np.asarray(m0, np.float32)
    m1 = np.asarray(m1, np.float32)
    if np.allclose(m0, m1):
        w = tr.xform_p_np(m0, corners)
        lo, hi = w.min(0), w.max(0)
    else:
        t0, q0, s0 = tr.decompose(m0)
        t1, q1, s1 = tr.decompose(m1)
        q0 = np.asarray(q0, np.float64)
        q1 = np.asarray(q1, np.float64)
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for k in range(steps):
            u = k / (steps - 1.0)
            T = (1 - u) * t0 + u * t1
            S = (1 - u) * s0 + u * s1
            d = float(np.dot(q0, q1))
            qb = -q1 if d < 0 else q1
            d = abs(d)
            if d > 0.9995:
                q = (1 - u) * q0 + u * qb
            else:
                th = np.arccos(np.clip(d, -1.0, 1.0))
                q = (np.sin((1 - u) * th) * q0 + np.sin(u * th) * qb) / np.sin(th)
            q = q / np.linalg.norm(q)
            x, y, z, w_ = q
            R = np.asarray([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w_), 2 * (x * z + y * w_)],
                [2 * (x * y + z * w_), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w_)],
                [2 * (x * z - y * w_), 2 * (y * z + x * w_), 1 - 2 * (x * x + y * y)]])
            w = corners @ (R @ S).T + T
            lo = np.minimum(lo, w.min(0))
            hi = np.maximum(hi, w.max(0))
    pad = 1e-4 * (np.linalg.norm(hi - lo) + 1.0)
    return (lo - pad).astype(np.float32), (hi + pad).astype(np.float32)


def instance_pack(instances, obj_verts, obj_root):
    """The instance table's per-instance leaves (numpy) from {obj, m0, m1}
    dicts, each object's object-space vertices and each object's root ref:
    root, obj, t, q, s, anim, m0, m0_inv, swap, wmin, wmax."""
    I = len(instances)
    pk = {"root": np.zeros(I, np.int32), "obj": np.zeros(I, np.int32),
          "t": np.zeros((I, 2, 3), np.float32), "q": np.zeros((I, 2, 4), np.float32),
          "s": np.zeros((I, 2, 3, 3), np.float32), "anim": np.zeros(I, np.bool_),
          "m0": np.zeros((I, 4, 4), np.float32),
          "m0_inv": np.zeros((I, 4, 4), np.float32), "swap": np.zeros(I, np.bool_),
          "wmin": np.zeros((I, 3), np.float32), "wmax": np.zeros((I, 3), np.float32)}
    for i, ins in enumerate(instances):
        p = tr.animated_pack(ins["m0"], ins["m1"])
        pk["root"][i] = obj_root[ins["obj"]]
        pk["obj"][i] = ins["obj"]
        pk["t"][i], pk["q"][i], pk["s"][i] = p["t"], p["q"], p["s"]
        pk["anim"][i] = p["animated"]
        pk["m0"][i] = p["m0"]
        pk["m0_inv"][i] = tr.inverse(ins["m0"])
        pk["swap"][i] = bool(tr.swaps_handedness(ins["m0"]))
        ov = obj_verts[ins["obj"]]
        pk["wmin"][i], pk["wmax"][i] = _motion_bounds(ins["m0"], ins["m1"],
                                                      ov.min(0), ov.max(0))
    return pk


def world_bounds(base_verts, inst):
    """(2, 3) world bounds (Scene::WorldBound): the base vertices (none for
    an instanced-only scene's far sentinel) and the instances' motion
    bounds."""
    lo = np.minimum(np.min(base_verts, 0, initial=np.inf), inst["wmin"].min(0))
    hi = np.maximum(np.max(base_verts, 0, initial=-np.inf), inst["wmax"].max(0))
    return np.stack([lo, hi]).astype(np.float32)


def world_radius(lo, hi):
    """Half the diagonal of the world box, padded (the reference's
    world_radius)."""
    return np.float32(0.5 * np.linalg.norm(hi - lo) + 1e-3)


def _vertex_rows(nv, normals, uvs, reverse_orientation, swaps_handedness):
    """A mesh's vertex normal and uv rows (zeros where it has none) and its
    triangles' flag bits."""
    flags = ((geom.HAS_NS if normals is not None else 0)
             | (geom.HAS_UV if uvs is not None else 0)
             | (geom.REVERSE_ORIENTATION if reverse_orientation else 0)
             | (geom.XFORM_SWAPS_HANDEDNESS if swaps_handedness else 0))
    vnorm = (np.asarray(normals, np.float32).reshape(-1, 3) if normals is not None
             else np.zeros((nv, 3), np.float32))
    vuv = (np.asarray(uvs, np.float32).reshape(-1, 2) if uvs is not None
           else np.zeros((nv, 2), np.float32))
    return vnorm, vuv, flags


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


def light_power_distribution(larr, radius):
    """The power-weighted light Distribution1D (ComputeLightSamplingCDF) of
    the light table's numpy columns and the world radius, as numpy
    arrays."""
    power = lt.light_power({k: torch.tensor(larr[k]) for k in
                            ("type", "emit", "cos_total", "cos_falloff", "area")},
                           torch.tensor(radius))
    return {k: v.numpy() for k, v in mc.build_distribution_1d(power).items()}


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


def media_table(regions):
    """The region table (numpy) of add_volume's regions: the columns the
    media stages read."""
    def col(key, dtype=np.float32):
        return np.asarray([m[key] for m in regions], dtype)
    return {"w2v": np.stack([tr.inverse(m["v2w"]) for m in regions]).astype(np.float32),
            "bounds_min": col("p0"), "bounds_max": col("p1"),
            "sigma_a": col("sigma_a"), "sigma_s": col("sigma_s"), "g": col("g"),
            "le": col("le"), "grid_id": col("grid_id", np.int32),
            "exp_a": col("exp_a"), "exp_b": col("exp_b"), "updir": col("updir")}


class SceneBuilder:
    def __init__(self):
        self.verts = []
        self.vnorm = []
        self.vuv = []
        self.tri_idx = []
        self.tri_mat = []
        self.tri_light = []
        self.tri_flags = []
        self.tri_alpha = []
        self.n_verts = 0
        self.tex_specs = []
        self.tex_const = []
        self.tex_w2t = []
        self.images = []
        self.mat_rows = []       # list of list-of-lobe dicts
        self.mat_bump = []       # a material's bump float-texture row (-1 none)
        self.lights = []         # list of dicts
        self.env_map = None      # (H,W,3) lat-long map of the infinite light
        self.env_row = -1
        self.camera = None
        self.sampler = SamplerConfig()
        self.filter = FilterConfig()
        self.xres = 256
        self.yres = 256
        self.crop = (0.0, 1.0, 0.0, 1.0)   # film crop window [x0, x1, y0, y1]
        self.inst_objects = []   # object-space mesh buckets (add_object)
        self.instances = []      # {obj, m0, m1} (add_instance)
        self.brdf_tables = []    # measured half-angle BRDF tables (numpy)
        self.media_regions = []  # add_volume's regions
        self.density_grids = []

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
    def add_material(self, lobes, bump=None):
        """lobes: list of dicts with keys type, fr, s0, s1, s2, f0, f1, f2,
        f0_conv, f1_conv (texture ids for s*/f*; missing keys defaulted).
        bump: a float texture row, the displacement of Material::Bump."""
        self.mat_rows.append(list(lobes))
        self.mat_bump.append(-1 if bump is None else int(bump))
        return len(self.mat_rows) - 1

    def measured_lobes(self, table):
        """The lobe stack of a measured BRDF material (measured.cpp): one
        MEASURED lobe over the half-angle table (shade/measured.py), its
        albedo estimate in S1 and its table row in f1."""
        from ..shade.measured import albedo_estimate
        gi = len(self.brdf_tables)
        self.brdf_tables.append(np.asarray(table, np.float32))
        one = self.const_tex((1.0, 1.0, 1.0))
        alb = self.const_tex(tuple(np.clip(albedo_estimate(table), 0.0, 1.0)))
        gid = self.add_texture(TexSpec(kind="const"), (float(gi),) * 3)
        return [{"type": bx.MEASURED, "s0": one, "s1": alb, "f1": gid}]

    def matte(self, kd_tex=None, kd=(0.5, 0.5, 0.5)):
        """pbrt matte.cpp, Lambertian (the parser builds OrenNayar itself)."""
        if kd_tex is None:
            kd_tex = self.const_tex(kd)
        return self.add_material([{"type": bx.LAMBERT, "s0": kd_tex}])

    # -------------------------------------------------------------------- geometry
    def add_mesh(self, verts, idx, material, normals=None, uvs=None,
                 reverse_orientation=False, swaps_handedness=False,
                 area_light_emit=None, n_samples=1, alpha_tex=-1):
        """Append a world-space triangle mesh. With area_light_emit every
        triangle becomes part of one DiffuseAreaLight; alpha_tex: the float
        texture row of its alpha cutout (-1: opaque)."""
        verts = np.asarray(verts, np.float32).reshape(-1, 3)
        idx = np.asarray(idx, np.int64).reshape(-1, 3)
        nv = verts.shape[0]
        ntri = idx.shape[0]
        base = self.n_verts
        vnorm, vuv, flags = _vertex_rows(nv, normals, uvs, reverse_orientation,
                                         swaps_handedness)
        self.verts.append(verts)
        self.vnorm.append(vnorm)
        self.vuv.append(vuv)
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
        self.tri_alpha.append(np.full(ntri, alpha_tex, np.int64))
        return light_id

    # ------------------------------------------------------------------- instances
    def add_object(self):
        """Open a reusable object-space geometry bucket (pbrtObjectBegin);
        returns its id for add_object_mesh and add_instance."""
        self.inst_objects.append({"verts": [], "vnorm": [], "vuv": [], "tri_idx": [],
                                  "tri_mat": [], "tri_flags": [], "tri_alpha": [],
                                  "n_verts": 0})
        return len(self.inst_objects) - 1

    def add_object_mesh(self, obj_id, verts, idx, material, normals=None, uvs=None,
                        reverse_orientation=False, swaps_handedness=False,
                        alpha_tex=-1):
        """Append an object-space mesh to an object: stored once whatever the
        number of instances (area lights inside objects are not supported,
        as in the reference); alpha_tex as add_mesh's."""
        ob = self.inst_objects[obj_id]
        verts = np.asarray(verts, np.float32).reshape(-1, 3)
        idx = np.asarray(idx, np.int64).reshape(-1, 3)
        nv = verts.shape[0]
        ntri = idx.shape[0]
        vnorm, vuv, flags = _vertex_rows(nv, normals, uvs, reverse_orientation,
                                         swaps_handedness)
        ob["verts"].append(verts)
        ob["vnorm"].append(vnorm)
        ob["vuv"].append(vuv)
        ob["tri_idx"].append(idx + ob["n_verts"])
        ob["tri_mat"].append(np.full(ntri, material, np.int64))
        ob["tri_flags"].append(np.full(ntri, flags, np.int64))
        ob["tri_alpha"].append(np.full(ntri, alpha_tex, np.int64))
        ob["n_verts"] += nv

    def add_instance(self, obj_id, m0, m1=None):
        """Instantiate an object with an object-to-world transform, animated
        from m0 at shutter open to m1 at close (pbrtObjectInstance)."""
        m0 = np.asarray(m0, np.float32)
        m1 = m0 if m1 is None else np.asarray(m1, np.float32)
        self.instances.append({"obj": obj_id, "m0": m0, "m1": m1})

    # ---------------------------------------------------------------------- lights
    def add_point_light(self, p, intensity):
        self.lights.append({"type": lt.POINT, "emit": np.asarray(intensity, np.float32),
                            "l2w": tr.translate(np.asarray(p, np.float64))})

    def add_spot_light(self, l2w, intensity, cone_angle=30.0, cone_delta=5.0):
        """SpotLight (spot.cpp): intensity along the light's +z, full inside
        cone_angle - cone_delta, falling off to 0 at cone_angle (degrees)."""
        self.lights.append({
            "type": lt.SPOT, "emit": np.asarray(intensity, np.float32), "l2w": l2w,
            "cos_total": np.cos(np.radians(cone_angle)),
            "cos_falloff": np.cos(np.radians(cone_angle - cone_delta))})

    def add_projection_light(self, l2w, intensity, fov=45.0, image_id=-1):
        """ProjectionLight (projection.cpp): intensity projected through a
        perspective frustum of `fov` degrees along the light's +z; image_id:
        the builder image it projects (-1: none), whose aspect sets the
        screen window."""
        aspect = 1.0
        if image_id >= 0:
            im = self.images[image_id]
            aspect = im.shape[1] / im.shape[0]
        if aspect > 1.0:
            screen = (-aspect, aspect, -1.0, 1.0)
        else:
            screen = (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)
        self.lights.append({
            "type": lt.PROJECTION, "emit": np.asarray(intensity, np.float32),
            "l2w": l2w, "proj": tr.perspective(fov, 1e-3, 1e30),
            "proj_hither": 1e-3, "screen": np.asarray(screen, np.float32),
            "image_id": int(image_id)})

    def add_goniometric_light(self, l2w, intensity, image_id=-1):
        """GonioPhotometricLight (goniometric.cpp): a point intensity scaled
        by the lat-long image `image_id` (-1: none)."""
        self.lights.append({"type": lt.GONIOMETRIC,
                            "emit": np.asarray(intensity, np.float32),
                            "l2w": l2w, "image_id": int(image_id)})

    def add_distant_light(self, from_p, to_p, radiance):
        """DistantLight (distant.cpp): radiance arriving along from -> to."""
        d = np.asarray(to_p, np.float64) - np.asarray(from_p, np.float64)
        d = d / np.linalg.norm(d)
        self.lights.append({"type": lt.DISTANT,
                            "emit": np.asarray(radiance, np.float32),
                            "l2w": tr.identity(),
                            "world_dir": (-d).astype(np.float32)})

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
    # -------------------------------------------------------------------- volumes
    def add_volume(self, vtype, v2w=None, p0=(0, 0, 0), p1=(1, 1, 1),
                   sigma_a=(0.45, 0.45, 0.45), sigma_s=(0.25, 0.25, 0.25),
                   g=0.0, le=(0, 0, 0), density=None, exp_a=1.0, exp_b=1.0,
                   updir=(0, 1, 0)):
        """A media region (pbrt src/volumes/*): vtype media.HOMOGENEOUS,
        GRID (density: a (nz, ny, nx) grid) or EXPONENTIAL; the box [p0, p1]
        in volume space; v2w the VolumeToWorld transform."""
        grid_id = -1
        if density is not None:
            grid_id = len(self.density_grids)
            self.density_grids.append(np.asarray(density, np.float32))
        self.media_regions.append(dict(
            type=vtype, v2w=v2w if v2w is not None else tr.identity(),
            p0=np.asarray(p0, np.float32), p1=np.asarray(p1, np.float32),
            sigma_a=np.asarray(sigma_a, np.float32),
            sigma_s=np.asarray(sigma_s, np.float32),
            g=float(g), le=np.asarray(le, np.float32), grid_id=grid_id,
            exp_a=float(exp_a), exp_b=float(exp_b),
            updir=np.asarray(updir, np.float32)))

    def finalize(self, device=None):
        """Compile to (scene, meta); tensors go to `device` (CUDA unless the
        caller passes another)."""
        device = resolve_device(device)
        has_sentinel = bool(self.instances) and sum(len(t) for t in self.tri_idx) == 0
        if has_sentinel:
            # an instanced-only scene: the base routes want geometry, so one
            # far micro-triangle that no ray reaches (left out of the world
            # bounds), as the reference
            self.add_mesh(SENTINEL_TRI, np.asarray([[0, 1, 2]], np.int64), 0)
        n_tris = sum(len(t) for t in self.tri_idx)     # the base soup
        if n_tris == 0:
            raise ValueError("scene has no geometry")
        if self.camera is None:
            raise ValueError("scene has no camera")
        base_verts = np.concatenate(self.verts)
        base_idx = np.concatenate(self.tri_idx)
        parts = {k: [np.concatenate(getattr(self, k))]
                 for k in ("vnorm", "vuv", "tri_mat", "tri_light", "tri_flags",
                           "tri_alpha")}
        parts["verts"], parts["tri_idx"] = [base_verts], [base_idx]
        # objects' object-space triangles, appended once after the base soup,
        # so that prim ids are the reference's
        obj_ranges, obj_verts = [], []
        n_verts, t0 = len(base_verts), n_tris
        for ob in self.inst_objects:
            ov = (np.concatenate(ob["verts"]) if ob["verts"]
                  else np.zeros((0, 3), np.float32))
            obj_verts.append(ov)
            nt = sum(len(t) for t in ob["tri_idx"])
            obj_ranges.append((t0, t0 + nt))
            if nt == 0:
                continue
            parts["verts"].append(ov)
            parts["tri_idx"].append(np.concatenate(ob["tri_idx"]) + n_verts)
            # instanced shapes keep their alpha cutout (TransformedPrimitive
            # defers to the inner shape)
            for k in ("vnorm", "vuv", "tri_mat", "tri_flags", "tri_alpha"):
                parts[k].append(np.concatenate(ob[k]))
            parts["tri_light"].append(np.full(nt, -1, np.int64))
            n_verts += len(ov)
            t0 += nt
        verts = np.concatenate(parts["verts"])
        tri_idx = np.concatenate(parts["tri_idx"])
        tri_flags = np.concatenate(parts["tri_flags"])
        scene = {
            "verts": verts,
            "vnorm": np.concatenate(parts["vnorm"]),
            "vuv": np.concatenate(parts["vuv"]),
            "tri_idx": tri_idx.astype(np.int32),
            "tri_mat": np.concatenate(parts["tri_mat"]).astype(np.int32),
            "tri_light": np.concatenate(parts["tri_light"]).astype(np.int32),
            "tri_flags": tri_flags.astype(np.int32),
            "tri_alpha": np.concatenate(parts["tri_alpha"]).astype(np.int32),
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
        mat_specs = tuple(tuple(tuple(int(fields[f][mi, ki]) for f in MAT_FIELDS)
                                for ki in range(len(row)))
                          for mi, row in enumerate(self.mat_rows))
        fields["bump"] = np.full(M, -1, np.int32)
        fields["bump"][:len(self.mat_bump)] = self.mat_bump
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

        # ---- light table
        L = max(len(self.lights), 1)
        at_max = max(max((len(lg.get("tris", ())) for lg in self.lights), default=0), 1)
        larr = {
            "type": np.zeros(L, np.int32),
            "emit": np.zeros((L, 3), np.float32),
            "l2w": np.tile(tr.identity(), (L, 1, 1)),
            "w2l": np.tile(tr.identity(), (L, 1, 1)),
            "cos_total": np.zeros(L, np.float32),
            "cos_falloff": np.zeros(L, np.float32),
            "world_dir": np.zeros((L, 3), np.float32),
            "area": np.ones(L, np.float32),
            "av0": np.zeros((L, at_max, 3), np.float32),
            "av1": np.zeros((L, at_max, 3), np.float32),
            "av2": np.zeros((L, at_max, 3), np.float32),
            "aflip": np.zeros((L, at_max), np.int32),
            "acdf": np.tile(np.linspace(0, 1, at_max + 1, dtype=np.float32), (L, 1)),
            "proj": np.tile(tr.identity(), (L, 1, 1)),
            "proj_hither": np.full(L, 1e-3, np.float32),
            "screen": np.tile(np.asarray([-1, 1, -1, 1], np.float32), (L, 1)),
            "image_row": np.full(L, -1, np.int32),
        }
        light_image_rows = {}
        for i, lg in enumerate(self.lights):
            larr["type"][i] = lg["type"]
            larr["emit"][i] = lg["emit"]
            larr["l2w"][i] = np.asarray(lg.get("l2w", tr.identity()), np.float32)
            larr["w2l"][i] = tr.inverse(lg.get("l2w", tr.identity()))
            larr["cos_total"][i] = lg.get("cos_total", 0.0)
            larr["cos_falloff"][i] = lg.get("cos_falloff", 0.0)
            larr["world_dir"][i] = lg.get("world_dir", (0, 0, 1))
            if "proj" in lg:
                larr["proj"][i] = np.asarray(lg["proj"], np.float32)
                larr["proj_hither"][i] = lg["proj_hither"]
                larr["screen"][i] = lg["screen"]
            if lg.get("image_id", -1) >= 0:
                larr["image_row"][i] = i
                light_image_rows[i] = lg["image_id"]
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
        if self.brdf_tables:
            scene["brdf_tables"] = tuple(self.brdf_tables)
        if self.media_regions:
            scene["media"] = media_table(self.media_regions)
            scene["density_grids"] = tuple(self.density_grids)

        # ---- the BVH's 4-wide tables over the base soup (the record table
        # only on request: attach_record_table). An instanced scene always
        # has one: the brute route would test the object-space rows too.
        if n_tris > BRUTE_MAX_TRIS or self.instances:
            nodes, tris4, stack = build_bvh4_tables(binary_bvh(verts, base_idx),
                                                    verts, tri_idx)
            scene["bvh"] = {"bvh4_nodes": nodes, "bvh4_tris": tris4,
                            "bvh4_stack": stack}

        # ---- the instance table: the BLAS of every instanced object in one
        # 4-wide table, each from its own binary tree; instances of empty
        # objects dropped
        instances = [i for i in self.instances
                     if obj_ranges[i["obj"]][1] > obj_ranges[i["obj"]][0]]
        if instances:
            objs = sorted({i["obj"] for i in instances})
            trees = []
            for k in objs:
                a, b = obj_ranges[k]
                tree = binary_bvh(verts, tri_idx[a:b])
                trees.append(dict(tree, prim_ids=tree["prim_ids"] + a))
            nodes, tris4, roots, stack = build_bvh4_blas(trees, verts, tri_idx)
            obj_root = dict(zip(objs, roots.tolist()))
            scene["inst"] = dict(instance_pack(instances, obj_verts, obj_root),
                                 bvh4_nodes=nodes, bvh4_tris=tris4, bvh4_stack=stack)
            scene["world_bounds"] = world_bounds(base_verts[:0] if has_sentinel
                                                 else base_verts, scene["inst"])
        # the world's bounding radius (Scene::WorldBound: the base vertices
        # and the instances' motion bounds), and the lights' power
        lo, hi = (scene["world_bounds"] if "world_bounds" in scene
                  else (base_verts.min(0), base_verts.max(0)))
        scene["world_radius"] = world_radius(lo, hi)
        scene["light_power_dist"] = light_power_distribution(larr, scene["world_radius"])

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
            has_bump=any(bt >= 0 for bt in self.mat_bump),
            bump_rows=tuple(sorted({bt for bt in self.mat_bump if bt >= 0})),
            light_image_rows=tuple(sorted(light_image_rows.items())),
            alpha_rows=tuple(sorted({int(a) for a in np.unique(scene["tri_alpha"])
                                     if a >= 0})),
            media_kinds=tuple(int(m["type"]) for m in self.media_regions),
            crop=tuple(float(c) for c in self.crop),
            mat_specs=mat_specs,
        )
        return to_torch(scene, device), meta
