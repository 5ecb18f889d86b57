"""Carry a finalized reference scene across to the port.

`scene_from_numpy` takes the JAX package's finalized scene with every leaf
converted to numpy (e.g. `jax.tree_util.tree_map(np.asarray, scene)`) and its
SceneMeta, read by attribute name only, and returns the port's scene dict and
SceneMeta on `device`: geometry with its alpha-cutout rows, materials with
their bump rows, textures with their images and MIP pyramids, lights with
the projection frusta and light image rows and the environment map and its
distribution, the world radius and the power-weighted light distribution,
the camera (an environment camera given the film resolution that the
reference's pack lacks, ROADMAP C.8), the 4-wide tables built from the
reference's own binary tree (for a single record table and for clustered
tables alike; the record
table is the port's own, on request: buffers.attach_record_table), and the
instance table, whose BLAS table is collapsed from the reference's own
per-object binary trees, the measured BRDF tables, and the media regions
with their density grids. Leaves the port does not read are dropped; a
scene that needs a route the port lacks raises. This module imports nothing of the reference: everything
arrives as numpy arrays and plain attributes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.rng import SamplerConfig
from ..engine.camera import ENVIRONMENT
from ..device import resolve_device
from ..engine.filters import FilterConfig
from ..kernels.bvh4 import build_bvh4_blas, build_bvh4_tables
from ..shade.lights import INFINITE
from ..shade.materials import MAT_FIELDS
from ..shade.textures import TexSpec
from .buffers import SENTINEL_TRI, SceneMeta, to_torch, world_bounds

_GEOMETRY = ("verts", "vnorm", "vuv", "tri_idx", "tri_mat", "tri_light", "tri_flags",
             "tri_alpha")
_LIGHTS = ("type", "emit", "l2w", "w2l", "cos_total", "cos_falloff", "world_dir",
           "area", "av0", "av1", "av2", "aflip", "acdf", "proj", "proj_hither", "screen",
           "image_row")
_CAMERA = ("type", "raster2cam", "c2w", "lens_radius", "focal_distance", "shutter")
_PYRAMID = ("flat", "h", "w", "off")
_INSTANCE = ("obj", "t", "q", "s", "anim", "m0", "m0_inv", "swap", "wmin", "wmax")
_MEDIA = ("w2v", "bounds_min", "bounds_max", "sigma_a", "sigma_s", "g", "le", "grid_id",
          "exp_a", "exp_b", "updir")
# reference-side features whose routes are not ported yet
_UNPORTED_LEAVES = ("ring",)


def _same_fields(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def meta_from(meta) -> SceneMeta:
    """The port's SceneMeta from any object with the reference's attributes."""
    return SceneMeta(
        tex_specs=tuple(_same_fields(TexSpec, s) for s in meta.tex_specs),
        lobe_types=tuple(int(t) for t in meta.lobe_types),
        light_types=tuple(int(t) for t in meta.light_types),
        n_lights=int(meta.n_lights),
        n_tris=int(meta.n_tris),
        sampler=_same_fields(SamplerConfig, meta.sampler),
        cam_kind=int(meta.cam_kind),
        filter=_same_fields(FilterConfig, meta.filter),
        xres=int(meta.xres),
        yres=int(meta.yres),
        has_env_map=bool(meta.has_env_map),
        n_images=int(meta.n_images),
        has_bump=bool(meta.has_bump),
        bump_rows=tuple(int(r) for r in meta.bump_rows),
        light_image_rows=tuple((int(r), int(i)) for r, i in meta.light_image_rows),
        alpha_rows=tuple(int(r) for r in meta.alpha_rows),
        media_kinds=tuple(int(k) for k in getattr(meta, "media_kinds", ())),
        crop=tuple(float(c) for c in getattr(meta, "crop", (0.0, 1.0, 0.0, 1.0))),
    )


def _object_tree(blas, root):
    """The binary BLAS of the object at node `root`, sliced out of the
    reference's concatenation of every object's tree (depth first, child
    refs and prim offsets shifted by the object's offsets) and shifted back;
    its prim_ids stay global."""
    right, nprims = blas["right"], blas["nprims"]
    last = root
    while nprims[last] == 0:            # a subtree ends with its right child's
        last = right[last]
    part = slice(root, last + 1)
    leaf = nprims[part] > 0
    first = int(blas["prim_off"][part][leaf].min())
    count = int(nprims[part].sum())
    return {"bounds_min": blas["bounds_min"][part], "bounds_max": blas["bounds_max"][part],
            "right": np.where(right[part] >= 0, right[part] - root, right[part]),
            "prim_off": blas["prim_off"][part] - first, "nprims": nprims[part],
            "prim_ids": blas["prim_ids"][first:first + count]}


def instance_table(inst_np, verts, tri_idx):
    """The port's instance table from the reference's: the pack leaves, and
    the BLAS of every instanced object in one 4-wide table with each
    instance's root (bvh4.build_bvh4_blas)."""
    objs, first = np.unique(inst_np["obj"], return_index=True)
    trees = [_object_tree(inst_np["blas"], int(inst_np["root"][i])) for i in first]
    nodes, tris4, roots, stack = build_bvh4_blas(trees, verts, tri_idx)
    root = roots[np.searchsorted(objs, inst_np["obj"])]
    return dict({k: inst_np[k] for k in _INSTANCE}, root=root.astype(np.int32),
                bvh4_nodes=nodes, bvh4_tris=tris4, bvh4_stack=stack)


def scene_from_numpy(scene_np, meta, device=None):
    """(port scene dict, port SceneMeta) from the reference's numpy scene."""
    device = resolve_device(device)
    for key in _UNPORTED_LEAVES:
        if scene_np.get(key) is not None:
            raise NotImplementedError(f"scene has {key!r}: not ported yet")
    scene = {k: scene_np[k] for k in _GEOMETRY}
    scene["materials"] = {k: scene_np["materials"][k] for k in MAT_FIELDS + ("bump",)}
    scene["tex_data"] = {k: scene_np["tex_data"][k] for k in ("const", "w2t")}
    if len(scene_np.get("images", ())) > 0:
        scene["images"] = tuple(scene_np["images"])
        scene["mipmaps"] = tuple(
            dict({k: m[k] for k in _PYRAMID}, n_levels=int(m["n_levels"]))
            for m in scene_np["mipmaps"])
    scene["lights"] = {k: scene_np["lights"][k] for k in _LIGHTS}
    scene["world_radius"] = scene_np["world_radius"]
    scene["light_power_dist"] = scene_np["light_power_dist"]
    if INFINITE in meta.light_types:
        scene["env_row"] = scene_np["env_row"]
        scene["env_dist"] = scene_np["env_dist"]
        if scene_np.get("env_map") is not None:
            scene["env_map"] = scene_np["env_map"]
    scene["camera"] = {k: scene_np["camera"][k] for k in _CAMERA}
    if int(meta.cam_kind) == ENVIRONMENT:
        scene["camera"]["xres"] = np.float32(meta.xres)
        scene["camera"]["yres"] = np.float32(meta.yres)
    if len(scene_np.get("brdf_tables", ())) > 0:
        scene["brdf_tables"] = tuple(scene_np["brdf_tables"])
    if scene_np.get("media") is not None:
        scene["media"] = {k: scene_np["media"][k] for k in _MEDIA}
        scene["density_grids"] = tuple(scene_np.get("density_grids", ()))
    bvh = scene_np.get("bvh")
    if bvh is not None:
        # one 4-wide table from the binary tree, whether the reference packed
        # one record table ("stream") or, above the TPU's VMEM budget,
        # clustered ones ("cstream"): the card has no such wall
        nodes, tris4, stack = build_bvh4_tables(bvh, scene_np["verts"],
                                                scene_np["tri_idx"])
        scene["bvh"] = {"bvh4_nodes": nodes, "bvh4_tris": tris4, "bvh4_stack": stack}
    if scene_np.get("inst") is not None:
        scene["inst"] = instance_table(scene_np["inst"], scene_np["verts"],
                                       scene_np["tri_idx"])
        base = scene_np["verts"][scene_np["tri_idx"][:int(meta.n_tris)]].reshape(-1, 3)
        if np.array_equal(base, SENTINEL_TRI):     # an instanced-only scene
            base = base[:0]
        scene["world_bounds"] = world_bounds(base, scene["inst"])
    return to_torch(scene, device), meta_from(meta)
