"""A configuration's scene, made from the seed and handed to both sides: the
system under test builds it through its own SceneBuilder (its BVH, tables,
MIP pyramids and light tables are its set-up); the reference gets the same
description and works those out again itself.

A configuration is `configs/<name>.json` (its numbers) and
`configs/<name>.py`, whose `scene_inputs(params, words)` returns the
meshes, materials, images, environment map and camera from the numbers and
the seed's words (see reference/render.py for the format).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def seed_words(seed, n=4):
    """n 32-bit words drawn from the seed (any non-negative integer):
    [0] the sampler's scramble, [1], [2] the configuration's, [3] the
    check's choice of what it compares."""
    return [int(w) for w in np.random.SeedSequence(int(seed)).generate_state(n)]


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        params = json.load(f)
    mod = load_module(os.path.join(HERE, "configs", name + ".py"), "portbench_config_" + name)
    return params, mod


def describe(config, seed, xres, yres):
    """The reference's scene description of `config` for this seed."""
    params, mod = load_config(config)
    words = seed_words(seed)
    desc = mod.scene_inputs(params, words)
    desc.update(xres=xres, yres=yres, seed=words[0])
    return desc


@dataclasses.dataclass
class Built:
    scene: dict
    meta: object
    albedo_rows: dict       # material -> its Lambertian lobe's texture row
    build_s: float          # host seconds from the inputs to the scene on the card


def build_program(desc, spp, device):
    """The description through the system's SceneBuilder, to `device`."""
    from grail_torch.core import transform as tr
    from grail_torch.core.rng import SamplerConfig, ZERO_TWO
    from grail_torch.engine import camera as cam
    from grail_torch.engine.filters import FilterConfig
    from grail_torch.scene.buffers import SceneBuilder
    from grail_torch.shade import bsdf as bx
    from grail_torch.shade.materials import CONV_INV
    from grail_torch.shade.textures import TexSpec

    t0 = time.perf_counter()
    b = SceneBuilder()
    b.xres, b.yres = desc["xres"], desc["yres"]
    b.sampler = SamplerConfig(kind=ZERO_TWO, spp=spp, seed=desc["seed"])
    b.filter = FilterConfig.from_name("box")
    images = {name: b.add_image(img) for name, img in desc.get("images", {}).items()}
    mat_ids, albedo_rows = {}, {}
    for name, lobes in desc["materials"].items():
        rows = []
        for lb in lobes:
            if lb["kind"] == "lambert":
                kd = lb["kd"]
                row = (b.add_texture(TexSpec(kind="image", image_id=images[kd["image"]],
                                             su=kd["su"], sv=kd["sv"]))
                       if isinstance(kd, dict) else b.const_tex(tuple(kd)))
                albedo_rows[name] = row
                rows.append({"type": bx.LAMBERT, "s0": row})
            else:
                rough = lb["roughness"]
                rows.append({"type": bx.BLINN, "s0": b.const_tex(tuple(lb["ks"])),
                             "fr": bx.FR_DIELECTRIC,
                             "f0": b.add_texture(TexSpec(kind="const"), (rough,) * 3),
                             "f0_conv": CONV_INV, "f2": b.const_tex((lb["ior"],) * 3)})
        mat_ids[name] = b.add_material(rows)
    for m in desc["meshes"]:
        b.add_mesh(m["verts"], m["idx"], mat_ids[m["material"]], uvs=m.get("uvs"),
                   area_light_emit=m.get("emit"))
    if desc.get("env_map") is not None:
        b.add_infinite_light(env_map=desc["env_map"])
    c = desc["camera"]
    c2w = tr.look_at(c["pos"], c["look"], c["up"])
    b.camera = cam.build_camera(cam.PERSPECTIVE, c2w, c2w, desc["xres"], desc["yres"],
                                fov=c["fov"])
    scene, meta = b.finalize(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Built(scene, meta, albedo_rows, time.perf_counter() - t0)
