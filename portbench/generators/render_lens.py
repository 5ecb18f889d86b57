"""The `render` generator's closed loop through a thin lens and a moving
camera: the configuration's camera gives two poses (shutter open and close),
a lens radius, a focal distance and the shutter, and both sides render
through them. The system's scene is built as `render` builds it, with the
lens and moving camera in place of the still pinhole; the check's reference
is reference/lens.py's LensScene. Set-up raises where the finalized camera
has no lens or does not move, so a pinhole or still camera fails loudly.

Traffic parameters: those of `render`."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import scenes
from ..reference.lens import LensScene
from ..reference.render import pixel_means
from . import render


def build_program(desc, spp, device):
    """The description through the system's SceneBuilder (scenes.build_program,
    given the open pose as a still pinhole), then the lens and moving camera
    made by the system's build_camera and put on `device` as the builder puts
    every pack."""
    from grail_torch.core import transform as tr
    from grail_torch.engine import camera as cam
    from grail_torch.scene.buffers import to_torch

    t0 = time.perf_counter()
    c = desc["camera"]
    pinhole = {"pos": c["pos0"], "look": c["look"], "up": c["up"], "fov": c["fov"]}
    built = scenes.build_program(dict(desc, camera=pinhole), spp, device)
    pack = cam.build_camera(cam.PERSPECTIVE, tr.look_at(c["pos0"], c["look"], c["up"]),
                            tr.look_at(c["pos1"], c["look"], c["up"]),
                            desc["xres"], desc["yres"], fov=c["fov"],
                            lens_radius=c["lens_radius"], focal_distance=c["focal_distance"],
                            shutter_open=c["shutter"][0], shutter_close=c["shutter"][1])
    built.scene["camera"] = to_torch(pack, device)
    camera = built.scene["camera"]
    if not (float(camera["lens_radius"]) > 0.0 and bool(camera["c2w"]["animated"])):
        raise ValueError("the lens cell's camera has no lens or does not move")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dataclasses.replace(built, build_s=time.perf_counter() - t0)


class Generator(render.Generator):
    def setup(self):
        from grail_torch.engine.integrator import IntegratorConfig
        from grail_torch.engine.render import render as render_fn
        tr, run = self.tr, self.run
        self.desc = scenes.describe(run.config, run.seed, tr["res"], tr["res"])
        self.built = build_program(self.desc, tr["spp"], run.device)
        self.cfg = IntegratorConfig(kind=tr["kind"], max_depth=tr["max_depth"],
                                    light_strategy=tr["light_strategy"])
        self._render = render_fn
        self.request(0)
        return {"scene_build_s": self.built.build_s}

    def reference_images(self, pick, pixels, dt=torch.float32):
        ref = LensScene(self.desc, self.run.device, dt)
        spp = self.tr["spp"]
        return {k: pixel_means(ref, pixels, np.arange(k * spp, (k + 1) * spp),
                               self.tr["kind"], self.tr["max_depth"]) for k in pick}
