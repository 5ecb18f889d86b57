"""The `render` generator's closed loop on instanced geometry: the
configuration's objects are added once each through the system's
SceneBuilder (add_object, add_object_mesh) and placed by add_instance, so
every ray of the render takes the system's two-level route (the TLAS sweep
and the 4-wide walk from each ray's own BLAS root); the lights are point
lights. The check's reference is reference/instances.py's InstancesScene,
which flattens every instance into world-space triangles and never walks
two levels. Set-up raises where the finalized scene has no instance table
or does not hold the configured instances of one object, so a scene
flattened by mistake fails loudly.

Besides `render`'s rel_gap, the check compares where the instances are:
camera rays through the centres of `hit_rays` pixels drawn from the seed
(the reference camera's rays, handed to both sides) are cast once through
the system's intersect dispatch, on the scene the window rendered, and
once through the reference's brute force; hit_gap is the share of rays
whose hit lies on another instance on the two sides (the world's own
meshes count as one, a miss as another). A pixel check of a few hundred
pixels sees an instance misplaced only where a compared pixel falls on
it; a ray cast on many more pixels sees it wherever it lies. The instance
and not the hit's t is compared: a ray that slips between two triangles
of a sphere in one side's rounding and meets its far side in the other's
hits the same instance, and such rays are about one in ten thousand on
50,176-triangle spheres seen whole.

Traffic parameters: those of `render`, and hit_rays with the limit of
hit_gap."""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import scenes
from ..reference.geometry import RAY_TMAX, Camera, closest_hit
from ..reference.instances import InstancesScene
from ..reference.render import pixel_means
from . import render

BASE, MISS = -1, -2         # hit_gap's classes of the world's meshes and of a miss


def build_program(desc, spp, device):
    """The description through the system's SceneBuilder, to `device`: the
    world meshes, the Lambertian materials, each object once, its
    instances, the point lights and the pinhole camera."""
    from grail_torch.core import transform as tr
    from grail_torch.core.rng import SamplerConfig, ZERO_TWO
    from grail_torch.engine import camera as cam
    from grail_torch.engine.filters import FilterConfig
    from grail_torch.scene.buffers import SceneBuilder

    t0 = time.perf_counter()
    b = SceneBuilder()
    b.xres, b.yres = desc["xres"], desc["yres"]
    b.sampler = SamplerConfig(kind=ZERO_TWO, spp=spp, seed=desc["seed"])
    b.filter = FilterConfig.from_name("box")
    mat_ids = {}
    for name, lobes in desc["materials"].items():
        if [lb["kind"] for lb in lobes] != ["lambert"]:
            raise ValueError("the instanced configuration takes one Lambertian lobe a material")
        mat_ids[name] = b.matte(kd=tuple(lobes[0]["kd"]))
    for m in desc["meshes"]:
        b.add_mesh(m["verts"], m["idx"], mat_ids[m["material"]])
    obj_ids = {}
    for name, ob in desc["objects"].items():
        obj_ids[name] = b.add_object()
        b.add_object_mesh(obj_ids[name], ob["verts"], ob["idx"], mat_ids[ob["material"]])
    for ins in desc["instances"]:
        b.add_instance(obj_ids[ins["object"]], ins["m0"])
    for lg in desc["point_lights"]:
        b.add_point_light(tuple(lg["pos"]), tuple(lg["intensity"]))
    c = desc["camera"]
    c2w = tr.look_at(c["pos"], c["look"], c["up"])
    b.camera = cam.build_camera(cam.PERSPECTIVE, c2w, c2w, desc["xres"], desc["yres"],
                                fov=c["fov"])
    scene, meta = b.finalize(device)
    inst = scene.get("inst")
    if inst is None:
        raise ValueError("the instanced cell's scene has no instance table")
    objs = set(inst["obj"].tolist())
    if inst["root"].shape[0] != len(desc["instances"]) or len(objs) != len(desc["objects"]):
        raise ValueError(f"the instanced cell's scene holds {inst['root'].shape[0]} instances "
                         f"of {len(objs)} objects, not {len(desc['instances'])} of "
                         f"{len(desc['objects'])}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return scenes.Built(scene, meta, {}, time.perf_counter() - t0)


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
        self._refs = {}
        self.request(0)
        return {"scene_build_s": self.built.build_s}

    def reference_scene(self, dt):
        """The reference scene in float type dt, made once a check (the
        pixels and the hit rays share it)."""
        if dt not in self._refs:
            self._refs[dt] = InstancesScene(self.desc, self.run.device, dt)
        return self._refs[dt]

    def reference_images(self, pick, pixels, dt=torch.float32):
        ref = self.reference_scene(dt)
        spp = self.tr["spp"]
        return {k: pixel_means(ref, pixels, np.arange(k * spp, (k + 1) * spp),
                               self.tr["kind"], self.tr["max_depth"]) for k in pick}

    # ------------------------------------------------------------- hits
    def hit_rays(self):
        """The reference camera's rays (float32, on the run's device) through
        the centres of hit_rays pixels drawn from the seed."""
        tr = self.tr
        rng = np.random.default_rng([scenes.seed_words(self.run.seed)[3], 1])
        npix = tr["res"] * tr["res"]
        pix = torch.as_tensor(np.sort(rng.choice(npix, size=min(tr["hit_rays"], npix),
                                                 replace=False)), device=self.run.device)
        cam = Camera(self.desc["camera"], tr["res"], tr["res"], self.run.device, torch.float32)
        return cam.rays((pix % tr["res"]).float() + 0.5, (pix // tr["res"]).float() + 0.5)

    def program_hits(self, o, d):
        """Each ray's class on the system's intersect dispatch, on the scene
        the window rendered: its instance, BASE or MISS."""
        from grail_torch.kernels.intersect import intersect
        with torch.no_grad():
            hit = intersect(self.built.scene, o.contiguous(), d.contiguous(),
                            torch.full(o.shape[:1], RAY_TMAX, device=o.device),
                            device=self.run.device)
        return torch.where(hit["prim"] < 0, MISS,
                           torch.where(hit["inst"] >= 0, hit["inst"], BASE)).long().cpu()

    def reference_hits(self, o, d, dt=torch.float32):
        """Each ray's class on the reference's brute force."""
        ref = self.reference_scene(dt)
        with torch.no_grad():
            _, prim, _, _ = closest_hit(ref.tri, o.to(dt), d.to(dt),
                                        torch.full(o.shape[:1], RAY_TMAX, dtype=dt,
                                                   device=o.device))
        return torch.where(prim < 0, MISS, ref.tri_inst[prim.clamp_min(0)]).cpu()

    @staticmethod
    def hit_gap(got, ref):
        return float((got != ref).double().mean())

    def check(self):
        o, d = self.hit_rays()
        got = self.program_hits(o, d)
        out = super().check()
        out["hit_gap"] = self.hit_gap(got, self.reference_hits(o, d))
        self._refs.clear()
        return out

    def control(self):
        """The reference in bfloat16 in the program's place."""
        o, d = self.hit_rays()
        out = super().control()
        out["hit_gap"] = self.hit_gap(self.reference_hits(o, d, torch.bfloat16),
                                      self.reference_hits(o, d))
        self._refs.clear()
        return out
