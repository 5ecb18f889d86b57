"""Closed-loop image requests, one client: request k renders the whole film at
the traffic's samples a pixel, sample indices [k·spp, (k+1)·spp), through
the system's `render`, and waits for it. Request 0 is the set-up's warm-up;
the window's requests start at 1.

Traffic parameters: res, spp, kind, max_depth, light_strategy; check_pixels
(how many pixels of two of the window's images the reference re-renders
after the window), and the limit of the one number compared, rel_gap."""
from __future__ import annotations

import numpy as np
import torch

from .. import scenes
from ..reference.render import Scene as RefScene, pixel_means


class Generator:
    def __init__(self, run):
        self.run, self.tr = run, run.traffic
        self.images = {}

    def setup(self):
        from grail_torch.engine.integrator import IntegratorConfig
        from grail_torch.engine.render import render
        tr, run = self.tr, self.run
        self.desc = scenes.describe(run.config, run.seed, tr["res"], tr["res"])
        self.built = scenes.build_program(self.desc, tr["spp"], run.device)
        self.cfg = IntegratorConfig(kind=tr["kind"], max_depth=tr["max_depth"],
                                    light_strategy=tr["light_strategy"])
        self._render = render
        self.request(0)
        return {"scene_build_s": self.built.build_s}

    @property
    def rays_per_request(self):
        return self.tr["res"] * self.tr["res"] * self.tr["spp"]

    def request(self, k):
        spp = self.tr["spp"]
        img, _ = self._render(self.built.scene, self.built.meta, self.cfg,
                              spp=(k + 1) * spp, start_wave=k * spp, device=self.run.device)
        self.run.sync()
        if k > 0:
            self.images[k] = img
        return img

    def end_to_end(self, window):
        return {"camera_rays_per_s": window.rays / window.seconds}

    def free(self):
        self.built = None

    # ------------------------------------------------------------- check
    def _draw(self):
        """(images, pixels) the check compares, drawn from the seed: the
        window's first image and one other (where there is one), the same
        pixels in each."""
        rng = np.random.default_rng(scenes.seed_words(self.run.seed)[3])
        ks = sorted(self.images)
        pick = [ks[0]] + ([int(rng.choice(ks[1:]))] if len(ks) > 1 else [])
        npix = self.tr["res"] * self.tr["res"]
        pixels = np.sort(rng.choice(npix, size=min(self.tr["check_pixels"], npix),
                                    replace=False))
        return pick, pixels

    def reference_images(self, pick, pixels, dt=torch.float32):
        ref = RefScene(self.desc, self.run.device, dt)
        spp = self.tr["spp"]
        return {k: pixel_means(ref, pixels, np.arange(k * spp, (k + 1) * spp),
                               self.tr["kind"], self.tr["max_depth"]) for k in pick}

    def program_pixels(self, pick, pixels):
        return {k: self.images[k].reshape(-1, 3)[torch.as_tensor(pixels)]
                .double().cpu().numpy() for k in pick}

    @staticmethod
    def compare(got, ref):
        """rel_gap: the summed absolute difference over the summed reference,
        over every compared pixel and channel of every compared image."""
        num = sum(np.abs(got[k] - ref[k]).sum() for k in ref)
        den = sum(np.abs(ref[k]).sum() for k in ref)
        return {"rel_gap": float(num / max(den, 1e-30))}

    def check(self):
        pick, pixels = self._draw()
        got = self.program_pixels(pick, pixels)
        self.images.clear()
        self.free()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
        return self.compare(got, self.reference_images(pick, pixels))

    def control(self):
        """The reference in bfloat16 in the program's place."""
        pick, pixels = self._draw()
        self.images.clear()
        self.free()
        ref = self.reference_images(pick, pixels)
        return self.compare(self.reference_images(pick, pixels, torch.bfloat16), ref)
