"""Inverse rendering, one client: gradient steps on the albedos of the
configuration's Lambertian materials named in the traffic ("params"), which
start grey. A step renders one sample a pixel through the system's
`render_wave` (sample index target_spp + k at step k), takes the mean squared
error against a target the system rendered at set-up with the true albedos
(target_spp samples a pixel), runs the backward pass and an Adam step.

Set-up builds the one training object and drives it through its first
`check_steps` steps through the same call as the window; the check follows
those steps with the reference (the loss of each, the first gradient as
Adam's state holds it, the albedos' change over the steps)."""
from __future__ import annotations

import numpy as np
import torch

from .. import scenes
from ..reference.render import Scene as RefScene

BETAS, EPS = (0.9, 0.999), 1e-8


def mse(img, target):
    """The step's loss: the mean squared error over every pixel and channel."""
    return torch.mean((img - target) ** 2)


def leaf_gap(got, ref):
    """The worst leaf's |norm(got) - norm(ref)| over the larger of that
    leaf's reference norm and the median leaf's; leaves whose reference
    gradient is under a thousandth of the median leaf's are left out."""
    norms = {k: float(np.linalg.norm(v)) for k, v in ref.items()}
    med = float(np.median(list(norms.values())))
    return max(abs(float(np.linalg.norm(got[k])) - norms[k]) / max(norms[k], med, 1e-30)
               for k in ref)


class Generator:
    def __init__(self, run):
        self.run, self.tr = run, run.traffic
        self.backward_s = []
        self.time_backward = False

    def setup(self):
        from grail_torch.engine import film as flm
        from grail_torch.engine.integrator import IntegratorConfig
        from grail_torch.engine.render import render, render_wave
        tr, run = self.tr, self.run
        self.desc = scenes.describe(run.config, run.seed, tr["res"], tr["res"])
        self.built = scenes.build_program(self.desc, tr["target_spp"], run.device)
        self.cfg = IntegratorConfig(kind="path", max_depth=tr["max_depth"])
        self._flm, self._render_wave = flm, render_wave
        scene, meta = self.built.scene, self.built.meta
        self.target, _ = render(scene, meta, self.cfg, spp=tr["target_spp"], device=run.device)
        const = scene["tex_data"]["const"]
        self.rows = torch.tensor([self.built.albedo_rows[m] for m in tr["params"]],
                                 device=run.device)
        self.params = {m: torch.full((3,), tr["init"], device=run.device, requires_grad=True)
                       for m in tr["params"]}
        self.base_const = const.detach().clone()
        self.opt = torch.optim.Adam(list(self.params.values()), lr=tr["lr"], betas=BETAS,
                                    eps=EPS)
        p0 = {m: p.detach().cpu().numpy().copy() for m, p in self.params.items()}
        self.losses = []
        for k in range(tr["check_steps"]):
            self.losses.append(float(self.step(k)))
            if k == 0:
                # the gradient as Adam got it; none where it took no step
                self.grad0 = {m: (self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                                  / (1.0 - BETAS[0])).cpu().numpy().copy()
                              for m, p in self.params.items()}
        self.change = {m: p.detach().cpu().numpy() - p0[m] for m, p in self.params.items()}
        self.next_step = tr["check_steps"]
        return {"scene_build_s": self.built.build_s}

    @property
    def rays_per_request(self):
        return self.tr["res"] * self.tr["res"]

    def step(self, k):
        scene, meta = self.built.scene, self.built.meta
        const = self.base_const.index_put((self.rows,), torch.stack(list(self.params.values())))
        s = dict(scene, tex_data=dict(scene["tex_data"], const=const))
        f = self._render_wave(s, meta, self.cfg, self._flm.new_film(meta.xres, meta.yres,
                                                                     self.run.device),
                              self.tr["target_spp"] + k, device=self.run.device)
        loss = mse(self._flm.develop(f), self.target)
        self.opt.zero_grad(set_to_none=True)
        if self.time_backward:
            import time
            self.run.sync()
            t0 = time.perf_counter()
            loss.backward()
            self.run.sync()
            self.backward_s.append(time.perf_counter() - t0)
        else:
            loss.backward()
        self.opt.step()
        self.run.sync()
        return loss.detach()

    def request(self, k):
        loss = self.step(self.next_step)
        self.next_step += 1
        return loss

    def end_to_end(self, window):
        return {"train_rays_per_s": window.rays / window.seconds,
                "train_step_ms_p90": 1e3 * window.p90}

    def free(self):
        self.built = self.opt = self.params = self.target = self.base_const = None

    # ------------------------------------------------------------- check
    def reference(self, dt=torch.float32):
        """The reference's losses, first gradient and change over the
        check's steps, from the same description, grey start and Adam."""
        tr, dev = self.tr, self.run.device
        npix = tr["res"] * tr["res"]
        pix = torch.arange(npix, device=dev)
        with torch.no_grad():
            target_scene = RefScene(self.desc, dev, dt)
            acc = 0
            for s in range(tr["target_spp"]):
                acc = acc + target_scene.li(pix, torch.full_like(pix, s), "path",
                                            tr["max_depth"])[0]
            target = acc / tr["target_spp"]
        params = {m: torch.full((3,), tr["init"], dtype=dt, device=dev, requires_grad=True)
                  for m in tr["params"]}
        m1 = {m: torch.zeros(3, dtype=torch.float64) for m in params}
        m2 = {m: torch.zeros(3, dtype=torch.float64) for m in params}
        start = {m: p.detach().double().cpu().clone() for m, p in params.items()}
        losses, grad0 = [], None
        for k in range(tr["check_steps"]):
            scene = RefScene(self.desc, dev, dt, albedo=params)
            L = scene.li(pix, torch.full_like(pix, tr["target_spp"] + k), "path",
                         tr["max_depth"])[0]
            loss = torch.mean((L - target) ** 2)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for (m, p), g in zip(params.items(), grads):
                    g = g.double().cpu()
                    if k == 0:
                        grad0 = dict(grad0 or {}, **{m: g.numpy()})
                    m1[m] = BETAS[0] * m1[m] + (1 - BETAS[0]) * g
                    m2[m] = BETAS[1] * m2[m] + (1 - BETAS[1]) * g * g
                    mh = m1[m] / (1 - BETAS[0] ** (k + 1))
                    vh = m2[m] / (1 - BETAS[1] ** (k + 1))
                    p -= (tr["lr"] * mh / (vh.sqrt() + EPS)).to(dev, dt)
        change = {m: (p.detach().double().cpu() - start[m]).numpy() for m, p in params.items()}
        return losses, grad0, change

    @staticmethod
    def compare(got, ref):
        (lg, gg, cg), (lr, gr, cr) = got, ref
        return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lg, lr)),
                "grad_gap": leaf_gap(gg, gr), "step_gap": leaf_gap(cg, cr)}

    def check(self):
        got = (self.losses, self.grad0, self.change)
        self.free()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
        return self.compare(got, self.reference())

    def control(self):
        self.free()
        return self.compare(self.reference(torch.bfloat16), self.reference())
