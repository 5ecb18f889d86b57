"""Inverse rendering (port of grail/tools/optimize.py): recover scene
parameters from a target image by gradient descent through the path-traced
render. Every step re-renders, and backpropagates through the intersector's
frozen-prim backward, shading, MIS direct lighting and the film.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..engine import film as flm
from ..engine.render import render_wave


def optimize_albedo(scene, meta, cfg, target, steps=60, lr=0.05, spp=None,
                    param_rows=None, verbose=False, device=None):
    """Gradient-descent recovery of the texture table's albedos (the rows of
    tex_data["const"]) from `target`, an (H,W,3) image rendered with the
    true values. The optimized rows start grey (0.5); Adam(lr) steps on the
    mean squared image error, with the gradient masked to `param_rows`
    (default: every row) and the albedos clamped to [0, 1] after each step.
    Returns (optimized const (R,3), per-step losses)."""
    device = resolve_device(device)
    spp = spp if spp is not None else meta.sampler.spp
    target = torch.as_tensor(target, device=device)
    init = scene["tex_data"]["const"]
    mask = torch.zeros((init.shape[0], 1), dtype=torch.float32, device=device)
    mask[list(range(init.shape[0]) if param_rows is None else param_rows)] = 1.0
    params = (init * 0.0 + 0.5 * mask + init * (1.0 - mask)).requires_grad_(True)
    opt = torch.optim.Adam([params], lr=lr)
    losses = []
    for it in range(steps):
        s = dict(scene, tex_data=dict(scene["tex_data"], const=params))
        film = flm.new_film(meta.xres, meta.yres, device)
        for w in range(spp):
            film = render_wave(s, meta, cfg, film, w, device=device)
        loss = torch.mean((flm.develop(film) - target) ** 2)
        opt.zero_grad()
        loss.backward()
        params.grad *= mask                 # only the requested rows move
        opt.step()
        with torch.no_grad():
            params.clamp_(0.0, 1.0)
        losses.append(loss.item())
        if verbose and (it % 10 == 0 or it == steps - 1):
            print(f"step {it:3d}  loss {losses[-1]:.6f}")
    return params.detach(), losses
