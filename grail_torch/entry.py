"""The port's entry points for a quick check (the twin of the repository's
__graft_entry__.py): `entry` gives a one-wave render function of the
Cornell box and its arguments; `dryrun_multichip(n)` runs the multi-rank
sequence on n ranks (a sharded render, a sharded photon render and one
training step), one card a rank through NCCL unless device="cpu" asks for
gloo CPU ranks.
"""
from __future__ import annotations

import torch

from .device import resolve_device
from .dist.launch import run_ranks
from .dist.sharding import make_train_step, render_sharded
from .engine import film as flm
from .engine.integrator import IntegratorConfig
from .engine.render import render_wave
from .scene.presets import cornell_box


def entry(device=None):
    """(fn, args): one path-traced wave over the 64x64 Cornell box;
    fn(scene, film, samp_idx) returns the new film."""
    device = resolve_device(device)
    scene, meta, _ = cornell_box(xres=64, yres=64, spp=4, device=device)
    cfg = IntegratorConfig(kind="path", max_depth=3)

    def fn(scene, film, samp_idx):
        return render_wave(scene, meta, cfg, film, samp_idx, device=device)

    return fn, (scene, flm.new_film(meta.xres, meta.yres, device), 0)


def dryrun_rank(mesh):
    """One rank of dryrun_multichip: returns (loss, gradient norm)."""
    scene, meta, _ = cornell_box(xres=16, yres=16, spp=2, device=mesh.device)
    cfg = IntegratorConfig(kind="path", max_depth=2)
    img, _ = render_sharded(scene, meta, cfg, spp=1, mesh=mesh)
    if not torch.isfinite(img).all():
        raise RuntimeError("the sharded render is not finite")
    cfg_ph = IntegratorConfig(kind="photon", photon_paths=64 * mesh.world_size,
                              photon_radius=0.3)
    img_ph, _ = render_sharded(scene, meta, cfg_ph, spp=1, mesh=mesh)
    if not torch.isfinite(img_ph).all():
        raise RuntimeError("the sharded photon render is not finite")
    target = torch.zeros((meta.yres, meta.xres, 3), device=mesh.device)
    loss, grads = make_train_step(meta, cfg, mesh)(scene, target, 0)
    g = grads["tex_data"]["const"]
    if not (torch.isfinite(loss) and torch.isfinite(g).all()):
        raise RuntimeError("the training step's loss or gradient is not finite")
    return float(loss), float(torch.linalg.vector_norm(g))


def dryrun_multichip(n_devices, device=None, timeout_s=300):
    """Run dryrun_rank on n_devices ranks (spawned, dist/launch.py); prints
    and returns rank 0's (loss, gradient norm)."""
    if device is None:
        resolve_device(device)
        device = "cuda"
    loss, gnorm = run_ranks(dryrun_rank, n_devices, device, timeout_s)[0]
    print(f"dryrun_multichip({n_devices}): loss={loss:.6f}, grad_norm={gnorm:.6f}")
    return loss, gnorm
