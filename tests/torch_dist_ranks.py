"""The rank side of tests/test_torch_dist.py and test_torch_scene_shard.py:
functions that grail_torch.dist.launch.run_ranks runs in gloo CPU ranks.
They import the port only (no JAX), make their inputs from the port's
presets and seeds, and return numpy arrays."""
import numpy as np
import torch

from grail_torch.dist.scene_shard import local_ring, partition_scene, ring_intersect
from grail_torch.dist.sharding import (make_train_step, render_scene_sharded,
                                       render_sharded)
from grail_torch.engine import metropolis as mlt
from grail_torch.engine import photonmap
from grail_torch.engine.integrator import IntegratorConfig
from grail_torch.scene.presets import cornell_box

RES, SPP = 16, 2
DIRECT = IntegratorConfig(kind="direct", max_depth=1)
RING_PATH = IntegratorConfig(kind="path", max_depth=3, compact=False)
PHOTONS = photonmap.PhotonConfig(n_paths=2048, radius=0.3)
MLT_CFG = mlt.MLTConfig(max_depth=3, n_chains=256, n_bootstrap=256, mutations_per_wave=4)
MLT_WAVES = 1


def _np(x):
    return x.detach().cpu().numpy()


def render_job(mesh):
    scene, meta, _ = cornell_box(RES, RES, SPP, device=mesh.device)
    return {f"render_{name}": _np(render_sharded(scene, meta, DIRECT, SPP, mesh,
                                                 fused=fused)[0])
            for name, fused in (("fused", True), ("unfused", False))}


def train_job(mesh):
    scene, meta, _ = cornell_box(RES, RES, SPP, device=mesh.device)
    target = torch.zeros((meta.yres, meta.xres, 3))
    loss, grads = make_train_step(meta, DIRECT, mesh)(scene, target, 0)
    return {"loss": float(loss), **{f"grad_{k}": _np(v) for k, v in grads["tex_data"].items()}}


def photon_job(mesh):
    scene, meta, _ = cornell_box(8, 8, 1, device=mesh.device)
    raw = photonmap.gather_photons(scene, meta, PHOTONS, mesh)
    grid = photonmap.shoot_photons_sharded(scene, meta, PHOTONS, mesh)
    return {**{f"raw_{k}": _np(v) for k, v in raw.items()},
            **{f"grid_{k}": _np(v) for k, v in grid.items()}}


def mlt_job(mesh):
    scene, meta, _ = cornell_box(RES, RES, SPP, with_boxes=False, device=mesh.device)
    return {"mlt": _np(mlt.render_mlt_sharded(scene, meta, MLT_CFG, MLT_WAVES, mesh)[0])}


def ring_rays_job(mesh, o, d, tmax):
    """ring_intersect over a partition into world_size shards, closest and
    any hit, of this rank's slice of the rays."""
    scene, _, _ = cornell_box(RES, RES, 1, device=mesh.device)
    shard = local_ring(partition_scene(scene, mesh.world_size), mesh)
    per = o.shape[0] // mesh.world_size
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    hit = ring_intersect(shard, *(torch.tensor(a[mine]) for a in (o, d, tmax)))
    occ = ring_intersect(shard, *(torch.tensor(a[mine]) for a in (o, d, tmax)), any_hit=True)
    return {**{k: _np(hit[k]) for k in ("t", "prim", "b1", "b2")},
            "occluded": _np(occ["occluded"])}


def ring_render_job(mesh):
    scene, meta, _ = cornell_box(RES, RES, SPP, device=mesh.device)
    return {f"ring_{name}": _np(render_scene_sharded(scene, meta, RING_PATH, SPP, mesh,
                                                     stream=stream)[0])
            for name, stream in (("brute", False), ("stream", True))}


JOBS = {"render": render_job, "train": train_job, "photon": photon_job, "mlt": mlt_job,
        "ring_rays": ring_rays_job, "ring_render": ring_render_job}


def run_jobs(mesh, jobs):
    """jobs: [(name, args)]; returns {output: array} of them all."""
    out = {}
    for name, args in jobs:
        out.update(JOBS[name](mesh, *args))
    return out


def failing(mesh):
    raise ValueError(f"rank {mesh.rank} fails on purpose")


def hanging(mesh):
    import time
    time.sleep(3600)
