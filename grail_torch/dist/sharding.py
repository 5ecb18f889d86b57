"""Multi-process distribution on torch.distributed (port of
grail/dist/sharding.py, whose ranks are the devices of a mesh under
shard_map).

One process a rank, one card a rank (NCCL; gloo for CPU ranks). The scene
is replicated; each rank renders its own pixels into its own film and the
films merge in one all-reduce. Counter-based sampling makes every lane a
pure function of (pixel, sample), so the image is the single-device render's
up to the order of the film's float sums.

- render_sharded: each rank owns a band of pixel rows (_band_layout) and
  accumulates it into a band film with dense shifted adds
  (film.add_samples_band), one sample a pixel a wave as the reference;
  _band_to_film places the band in the padded global film and all-reduces
  it (the only collective). fused=True all-reduces once a render,
  fused=False once a wave.
- make_train_step: one wave over the rank's slice of the padded pixel grid
  (scatter film), the film all-reduced, developed and compared with a
  target; the loss's gradient for the scene leaves under param_paths,
  all-reduced. The film's reduce passes the cotangent through unchanged in
  backward (each rank differentiates the whole loss through its own
  pixels), so the gradient is the single-device one at any world size.
- render_scene_sharded: the triangles partitioned over the ranks
  (dist/scene_shard.py), rays passed around the ring at every trace.
- _preprocess_aux: photon shooting split over the ranks
  (photonmap.shoot_photons_sharded); the other preprocesses replicated.

make_mesh returns this rank's Mesh; maybe_init_distributed joins a group
from the environment: COORDINATOR_ADDRESS (host:port) with NUM_PROCESSES
and PROCESS_ID as the reference reads them, or GRAIL_DIST=1 for a launcher
that sets torch's own variables (torchrun: env://). A lone process with no
group is a mesh of one rank, whose collectives are the identity.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..engine import film as flm
from ..engine import photonmap
from ..engine.integrator import IntegratorConfig
from ..engine.render import photon_config, preprocess, render_wave

# the leaves a scene-sharded render leaves out: no rank holds the mesh
MESH_KEYS = ("verts", "vnorm", "vuv", "tri_idx", "tri_mat", "tri_light", "tri_flags",
             "tri_alpha", "bvh")
TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the run: its process group (None for a lone
    process), the world size, its rank and its device."""
    world_size: int
    rank: int
    device: torch.device
    group: object = None

    def all_reduce(self, x):
        """x summed over the ranks, in place; returns x."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def reduce(self, film):
        """Every leaf of a dict of float32 tensors (a film) summed over the
        ranks, in one all-reduce; gradients pass through it (_Sum)."""
        flat = _Sum.apply(torch.cat([v.reshape(-1) for v in film.values()]), self)
        parts = flat.split([v.numel() for v in film.values()])
        return {k: p.reshape(v.shape) for (k, v), p in zip(film.items(), parts)}

    def all_gather(self, x):
        """(world_size, *x.shape): every rank's x in rank order."""
        if self.group is None:
            return x[None]
        y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(y) for _ in range(self.world_size)]
        dist.all_gather(parts, y, group=self.group)
        out = torch.stack(parts)
        return out.to(torch.bool) if x.dtype == torch.bool else out

    def ring_pass(self, *bufs):
        """Each buffer sent to the next rank around the ring and received
        from the previous one; a lone rank keeps its own."""
        if self.world_size == 1:
            return bufs
        nxt = (self.rank + 1) % self.world_size
        prv = (self.rank - 1) % self.world_size
        got = [torch.empty_like(b) for b in bufs]
        ops = ([dist.P2POp(dist.isend, b.contiguous(), nxt, self.group) for b in bufs]
               + [dist.P2POp(dist.irecv, g, prv, self.group) for g in got])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(got)


def _backend(device):
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_init_distributed(device=None):
    """Join the process group the environment describes: COORDINATOR_ADDRESS
    (host:port), NUM_PROCESSES, PROCESS_ID (tcp://), or GRAIL_DIST=1 with
    torch's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (env://, as
    torchrun sets them). NCCL on the card, gloo for device="cpu". Returns
    True when it joined one; False when the process already has a group or
    the environment names none."""
    if dist.is_initialized():
        return False
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if os.environ.get("COORDINATOR_ADDRESS"):
        world = int(os.environ.get("NUM_PROCESSES", "1"))
        rank = int(os.environ.get("PROCESS_ID", "0"))
        dev = _local_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(_backend(dev),
                                init_method="tcp://" + os.environ["COORDINATOR_ADDRESS"],
                                world_size=world, rank=rank, timeout=timeout)
        return True
    if os.environ.get("GRAIL_DIST") == "1":
        dev = _local_device(int(os.environ.get("RANK", "0")), device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(_backend(dev), init_method="env://", timeout=timeout)
        return True
    return False


def _local_device(rank, device):
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if device is not None and torch.device(device).index is not None:
        return resolve_device(device)
    resolve_device("cuda")
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def make_mesh(n=None, device=None):
    """This rank's Mesh. Joins the environment's group first where there is
    one (maybe_init_distributed); a process without a group is a mesh of
    one rank. n: the world size the caller expects (checked). device: the
    card of this rank (cuda:<local rank>) unless the caller names one;
    "cpu" for gloo ranks. The group's backend must suit the device: NCCL
    on the card, gloo on the CPU."""
    maybe_init_distributed(device)
    if dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks was asked for, but the process group "
                         f"has {world}")
    dev = _local_device(rank, device)
    if group is not None and dist.get_backend(group) != _backend(dev):
        raise RuntimeError(f"the process group runs {dist.get_backend(group)}, but "
                           f"{dev} ranks need {_backend(dev)}")
    return Mesh(world, rank, dev, group)


def _pad_pixels(n_pixels, n_dev):
    per = -(-n_pixels // n_dev)
    return per * n_dev, per


class _Sum(torch.autograd.Function):
    """All-reduce (sum) whose backward passes the cotangent through: the
    loss after the reduce is the same on every rank, and each rank's
    backward covers the terms of its own inputs (their sum over the ranks
    is the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def _band_layout(meta, n_dev):
    """(rows, margin, tiled) of the row bands: each rank owns `rows`
    consecutive pixel rows (n_dev*rows >= yres; a multiple of the tile
    height in 8x16 tile lane order where the width tiles) plus `margin`
    filter-spill rows each side."""
    margin = int(math.floor(meta.filter.ywidth + 0.5))
    rows = -(-meta.yres // n_dev)
    tiled = meta.xres % flm.TILE_W == 0
    if tiled:
        rows = -(-rows // flm.TILE_H) * flm.TILE_H
    return rows, margin, tiled


def _band_pixels(meta, mesh):
    """(pixel ids in the band's lane order, valid, rows, margin, tiled) of
    this rank's band; rows past the image are invalid lanes on the last
    row."""
    rows, margin, tiled = _band_layout(meta, mesh.world_size)
    lane = torch.arange(rows * meta.xres, dtype=torch.int64, device=mesh.device)
    if tiled:
        px, py_local = flm.lane_pixel(lane, meta.xres)
    else:
        px, py_local = lane % meta.xres, lane // meta.xres
    py = mesh.rank * rows + py_local.to(torch.int64)
    valid = py < meta.yres
    pix = torch.clamp_max(py, meta.yres - 1) * meta.xres + px.to(torch.int64)
    return pix, valid, rows, margin, tiled


def _band_to_film(band, film, rows, margin, mesh):
    """This rank's band placed in the padded global film, all-reduced (the
    only collective), cropped and added to `film`."""
    yres = film["weight"].shape[0]
    start = mesh.rank * rows

    def place(x):
        full = x.new_zeros((mesh.world_size * rows + 2 * margin,) + x.shape[1:])
        full[start:start + x.shape[0]] = x
        return full

    full = mesh.reduce({k: place(v) for k, v in band.items()})
    return {k: film[k] + full[k][margin:margin + yres] for k in film}


def _render_band(scene, meta, cfg, film, s0, s1, mesh, aux):
    """Samples s0 .. s1-1 of this rank's band, one sample a pixel a wave,
    into one band film, merged into `film` by one all-reduce; returns the
    new film (the same on every rank)."""
    pix, valid, rows, margin, tiled = _band_pixels(meta, mesh)
    band = flm.new_band_film(rows, meta.xres, margin, mesh.device)
    for s in range(s0, s1):
        band = render_wave(scene, meta, cfg, band, s, pix=pix, mask=valid, aux=aux,
                           band=(margin, tiled), device=mesh.device)
    return _band_to_film(band, film, rows, margin, mesh)


@torch.no_grad()
def render_wave_sharded(scene, meta, cfg, film, samp_idx, mesh, aux=None):
    """One sample a pixel of the image over the ranks, merged into `film`
    by one all-reduce."""
    return _render_band(scene, meta, cfg, film, samp_idx, samp_idx + 1, mesh, aux)


@torch.no_grad()
def render_sharded(scene, meta, cfg: IntegratorConfig, spp, mesh, film=None, fused=True):
    """Sharded render; returns (image, film), the same on every rank.
    fused=True: every wave of the band into one band film and one
    all-reduce at the end; fused=False: one all-reduce a wave."""
    if film is None:
        film = flm.new_film(meta.xres, meta.yres, mesh.device)
    aux = _preprocess_aux(scene, meta, cfg, mesh)
    if fused:
        film = _render_band(scene, meta, cfg, film, 0, spp, mesh, aux)
    else:
        for s in range(spp):
            film = render_wave_sharded(scene, meta, cfg, film, s, mesh, aux)
    return flm.develop(film), film


@torch.no_grad()
def render_scene_sharded(scene, meta, cfg: IntegratorConfig, spp, mesh, film=None,
                         stream=False):
    """Scene-sharded render: the triangles partitioned over the ranks
    (scene_shard.partition_scene; no rank keeps the mesh leaves), pixel
    bands as render_sharded, and every trace of the bounce loop passed
    around the ring (scene_shard.ring_intersect), shading from the carried
    triangle record. stream=True gives each shard a 4-wide table (the 4-wide
    walk as the local step) in place of brute force. Plain triangle scenes
    only. Compaction is off: it branches on each rank's own lane count, so
    ranks would trace different numbers of waves and issue different
    collectives. Returns (image, film), the same on every rank."""
    from .scene_shard import local_ring, partition_scene
    if scene.get("inst") is not None or scene.get("media") is not None \
            or getattr(meta, "alpha_rows", ()):
        raise NotImplementedError("the ring renders plain triangle scenes (no instances, "
                                  "media or alpha cutouts): use render_sharded")
    cfg = dataclasses.replace(cfg, compact=False)
    if film is None:
        film = flm.new_film(meta.xres, meta.yres, mesh.device)
    ring = partition_scene(scene, mesh.world_size, stream=stream)
    local = {k: v for k, v in scene.items() if k not in MESH_KEYS}
    local["ring"] = local_ring(ring, mesh)
    film = _render_band(local, meta, cfg, film, 0, spp, mesh, None)
    return flm.develop(film), film


def _preprocess_aux(scene, meta, cfg, mesh):
    """The render's preprocess: photon shooting split over the ranks where
    they divide the paths (each shoots a slice of the counter stream; the
    gathered grid is the replicated shoot's, bitwise), every other kind
    replicated."""
    if cfg.kind == "photon" and mesh.world_size > 1 \
            and cfg.photon_paths % mesh.world_size == 0:
        return photonmap.shoot_photons_sharded(scene, meta, photon_config(cfg), mesh)
    return preprocess(scene, meta, cfg)


def _requiring_grad(tree):
    """tree with each floating-point tensor leaf replaced by a detached copy
    that requires grad."""
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_requiring_grad(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.detach().clone().requires_grad_(True)
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) and tree.requires_grad else []


def _rebuild(tree, grads):
    """tree's structure with each leaf that requires grad replaced by the
    next of `grads`, every other leaf by None."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, grads) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, grads) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.requires_grad:
        return next(grads)
    return None


def make_train_step(meta, cfg, mesh, param_paths=("tex_data",)):
    """A training step over the ranks: each renders one wave of its slice
    of the padded pixel grid, the film is all-reduced and developed, and the
    loss is the mean squared difference from `target`. Returns
    step(scene, target (H, W, 3), samp_idx) -> (loss, grads): grads has the
    structure of the scene's leaves under param_paths (None for leaves that
    are not floating point) and is summed over the ranks: the
    single-device gradient, the same on every rank."""
    n_pix = meta.xres * meta.yres
    _, per = _pad_pixels(n_pix, mesh.world_size)
    lane = torch.arange(mesh.rank * per, (mesh.rank + 1) * per, dtype=torch.int64,
                        device=mesh.device)
    valid = lane < n_pix
    pix = torch.where(valid, lane, 0)

    def step(scene, target, samp_idx):
        params = {k: _requiring_grad(scene[k]) for k in param_paths}
        f = flm.new_film(meta.xres, meta.yres, mesh.device)
        f = render_wave({**scene, **params}, meta, cfg, f, samp_idx, pix=pix, mask=valid,
                        device=mesh.device)
        img = flm.develop(mesh.reduce(f))
        loss = torch.mean((img - target) ** 2)
        leaves = _leaves(params)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        got = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, got)]
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in got]))
        parts, at = [], 0
        for g in got:
            parts.append(flat[at:at + g.numel()].reshape(g.shape))
            at += g.numel()
        return loss.detach(), _rebuild(params, iter(parts))

    return step
