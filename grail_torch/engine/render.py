"""Render orchestration (port of grail/engine/render.py: render_wave,
_render_chunk, auto_spp_chunk and the fused render route).

A megawave is every pixel times `chunk` consecutive sample indices; the
render is a Python loop over megawaves. Counter-based sampling makes every
wave a pure function of (pixel, sample) ids, and the film accumulates wave by
wave in sample order, so the image is bitwise the same however the chunks
fall. `render` is the serving path and runs under torch.no_grad();
`render_wave` records gradients when a scene leaf requires them, as the
reference's render_wave is differentiated (tools/optimize.py).

kind="dipole" has a preprocess (engine/subsurface.py: the surface points and
their irradiance), which `render` builds once and hands every megawave as
`aux`, and its own Li. The reference's other preprocessed kinds (photon
mapping, PRT, probes, the irradiance cache) are not ported yet: li raises
on them.
"""
from __future__ import annotations

import torch

from ..core import rng as rngmod
from ..device import check_on, resolve_device
from . import camera as cam
from . import film as flm
from . import subsurface
from .integrator import IntegratorConfig, li, SLOT_FILM, SLOT_LENS, SLOT_TIME


def _wave_pixels(meta, device):
    """(pixel ids in lane order, tiled?) for one full-grid wave."""
    lane = torch.arange(meta.xres * meta.yres, dtype=torch.int64, device=device)
    if flm.tiled_order(meta):
        # 8x16-tile pixel order, as the reference
        px_t, py_t = flm.lane_pixel(lane, meta.xres)
        return py_t.to(torch.int64) * meta.xres + px_t.to(torch.int64), True
    return lane, False


def camera_rays(scene, meta, pix, samp):
    """Camera rays for lanes (pix, samp): returns (rays, px, py, ufx, ufy),
    the film sample offsets drawn from the same sampler slots as the rays."""
    px = (pix % meta.xres).to(torch.int32)
    py = (pix // meta.xres).to(torch.int32)
    ufx, ufy = rngmod.sample_2d(meta.sampler, pix, samp, SLOT_FILM)
    ul1, ul2 = rngmod.sample_2d(meta.sampler, pix, samp, SLOT_LENS)
    ut = rngmod.sample_1d(meta.sampler, pix, samp, SLOT_TIME)
    rays = cam.generate_rays(scene["camera"], px, py, ufx, ufy, ul1, ul2, ut,
                             meta.cam_kind)
    if meta.n_images > 0:
        # camera differential rays (Camera::GenerateRayDifferential: the same
        # sample one pixel over in x and in y) for texture filtering
        rx = cam.generate_rays(scene["camera"], px + 1, py, ufx, ufy, ul1, ul2,
                               ut, meta.cam_kind)
        ry = cam.generate_rays(scene["camera"], px, py + 1, ufx, ufy, ul1, ul2,
                               ut, meta.cam_kind)
        rays["camdiff"] = (rx["o"], rx["d"], ry["o"], ry["d"])
    return rays, px, py, ufx, ufy


def preprocess(scene, meta, cfg):
    """The render's `aux`: the dipole's point cloud and irradiance for
    kind="dipole", None for the other kinds."""
    if cfg.kind == "dipole":
        return subsurface.dipole_preprocess(scene, meta, cfg)
    return None


def render_wave(scene, meta, cfg, film, samp_idx, pix=None, grid_chunk=None,
                tiled=False, device=None, aux=None):
    """One megawave: raygen -> Li -> film accumulate; returns the new film,
    differentiable to the scene's leaves that require grad.

    pix: (N,) pixel ids (defaults to the full grid, one sample each);
    samp_idx: a scalar sample index or (N,) per-lane indices. grid_chunk:
    with pix the full pixel grid tiled grid_chunk times (lane i <-> pixel
    i % npix), which the dense film path needs. aux: the render's
    preprocess (made here when a kind needs one and none is given)."""
    device = resolve_device(device)
    check_on(scene["verts"], device, "the scene")
    if pix is None:
        pix, tiled = _wave_pixels(meta, device)
        if grid_chunk is None:
            grid_chunk = 1
    if grid_chunk is None:
        raise NotImplementedError("scattered (non-grid) waves are not ported yet")
    samp = torch.as_tensor(samp_idx, dtype=torch.int64, device=device).expand(pix.shape)
    rays, px, py, ufx, ufy = camera_rays(scene, meta, pix, samp)
    if cfg.kind == "dipole":
        aux = aux if aux is not None else preprocess(scene, meta, cfg)
        L = subsurface.dipole_li(scene, meta, cfg, rays, pix, samp, aux)
    else:
        L = li(scene, meta, cfg, rays, pix, samp)
    # NaN/Inf quarantine (samplerrenderer.cpp checks): drop bad samples
    bad = torch.any(~torch.isfinite(L), dim=-1)
    L = torch.where(bad[..., None], 0.0, L)

    sx = px.to(torch.float32) + ufx
    sy = py.to(torch.float32) + ufy
    return flm.add_samples_grid(film, meta.filter, sx, sy, L, grid_chunk,
                                tiled=tiled)


def megawave_lanes(meta, s0, chunk, device):
    """(pix, samp, tiled) of the megawave of pixels x `chunk` consecutive
    sample indices starting at s0, sample-major."""
    n_pix = meta.xres * meta.yres
    samp = torch.repeat_interleave(
        s0 + torch.arange(chunk, dtype=torch.int64, device=device), n_pix)
    wave_pix, tiled = _wave_pixels(meta, device)
    return wave_pix.repeat(chunk), samp, tiled


def _render_chunk(scene, meta, cfg, film, s0, chunk, device, aux=None):
    pix, samp, tiled = megawave_lanes(meta, s0, chunk, device)
    return render_wave(scene, meta, cfg, film, samp, pix=pix, grid_chunk=chunk,
                       tiled=tiled, device=device, aux=aux)


def auto_spp_chunk(meta, spp, target_rays=1 << 20):
    """Samples per megawave: as many as fit a ~1M-ray budget (the reference's
    choice, kept so both packages chunk the same way)."""
    n_pix = meta.xres * meta.yres
    return max(1, min(spp, target_rays // max(n_pix, 1)))


@torch.no_grad()
def render(scene, meta, cfg: IntegratorConfig, spp=None, spp_chunk=None,
           device=None):
    """Full render: spp samples per pixel in megawaves of spp_chunk samples;
    returns (image (H,W,3), film)."""
    device = resolve_device(device)
    check_on(scene["verts"], device, "the scene")
    spp = spp if spp is not None else meta.sampler.spp
    if spp_chunk is None:
        spp_chunk = auto_spp_chunk(meta, spp)
    aux = preprocess(scene, meta, cfg)
    film = flm.new_film(meta.xres, meta.yres, device)
    for s0 in range(0, spp, spp_chunk):
        film = _render_chunk(scene, meta, cfg, film, s0, min(spp_chunk, spp - s0),
                             device, aux)
    return flm.develop(film), film
