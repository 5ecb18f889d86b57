"""Render orchestration (port of grail/engine/render.py: render_wave, the
render loop with resume, checkpoints and a metrics sink, crop windows,
occupancy_probe and render_adaptive).

A megawave is every pixel times `chunk` consecutive sample indices; the
render is a Python loop over megawaves, where the reference fuses the whole
loop into one dispatch. Counter-based sampling makes every wave a pure
function of (pixel, sample) ids, and the film accumulates wave by wave in
sample order, so the image is bitwise the same however the chunks fall, and
a render resumed from a checkpoint (engine/checkpoint.py) is bitwise the
uninterrupted one. `render` is the serving path and runs under
torch.no_grad(); `render_wave` records gradients when a scene leaf requires
them, as the reference's render_wave is differentiated (tools/optimize.py).
Waves that are not the full pixel grid (a crop window's pixels, adaptive
sampling's flagged pixels) scatter into the film (film.add_samples).

kind="dipole" has a preprocess (engine/subsurface.py: the surface points and
their irradiance), which `render` builds once and hands every megawave as
`aux`, and its own Li. The reference's other preprocessed kinds (photon
mapping, PRT, probes, the irradiance cache) are not ported yet: li raises
on them.
"""
from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from ..core import rng as rngmod
from ..device import check_on, resolve_device
from . import camera as cam
from . import checkpoint as ckpt
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


def render_wave(scene, meta, cfg, film, samp_idx, pix=None, mask=None, grid_chunk=None,
                tiled=False, device=None, aux=None):
    """One megawave: raygen -> Li -> film accumulate; returns the new film,
    differentiable to the scene's leaves that require grad.

    pix: (N,) pixel ids (defaults to the full grid, one sample each);
    samp_idx: a scalar sample index or (N,) per-lane indices. grid_chunk:
    with pix the full pixel grid tiled grid_chunk times (lane i <-> pixel
    i % npix), which takes the dense film path; other waves scatter. mask:
    (N,) bool, False lanes add nothing (padding). aux: the render's
    preprocess (made here when a kind needs one and none is given)."""
    device = resolve_device(device)
    check_on(scene["verts"], device, "the scene")
    if pix is None:
        pix, tiled = _wave_pixels(meta, device)
        if grid_chunk is None:
            grid_chunk = 1
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
    w = None if mask is None else mask.to(torch.float32)
    if grid_chunk is not None:
        return flm.add_samples_grid(film, meta.filter, sx, sy, L, grid_chunk, weight=w,
                                    tiled=tiled)
    return flm.add_samples(film, meta.filter, sx, sy, L, weight=w)


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


def _render_cropped(scene, meta, cfg, film, spp, start_wave, aux, progress, device):
    """Film crop window (image.cpp: xPixelStart = ceil(xres * crop[0]) and
    so on, at least one pixel a side): only the crop's pixels are rendered,
    a wave a sample, scattered into the full-resolution film, which stays
    zero outside the window."""
    x0c, x1c, y0c, y1c = meta.crop
    x0 = int(math.ceil(meta.xres * x0c))
    x1 = max(x0 + 1, int(math.ceil(meta.xres * x1c)))
    y0 = int(math.ceil(meta.yres * y0c))
    y1 = max(y0 + 1, int(math.ceil(meta.yres * y1c)))
    xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
    pix = torch.as_tensor((ys * meta.xres + xs).ravel(), dtype=torch.int64, device=device)
    for s in range(start_wave, spp):
        film = render_wave(scene, meta, cfg, film, s, pix=pix, device=device, aux=aux)
        if progress is not None:
            progress(s + 1, spp)
    return flm.develop(film), film


@torch.no_grad()
def occupancy_probe(scene, meta, cfg, samp_idx=0, device=None):
    """The fraction of a full-grid wave's lanes live on entering each bounce
    (rounded to 4 places, as the reference), or None for the kinds without
    the shared bounce loop. One wave of sample index samp_idx, its camera
    rays without differentials, as the reference's probe."""
    if cfg.kind not in ("path", "direct", "whitted"):
        return None
    device = resolve_device(device)
    check_on(scene["verts"], device, "the scene")
    pix, _ = _wave_pixels(meta, device)
    samp = torch.full(pix.shape, samp_idx, dtype=torch.int64, device=device)
    rays = camera_rays(scene, meta, pix, samp)[0]
    rays.pop("camdiff", None)
    _, occ = li(scene, meta, cfg, rays, pix, samp, with_stats=True)
    n = meta.xres * meta.yres
    return [round(float(v) / n, 4) for v in occ.cpu()]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _append_json(path, record):
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


@torch.no_grad()
def render(scene, meta, cfg: IntegratorConfig, spp=None, film=None, start_wave=0,
           progress=None, checkpoint_path=None, checkpoint_every=0, metrics_path=None,
           spp_chunk=None, device=None):
    """Full render: spp samples per pixel in megawaves of spp_chunk samples;
    returns (image (H,W,3), film).

    Resume: pass the film of the samples below start_wave, or a
    checkpoint_path, whose file, where it exists, is loaded and continued;
    every checkpoint_every samples the state is written to it atomically,
    and the file is removed when the render completes. Either way the image
    is bitwise the uninterrupted render's. progress(done, spp) is called
    after each megawave. metrics_path: a JSONL sink that gets the occupancy
    line (occupancy_probe at start_wave) and then one record a megawave
    (wall time and cumulative camera rays/s; each waits for the device)."""
    device = resolve_device(device)
    check_on(scene["verts"], device, "the scene")
    spp = spp if spp is not None else meta.sampler.spp
    if checkpoint_path and os.path.exists(checkpoint_path):
        film, start_wave, _ = ckpt.load(checkpoint_path, meta, cfg, device=device)
    if film is None:
        film = flm.new_film(meta.xres, meta.yres, device)
    aux = preprocess(scene, meta, cfg)
    if tuple(meta.crop) != (0.0, 1.0, 0.0, 1.0):
        return _render_cropped(scene, meta, cfg, film, spp, start_wave, aux, progress,
                               device)
    if spp_chunk is None:
        spp_chunk = auto_spp_chunk(meta, spp)
    t0 = time.perf_counter()
    rays_done = 0
    if metrics_path:
        occ = occupancy_probe(scene, meta, cfg, samp_idx=start_wave, device=device)
        if occ is not None:
            _append_json(metrics_path, {"occupancy_per_bounce": occ})
    s = start_wave
    while s < spp:
        chunk = min(spp_chunk, spp - s)
        film = _render_chunk(scene, meta, cfg, film, s, chunk, device, aux)
        s += chunk
        if progress is not None:
            progress(s, spp)
        if checkpoint_path and checkpoint_every and s % checkpoint_every < chunk and s < spp:
            ckpt.save(checkpoint_path, film, s, meta, cfg)
        if metrics_path:
            _sync(device)
            rays_done += meta.xres * meta.yres * chunk
            dt = time.perf_counter() - t0
            _append_json(metrics_path, {
                "wave": s, "spp": spp, "wall_s": round(dt, 3), "camera_rays": rays_done,
                "camera_rays_per_sec": round(rays_done / max(dt, 1e-9), 1)})
    if checkpoint_path and os.path.exists(checkpoint_path):
        # complete: a stale file would make a re-run resume mid-way
        os.remove(checkpoint_path)
    return flm.develop(film), film


_LUMA = np.array([0.212671, 0.715160, 0.072169], np.float32)


@torch.no_grad()
def render_adaptive(scene, meta, cfg: IntegratorConfig, min_spp=4, max_spp=32,
                    threshold=0.02, progress=None, device=None):
    """Adaptive sampling (pbrt src/samplers/adaptive.cpp re-shaped as the
    reference's re-queue between waves): min_spp full waves split over two
    half films, then, while a pixel's relative luminance contrast between
    the halves exceeds `threshold` (and it has fewer than max_spp samples),
    one more sample for the flagged pixels only, the wave padded to a power
    of two of at least 256 lanes. The samples are the counter-based
    sequence's, so the image equals a plain render at each pixel's spp.
    Returns (image, (film_a, film_b, spp_map (H, W) int32))."""
    device = resolve_device(device)
    check_on(scene["verts"], device, "the scene")
    aux = preprocess(scene, meta, cfg)
    films = [flm.new_film(meta.xres, meta.yres, device) for _ in range(2)]
    for s in range(min_spp):
        films[s % 2] = render_wave(scene, meta, cfg, films[s % 2], s, device=device, aux=aux)
        if progress is not None:
            progress(s + 1, max_spp)

    spp_map = np.full((meta.xres * meta.yres,), min_spp, np.int32)
    s = min_spp
    while s < max_spp:
        # the contrast of the two half-film estimates (adaptive.cpp's
        # needsSupersampling compares the samples with their mean)
        lum_a, lum_b = (flm.develop(f).cpu().numpy() @ _LUMA for f in films)
        err = np.abs(lum_a - lum_b) / np.maximum(0.5 * (lum_a + lum_b), 1e-3)
        flagged = np.nonzero((err.reshape(-1) > threshold) & (spp_map < max_spp))[0]
        if flagged.size == 0:
            break
        cap = max(256, 1 << int(np.ceil(np.log2(flagged.size))))
        pix = np.zeros((cap,), np.int64)
        pix[:flagged.size] = flagged
        mask = np.zeros((cap,), bool)
        mask[:flagged.size] = True
        films[s % 2] = render_wave(scene, meta, cfg, films[s % 2], s,
                                   pix=torch.as_tensor(pix, device=device),
                                   mask=torch.as_tensor(mask, device=device), device=device,
                                   aux=aux)
        spp_map[flagged] += 1
        s += 1
        if progress is not None:
            progress(s, max_spp)
    img = flm.develop(flm.merge(films))
    return img, (films[0], films[1], spp_map.reshape(meta.yres, meta.xres))
