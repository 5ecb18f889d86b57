"""Camera ray generation, perspective (port of grail/engine/camera.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.vecmath import normalize, lerp
from ..core import transform as tr
from ..core import montecarlo as mc

PERSPECTIVE = 0


def build_camera(cam_type, cam2world_start, cam2world_end, xres, yres, fov=90.0,
                 screen_window=None, lens_radius=0.0, focal_distance=1e6,
                 shutter_open=0.0, shutter_close=1.0, znear=1e-2, zfar=1000.0):
    """Host-side camera pack (api.cpp MakeCamera analog); perspective only."""
    if cam_type != PERSPECTIVE:
        raise NotImplementedError("only the perspective camera is ported yet")
    aspect = xres / yres
    if screen_window is None:
        if aspect > 1.0:
            screen_window = [-aspect, aspect, -1.0, 1.0]
        else:
            screen_window = [-1.0, 1.0, -1.0 / aspect, 1.0 / aspect]
    x0, x1, y0, y1 = screen_window
    screen2raster = (
        tr.scale(xres, yres, 1.0)
        @ tr.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
        @ tr.translate([-x0, -y1, 0.0])
    )
    cam2screen = tr.perspective(fov, znear, zfar)
    raster2cam = tr.inverse(screen2raster @ cam2screen)
    return {
        "type": np.int32(cam_type),
        "raster2cam": raster2cam,
        "c2w": tr.animated_pack(cam2world_start, cam2world_end),
        "lens_radius": np.float32(lens_radius),
        "focal_distance": np.float32(focal_distance),
        "shutter": np.array([shutter_open, shutter_close], np.float32),
    }


def generate_rays(camera, px, py, u_film_x, u_film_y, u_lens_1, u_lens_2, u_time,
                  cam_kind):
    """Raster samples -> world rays. px, py integer pixel coords (N,); u_* in
    [0,1). Returns dict o, d, time, weight."""
    if cam_kind != PERSPECTIVE:
        raise NotImplementedError("only the perspective camera is ported yet")
    raster = torch.stack([px.to(torch.float32) + u_film_x,
                          py.to(torch.float32) + u_film_y,
                          torch.zeros_like(u_film_x)], dim=-1)
    pcam = tr.xform_p(camera["raster2cam"], raster)
    o = torch.zeros_like(pcam)
    d = normalize(pcam)

    # depth of field (perspective.cpp GenerateRay DOF block); the reference
    # selects it with a `where` on the lens radius, read here on the host
    lens_r = camera["lens_radius"]
    if float(lens_r) > 0.0:
        lx, ly = mc.concentric_sample_disk(u_lens_1, u_lens_2)
        lx = lx * lens_r
        ly = ly * lens_r
        dz = torch.where(torch.abs(d[..., 2]) > 1e-9, d[..., 2], 1.0)
        ft = camera["focal_distance"] / dz
        pfocus = o + ft[..., None] * d
        o = torch.stack([o[..., 0] + lx, o[..., 1] + ly, o[..., 2]], dim=-1)
        d = normalize(pfocus - o)

    time = lerp(u_time, camera["shutter"][0], camera["shutter"][1])
    o_w = tr.animated_apply(camera["c2w"], time, o, is_point=True)
    d_w = normalize(tr.animated_apply(camera["c2w"], time, d, is_point=False))
    return {"o": o_w, "d": d_w, "time": time,
            "weight": torch.ones(px.shape, dtype=torch.float32, device=px.device)}
