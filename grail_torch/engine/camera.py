"""Camera ray generation (port of grail/engine/camera.py): the perspective,
orthographic and environment cameras.

A camera is a dict of the scene: its type, the raster-to-camera matrix, the
animated camera-to-world pack, the lens radius and focal distance (depth of
field by concentric disk sampling, perspective.cpp), the shutter (a ray's
time lerps across it and picks the camera transform), and for the
environment camera the film resolution its lat-long mapping divides by.
The reference's environment camera reads `xres`/`yres` from a pack that
never stores them (ROADMAP C.8); this pack stores them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import telemetry
from ..core.vecmath import normalize, lerp
from ..core import transform as tr
from ..core import montecarlo as mc

PERSPECTIVE = 0
ORTHOGRAPHIC = 1
ENVIRONMENT = 2
KINDS = (PERSPECTIVE, ORTHOGRAPHIC, ENVIRONMENT)


def build_camera(cam_type, cam2world_start, cam2world_end, xres, yres, fov=90.0,
                 screen_window=None, lens_radius=0.0, focal_distance=1e6,
                 shutter_open=0.0, shutter_close=1.0, znear=1e-2, zfar=1000.0):
    """Host-side camera pack (api.cpp MakeCamera analog)."""
    if cam_type not in KINDS:
        raise ValueError(f"unknown camera kind {cam_type}")
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
    if cam_type == PERSPECTIVE:
        cam2screen = tr.perspective(fov, znear, zfar)
    elif cam_type == ORTHOGRAPHIC:
        cam2screen = tr.orthographic(znear, zfar)
    else:
        cam2screen = tr.identity()
    raster2cam = tr.inverse(screen2raster @ cam2screen)
    pack = {
        "type": np.int32(cam_type),
        "raster2cam": raster2cam,
        "c2w": tr.animated_pack(cam2world_start, cam2world_end),
        "lens_radius": np.float32(lens_radius),
        "focal_distance": np.float32(focal_distance),
        "shutter": np.array([shutter_open, shutter_close], np.float32),
    }
    if cam_type == ENVIRONMENT:
        pack["xres"] = np.float32(xres)
        pack["yres"] = np.float32(yres)
    return pack


@telemetry.spanned("camera")
def generate_rays(camera, px, py, u_film_x, u_film_y, u_lens_1, u_lens_2, u_time,
                  cam_kind):
    """Raster samples -> world rays. px, py integer pixel coords (N,); u_* in
    [0,1). Returns dict o, d, time, weight."""
    fx = px.to(torch.float32) + u_film_x
    fy = py.to(torch.float32) + u_film_y
    if cam_kind == ENVIRONMENT:
        # lat-long over the whole sphere (environment.cpp GenerateRay)
        theta = math.pi * fy / camera["yres"]
        phi = 2.0 * math.pi * fx / camera["xres"]
        d = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                         torch.sin(theta) * torch.sin(phi)], dim=-1)
        o = torch.zeros_like(d)
    elif cam_kind in (PERSPECTIVE, ORTHOGRAPHIC):
        pcam = tr.xform_p(camera["raster2cam"],
                          torch.stack([fx, fy, torch.zeros_like(fx)], dim=-1))
        if cam_kind == PERSPECTIVE:
            o = torch.zeros_like(pcam)
            d = normalize(pcam)
        else:
            o = pcam
            d = pcam.new_tensor([0.0, 0.0, 1.0]).expand(pcam.shape)
        # depth of field (perspective.cpp and orthographic.cpp GenerateRay):
        # focus at focal_distance / d.z; the reference selects it with a
        # `where` on the lens radius, read here on the host
        lens_r = camera["lens_radius"]
        if telemetry.sync("lens", float, lens_r) > 0.0:
            lx, ly = mc.concentric_sample_disk(u_lens_1, u_lens_2)
            lx = lx * lens_r
            ly = ly * lens_r
            dz = torch.where(torch.abs(d[..., 2]) > 1e-9, d[..., 2], 1.0)
            ft = camera["focal_distance"] / dz
            pfocus = o + ft[..., None] * d
            o = torch.stack([o[..., 0] + lx, o[..., 1] + ly, o[..., 2]], dim=-1)
            d = normalize(pfocus - o)
    else:
        raise ValueError(f"unknown camera kind {cam_kind}")

    time = lerp(u_time, camera["shutter"][0], camera["shutter"][1])
    o_w = tr.animated_apply(camera["c2w"], time, o, is_point=True)
    d_w = normalize(tr.animated_apply(camera["c2w"], time, d, is_point=False))
    return {"o": o_w, "d": d_w, "time": time,
            "weight": torch.ones(px.shape, dtype=torch.float32, device=px.device)}
