"""Built-in scenes (port of grail/scene/presets.py: the Cornell box)."""
from __future__ import annotations

import numpy as np

from .buffers import SceneBuilder
from ..core import transform as tr
from ..core.rng import SamplerConfig, ZERO_TWO
from ..engine import camera as cam
from ..engine.filters import FilterConfig


def _quad(p0, p1, p2, p3):
    """Two triangles for quad p0..p3 (ccw)."""
    verts = np.array([p0, p1, p2, p3], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return verts, idx


def _box(pmin, pmax):
    """Axis-aligned box as 12 triangles, outward normals."""
    x0, y0, z0 = pmin
    x1, y1, z1 = pmax
    vs, fs = [], []

    def add_quad(p0, p1, p2, p3):
        base = len(vs)
        vs.extend([p0, p1, p2, p3])
        fs.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])

    add_quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0))  # z0 face
    add_quad((x1, y0, z1), (x0, y0, z1), (x0, y1, z1), (x1, y1, z1))  # z1 face
    add_quad((x0, y0, z1), (x0, y0, z0), (x0, y1, z0), (x0, y1, z1))  # x0
    add_quad((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0))  # x1
    add_quad((x0, y0, z1), (x1, y0, z1), (x1, y0, z0), (x0, y0, z0))  # y0
    add_quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1))  # y1
    return np.array(vs, np.float32), np.array(fs, np.int64)


def cornell_box(xres=256, yres=256, spp=16, sampler_kind=ZERO_TWO,
                light_emit=(17.0, 12.0, 4.0), white_kd=(0.725, 0.71, 0.68),
                red_kd=(0.63, 0.065, 0.05), green_kd=(0.14, 0.45, 0.091),
                with_boxes=True, device=None):
    """The classic Cornell box, unit 1.0 = 1m: interior [-1,1]x[0,2]x[-1,1],
    camera on +z looking -z, area light in the ceiling. Tensors go to
    `device` (CUDA unless the caller passes another).
    Returns (scene, meta, builder)."""
    b = SceneBuilder()
    b.xres, b.yres = xres, yres
    b.sampler = SamplerConfig(kind=sampler_kind, spp=spp)
    b.filter = FilterConfig.from_name("box")

    white = b.matte(kd=white_kd)
    red = b.matte(kd=red_kd)
    green = b.matte(kd=green_kd)

    s = 1.0
    # floor (y=0, normal +y)
    v, i = _quad((-s, 0, s), (s, 0, s), (s, 0, -s), (-s, 0, -s))
    b.add_mesh(v, i, white)
    # ceiling (y=2, normal -y)
    v, i = _quad((-s, 2 * s, -s), (s, 2 * s, -s), (s, 2 * s, s), (-s, 2 * s, s))
    b.add_mesh(v, i, white)
    # back wall (z=-1, normal +z)
    v, i = _quad((-s, 0, -s), (s, 0, -s), (s, 2 * s, -s), (-s, 2 * s, -s))
    b.add_mesh(v, i, white)
    # left wall (x=-1, normal +x) red
    v, i = _quad((-s, 0, s), (-s, 0, -s), (-s, 2 * s, -s), (-s, 2 * s, s))
    b.add_mesh(v, i, red)
    # right wall (x=1, normal -x) green
    v, i = _quad((s, 0, -s), (s, 0, s), (s, 2 * s, s), (s, 2 * s, -s))
    b.add_mesh(v, i, green)

    if with_boxes:
        bv, bi = _box((-0.55, 0.0, -0.55), (-0.05, 1.2, -0.05))
        b.add_mesh(bv, bi, white)
        bv, bi = _box((0.1, 0.0, 0.05), (0.6, 0.6, 0.55))
        b.add_mesh(bv, bi, white)

    # ceiling light: small quad just below the ceiling, facing down (-y)
    ls = 0.25
    v, i = _quad((-ls, 2 * s - 1e-3, -ls), (ls, 2 * s - 1e-3, -ls),
                 (ls, 2 * s - 1e-3, ls), (-ls, 2 * s - 1e-3, ls))
    b.add_mesh(v, i, b.matte(kd=(0, 0, 0)), area_light_emit=light_emit)

    c2w = tr.look_at([0.0, 1.0, 3.9], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0])
    b.camera = cam.build_camera(cam.PERSPECTIVE, c2w, c2w, xres, yres, fov=39.0)

    scene, meta = b.finalize(device)
    return scene, meta, b
