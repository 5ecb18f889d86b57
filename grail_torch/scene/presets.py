"""Built-in scenes (port of grail/scene/presets.py: the Cornell box and the
textured terrains under a sky, mesh_scene and mesh_scene_1m)."""
from __future__ import annotations

import numpy as np

from .buffers import SceneBuilder
from ..core import transform as tr
from ..core.rng import SamplerConfig, ZERO_TWO
from ..engine import camera as cam
from ..engine.filters import FilterConfig
from ..shade import bsdf as bx
from ..shade.materials import CONV_INV
from ..shade.textures import TexSpec


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


def tessellate_sphere(center=(0, 0, 0), radius=1.0, nu=32, nv=16):
    """Lat-long sphere tessellation."""
    cx, cy, cz = center
    vs = []
    for j in range(nv + 1):
        theta = np.pi * j / nv
        for i in range(nu):
            phi = 2 * np.pi * i / nu
            vs.append([cx + radius * np.sin(theta) * np.cos(phi),
                       cy + radius * np.cos(theta),
                       cz + radius * np.sin(theta) * np.sin(phi)])
    vs = np.array(vs, np.float32)
    fs = []
    for j in range(nv):
        for i in range(nu):
            i2 = (i + 1) % nu
            a = j * nu + i
            bq = j * nu + i2
            c = (j + 1) * nu + i2
            d = (j + 1) * nu + i
            if j > 0:
                fs.append([a, c, bq])
            if j < nv - 1:
                fs.append([a, d, c])
    return vs, np.array(fs, np.int64)


def _sky_env_map(h=64, w=128, sun_dir=(0.4, 0.6, 0.5), sun_power=60.0):
    """Procedural lat-long sky: a horizon-to-zenith gradient and a sun disk.
    Row v is theta from the light's +z axis; with an identity light-to-world,
    world up (+y) is the sinθ·sinφ component."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    dx = st * np.cos(phi)[None, :]
    dy = st * np.sin(phi)[None, :]
    dz = np.broadcast_to(ct, (h, w))
    sd = np.asarray(sun_dir, np.float64)
    sd /= np.linalg.norm(sd)
    cos_sun = dx * sd[0] + dy * sd[1] + dz * sd[2]
    horizon = np.clip(1.0 - np.abs(dy), 0, 1) ** 3
    sky = (np.stack([0.25 + 0.5 * horizon,
                     0.45 + 0.35 * horizon,
                     0.9 - 0.1 * horizon], -1)
           * np.clip(dy + 0.35, 0.05, 1.0)[..., None])
    sun = np.clip((cos_sun - 0.9995) / 0.0005, 0, 1)[..., None] \
        * np.array([1.0, 0.9, 0.7]) * sun_power
    return (sky + sun).astype(np.float32)


def _checker_image(n=256, c0=(0.9, 0.85, 0.75), c1=(0.25, 0.3, 0.35), k=16):
    ij = np.indices((n, n)).sum(0) // (n // k)
    m = (ij % 2).astype(np.float32)[..., None]
    return (np.asarray(c0) * (1 - m) + np.asarray(c1) * m).astype(np.float32)


def _lattice_noise(X, Z):
    """Smoothstep-interpolated value noise on a fixed 17x17 lattice (seed 7)."""
    rng = np.random.RandomState(7)
    gsz = 17
    lattice = rng.rand(gsz, gsz).astype(np.float32)
    u = (X + 4.0) / 8.0 * (gsz - 1)
    v = (Z + 4.0) / 8.0 * (gsz - 1)
    iu, iv = u.astype(np.int64), v.astype(np.int64)
    fu, fv = u - iu, v - iv
    fu = fu * fu * (3 - 2 * fu)
    fv = fv * fv * (3 - 2 * fv)
    n00 = lattice[iv, iu]
    n10 = lattice[iv, np.minimum(iu + 1, gsz - 1)]
    n01 = lattice[np.minimum(iv + 1, gsz - 1), iu]
    n11 = lattice[np.minimum(iv + 1, gsz - 1), np.minimum(iu + 1, gsz - 1)]
    return (n00 * (1 - fu) * (1 - fv) + n10 * fu * (1 - fv)
            + n01 * (1 - fu) * fv + n11 * fu * fv)


def _terrain(grid, lattice_noise):
    """The displaced terrain of both mesh presets over [-4,4]^2: a grid x grid
    height field of a few fixed-frequency sines (plus value noise for
    mesh_scene), 2(grid-1)^2 triangles. Returns (verts, uvs, tri_idx)."""
    n = grid
    xs = np.linspace(-4.0, 4.0, n, dtype=np.float32)
    zs = np.linspace(-4.0, 4.0, n, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs)
    Y = (0.35 * np.sin(1.7 * X) * np.cos(1.3 * Z)
         + 0.18 * np.sin(4.1 * X + 1.0) * np.sin(3.7 * Z))
    if lattice_noise:
        Y = Y + 0.9 * _lattice_noise(X, Z)
    Y = Y.astype(np.float32)
    verts = np.stack([X, Y, Z], -1).reshape(-1, 3)
    uvs = np.stack([(X + 4.0) / 8.0, (Z + 4.0) / 8.0], -1).reshape(-1, 2)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1))
    a = (jj * n + ii).ravel()
    idx = np.concatenate([
        np.stack([a, a + n, a + 1], -1),
        np.stack([a + 1, a + n, a + n + 1], -1)], 0).astype(np.int64)
    return verts, uvs, idx


def mesh_scene(xres=256, yres=256, spp=16, grid=224, sampler_kind=ZERO_TWO,
               device=None):
    """The ~100k-triangle textured terrain (2(grid-1)^2 triangles of a
    displaced height field, image-mapped checker texture) with a glossy
    sphere of 2,208 triangles, lit by a procedural sky environment map with a
    sun disk. Tensors go to `device` (CUDA unless the caller passes another).
    Returns (scene, meta, builder)."""
    b = SceneBuilder()
    b.xres, b.yres = xres, yres
    b.sampler = SamplerConfig(kind=sampler_kind, spp=spp)
    b.filter = FilterConfig.from_name("box")

    verts, uvs, idx = _terrain(grid, lattice_noise=True)
    img_id = b.add_image(_checker_image())
    tex = b.add_texture(TexSpec(kind="image", image_id=img_id, su=6.0, sv=6.0))
    terrain_mat = b.matte(kd_tex=tex)
    b.add_mesh(verts, idx, terrain_mat, uvs=uvs)

    # glossy sphere resting on the terrain
    sp_v, sp_i = tessellate_sphere(center=(0.0, 1.4, 0.0), radius=0.8, nu=48, nv=24)
    ks = b.const_tex((0.6, 0.6, 0.6))
    kd = b.const_tex((0.25, 0.05, 0.04))
    rough = b.add_texture(TexSpec(kind="const"), (0.08, 0.08, 0.08))
    ior = b.const_tex((1.5,) * 3)
    sphere_mat = b.add_material([
        {"type": bx.LAMBERT, "s0": kd},
        {"type": bx.BLINN, "s0": ks, "fr": bx.FR_DIELECTRIC, "f0": rough,
         "f0_conv": CONV_INV, "f2": ior},
    ])
    b.add_mesh(sp_v, sp_i, sphere_mat)

    b.add_infinite_light(env_map=_sky_env_map())

    c2w = tr.look_at([0.0, 3.2, 7.5], [0.0, 0.6, 0.0], [0.0, 1.0, 0.0])
    b.camera = cam.build_camera(cam.PERSPECTIVE, c2w, c2w, xres, yres, fov=42.0)
    scene, meta = b.finalize(device)
    return scene, meta, b


def mesh_scene_1m(xres=256, yres=256, spp=16, grid=708, sampler_kind=ZERO_TWO,
                  device=None):
    """The 1M-triangle scene: the terrain without value noise at grid=708
    (2(grid-1)^2 = 999,698 triangles, image-mapped checker texture) with a
    matte sphere of 2,208 triangles under the sky environment light, seen
    through a thin lens (radius 0.04, focused at 7.6) by a camera that moves
    over the shutter (motion blur). Tensors go to `device` (CUDA unless the
    caller passes another). Returns (scene, meta, builder)."""
    b = SceneBuilder()
    b.xres, b.yres = xres, yres
    b.sampler = SamplerConfig(kind=sampler_kind, spp=spp)
    b.filter = FilterConfig.from_name("box")

    verts, uvs, idx = _terrain(grid, lattice_noise=False)
    img_id = b.add_image(_checker_image())
    tex = b.add_texture(TexSpec(kind="image", image_id=img_id, su=6.0, sv=6.0))
    b.add_mesh(verts, idx, b.matte(kd_tex=tex), uvs=uvs)

    sp_v, sp_i = tessellate_sphere(center=(0.0, 1.2, 0.0), radius=0.7, nu=48, nv=24)
    b.add_mesh(sp_v, sp_i, b.matte(kd=(0.3, 0.1, 0.08)))
    b.add_infinite_light(env_map=_sky_env_map())

    # depth of field (a thin lens focused near the sphere) and motion blur
    # (the camera-to-world moves between shutter open and close)
    c2w0 = tr.look_at([0.0, 3.2, 7.5], [0.0, 0.6, 0.0], [0.0, 1.0, 0.0])
    c2w1 = tr.look_at([0.12, 3.2, 7.44], [0.0, 0.6, 0.0], [0.0, 1.0, 0.0])
    b.camera = cam.build_camera(cam.PERSPECTIVE, c2w0, c2w1, xres, yres, fov=42.0,
                                lens_radius=0.04, focal_distance=7.6)
    scene, meta = b.finalize(device)
    return scene, meta, b
