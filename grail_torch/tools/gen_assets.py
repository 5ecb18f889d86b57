"""The image assets of the bump and projgonio scenes, the alpha-cutout scene,
and a copy of the scene directory that holds them.

scenes/bump.pbrt and scenes/projgonio.pbrt read assets/bumps.pfm,
assets/slide.pfm and assets/gonio.pfm, which the repository does not hold
(it ignores *.pfm). This makes the same three arrays as the reference's
scenes/gen_assets.py and writes them with the port's image I/O, into a
directory the caller names, never into scenes/assets/:

    python -m grail_torch.tools.gen_assets OUT_DIR            # the three PFMs
    python -m grail_torch.tools.gen_assets --scenes OUT_DIR   # scenes/ + assets

The copy also holds alphacut.pbrt (ALPHA_SCENE): a quad cut by a
checkerboard alpha texture over a 98-triangle floor under a point light,
rendered by directlighting. It has no golden; it holds the cutouts'
re-traces against the reference and on the card.
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from ..engine.imageio import write_pfm

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                      "scenes")
ALPHA_SCENE = """# an alpha cutout (Triangle::Intersect's alpha test): a checkerboard quad
LookAt 0 3 4.5  0 0.6 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [64] "integer yresolution" [64]
Sampler "lowdiscrepancy" "integer pixelsamples" [4]
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "point" "rgb I" [30 30 30] "point from" [1 5 1.5]
Material "matte" "rgb Kd" [0.6 0.6 0.6]
AttributeBegin
  Translate -3 0 3
  Rotate -90 1 0 0
  Scale 6 6 1
  Shape "heightfield" "integer nu" [8] "integer nv" [8] "float Pz" [
    0 0 0 0 0 0 0 0  0 0 0 0 0 0 0 0  0 0 0 0 0 0 0 0  0 0 0 0 0 0 0 0
    0 0 0 0 0 0 0 0  0 0 0 0 0 0 0 0  0 0 0 0 0 0 0 0  0 0 0 0 0 0 0 0]
AttributeEnd
Texture "cut" "float" "checkerboard" "float uscale" [4] "float vscale" [4]
AttributeBegin
  Material "matte" "rgb Kd" [0.8 0.3 0.2]
  Translate 0 1.2 0
  Rotate 30 1 0 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 0 1  1 0 1  1 0 -1  -1 0 -1] "float uv" [0 0 1 0 1 1 0 1]
    "texture alpha" "cut"
AttributeEnd
WorldEnd
"""


def assets():
    """{name: (H, W, 3) float32}: the projection light's slide, the
    goniometric light's lat-long map and the bump displacement map."""
    h = w = 16
    yy, xx = np.mgrid[0:h, 0:w]
    slide = np.zeros((h, w, 3), np.float32)
    slide[..., 0] = ((xx // 4 + yy // 4) % 2).astype(np.float32)
    slide[..., 1] = (xx / (w - 1.0)).astype(np.float32)
    slide[..., 2] = (yy / (h - 1.0)).astype(np.float32)
    # a bright equator band and dark poles
    h, w = 16, 32
    t = (np.arange(h) + 0.5) / h * np.pi
    gonio = np.tile(np.sin(t)[:, None, None] ** 2, (1, w, 3)).astype(np.float32)
    # raised bubbles
    yy, xx = np.mgrid[0:32, 0:32] / 31.0
    bump = (0.04 * np.sin(xx * 6 * np.pi) * np.sin(yy * 6 * np.pi)).astype(np.float32)
    return {"slide": slide, "gonio": gonio,
            "bumps": np.repeat(bump[..., None], 3, -1)}


def write_assets(out):
    """Write NAME.pfm for each asset into directory `out`; returns the
    paths."""
    if os.path.realpath(out) == os.path.realpath(os.path.join(SCENES, "assets")):
        raise ValueError("gen_assets writes into a directory of the caller's, "
                         "never into scenes/assets/")
    os.makedirs(out, exist_ok=True)
    paths = []
    for name, img in assets().items():
        paths.append(os.path.join(out, name + ".pfm"))
        write_pfm(paths[-1], img)
    return paths


def scene_copy(out):
    """Copy scenes/ into directory `out` (which must not be scenes/ itself)
    and write the assets into its assets/; returns `out`."""
    if os.path.realpath(out) == os.path.realpath(SCENES):
        raise ValueError("scene_copy needs a directory other than scenes/")
    shutil.copytree(SCENES, out, dirs_exist_ok=True)
    write_assets(os.path.join(out, "assets"))
    with open(os.path.join(out, "alphacut.pbrt"), "w") as f:
        f.write(ALPHA_SCENE)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="the directory to write into")
    ap.add_argument("--scenes", action="store_true",
                    help="copy scenes/ into OUT and write the assets into OUT/assets")
    args = ap.parse_args(argv)
    if args.scenes:
        scene_copy(args.out)
    else:
        write_assets(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
