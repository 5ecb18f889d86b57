"""30-band spectral rendering (port of grail/core/sampled_spectrum.py; pbrt
src/core/spectrum.cpp SampledSpectrum and FromRGB with a Smits-style
promotion).

The render path keeps three channels a value. A spectral image is ten
3-band passes: every colour the scene carries is promoted from RGB to 30
bands once, on the host, pass g renders bands [3g, 3g+3) through the
unchanged RGB render, and the passes are integrated against the CIE curves
to linear sRGB. Band-wise products of promoted reflectances and emitters are
SampledSpectrum arithmetic, so tints compound spectrally across bounces.

The basis spectra are the smoothest non-negative metamers of Smits' seven
targets (white, cyan, magenta, yellow, red, green, blue), each the solution
of min |D s|^2 subject to M s = rgb, s >= 0 (D the second difference, M the
band-averaged CIE-to-sRGB matrix) by the reference's projected gradient, in
float64 numpy with the reference's operations, at import.

What is promoted: the lights' emission, the environment map, the texture
rows that a material slot reads as a colour (s0; s1 and s2 where the lobe
type reads them: a conductor's eta and k, FresnelBlend's specular colour, a
measured lobe's albedo), with the rows they are mixed from (not a mix's
amount), and the images those rows or a projection or goniometric light
read. Rows that only float slots (roughness, exponents, eta, mix amounts,
a measured lobe's table index), bump maps or alpha cutouts read keep their
RGB triplet in every pass, as do images only they read: the reference
promotes every constant row and image, which renders each pass with another
roughness or index of refraction (ROADMAP C.3). A slot its lobe type does
not read counts for nothing; unset slots point at row 0, so this is what
keeps a float row 0 unpromoted. An image that both kinds of row read is
promoted. Media and measured-BRDF tables stay RGB, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..shade import bsdf as bx
from ..shade.materials import MAT_FIELDS
from ..shade.mipmap import build_pyramid, pack_pyramid
from .spectrum import _CIE_LAMBDA, _CIE_X, _CIE_Y, _CIE_Z, CIE_Y_INTEGRAL, XYZ_TO_RGB

N_BANDS = 30
LAMBDA_MIN, LAMBDA_MAX = 400.0, 700.0   # pbrt sampledLambdaStart, sampledLambdaEnd
BAND_EDGES = np.linspace(LAMBDA_MIN, LAMBDA_MAX, N_BANDS + 1)
N_PASSES = N_BANDS // 3


def _band_average(curve):
    """A CIE curve's mean over each band (pbrt AverageSpectrumSamples)."""
    out = np.zeros(N_BANDS)
    for b in range(N_BANDS):
        lam = np.linspace(BAND_EDGES[b], BAND_EDGES[b + 1], 16)
        out[b] = np.interp(lam, _CIE_LAMBDA, curve).mean()
    return out


_XBAR = _band_average(_CIE_X)
_YBAR = _band_average(_CIE_Y)
_ZBAR = _band_average(_CIE_Z)
_DLAM = (LAMBDA_MAX - LAMBDA_MIN) / N_BANDS

# spectrum (30,) -> linear sRGB (3,): CIE integration, then the sRGB matrix
SPEC_TO_RGB = (XYZ_TO_RGB @ np.stack([_XBAR, _YBAR, _ZBAR])
               * _DLAM / CIE_Y_INTEGRAL).astype(np.float64)     # (3, 30)


def _smoothest_metamer(rgb, iters=4000):
    """min |D s|^2 s.t. M s = rgb, s >= 0, by penalty projected gradient."""
    M = SPEC_TO_RGB
    D = np.diff(np.eye(N_BANDS), n=2, axis=0)                   # (28, 30)
    rho = 1e4
    A = D.T @ D + rho * M.T @ M
    b = rho * M.T @ np.asarray(rgb, np.float64)
    s = np.full(N_BANDS, max(np.mean(rgb), 0.0))
    lr = 1.0 / np.linalg.eigvalsh(A).max()
    for _ in range(iters):
        s = np.maximum(s - lr * (A @ s - b), 0.0)
    return s


_SMITS_TARGETS = {
    "white": (1, 1, 1), "cyan": (0, 1, 1), "magenta": (1, 0, 1),
    "yellow": (1, 1, 0), "red": (1, 0, 0), "green": (0, 1, 0),
    "blue": (0, 0, 1),
}
_BASIS = {k: _smoothest_metamer(v) for k, v in _SMITS_TARGETS.items()}


def rgb_to_spectrum(rgb):
    """RGB (..., 3) reflectance or emission -> (..., 30) band values, float32:
    Smits' combination (the smallest channel takes white, the rest the
    matching secondary and primary)."""
    rgb = np.asarray(rgb, np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    out = np.zeros(rgb.shape[:-1] + (N_BANDS,))
    done = np.zeros(rgb.shape[:-1], bool)
    cases = (
        ((r <= g) & (g <= b), r, g, b, "cyan", "blue"),
        ((r <= b) & (b <= g), r, b, g, "cyan", "green"),
        ((g <= r) & (r <= b), g, r, b, "magenta", "blue"),
        ((g <= b) & (b <= r), g, b, r, "magenta", "red"),
        ((b <= r) & (r <= g), b, r, g, "yellow", "green"),
        ((b <= g) & (g <= r), b, g, r, "yellow", "red"),
    )
    for mask, lo, mid, hi, sec, prim in cases:
        m = mask & ~done
        done |= m
        out[m] = (lo[m][..., None] * _BASIS["white"]
                  + (mid[m] - lo[m])[..., None] * _BASIS[sec]
                  + (hi[m] - mid[m])[..., None] * _BASIS[prim])
    return np.maximum(out, 0.0).astype(np.float32)


def spectrum_to_rgb(spec):
    """(..., 30) band values -> linear sRGB by CIE integration, float32."""
    return np.einsum("ck,...k->...c", SPEC_TO_RGB,
                     np.asarray(spec, np.float64)).astype(np.float32)


# ------------------------------------------------------------- band passes
_F = {f: i for i, f in enumerate(MAT_FIELDS)}
_CONDUCTOR_FRESNEL = (bx.BLINN, bx.ANISO, bx.BLINN_T, bx.SPEC_REFL)


def _colour_slots(slot):
    """The slots of a lobe slot tuple that its lobe type reads as colours."""
    lobe_type, fr = slot[_F["lobe_type"]], slot[_F["fr"]]
    if lobe_type == bx.NONE:
        return ()
    if lobe_type in (bx.FRESNEL_BLEND, bx.MEASURED):
        return ("s0", "s1")
    if fr == bx.FR_CONDUCTOR and lobe_type in _CONDUCTOR_FRESNEL:
        return ("s0", "s1", "s2")
    return ("s0",)


def colour_rows(meta):
    """The texture rows read as colours: the colour slots' rows and the
    rows they are made of, a mix's amount apart (a float texture)."""
    stack = [slot[_F[k]] for spec in meta.mat_specs for slot in spec
             for k in _colour_slots(slot)]
    rows = set()
    while stack:
        r = stack.pop()
        if r in rows:
            continue
        rows.add(r)
        spec = meta.tex_specs[r]
        stack.extend(spec.inputs[:2] if spec.kind == "mix" else spec.inputs)
    return frozenset(rows)


def colour_images(meta):
    """The image ids read as colours: by a colour row or by a light."""
    rows = colour_rows(meta)
    return frozenset({meta.tex_specs[r].image_id for r in rows
                      if meta.tex_specs[r].kind == "image"}
                     | {img for _, img in meta.light_image_rows})


def _numpy(t):
    return t.detach().cpu().numpy()


def _promoted_sources(scene, meta):
    """Every colour table promoted once, as (..., 30) float32 tensors on the
    scene's device: "tex_const" (rows read only as floats tiled, so every
    pass reads their triplet), "emit", "env_map" where the scene has one,
    and "images" {image id: (image, pyramid)} for the colour images, each
    pyramid built once over the 30 channels (a pass's slice is the
    reference's pyramid of the sliced image, bitwise)."""
    dev = scene["verts"].device
    rows = colour_rows(meta)
    const = _numpy(scene["tex_data"]["const"])
    tex = np.tile(const, (1, N_PASSES))
    picked = sorted(rows)
    if picked:
        tex[picked] = rgb_to_spectrum(const[picked])
    out = {"tex_const": torch.tensor(tex, device=dev),
           "emit": torch.tensor(rgb_to_spectrum(_numpy(scene["lights"]["emit"])), device=dev),
           "images": {}}
    images = scene.get("images", ())
    for i in sorted(colour_images(meta)):
        im = rgb_to_spectrum(_numpy(images[i]))
        pyr = pack_pyramid(build_pyramid(im))
        out["images"][i] = (torch.tensor(im, device=dev),
                            dict({k: torch.tensor(pyr[k], device=dev)
                                  for k in ("flat", "h", "w", "off")},
                                 n_levels=pyr["n_levels"]))
    if scene.get("env_map") is not None:
        out["env_map"] = torch.tensor(rgb_to_spectrum(_numpy(scene["env_map"])), device=dev)
    return out


def _band_scene(scene, src, g):
    """The scene with every promoted table replaced by bands [3g, 3g+3)."""
    sl = slice(3 * g, 3 * g + 3)
    s2 = dict(scene)
    s2["tex_data"] = dict(scene["tex_data"], const=src["tex_const"][:, sl].contiguous())
    s2["lights"] = dict(scene["lights"], emit=src["emit"][:, sl].contiguous())
    if src["images"]:
        images, mipmaps = list(scene["images"]), list(scene["mipmaps"])
        for i, (im, pyr) in src["images"].items():
            images[i] = im[..., sl].contiguous()
            mipmaps[i] = dict(pyr, flat=pyr["flat"][:, sl].contiguous())
        s2["images"], s2["mipmaps"] = tuple(images), tuple(mipmaps)
    if "env_map" in src:
        s2["env_map"] = src["env_map"][..., sl].contiguous()
    return s2


def render_spectral(scene, meta, cfg, spp=None, film=None):
    """A 30-band spectral render: ten 3-band passes through
    engine.render.render, integrated to linear sRGB. Returns (image (H, W, 3)
    on the scene's device, the ten band films). film: read by nothing (the
    reference's signature); each pass starts its own film."""
    from ..engine.render import render
    dev = scene["verts"].device
    src = _promoted_sources(scene, meta)
    M = torch.tensor(SPEC_TO_RGB, dtype=torch.float32, device=dev)
    rgb, films = None, []
    for g in range(N_PASSES):
        img, film_g = render(_band_scene(scene, src, g), meta, cfg, spp=spp, device=dev)
        films.append(film_g)
        part = sum(img[..., k, None] * M[:, 3 * g + k] for k in range(3))
        rgb = part if rgb is None else rgb + part
    return rgb, films
