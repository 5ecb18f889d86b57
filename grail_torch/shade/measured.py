"""Measured BRDFs (port of grail/shade/measured.py; pbrt
src/materials/measured.cpp, RegularHalfangleBRDF and IrregIsotropicBRDF).

Both file formats become a dense table over Rusinkiewicz's half and
difference angles (theta_half, theta_diff, phi_diff, rgb). A MERL
``.binary`` keeps its 90x90x180 grid and channel scales; a pbrt ``.brdf``
file's irregular isotropic samples are baked on the host onto a coarser
half-angle grid with the Shepard kernel pbrt applies at run time
(exp(-100 d^2) over BRDFRemap space). The readers and the bake are host
numpy, the same calls as the reference's, so the tables hold its bits.

`lookup` is the device side: each lane's nearest cell, with the sqrt warp on
theta_half (RegularHalfangleBRDF::f). The cell index truncates a float
product, so one ulp in the angles can move a lane to the next cell; the
angles are computed in the reference's order of operations.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import telemetry
from ..core.spectrum import spd_to_rgb
from ..core.vecmath import normalize
from ..scene.floatfile import read_float_file

MERL_N_THETA_H = 90
MERL_N_THETA_D = 90
MERL_N_PHI_D = 180
# RegularHalfangleBRDF's channel scales (measured.cpp CreateMeasuredMaterial)
MERL_SCALES = (1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0)


# --------------------------------------------------------------------- loaders
def read_merl(path):
    """MERL .binary -> (90, 90, 180, 3) float32 BRDF table."""
    with open(path, "rb") as f:
        dims = np.fromfile(f, np.int32, 3)
        n = int(dims[0]) * int(dims[1]) * int(dims[2])
        if n != MERL_N_THETA_H * MERL_N_THETA_D * MERL_N_PHI_D:
            raise ValueError(f"unexpected MERL dims {tuple(dims)} in {path}")
        data = np.fromfile(f, np.float64, 3 * n)
    if data.size != 3 * n:
        raise ValueError(f"truncated MERL file {path}")
    tab = data.reshape(3, MERL_N_THETA_H, MERL_N_THETA_D, MERL_N_PHI_D)
    tab = np.moveaxis(tab, 0, -1).astype(np.float32)
    tab *= np.asarray(MERL_SCALES, np.float32)
    return np.maximum(tab, 0.0)


def read_brdf(path):
    """pbrt .brdf (irregular isotropic) -> (angles (S,4), rgb (S,3)): the
    wavelength count, the wavelengths, then (theta_i, phi_i, theta_o,
    phi_o, spectrum...) tuples."""
    vals = np.asarray(read_float_file(path), np.float64)
    nwl = int(vals[0])
    wls = vals[1:1 + nwl]
    rest = vals[1 + nwl:]
    stride = 4 + nwl
    if rest.size % stride != 0:
        raise ValueError(f"malformed .brdf file {path}")
    rest = rest.reshape(-1, stride)
    rgb = np.stack([np.asarray(spd_to_rgb(wls, row), np.float32) for row in rest[:, 4:]], 0)
    return rest[:, :4].astype(np.float32), np.maximum(rgb, 0.0)


# ------------------------------------------------------- half-angle machinery
def _sph_dir(theta, phi):
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], -1)


def _halfdiff_to_io(th, td, pd):
    """(theta_half, theta_diff, phi_diff) -> (wo, wi) with phi_half = 0."""
    wh = _sph_dir(th, np.zeros_like(th))
    wd = _sph_dir(td, pd)
    # wd rotated by theta_half about +y
    ct, st = np.cos(th), np.sin(th)
    wi = np.stack([ct * wd[..., 0] + st * wd[..., 2], wd[..., 1],
                   -st * wd[..., 0] + ct * wd[..., 2]], -1)
    wo = 2.0 * np.sum(wi * wh, -1, keepdims=True) * wh - wi
    return wo, wi


def _brdf_remap(wo, wi):
    """reflection.cpp BRDFRemap: (sin_i sin_o, dphi/pi, cos_i cos_o)."""
    ci, co = wi[..., 2], wo[..., 2]
    si = np.sqrt(np.maximum(0.0, 1.0 - ci * ci))
    so = np.sqrt(np.maximum(0.0, 1.0 - co * co))
    dphi = np.arctan2(wi[..., 1], wi[..., 0]) - np.arctan2(wo[..., 1], wo[..., 0])
    dphi = np.where(dphi < 0, dphi + 2 * np.pi, dphi)
    dphi = np.where(dphi > np.pi, 2 * np.pi - dphi, dphi)
    return np.stack([si * so, dphi / np.pi, ci * co], -1)


def bake_irregular(angles, rgb, nh=32, nd=16, npd=32):
    """Shepard-bake irregular (theta_i, phi_i, theta_o, phi_o) samples onto a
    half-angle grid: IrregIsotropicBRDF::f's exp(-100 d^2) gather over
    BRDFRemap space, once at scene build. A cell with no sample in reach
    takes its nearest sample (pbrt returns 0 there), as in the reference;
    cells below the horizon are 0."""
    m_s = _brdf_remap(_sph_dir(angles[:, 2], angles[:, 3]),
                      _sph_dir(angles[:, 0], angles[:, 1]))            # (S,3)
    th = ((np.arange(nh) + 0.5) / nh) ** 2 * (np.pi / 2)   # the sqrt warp's inverse
    td = (np.arange(nd) + 0.5) / nd * (np.pi / 2)
    pd = (np.arange(npd) + 0.5) / npd * np.pi
    wo_g, wi_g = _halfdiff_to_io(*np.meshgrid(th, td, pd, indexing="ij"))
    below = (wo_g[..., 2] <= 1e-4) | (wi_g[..., 2] <= 1e-4)
    m_g = _brdf_remap(wo_g, wi_g).reshape(-1, 3)                       # (G,3)
    d2 = ((m_g[:, None, :] - m_s[None, :, :]) ** 2).sum(-1)            # (G,S)
    w = np.exp(-100.0 * d2)
    wsum = w.sum(1)
    nearest = rgb[np.argmin(d2, axis=1)]
    vals = np.where(wsum[:, None] > 1e-12,
                    (w @ rgb) / np.maximum(wsum[:, None], 1e-12), nearest)
    vals = vals.reshape(nh, nd, npd, 3)
    vals[below] = 0.0
    return vals.astype(np.float32)


def albedo_estimate(table):
    """A rough hemispherical reflectance: pi times the table's mean."""
    return float(np.pi) * np.asarray(table, np.float32).mean(axis=(0, 1, 2))


# ------------------------------------------------------------- device lookup
def _halfdiff_coords(wo, wi):
    """(N,3) local directions -> (theta_half, theta_diff, phi_diff)."""
    wh = normalize(wo + wi)
    th = torch.arccos(torch.clamp(wh[..., 2], -1.0, 1.0))
    ph = torch.atan2(wh[..., 1], wh[..., 0])
    # wi rotated by -phi_half about z, then by -theta_half about y
    cph, sph = torch.cos(ph), torch.sin(ph)
    x1 = cph * wi[..., 0] + sph * wi[..., 1]
    y1 = -sph * wi[..., 0] + cph * wi[..., 1]
    z1 = wi[..., 2]
    ct, st = torch.cos(th), torch.sin(th)
    xd = ct * x1 - st * z1
    zd = st * x1 + ct * z1
    td = torch.arccos(torch.clamp(zd, -1.0, 1.0))
    pd = torch.atan2(y1, xd)
    pd = torch.where(pd < 0.0, pd + math.pi, pd)       # reciprocity: fold to [0, pi)
    return th, td, pd


@telemetry.spanned("measured")
def lookup(tables, grid_id, wo, wi):
    """Each lane's nearest cell of its table (RegularHalfangleBRDF::f, with
    the sqrt warp on theta_half). tables: tuple of (NH,ND,NP,3) tensors;
    grid_id (N,) int32, the table row of each lane."""
    out = wo.new_zeros((wo.shape[0], 3))
    if not tables:
        return out
    th, td, pd = _halfdiff_coords(wo, wi)
    for gi, tab in enumerate(tables):
        nh, nd, npd = tab.shape[:3]
        ih = torch.clamp((torch.sqrt(torch.clamp_min(th / (math.pi / 2), 0.0))
                          * nh).to(torch.int32), 0, nh - 1)
        idd = torch.clamp((td / (math.pi / 2) * nd).to(torch.int32), 0, nd - 1)
        ip = torch.clamp((pd / math.pi * npd).to(torch.int32), 0, npd - 1)
        v = tab.reshape(-1, 3)[((ih * nd + idd) * npd + ip).long()]
        out = torch.where((grid_id == gi)[..., None], v, out)
    return out
