"""RGB helpers (port of grail/core/spectrum.py): luminance for Russian
roulette on the device, and the host-side colour conversions the scene
parser reads (XYZ, sampled spectra and blackbody emitters to RGB),
in numpy with the reference's matrices, tables and float32 rounding."""
from __future__ import annotations

import numpy as np

# pbrt spectrum.h XYZToRGB matrix (sRGB primaries, D65)
XYZ_TO_RGB = np.array(
    [[3.240479, -1.537150, -0.498535],
     [-0.969256, 1.875991, 0.041556],
     [0.055648, -0.204043, 1.057311]], dtype=np.float32)


def luminance(rgb):
    """y() — the Russian-roulette weight (pbrt RGBSpectrum::y)."""
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


def _fma(a, b, c):
    """float32 a*b + c with one rounding (the product is exact in float64)."""
    return (np.float64(a) * np.asarray(b, np.float64) + c).astype(np.float32)


def _mat3(m, v):
    """float32 m @ v over the last axis of v as XLA's CPU dot rounds it: a
    multiply-add chain from the first column on."""
    v = np.asarray(v, np.float32)
    return np.stack([_fma(m[i, 2], v[..., 2], _fma(m[i, 1], v[..., 1],
                                                    m[i, 0] * v[..., 0]))
                     for i in range(3)], axis=-1)


def xyz_to_rgb(xyz):
    return _mat3(XYZ_TO_RGB, xyz)


def _trapezoid(y, x):
    """np.trapezoid(y, x) for 1-D arrays, with numpy's own expression."""
    return (np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum()


# --------------------------------------------------------------------- host-side: SPD
# CIE standard observer sampled coarsely (5nm would be 471 entries as in pbrt
# spectrum.cpp; a 10nm table is sufficient for converting measured .spd data and
# blackbody curves to RGB at scene-build time).
CIE_LAMBDA_START, CIE_LAMBDA_END = 360.0, 830.0

_CIE_X = np.array([
    0.0001299, 0.0002321, 0.0004149, 0.0007416, 0.001368, 0.002236, 0.004243, 0.00765,
    0.01431, 0.02319, 0.04351, 0.07763, 0.13438, 0.21477, 0.2839, 0.3285, 0.34828,
    0.34806, 0.3362, 0.3187, 0.2908, 0.2511, 0.19536, 0.1421, 0.09564, 0.05795,
    0.03201, 0.0147, 0.0049, 0.0024, 0.0093, 0.0291, 0.06327, 0.1096, 0.1655, 0.22575,
    0.2904, 0.3597, 0.43345, 0.51205, 0.5945, 0.6784, 0.7621, 0.8425, 0.9163, 0.9786,
    1.0263, 1.0567, 1.0622, 1.0456, 1.0026, 0.9384, 0.85445, 0.7514, 0.6424, 0.5419,
    0.4479, 0.3608, 0.2835, 0.2187, 0.1649, 0.1212, 0.0874, 0.0636, 0.04677, 0.0329,
    0.0227, 0.01584, 0.01136, 0.00811, 0.00579, 0.004109, 0.002899, 0.002049, 0.00144,
    0.001, 0.00069, 0.000476, 0.000332, 0.000235, 0.000166, 0.000117, 8.3e-05,
    5.9e-05, 4.2e-05, 2.94e-05, 2.07e-05, 1.46e-05, 1.03e-05, 7.2e-06, 5.1e-06,
    3.6e-06, 2.5e-06, 1.8e-06, 1.3e-06], dtype=np.float64)
_CIE_Y = np.array([
    3.9e-06, 7e-06, 1.2e-05, 2.2e-05, 3.9e-05, 6.4e-05, 0.00012, 0.000217, 0.000396,
    0.00064, 0.00121, 0.00218, 0.004, 0.0073, 0.0116, 0.01684, 0.023, 0.0298, 0.038,
    0.048, 0.06, 0.0739, 0.09098, 0.1126, 0.13902, 0.1693, 0.20802, 0.2586, 0.323,
    0.4073, 0.503, 0.6082, 0.71, 0.7932, 0.862, 0.91485, 0.954, 0.9803, 0.99495, 1.0,
    0.995, 0.9786, 0.952, 0.9154, 0.87, 0.8163, 0.757, 0.6949, 0.631, 0.5668, 0.503,
    0.4412, 0.381, 0.321, 0.265, 0.217, 0.175, 0.1382, 0.107, 0.0816, 0.061, 0.04458,
    0.032, 0.0232, 0.017, 0.01192, 0.00821, 0.005723, 0.004102, 0.002929, 0.002091,
    0.001484, 0.001047, 0.00074, 0.00052, 0.000361, 0.000249, 0.000172, 0.00012,
    8.5e-05, 6e-05, 4.2e-05, 3e-05, 2.1e-05, 1.5e-05, 1.06e-05, 7.5e-06, 5.3e-06,
    3.7e-06, 2.6e-06, 1.8e-06, 1.3e-06, 9e-07, 6e-07, 5e-07], dtype=np.float64)
_CIE_Z = np.array([
    0.0006061, 0.001086, 0.001946, 0.003486, 0.00645, 0.01055, 0.02005, 0.03621,
    0.06785, 0.1102, 0.2074, 0.3713, 0.6456, 1.03905, 1.3856, 1.62296, 1.74706,
    1.7826, 1.77211, 1.7441, 1.6692, 1.5281, 1.28764, 1.0419, 0.81295, 0.6162,
    0.46518, 0.3533, 0.272, 0.2123, 0.1582, 0.1117, 0.07825, 0.05725, 0.04216,
    0.02984, 0.0203, 0.0134, 0.00875, 0.00575, 0.0039, 0.00275, 0.0021, 0.0018,
    0.00165, 0.0014, 0.0011, 0.001, 0.0008, 0.0006, 0.00034, 0.00024, 0.00019,
    0.0001, 5e-05, 3e-05, 2e-05, 1e-05, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=np.float64)
_CIE_LAMBDA = np.linspace(360.0, 830.0, len(_CIE_X))
CIE_Y_INTEGRAL = float(_trapezoid(_CIE_Y, _CIE_LAMBDA))


def spd_to_rgb(lambdas, values):
    """Piecewise-linear SPD -> RGB via CIE integration (host; pbrt FromSampled)."""
    lambdas = np.asarray(lambdas, np.float64)
    values = np.asarray(values, np.float64)
    order = np.argsort(lambdas)
    lambdas, values = lambdas[order], values[order]
    v = np.interp(_CIE_LAMBDA, lambdas, values)
    x = _trapezoid(v * _CIE_X, _CIE_LAMBDA) / CIE_Y_INTEGRAL
    y = _trapezoid(v * _CIE_Y, _CIE_LAMBDA) / CIE_Y_INTEGRAL
    z = _trapezoid(v * _CIE_Z, _CIE_LAMBDA) / CIE_Y_INTEGRAL
    rgb = XYZ_TO_RGB @ np.array([x, y, z])
    return rgb.astype(np.float32)


def blackbody_rgb(temperature, scale=1.0):
    """Planck blackbody emitter at T kelvin -> RGB, normalized so y=scale (host)."""
    h, c, kb = 6.62606957e-34, 299792458.0, 1.3806488e-23
    lam = _CIE_LAMBDA * 1e-9
    le = (2.0 * h * c * c) / (lam ** 5 * (np.exp(h * c / (lam * kb * temperature)) - 1.0))
    rgb = spd_to_rgb(_CIE_LAMBDA, le)
    peak = max(float(0.212671 * rgb[0] + 0.715160 * rgb[1] + 0.072169 * rgb[2]), 1e-20)
    return (rgb / peak * scale).astype(np.float32)
