"""Monte Carlo sampling routines the path integrator reads (port of the
matching parts of grail/core/montecarlo.py)."""
from __future__ import annotations

import math

import torch

from .vecmath import INV_FOURPI, PI, TWO_PI, coordinate_system

_COUNT_MAX = 64   # counting search up to this table width, as the reference


def concentric_sample_disk(u1, u2):
    """Shirley-Chiu concentric map (pbrt ConcentricSampleDisk), branch-free."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    zero = (sx == 0.0) & (sy == 0.0)
    use_x = torch.abs(sx) > torch.abs(sy)
    r = torch.where(use_x, sx, sy)
    theta = torch.where(
        use_x,
        (PI / 4.0) * (sy / torch.where(sx == 0.0, 1.0, sx)),
        (PI / 2.0) - (PI / 4.0) * (sx / torch.where(sy == 0.0, 1.0, sy)),
    )
    dx = torch.where(zero, 0.0, r * torch.cos(theta))
    dy = torch.where(zero, 0.0, r * torch.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1, u2):
    dx, dy = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    return torch.stack([dx, dy, z], dim=-1)


def uniform_sample_hemisphere(u1, u2):
    z = u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sphere_pdf():
    return INV_FOURPI


def uniform_sample_cone(u1, u2, cos_theta_max):
    """Directions in a cone about +z (pbrt UniformSampleCone)."""
    costheta = (1.0 - u1) + u1 * cos_theta_max
    sintheta = torch.sqrt(torch.clamp_min(1.0 - costheta * costheta, 0.0))
    phi = u2 * TWO_PI
    return torch.stack([torch.cos(phi) * sintheta, torch.sin(phi) * sintheta, costheta],
                       dim=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (TWO_PI * torch.clamp_min(1.0 - cos_theta_max, 1e-8))


def uniform_sample_triangle(u1, u2):
    """Barycentrics (b0, b1) (pbrt UniformSampleTriangle)."""
    su1 = torch.sqrt(u1)
    return 1.0 - su1, u2 * su1


def sample_hg(w, u1, u2, g):
    """A direction about w distributed as the Henyey-Greenstein phase
    function (pbrt SampleHG); |g| < 1e-3 samples the sphere uniformly."""
    costheta_iso = 1.0 - 2.0 * u1
    sq = (1.0 - g * g) / torch.clamp_min(1.0 - g + 2.0 * g * u1, 1e-8)
    costheta_hg = (1.0 + g * g - sq * sq) / torch.clamp_min(2.0 * torch.abs(g), 1e-8)
    costheta = torch.where(torch.abs(g) < 1e-3, costheta_iso, costheta_hg)
    sintheta = torch.sqrt(torch.clamp_min(1.0 - costheta * costheta, 0.0))
    phi = TWO_PI * u2
    v1, v2 = coordinate_system(w)
    return ((sintheta * torch.cos(phi))[..., None] * v1
            + (sintheta * torch.sin(phi))[..., None] * v2 + costheta[..., None] * w)


def hg_pdf(cos_theta, g):
    """The Henyey-Greenstein phase function, which is its own pdf (pbrt
    PhaseHG)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g * g) / torch.clamp_min(
        denom * torch.sqrt(torch.clamp_min(denom, 1e-12)), 1e-12)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """beta=2 power heuristic (pbrt PowerHeuristic). Weights above 1e18,
    whose squares would overflow to a NaN weight (and a NaN gradient even on
    a masked lane), are clamped first; below that the result is unchanged."""
    f = torch.clamp_max(nf * f_pdf, 1e18)
    g = torch.clamp_max(ng * g_pdf, 1e18)
    return (f * f) / torch.clamp_min(f * f + g * g, 1e-12)


def batched_searchsorted(cdf, u):
    """Last interval index i with cdf[i] <= u, clipped to [0, n-2], for one
    shared 1-D table."""
    n = cdf.shape[-1]
    if n <= _COUNT_MAX:
        cnt = torch.sum((cdf[1:-1] <= u[..., None]).to(torch.int32), dim=-1)
        return torch.clamp(cnt, 0, n - 2)
    return _binary_search(cdf, torch.zeros_like(u, dtype=torch.int64), n, u)


def _binary_search(flat, base, n, u):
    lo = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    hi = torch.full(u.shape, n - 1, dtype=torch.int64, device=u.device)
    for _ in range(max(1, int(math.ceil(math.log2(n))) + 1)):
        mid = (lo + hi + 1) // 2
        go_right = flat[base + mid] <= u
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid - 1)
    return torch.clamp(lo, 0, n - 2)


def searchsorted_rows(cdf_tab, rows, u):
    """Per-lane interval search in a table of CDF rows: cdf_tab (R, n), rows
    (N,) row per lane, u (N,). Returns (N,) index in [0, n-2]."""
    r, n = cdf_tab.shape
    if n <= _COUNT_MAX and r == 1:
        return batched_searchsorted(cdf_tab[0], u)
    return _binary_search(cdf_tab.reshape(-1), rows.to(torch.int64) * n, n, u)


def gather_rows(tab, rows, idx):
    """tab (R, n), rows (N,), idx (N,) -> tab[rows, idx] via a flat gather."""
    return tab.reshape(-1)[rows.to(torch.int64) * tab.shape[-1] + idx.to(torch.int64)]


def build_distribution_1d(func):
    """func (..., n) >= 0 -> dict with func, cdf (..., n+1) and func_int (...)
    (pbrt Distribution1D's constructor, batched over leading dims). An
    all-zero row gets the uniform cdf."""
    func = torch.as_tensor(func, dtype=torch.float32)
    n = func.shape[-1]
    c = torch.cumsum(func, dim=-1) / n
    func_int = c[..., -1]
    cdf = torch.cat([torch.zeros(func.shape[:-1] + (1,), dtype=torch.float32,
                                 device=func.device), c], dim=-1)
    uniform = torch.linspace(0.0, 1.0, n + 1, dtype=torch.float32, device=func.device)
    safe = func_int[..., None] > 0.0
    cdf = torch.where(safe, cdf / torch.where(safe, func_int[..., None], 1.0), uniform)
    return {"func": func, "cdf": cdf, "func_int": func_int}


def sample_distribution_1d_continuous(dist, u):
    """u (N,) -> (x in [0,1), pdf, offset) for a 1-D distribution
    (pbrt Distribution1D::SampleContinuous)."""
    cdf, func, func_int = dist["cdf"], dist["func"], dist["func_int"]
    n = func.shape[-1]
    off = batched_searchsorted(cdf, u)
    c0 = cdf[off]
    c1 = cdf[off + 1]
    du = (u - c0) / torch.clamp_min(c1 - c0, 1e-12)
    x = (off.to(torch.float32) + du) / n
    pdf = func[off] / torch.clamp_min(func_int, 1e-12)
    return x, pdf, off


def sample_distribution_1d_discrete(dist, u):
    """u (N,) -> (index, pmf) for a 1-D distribution (pbrt
    Distribution1D::SampleDiscrete)."""
    off = batched_searchsorted(dist["cdf"], u)
    return off, distribution_1d_pdf_discrete(dist, off)


def distribution_1d_pdf_discrete(dist, idx):
    """The pmf of entry idx: func[idx] / (func_int * n)."""
    func = dist["func"]
    return func[idx] / torch.clamp_min(dist["func_int"] * func.shape[-1], 1e-12)


def build_distribution_2d(func):
    """func (nv, nu) -> marginal over v + conditional over u (pbrt
    Distribution2D)."""
    cond = build_distribution_1d(func)
    return {"cond": cond, "marg": build_distribution_1d(cond["func_int"])}


def sample_distribution_2d(dist, u1, u2):
    """(u1, u2) -> (u, v) in [0,1)^2 and pdf (pbrt Distribution2D::
    SampleContinuous); conditional rows are read through flat gathers."""
    v, pdf_v, iv = sample_distribution_1d_continuous(dist["marg"], u2)
    cond = dist["cond"]
    nu = cond["func"].shape[-1]
    off = searchsorted_rows(cond["cdf"], iv, u1)
    c0 = gather_rows(cond["cdf"], iv, off)
    c1 = gather_rows(cond["cdf"], iv, off + 1)
    du = (u1 - c0) / torch.clamp_min(c1 - c0, 1e-12)
    u = (off.to(torch.float32) + du) / nu
    f_int = cond["func_int"][iv]
    pdf_u = gather_rows(cond["func"], iv, off) / torch.clamp_min(f_int, 1e-12)
    return u, v, pdf_u * pdf_v


def distribution_2d_pdf(dist, u, v):
    """pdf at continuous (u, v) (pbrt Distribution2D::Pdf)."""
    func = dist["cond"]["func"]
    nv, nu = func.shape
    iu = torch.clamp((u * nu).to(torch.int64), 0, nu - 1)
    iv = torch.clamp((v * nv).to(torch.int64), 0, nv - 1)
    return gather_rows(func, iv, iu) / torch.clamp_min(dist["marg"]["func_int"], 1e-12)
