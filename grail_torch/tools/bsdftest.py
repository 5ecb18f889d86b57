"""bsdftest (port of grail/tools/bsdftest.py; pbrt src/tools/bsdftest.cpp):
check BSDF sampling numerically. For each lobe type, the hemispherical
reflectance rho is estimated two ways, by importance sampling through
Sample_f and by uniform hemisphere sampling of f; the two agree (within 10%)
only if the sampled directions and their pdf match f. Exits 1 if any case
fails.

Usage: python -m grail_torch.tools.bsdftest [n_samples] [--cpu]
(on the CUDA card unless --cpu).
"""
from __future__ import annotations

import sys

import torch

from ..core import montecarlo as mc
from ..core import rng
from ..core.vecmath import PI
from ..device import resolve_device
from ..shade import bsdf as bx

CASES = (
    ("Lambertian(0.7)", bx.LAMBERT, dict(R=(0.7,) * 3)),
    ("OrenNayar(0.7, sigma=20deg)", bx.OREN_NAYAR, dict(R=(0.7,) * 3, f0=0.35)),
    ("Blinn(0.8, e=4)", bx.BLINN, dict(R=(0.8,) * 3, f0=4.0)),
    ("Blinn(0.8, e=50)", bx.BLINN, dict(R=(0.8,) * 3, f0=50.0)),
    ("Aniso(0.8, 10/100)", bx.ANISO, dict(R=(0.8,) * 3, f0=10.0, f1=100.0)),
    ("FresnelBlend(.5/.08, e=30)", bx.FRESNEL_BLEND,
     dict(R=(0.5,) * 3, S1=(0.08,) * 3, f0=30.0, f1=30.0)),
)


def run(n=16384, device=None):
    """Print one line a case (OK or FAIL, both estimates, their relative
    difference); returns the exit code."""
    dev = resolve_device(device)
    wo = torch.tensor([0.3, -0.25, 0.92], dtype=torch.float32, device=dev)
    wo = (wo / torch.linalg.norm(wo)).expand(n, 3)
    cfg = rng.SamplerConfig(kind=rng.RANDOM)
    pix = torch.zeros(n, dtype=torch.int64, device=dev)
    samp = torch.arange(n, dtype=torch.int64, device=dev)

    def u(dim):
        return rng.sample_1d(cfg, pix, samp, dim)

    def column(value, width):
        return torch.tensor(value, dtype=torch.float32, device=dev).expand(n, 1, width)

    ok = True
    for name, ltype, kw in CASES:
        lobes = {
            "type": torch.full((n, 1), ltype, dtype=torch.int32, device=dev),
            "fr": torch.full((n, 1), kw.get("fr", bx.FR_NOOP), dtype=torch.int32,
                             device=dev),
            "R": column(kw.get("R", (1.0,) * 3), 3),
            "S1": column(kw.get("S1", (0.5,) * 3), 3),
            "S2": column(kw.get("S2", (1.0,) * 3), 3),
            "f0": column((kw.get("f0", 1.0),), 1)[..., 0],
            "f1": column((kw.get("f1", 1.0),), 1)[..., 0],
            "f2": column((kw.get("f2", 1.5),), 1)[..., 0],
        }
        present = (ltype,)
        out = bx.bsdf_sample(lobes, wo, u(0), u(1), u(2), present)
        imp = out["f"] * (torch.abs(out["wi"][:, 2])
                          / torch.clamp_min(out["pdf"], 1e-9))[:, None]
        imp = torch.where((out["valid"] & (out["pdf"] > 0))[:, None], imp, 0.0)
        rho_imp = float(imp.mean(dim=0)[0])
        wi_u = mc.uniform_sample_hemisphere(u(3), u(4))
        f = bx.bsdf_f(lobes, wo, wi_u, present)
        rho_uni = float((f * (wi_u[:, 2:3] * 2 * PI)).mean(dim=0)[0])
        rel = abs(rho_imp - rho_uni) / max(rho_uni, 1e-9)
        ok = ok and rel < 0.1
        print(f"{'OK ' if rel < 0.1 else 'FAIL'} {name:32s} rho(Sample_f)={rho_imp:.4f} "
              f"rho(uniform)={rho_uni:.4f} rel={rel:.3f}")
    return 0 if ok else 1


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cpu" if "--cpu" in argv else None
    argv = [a for a in argv if a != "--cpu"]
    return run(int(argv[0]) if argv else 16384, device=device)


if __name__ == "__main__":
    sys.exit(main())
