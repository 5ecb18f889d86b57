"""exrdiff (port of grail/tools/exrdiff.py; pbrt src/tools/exrdiff.cpp):
compare two images: each one's mean, the pixels that differ and those that
differ by more than 5%, the MAE and RMSE; optionally write the absolute
difference image. With a tolerance (a percentage of pixels), exits 1 when
more pixels than that differ by more than 5%. Reads every format
engine/imageio.py reads.

Usage: python -m grail_torch.tools.exrdiff [-o diff.exr] IMG1 IMG2 [tolerance%]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..engine.imageio import read_image, write_image


def image_diff(a, b):
    """The exrdiff report's numbers, as a dict."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"resolution mismatch: {a.shape} vs {b.shape}")
    smallest = 0.5 ** 16  # exrdiff ignores values below half's precision
    big_a = np.abs(a) > smallest
    big_b = np.abs(b) > smallest
    rel = np.abs(a - b) / np.where(big_a, np.abs(a), 1.0)
    differing = (big_a | big_b) & (rel > 0.0)
    bigdiff = (big_a | big_b) & (rel > 0.05)
    return {
        "n_differing": int(differing.any(axis=-1).sum()),
        "n_big_diff": int(bigdiff.any(axis=-1).sum()),
        "avg1": float(a.mean()),
        "avg2": float(b.mean()),
        "mae": float(np.abs(a - b).mean()),
        "rmse": float(np.sqrt(((a - b) ** 2).mean())),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="exrdiff")
    ap.add_argument("-o", "--outfile", default=None, help="write absolute-difference image")
    ap.add_argument("images", nargs=2)
    ap.add_argument("tolerance", nargs="?", type=float, default=0.0,
                    help="%% of pixels allowed to differ before exit 1")
    args = ap.parse_args(argv)
    a = read_image(args.images[0])
    b = read_image(args.images[1])
    stats = image_diff(a, b)
    n_pix = a.shape[0] * a.shape[1]
    print(f"{args.images[0]}: avg {stats['avg1']:.6g}")
    print(f"{args.images[1]}: avg {stats['avg2']:.6g}")
    print(f"{stats['n_differing']} / {n_pix} pixels differ "
          f"({100.0 * stats['n_differing'] / n_pix:.2f}%), "
          f"{stats['n_big_diff']} by >5%")
    print(f"MAE {stats['mae']:.6g}, RMSE {stats['rmse']:.6g}")
    if args.outfile:
        write_image(args.outfile, np.abs(np.asarray(a) - np.asarray(b)))
    if args.tolerance > 0:
        return 1 if (100.0 * stats["n_big_diff"] / n_pix) > args.tolerance else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
