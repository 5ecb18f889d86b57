"""exravg (port of grail/tools/exravg.py; pbrt src/tools/exravg.cpp): print
the mean pixel value of each image.

Usage: python -m grail_torch.tools.exravg IMAGE...
"""
from __future__ import annotations

import sys

import numpy as np

from ..engine.imageio import read_image


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    for path in argv:
        print(f"{path}: {float(np.asarray(read_image(path)).mean()):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
