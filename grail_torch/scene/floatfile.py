"""ReadFloatFile (port of grail/scene/floatfile.py, pbrt src/core/floatfile):
whitespace-separated numbers with #-comments, as in .spd spectra."""
from __future__ import annotations


def read_float_file(path):
    vals = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0]
            for tok in line.split():
                vals.append(float(tok))
    return vals
