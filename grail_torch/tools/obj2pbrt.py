"""obj2pbrt (port of grail/tools/obj2pbrt.py; pbrt src/tools/obj2pbrt.cpp):
a Wavefront OBJ as a pbrt scene fragment, one trianglemesh a material.

Reads v, vn, vt and f (polygons fan-triangulated, negative indices counted
from the end) and usemtl/mtllib (an .mtl's Kd and Ks become a matte or
plastic material). Pure text: the output is the reference's.

Usage: python -m grail_torch.tools.obj2pbrt model.obj > model.pbrt
"""
from __future__ import annotations

import os
import sys


def load_mtl(path):
    mats = {}
    cur = None
    try:
        with open(path) as f:
            for line in f:
                t = line.split()
                if not t:
                    continue
                if t[0] == "newmtl":
                    cur = t[1]
                    mats[cur] = {}
                elif cur and t[0] in ("Kd", "Ks"):
                    mats[cur][t[0]] = [float(x) for x in t[1:4]]
                elif cur and t[0] == "d":
                    mats[cur]["d"] = float(t[1])
                elif cur and t[0] == "map_Kd":
                    mats[cur]["map_Kd"] = t[1]
    except OSError:
        pass
    return mats


def convert(path, out=sys.stdout):
    v, vn, vt = [], [], []
    groups = {}     # material name -> list of triangles [(vi, ti, ni) x3]
    cur_mat = ""
    mtl = {}
    base = os.path.dirname(os.path.abspath(path))

    def idx(s, n):
        i = int(s)
        return i - 1 if i > 0 else n + i

    with open(path) as f:
        for line in f:
            t = line.split()
            if not t or t[0].startswith("#"):
                continue
            if t[0] == "v":
                v.append([float(x) for x in t[1:4]])
            elif t[0] == "vn":
                vn.append([float(x) for x in t[1:4]])
            elif t[0] == "vt":
                vt.append([float(x) for x in t[1:3]])
            elif t[0] == "mtllib":
                mtl.update(load_mtl(os.path.join(base, t[1])))
            elif t[0] == "usemtl":
                cur_mat = t[1]
            elif t[0] == "f":
                corners = []
                for c in t[1:]:
                    parts = (c.split("/") + ["", ""])[:3]
                    vi = idx(parts[0], len(v))
                    ti = idx(parts[1], len(vt)) if parts[1] else -1
                    ni = idx(parts[2], len(vn)) if parts[2] else -1
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):   # fan triangulation
                    groups.setdefault(cur_mat, []).append(
                        (corners[0], corners[k], corners[k + 1]))

    for mat_name, tris in groups.items():
        m = mtl.get(mat_name, {})
        kd = m.get("Kd", [0.5, 0.5, 0.5])
        out.write("AttributeBegin\n")
        out.write(f'  # material {mat_name or "(default)"}\n')
        if "Ks" in m and max(m["Ks"]) > 0.01:
            ks = m["Ks"]
            out.write(f'  Material "plastic" "rgb Kd" [{kd[0]} {kd[1]} {kd[2]}]'
                      f' "rgb Ks" [{ks[0]} {ks[1]} {ks[2]}]\n')
        else:
            out.write(f'  Material "matte" "rgb Kd" [{kd[0]} {kd[1]} {kd[2]}]\n')

        # compact per-group vertex list
        remap = {}
        pts, norms, uvs, inds = [], [], [], []
        has_n = all(c[2] >= 0 for tri in tris for c in tri)
        has_t = all(c[1] >= 0 for tri in tris for c in tri)
        for tri in tris:
            for c in tri:
                if c not in remap:
                    remap[c] = len(pts)
                    pts.append(v[c[0]])
                    if has_n:
                        norms.append(vn[c[2]])
                    if has_t:
                        uvs.append(vt[c[1]])
                inds.append(remap[c])
        out.write('  Shape "trianglemesh"\n')
        out.write('    "integer indices" [' +
                  " ".join(map(str, inds)) + "]\n")
        out.write('    "point P" [' +
                  " ".join(f"{p[0]} {p[1]} {p[2]}" for p in pts) + "]\n")
        if has_n:
            out.write('    "normal N" [' +
                      " ".join(f"{p[0]} {p[1]} {p[2]}" for p in norms) + "]\n")
        if has_t:
            out.write('    "float uv" [' +
                      " ".join(f"{p[0]} {p[1]}" for p in uvs) + "]\n")
        out.write("AttributeEnd\n")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: obj2pbrt model.obj [> out.pbrt]", file=sys.stderr)
        return 1
    convert(argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
