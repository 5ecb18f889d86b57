"""Host-side C++ components of the port, loaded with ctypes: the SAH BVH
builder (bvh_builder.cpp) and its collapse into the 4-wide node table of the
bvh4 kernels (bvh4_collapse.cpp). The C++ builder builds the trees of meshes
of scene/bvh.py's NATIVE_THRESHOLD (2,048) triangles and more, as the
reference's native builder does; below that size scene/bvh.py's numpy
builder, the reference's, builds them (the two split some small meshes
otherwise: a 48- and a 100-triangle sphere among those tests/test_torch_bvh.py
holds). The builder flattens the tree depth-first into structure-of-arrays
tables:

  bounds_min/max (Nn,3) f32 | right (Nn,) i32 second-child index (-1 = leaf)
  prim_off (Nn,) i32 | nprims (Nn,) i32 | axis (Nn,) i32 | prim_ids (T,) i32

The first child of node i is node i+1.

One shared library holds both, compiled with g++ on first use into
grail_torch/native/_build/, named by a hash of the sources and the flags, so
a changed source never loads a stale build. A failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
_SOURCES = tuple(os.path.join(_HERE, f) for f in ("bvh_builder.cpp",
                                                   "bvh4_collapse.cpp"))
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None


def lib_path():
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libgrail_bvh-{digest.hexdigest()[:16]}.so")


def _load():
    """The ctypes handle of the builder, compiled on first use."""
    global _lib
    if _lib is not None:
        return _lib
    out = lib_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run(["g++", *_FLAGS, *_SOURCES, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for the native sources:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.grail_build_bvh.restype = ctypes.c_long
    lib.grail_build_bvh.argtypes = [fp, ctypes.c_long, ip, ctypes.c_long,
                                    ctypes.c_int, ctypes.c_int, fp, fp,
                                    ip, ip, ip, ip, ip]
    lib.grail_collapse_bvh4.restype = ctypes.c_long
    lib.grail_collapse_bvh4.argtypes = [fp, fp, ip, ip, ip, fp, ip]
    _lib = lib
    return lib


def build_bvh_native(verts, tris, max_prims=4, force_leaf=0):
    """C++ binned-SAH build over triangles; verts (V,3), tris (T,3) numpy.
    Returns a dict of numpy arrays (module docstring layout).

    force_leaf: make a leaf whenever n <= force_leaf regardless of SAH (the
    stream traversal pays as much for a box record as for a triangle one)."""
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    T = tris.shape[0]
    cap = max(2 * T - 1, 1)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    right, prim_off, nprims, axis = (np.empty(cap, np.int32) for _ in range(4))
    prim_ids = np.empty(T, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n_nodes = lib.grail_build_bvh(
        verts.ctypes.data_as(fp), verts.shape[0], tris.ctypes.data_as(ip), T,
        int(max_prims), int(force_leaf), bmin.ctypes.data_as(fp),
        bmax.ctypes.data_as(fp), right.ctypes.data_as(ip),
        prim_off.ctypes.data_as(ip), nprims.ctypes.data_as(ip),
        axis.ctypes.data_as(ip), prim_ids.ctypes.data_as(ip))
    return {
        "bounds_min": bmin[:n_nodes].copy(),
        "bounds_max": bmax[:n_nodes].copy(),
        "right": right[:n_nodes].copy(),
        "prim_off": prim_off[:n_nodes].copy(),
        "nprims": nprims[:n_nodes].copy(),
        "axis": axis[:n_nodes].copy(),
        "prim_ids": prim_ids,
        "max_prims": np.int32(max_prims),
    }


def collapse_bvh4(bvh):
    """The 4-wide node table of a binary BVH (this module's layout, or the
    reference's with the same keys): ((N4, 32) float32 nodes whose child and
    count words hold int32 bits, the most stack entries a walk can hold).
    See bvh4_collapse.cpp for the layout."""
    lib = _load()
    bmin, bmax = (np.ascontiguousarray(bvh[k], np.float32)
                  for k in ("bounds_min", "bounds_max"))
    right, nprims, prim_off = (np.ascontiguousarray(bvh[k], np.int32)
                               for k in ("right", "nprims", "prim_off"))
    nodes = np.empty((max(right.shape[0], 1), 32), np.float32)
    stack = np.zeros(1, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n4 = lib.grail_collapse_bvh4(
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp), right.ctypes.data_as(ip),
        nprims.ctypes.data_as(ip), prim_off.ctypes.data_as(ip),
        nodes.ctypes.data_as(fp), stack.ctypes.data_as(ip))
    return nodes[:n4].copy(), int(stack[0])
