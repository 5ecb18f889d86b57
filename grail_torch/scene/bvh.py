"""The binary SAH BVH of a triangle mesh (port of grail/scene/bvh.py): the
numpy builder that the reference uses below NATIVE_THRESHOLD triangles, and
the dispatch between it and the C++ builder (native/bvh_builder.cpp) at and
above that size, as the reference's build_bvh_auto.

pbrt's BVHAccel (bvh.cpp): 12 SAH buckets along the widest centroid axis,
traversal cost 0.125, a leaf where splitting costs more than the prims;
flattened depth-first into structure-of-arrays tables:

  bounds_min/max (Nn,3) f32 | right (Nn,) i32 second-child index (-1 = leaf)
  prim_off (Nn,) i32 | nprims (Nn,) i32 | axis (Nn,) i32 | prim_ids (T,) i32

The first child of node i is node i+1. The two builders split some small
meshes differently, so a size picks the reference's builder for it and the
port's trees equal the reference's array for array.
"""
from __future__ import annotations

import sys

import numpy as np

from ..native import build_bvh_native

MAX_PRIMS_IN_NODE = 4
N_BUCKETS = 12
TRAV_COST = 0.125
NATIVE_THRESHOLD = 2048     # triangles from which the C++ builder builds


def _surface_area(mn, mx):
    d = np.maximum(mx - mn, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_bvh(verts, tris, max_prims=MAX_PRIMS_IN_NODE, force_leaf=0):
    """SAH BVH over triangles in numpy; verts (V,3), tris (T,3). Returns a
    dict of numpy arrays (module docstring layout).

    force_leaf: make a leaf whenever n <= force_leaf whatever the SAH says."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int64)
    p0, p1, p2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    prim_min = np.minimum(np.minimum(p0, p1), p2)
    prim_max = np.maximum(np.maximum(p0, p1), p2)
    centroid = 0.5 * (prim_min + prim_max)
    nodes_min, nodes_max, nodes_right, nodes_off, nodes_n, nodes_axis = ([] for _ in range(6))
    ordered = []
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))

    def leaf(ni, ids):
        nodes_off[ni] = len(ordered)
        nodes_n[ni] = len(ids)
        ordered.extend(ids.tolist())
        return ni

    def build(ids):
        ni = len(nodes_min)
        mn, mx = prim_min[ids].min(0), prim_max[ids].max(0)
        nodes_min.append(mn)
        nodes_max.append(mx)
        nodes_right.append(-1)
        nodes_off.append(0)
        nodes_n.append(0)
        nodes_axis.append(0)
        n = len(ids)
        if n <= max(1, force_leaf):
            return leaf(ni, ids)
        c = centroid[ids]
        cmn, cmx = c.min(0), c.max(0)
        axis = int(np.argmax(cmx - cmn))
        nodes_axis[ni] = axis
        if cmx[axis] - cmn[axis] < 1e-12:
            # every centroid at one point: a leaf (bvh.cpp's same-point case)
            return leaf(ni, ids)
        if n <= 2:
            part = np.argsort(c[:, axis], kind="stable")
            left_ids, right_ids = ids[part[:n // 2]], ids[part[n // 2:]]
        else:
            # binned SAH (bvh.cpp recursiveBuild)
            b = np.minimum((N_BUCKETS * (c[:, axis] - cmn[axis])
                            / (cmx[axis] - cmn[axis])).astype(np.int64), N_BUCKETS - 1)
            cnt = np.bincount(b, minlength=N_BUCKETS)
            bmn = np.full((N_BUCKETS, 3), np.inf, np.float32)
            bmx = np.full((N_BUCKETS, 3), -np.inf, np.float32)
            np.minimum.at(bmn, b, prim_min[ids])
            np.maximum.at(bmx, b, prim_max[ids])
            lmn, lmx = np.minimum.accumulate(bmn, 0), np.maximum.accumulate(bmx, 0)
            rmn = np.minimum.accumulate(bmn[::-1], 0)[::-1]
            rmx = np.maximum.accumulate(bmx[::-1], 0)[::-1]
            lcnt, rcnt = np.cumsum(cnt), np.cumsum(cnt[::-1])[::-1]
            total_sa = max(_surface_area(mn, mx), 1e-20)
            costs = np.full(N_BUCKETS - 1, np.inf)
            for i in range(N_BUCKETS - 1):
                if lcnt[i] == 0 or rcnt[i + 1] == 0:
                    continue
                costs[i] = TRAV_COST + (
                    lcnt[i] * _surface_area(lmn[i], lmx[i])
                    + rcnt[i + 1] * _surface_area(rmn[i + 1], rmx[i + 1])) / total_sa
            best = int(np.argmin(costs))
            if n <= max_prims and float(n) <= costs[best]:
                return leaf(ni, ids)
            go_left = b <= best
            left_ids, right_ids = ids[go_left], ids[~go_left]
            if len(left_ids) == 0 or len(right_ids) == 0:
                part = np.argsort(c[:, axis], kind="stable")
                left_ids, right_ids = ids[part[:n // 2]], ids[part[n // 2:]]
        build(left_ids)
        nodes_right[ni] = build(right_ids)
        return ni

    build(np.arange(tris.shape[0]))
    return {
        "bounds_min": np.stack(nodes_min).astype(np.float32),
        "bounds_max": np.stack(nodes_max).astype(np.float32),
        "right": np.asarray(nodes_right, np.int32),
        "prim_off": np.asarray(nodes_off, np.int32),
        "nprims": np.asarray(nodes_n, np.int32),
        "axis": np.asarray(nodes_axis, np.int32),
        "prim_ids": np.asarray(ordered, np.int32),
        "max_prims": np.int32(max_prims),
    }


def build_bvh_auto(verts, tris, max_prims=MAX_PRIMS_IN_NODE, force_leaf=0):
    """The reference's builder dispatch: the C++ builder from
    NATIVE_THRESHOLD triangles, the numpy builder below."""
    if np.asarray(tris).shape[0] >= NATIVE_THRESHOLD:
        return build_bvh_native(verts, tris, max_prims, force_leaf)
    return build_bvh(verts, tris, max_prims, force_leaf)
