// Native SAH BVH builder — the C++ tier of the host scene pipeline
// (pbrt src/accelerators/bvh.cpp BVHAccel::recursiveBuild + flattenBVHTree).
//
// Mirrors the reference's numpy builder (grail/scene/bvh.py build_bvh):
// binned SAH with 12 buckets, traversal cost 0.125, leaf cap max_prims,
// degenerate-centroid leaves, equal-count fallback, DFS flattening with first
// child at i+1 and the second-child index in `right` (-1 for leaves). That
// builder is the semantic reference; this one is the port's only builder,
// because an interpreted build over 100k-triangle meshes is far too slow.
//
// Build: grail_torch/native/__init__.py (g++ -O2 -shared -fPIC -std=c++17)
// ABI: plain C arrays (ctypes); caller allocates 2*T-1 node slots.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int N_BUCKETS = 12;
constexpr float TRAV_COST = 0.125f;

struct V3 {
    float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float surface_area(const V3 &mn, const V3 &mx) {
    float dx = std::max(mx.x - mn.x, 0.0f);
    float dy = std::max(mx.y - mn.y, 0.0f);
    float dz = std::max(mx.z - mn.z, 0.0f);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
}

struct Builder {
    const V3 *prim_min;
    const V3 *prim_max;
    const V3 *centroid;
    int max_prims;
    int force_leaf;   // make a leaf whenever n <= force_leaf (stream kernel)

    std::vector<float> bmin, bmax;
    std::vector<int32_t> right, prim_off, nprims, axis;
    std::vector<int32_t> ordered;

    int emit() {
        int i = static_cast<int>(right.size());
        bmin.insert(bmin.end(), {0, 0, 0});
        bmax.insert(bmax.end(), {0, 0, 0});
        right.push_back(-1);
        prim_off.push_back(0);
        nprims.push_back(0);
        axis.push_back(0);
        return i;
    }

    void set_bounds(int ni, const V3 &mn, const V3 &mx) {
        bmin[3 * ni] = mn.x; bmin[3 * ni + 1] = mn.y; bmin[3 * ni + 2] = mn.z;
        bmax[3 * ni] = mx.x; bmax[3 * ni + 1] = mx.y; bmax[3 * ni + 2] = mx.z;
    }

    void make_leaf(int ni, int32_t *ids, int n) {
        prim_off[ni] = static_cast<int32_t>(ordered.size());
        nprims[ni] = n;
        ordered.insert(ordered.end(), ids, ids + n);
    }

    // ids is a mutable span the node may partition in place
    int build(int32_t *ids, int n) {
        int ni = emit();
        V3 mn = prim_min[ids[0]], mx = prim_max[ids[0]];
        for (int i = 1; i < n; ++i) {
            mn = vmin(mn, prim_min[ids[i]]);
            mx = vmax(mx, prim_max[ids[i]]);
        }
        set_bounds(ni, mn, mx);
        if (n <= std::max(1, force_leaf)) {
            make_leaf(ni, ids, n);
            return ni;
        }
        V3 cmn = centroid[ids[0]], cmx = centroid[ids[0]];
        for (int i = 1; i < n; ++i) {
            cmn = vmin(cmn, centroid[ids[i]]);
            cmx = vmax(cmx, centroid[ids[i]]);
        }
        float ext[3] = {cmx.x - cmn.x, cmx.y - cmn.y, cmx.z - cmn.z};
        int ax = 0;
        if (ext[1] > ext[0]) ax = 1;
        if (ext[2] > ext[ax]) ax = 2;
        axis[ni] = ax;
        auto cval = [&](int32_t id) {
            const V3 &c = centroid[id];
            return ax == 0 ? c.x : (ax == 1 ? c.y : c.z);
        };
        float lo = ax == 0 ? cmn.x : (ax == 1 ? cmn.y : cmn.z);
        float hi = ax == 0 ? cmx.x : (ax == 1 ? cmx.y : cmx.z);
        if (hi - lo < 1e-12f) {   // degenerate: coincident centroids
            make_leaf(ni, ids, n);
            return ni;
        }
        int mid;
        if (n <= 2) {
            std::stable_sort(ids, ids + n, [&](int32_t a, int32_t b) {
                return cval(a) < cval(b);
            });
            mid = n / 2;
        } else {
            // binned SAH (bvh.cpp recursiveBuild SAH branch)
            int cnt[N_BUCKETS] = {};
            V3 bnmn[N_BUCKETS], bnmx[N_BUCKETS];
            for (int b = 0; b < N_BUCKETS; ++b) {
                bnmn[b] = {INFINITY, INFINITY, INFINITY};
                bnmx[b] = {-INFINITY, -INFINITY, -INFINITY};
            }
            auto bucket_of = [&](int32_t id) {
                int b = static_cast<int>(N_BUCKETS * (cval(id) - lo) / (hi - lo));
                return std::min(b, N_BUCKETS - 1);
            };
            for (int i = 0; i < n; ++i) {
                int b = bucket_of(ids[i]);
                cnt[b]++;
                bnmn[b] = vmin(bnmn[b], prim_min[ids[i]]);
                bnmx[b] = vmax(bnmx[b], prim_max[ids[i]]);
            }
            double costs[N_BUCKETS - 1];
            double total_sa = std::max(
                static_cast<double>(surface_area(mn, mx)), 1e-20);
            {
                V3 lmn = bnmn[0], lmx = bnmx[0];
                int lcnt = cnt[0];
                double lsa[N_BUCKETS - 1];
                int lcs[N_BUCKETS - 1];
                for (int i = 0; i < N_BUCKETS - 1; ++i) {
                    if (i > 0) {
                        lmn = vmin(lmn, bnmn[i]);
                        lmx = vmax(lmx, bnmx[i]);
                        lcnt += cnt[i];
                    }
                    lsa[i] = surface_area(lmn, lmx);
                    lcs[i] = lcnt;
                }
                V3 rmn = bnmn[N_BUCKETS - 1], rmx = bnmx[N_BUCKETS - 1];
                int rcnt = cnt[N_BUCKETS - 1];
                for (int i = N_BUCKETS - 2; i >= 0; --i) {
                    if (i < N_BUCKETS - 2) {
                        rmn = vmin(rmn, bnmn[i + 1]);
                        rmx = vmax(rmx, bnmx[i + 1]);
                        rcnt += cnt[i + 1];
                    }
                    costs[i] = (lcs[i] == 0 || rcnt == 0)
                        ? std::numeric_limits<double>::infinity()
                        : TRAV_COST + (lcs[i] * lsa[i]
                                       + rcnt * surface_area(rmn, rmx))
                              / total_sa;
                }
            }
            int best = 0;
            for (int i = 1; i < N_BUCKETS - 1; ++i)
                if (costs[i] < costs[best]) best = i;
            if (n <= max_prims && static_cast<double>(n) <= costs[best]) {
                make_leaf(ni, ids, n);
                return ni;
            }
            int32_t *split = std::stable_partition(
                ids, ids + n,
                [&](int32_t id) { return bucket_of(id) <= best; });
            mid = static_cast<int>(split - ids);
            if (mid == 0 || mid == n) {   // all in one bucket side: equal count
                std::stable_sort(ids, ids + n, [&](int32_t a, int32_t b) {
                    return cval(a) < cval(b);
                });
                mid = n / 2;
            }
        }
        build(ids, mid);
        right[ni] = build(ids + mid, n - mid);
        return ni;
    }
};

}  // namespace

extern "C" {

// Returns the node count; outputs sized by caller: bounds 3*(2T-1) floats,
// index arrays (2T-1) int32, prim_ids T int32.
long grail_build_bvh(const float *verts, long n_verts, const int32_t *tris,
                     long n_tris, int max_prims, int force_leaf,
                     float *out_bmin,
                     float *out_bmax, int32_t *out_right,
                     int32_t *out_prim_off, int32_t *out_nprims,
                     int32_t *out_axis, int32_t *out_prim_ids) {
    (void)n_verts;
    std::vector<V3> pmin(n_tris), pmax(n_tris), cent(n_tris);
    for (long t = 0; t < n_tris; ++t) {
        const float *a = verts + 3 * tris[3 * t];
        const float *b = verts + 3 * tris[3 * t + 1];
        const float *c = verts + 3 * tris[3 * t + 2];
        V3 va{a[0], a[1], a[2]}, vb{b[0], b[1], b[2]}, vc{c[0], c[1], c[2]};
        pmin[t] = vmin(vmin(va, vb), vc);
        pmax[t] = vmax(vmax(va, vb), vc);
        cent[t] = {0.5f * (pmin[t].x + pmax[t].x),
                   0.5f * (pmin[t].y + pmax[t].y),
                   0.5f * (pmin[t].z + pmax[t].z)};
    }
    std::vector<int32_t> ids(n_tris);
    for (long t = 0; t < n_tris; ++t) ids[t] = static_cast<int32_t>(t);

    Builder bld;
    bld.prim_min = pmin.data();
    bld.prim_max = pmax.data();
    bld.centroid = cent.data();
    bld.max_prims = max_prims;
    bld.force_leaf = force_leaf;
    long cap = 2 * n_tris - 1;
    bld.bmin.reserve(3 * cap);
    bld.bmax.reserve(3 * cap);
    bld.right.reserve(cap);
    bld.ordered.reserve(n_tris);
    bld.build(ids.data(), static_cast<int>(n_tris));

    long n_nodes = static_cast<long>(bld.right.size());
    std::memcpy(out_bmin, bld.bmin.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(out_bmax, bld.bmax.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(out_right, bld.right.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(out_prim_off, bld.prim_off.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(out_nprims, bld.nprims.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(out_axis, bld.axis.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(out_prim_ids, bld.ordered.data(), sizeof(int32_t) * n_tris);
    return n_nodes;
}

}  // extern "C"
