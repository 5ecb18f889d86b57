// Collapse of the binary SAH BVH (bvh_builder.cpp's flattened layout) into
// the 4-wide node table that csrc/bvh4.cu walks.
//
// Each 4-wide node starts from a binary interior node's two children and
// repeatedly opens the interior child with the largest surface area (the
// first one on a tie), putting its two children in its place, until it has
// 4 children or only leaves. An interior child becomes a 4-wide node of its
// own (numbered breadth first); a leaf child is the binary leaf's triangle
// range in leaf order. A binary tree whose root is a leaf gives one node
// with that leaf as its only child.
//
// Node: 32 words (128 B), SoA over the 4 slots:
//   words  0..23  lo.x[4] lo.y[4] lo.z[4] hi.x[4] hi.y[4] hi.z[4] (float)
//   words 24..27  child[4] (int): node index, or ~first triangle of a leaf
//   words 28..31  count[4] (int): 0 for a node, the leaf's triangle count
// A child's box is its binary node's bounds_min/max, bit for bit. An empty
// slot has lo = hi = +inf on every axis, a box no finite ray enters, child
// -1 and count 0.
//
// Build: grail_torch/native/__init__.py, into the builder's library.
// ABI: plain C arrays (ctypes); the caller allocates one node per binary
// node (every 4-wide node but a root leaf's takes a binary interior node).

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kWidth = 4;
constexpr int kWords = 32;

float surface_area(const float *mn, const float *mx) {
    float dx = mx[0] - mn[0], dy = mx[1] - mn[1], dz = mx[2] - mn[2];
    dx = dx > 0.0f ? dx : 0.0f;
    dy = dy > 0.0f ? dy : 0.0f;
    dz = dz > 0.0f ? dz : 0.0f;
    return 2.0f * (dx * dy + dy * dz + dz * dx);
}

}  // namespace

extern "C" {

// Returns the number of 4-wide nodes written to out_nodes (n4 * 32 words)
// and the most stack entries a walk can hold in *out_stack: a node pushes
// all its hit children but the nearest, so a node's bound is its child
// count - 1 plus the largest bound among its node children.
long grail_collapse_bvh4(const float *bmin, const float *bmax,
                         const int32_t *right, const int32_t *nprims,
                         const int32_t *prim_off, float *out_nodes,
                         int32_t *out_stack) {
    const float inf = std::numeric_limits<float>::infinity();
    std::vector<int32_t> source;         // binary node of each 4-wide node
    auto is_leaf = [&](int32_t b) { return nprims[b] > 0; };

    source.push_back(0);
    for (size_t i = 0; i < source.size(); ++i) {
        const int32_t b = source[i];
        std::vector<int32_t> ch;
        if (is_leaf(b)) {
            ch.push_back(b);             // a root leaf: one child
        } else {
            ch = {b + 1, right[b]};
            while (ch.size() < kWidth) {
                int best = -1;
                float best_sa = -1.0f;
                for (size_t k = 0; k < ch.size(); ++k) {
                    if (is_leaf(ch[k])) continue;
                    float sa = surface_area(bmin + 3 * ch[k], bmax + 3 * ch[k]);
                    if (sa > best_sa) {
                        best_sa = sa;
                        best = static_cast<int>(k);
                    }
                }
                if (best < 0) break;
                const int32_t c = ch[best];
                ch[best] = c + 1;
                ch.insert(ch.begin() + best + 1, right[c]);
            }
        }
        float *node = out_nodes + kWords * i;
        int32_t child[kWidth], count[kWidth];
        for (int k = 0; k < kWidth; ++k) {
            if (k < static_cast<int>(ch.size())) {
                const int32_t c = ch[k];
                for (int a = 0; a < 3; ++a) {
                    node[4 * a + k] = bmin[3 * c + a];
                    node[4 * (3 + a) + k] = bmax[3 * c + a];
                }
                if (is_leaf(c)) {
                    child[k] = ~prim_off[c];
                    count[k] = nprims[c];
                } else {
                    child[k] = static_cast<int32_t>(source.size());
                    count[k] = 0;
                    source.push_back(c);
                }
            } else {
                for (int a = 0; a < 6; ++a) node[4 * a + k] = inf;
                child[k] = -1;
                count[k] = 0;
            }
        }
        std::memcpy(node + 24, child, sizeof(child));
        std::memcpy(node + 28, count, sizeof(count));
    }

    // children are numbered after their parent, so one reverse pass
    const long n4 = static_cast<long>(source.size());
    std::vector<int32_t> bound(n4, 0);
    for (long i = n4 - 1; i >= 0; --i) {
        int32_t child[kWidth], count[kWidth], n_child = 0, below = 0;
        std::memcpy(child, out_nodes + kWords * i + 24, sizeof(child));
        std::memcpy(count, out_nodes + kWords * i + 28, sizeof(count));
        for (int k = 0; k < kWidth; ++k) {
            if (child[k] == -1 && count[k] == 0) continue;
            ++n_child;
            if (count[k] == 0 && bound[child[k]] > below) below = bound[child[k]];
        }
        bound[i] = n_child - 1 + below;
    }
    *out_stack = bound[0];
    return n4;
}

}  // extern "C"
