// Farthest point sampling on the host: the port's own native twin of
// ops/fps.farthest_point_sampling_np, for offline mesh tools
// (tools/compute_fps.py --device cpu).
//
// It computes what the numpy version computes, bit for bit, ties included:
// each squared distance is (dx*dx + dy*dy) + dz*dz in float32 with every
// operation rounded once, as numpy's three-term sum rounds it, and the pick
// is the first maximum, as np.argmax's. A fused multiply-add rounds once
// where numpy rounds twice, which is enough to flip a pick between points
// at exactly equal distances (a lattice, a cylinder, a symmetric mesh), so
// contraction is switched off here whatever flags the file is built with;
// csrc/__init__.py builds it with -O2 and no -march=native, on one thread.
//
// C interface (ctypes):
//   int fps_sample(const float* pts, int64_t n, int64_t k, int init_center,
//                  int64_t start_idx, int64_t* out_idx)
// pts is row-major [n, 3], out_idx [k]. With init_center the min-distances
// start as the squared distances to the bounding box's centre
// ((max + min) * 0.5) and the first pick is the farthest point from it;
// without, they start at +inf and the first pick is start_idx. Each step
// records the current pick, takes the minimum with the squared distances
// to it, sets its slot to -inf and picks the first maximum. Returns 0, or
// -1 when n <= 0, k <= 0, k > n, or start_idx lies outside [0, n) without
// init_center.

#include <cstddef>
#include <cstdint>
#include <limits>
#include <vector>

#if defined(__clang__)
#pragma clang fp contract(off)
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off")
#endif

namespace {

inline float sq_dist(const float* a, const float* b) {
    const float dx = a[0] - b[0];
    const float dy = a[1] - b[1];
    const float dz = a[2] - b[2];
    const float xy = dx * dx + dy * dy;
    return xy + dz * dz;
}

// np.argmax: the index of the first maximum
inline int64_t first_max(const float* v, int64_t n) {
    int64_t best_i = 0;
    float best = v[0];
    for (int64_t i = 1; i < n; ++i) {
        if (v[i] > best) {
            best = v[i];
            best_i = i;
        }
    }
    return best_i;
}

}  // namespace

extern "C" int fps_sample(const float* pts, int64_t n, int64_t k, int init_center,
                          int64_t start_idx, int64_t* out_idx) {
    if (n <= 0 || k <= 0 || k > n) return -1;
    if (!init_center && (start_idx < 0 || start_idx >= n)) return -1;

    std::vector<float> min_d(static_cast<std::size_t>(n));
    int64_t cur = start_idx;
    if (init_center) {
        float lo[3] = {pts[0], pts[1], pts[2]};
        float hi[3] = {pts[0], pts[1], pts[2]};
        for (int64_t i = 1; i < n; ++i) {
            for (int d = 0; d < 3; ++d) {
                const float v = pts[i * 3 + d];
                if (v < lo[d]) lo[d] = v;
                if (v > hi[d]) hi[d] = v;
            }
        }
        const float c[3] = {(hi[0] + lo[0]) * 0.5f, (hi[1] + lo[1]) * 0.5f,
                            (hi[2] + lo[2]) * 0.5f};
        for (int64_t i = 0; i < n; ++i) min_d[i] = sq_dist(&pts[i * 3], c);
        cur = first_max(min_d.data(), n);
    } else {
        for (int64_t i = 0; i < n; ++i) min_d[i] = std::numeric_limits<float>::infinity();
    }

    for (int64_t s = 0; s < k; ++s) {
        out_idx[s] = cur;
        const float* p = &pts[cur * 3];
        for (int64_t i = 0; i < n; ++i) {
            const float d = sq_dist(&pts[i * 3], p);
            if (d < min_d[i]) min_d[i] = d;
        }
        min_d[cur] = -std::numeric_limits<float>::infinity();
        cur = first_max(min_d.data(), n);
    }
    return 0;
}
