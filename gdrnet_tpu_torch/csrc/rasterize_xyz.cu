// Z-buffer rasterizer of object coordinates: depth and XYZ maps of one mesh
// under B poses, each over an H x W pixel window at an integer origin.
//
//   for pose b and pixel (i, j), sample point (x, y) = (j + ox_b, i + oy_b):
//   the face that passes the edge-function test with the largest
//   perspective-correct 1/z wins (ties to the lowest face index);
//   depth[b, i, j] = 1 / best 1/z, xyz[b, i, j] = interpolated (object
//   coordinate / z) / best 1/z; 0 in both where no face covers the pixel.
//
// Replaces the TPU kernel gdrnet_tpu/ops/pallas_kernels.py:_raster_kernel
// (launched by rasterize_xyz_pallas). That kernel took [pixel tile, face
// chunk] blocks on a sequential grid, kept the running best 1/z and its
// attributes in a VMEM scratch across face chunks, found the first maximum
// in a chunk with a lane-iota min, since it had no arg-max, and tested every
// face at every pixel.
//
// What bounds it on an H100: the arithmetic of the (pixel, face) pairs that
// cannot be skipped. A pair costs about 25 f32 instructions (two edge
// functions, the third barycentric, the 1/z interpolation, the compares);
// all pairs of a 128 x 128 window over a 448-face mesh are 7.3e6 per pose,
// but most faces of a mesh cannot cover most 16 x 16 tiles of a window. The
// mesh and poses are a few KB; the outputs 16 bytes a pixel.
//
// What the design does about that, in two launches with no other op between
// them:
//  1. face_setup_kernel, one thread per (pose, face), projects the face's
//     three vertices and writes its record to a scratch table [B, F, 12]:
//     (x0 y0 x1 y1) (x2 y2 inv_area valid) (iz0 iz1 iz2 0), 48 bytes. It
//     repeats ops/kernels.raster_face_tables operation by operation (the
//     plain version's prologue), so the table is the plain version's bit
//     for bit. A face index outside [0, V) stops it with a device-side
//     fault before any read, as PyTorch's index kernels do.
//  2. zbuffer_kernel, one block of 8 x 8 threads per 16 x 16 pixel tile,
//     grid (W/16, H/16, B); each thread owns 2 x 2 pixels (columns j, j + 8,
//     rows i, i + 8) and keeps their best 1/z, two barycentrics and face
//     index in registers. The table streams through shared memory in chunks
//     of 64 faces:
//     - the block copies the next chunk's records with cp.async, 16
//       contiguous bytes a thread (whole 32-byte sectors of L2), while it
//       tests the current chunk;
//     - each thread tests its face against the tile's sample rectangle
//       (Culling, below), and the kept faces are compacted in face order
//       (warp ballot, then a prefix count over the warps in shared memory),
//       so the tie rule holds: a strict > in face order, which picks the
//       plain version's winner (its first arg-max per face chunk, then a
//       strict > across chunks);
//     - every kept record, read once from shared memory as a broadcast,
//       serves the thread's four pixels, which share the differences
//       x - px of their columns and y - py of their rows;
//     - at the end each pixel's XYZ is interpolated from its winning face's
//       vertices, read from the mesh, times their 1/z from the table.
//  The ragged window edge is masked at the store only, so every thread
//  takes part in the block's copies and barriers; any face count fits and
//  none is padded.
//
// Tensor cores: none. The work is per-pixel f32 edge tests with a
// data-dependent arg-max, and TF32 or bf16 products would break the exact
// agreement with the plain version.
//
// Exact agreement: every product, sum, division and clamp is written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the plain version's
// order of operations, so nvcc contracts nothing into an FMA; clamp_min
// keeps a NaN as torch.clamp_min does (fmaxf would drop it); 1e-12 and
// z_near compare as f32 constants, as PyTorch casts a Python scalar to the
// tensor's f32. Culling drops only faces that cannot pass the inside test
// at any pixel of the tile, so no output bit changes.
//
// Culling. For a face record and pixel p, the kernel computes in f32
//   wk = ((xa - px) (yb - py) - (ya - py) (xb - px)) * inv_area,
// (a, b) = (1, 2) for w0 and (2, 0) for w1, with five roundings of relative
// error u = 2^-24 each (two differences, a product, the difference, the
// product with inv_area). So |wk - Wk| <= g |inv_area| (|A B| + |C D|) with
// Wk the same expression in exact arithmetic on the same f32 inputs, A = xa
// - px, B = yb - py, C = ya - py, D = xb - px, and g = 5u / (1 - 5u) < 6u;
// a subnormal result adds at most 2^-150 a rounding, covered by 2^-148
// (|inv_area| + 1). On the tile's sample rectangle [px_lo, px_hi] x [py_lo,
// py_hi] |A| is at most max(|xa - px_lo|, |xa - px_hi|), and so on, which
// gives one bound Ek for the tile. w2 = (1 - w0) - w1 rounds twice more:
// |w2 - W2| <= E0 + E1 + u (2 + u) (1 + M0 + E0) + u (M1 + E1) <= E2 = E0 +
// E1 + 3u ((1 + M0 + E0) + (M1 + E1)), W2 = 1 - W0 - W1, Mk the largest
// |Wk| at the rectangle's corners. Wk is affine in p: when Wk < -Ek at all
// four corners, the f32 wk is negative at every pixel of the tile, and the
// face is dropped; an invalid face is dropped too. The tests run in f64 with
// __dmul_rn / __dsub_rn / __dadd_rn (exact enough: its own error is 2^-29
// of the bound, inside the margin from 5u to 6u). A wk that overflows is
// inf or NaN and fails the inside test anyway. A near-degenerate face has a
// huge inv_area, so a huge bound, and is kept. ops/kernels.raster_tile_keep
// is the plain version of this rule, in the same order of operations.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr int kTile = 16;                        // pixels per tile side
constexpr int kThreadsX = 8;                     // threads per tile side, 2 x 2 pixels each
constexpr int kThreads = kThreadsX * kThreadsX;  // 64
constexpr int kChunk = kThreads;                 // faces per chunk: one culling test a thread
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = 3;                     // attribute channels per vertex (XYZ)
constexpr int kSetupThreads = 128;

constexpr double kCullGamma = 6.0 * 0x1p-24;     // f32 error of edge() * inv_area, with margin
constexpr double kCullW2 = 3.0 * 0x1p-24;        // the two roundings of w2
constexpr double kCullTiny = 0x1p-148;           // subnormal results

// ---------------------------------------------------------------------------
// 1. face setup: ops/kernels.raster_face_tables, operation by operation
// ---------------------------------------------------------------------------

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);  // torch.clamp_min keeps NaN
}

// (m[0] * a + m[1] * b) + m[2] * c: ops/kernels._rows, rounded per operation
__device__ __forceinline__ float row(const float* m, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], a), __fmul_rn(m[1], b)), __fmul_rn(m[2], c));
}

struct Projected {
  float u, v, cz, iz;
};

__device__ __forceinline__ Projected project(const float* K, const float* R, const float* t,
                                             const float* vert, float z_near) {
  const float x = vert[0], y = vert[1], z = vert[2];
  const float cx = __fadd_rn(row(R, x, y, z), t[0]);
  const float cy = __fadd_rn(row(R + 3, x, y, z), t[1]);
  const float cz = __fadd_rn(row(R + 6, x, y, z), t[2]);
  const float uw = clamp_min(row(K + 6, cx, cy, cz), z_near);
  Projected p;
  p.u = __fdiv_rn(row(K, cx, cy, cz), uw);
  p.v = __fdiv_rn(row(K + 3, cx, cy, cz), uw);
  p.cz = cz;
  p.iz = __fdiv_rn(1.f, clamp_min(cz, z_near));  // 1.0 / t is reciprocal(t) * 1.0
  return p;
}

// verts [V, 3], faces [F, 3], K and R [B, 3, 3], t [B, 3] -> geom [B, F, 3] float4
template <typename Index>
__global__ void __launch_bounds__(kSetupThreads)
face_setup_kernel(const float* __restrict__ verts, const Index* __restrict__ faces,
                  const float* __restrict__ K, const float* __restrict__ R,
                  const float* __restrict__ t, float4* __restrict__ geom, int nv, int nf,
                  float z_near) {
  const int f = blockIdx.x * kSetupThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (f >= nf) return;
  Projected p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const Index vi = faces[3 * static_cast<size_t>(f) + k];
    if (vi < 0 || vi >= nv) {
      printf("rasterize_xyz: face %d has vertex index %lld outside [0, %d)\n", f,
             static_cast<long long>(vi), nv);
      __trap();
    }
    p[k] = project(K + 9 * b, R + 9 * b, t + 3 * b, verts + 3 * static_cast<size_t>(vi), z_near);
  }
  // (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
  const float area = __fsub_rn(__fmul_rn(__fsub_rn(p[1].u, p[0].u), __fsub_rn(p[2].v, p[0].v)),
                               __fmul_rn(__fsub_rn(p[1].v, p[0].v), __fsub_rn(p[2].u, p[0].u)));
  const bool valid = fabsf(area) > 1e-12f && p[0].cz > z_near && p[1].cz > z_near &&
                     p[2].cz > z_near;
  float4* out = geom + 3 * (static_cast<size_t>(b) * nf + f);
  out[0] = make_float4(p[0].u, p[0].v, p[1].u, p[1].v);
  out[1] = make_float4(p[2].u, p[2].v, valid ? __fdiv_rn(1.f, area) : 0.f, valid ? 1.f : 0.f);
  out[2] = make_float4(p[0].iz, p[1].iz, p[2].iz, 0.f);
}

// ---------------------------------------------------------------------------
// 2. z-buffer over culled, staged face chunks
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float interp(float w0, float w1, float w2, float a0, float a1,
                                        float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a0), __fmul_rn(w1, a1)), __fmul_rn(w2, a2));
}

__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }

// Exact barycentric ((xa - px)(yb - py) - (ya - py)(xb - px)) * ia at the
// rectangle's corners w[2 * y + x] and its bound e over the rectangle.
__device__ __forceinline__ void edge_cull(double xa, double ya, double xb, double yb, double ia,
                                          double abs_ia, const double px[2], const double py[2],
                                          double w[4], double& e) {
  double A[2], B[2], C[2], D[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    A[k] = __dsub_rn(xa, px[k]);
    D[k] = __dsub_rn(xb, px[k]);
    B[k] = __dsub_rn(yb, py[k]);
    C[k] = __dsub_rn(ya, py[k]);
  }
#pragma unroll
  for (int y = 0; y < 2; ++y) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      w[2 * y + x] = __dmul_rn(__dsub_rn(__dmul_rn(B[y], A[x]), __dmul_rn(C[y], D[x])), ia);
    }
  }
  const double s = __dadd_rn(
      __dmul_rn(dmax(fabs(A[0]), fabs(A[1])), dmax(fabs(B[0]), fabs(B[1]))),
      __dmul_rn(dmax(fabs(C[0]), fabs(C[1])), dmax(fabs(D[0]), fabs(D[1]))));
  e = __dadd_rn(__dmul_rn(__dmul_rn(kCullGamma, abs_ia), s),
                __dmul_rn(kCullTiny, __dadd_rn(abs_ia, 1.0)));
}

__device__ __forceinline__ bool all_below(const double w[4], double e) {
  return w[0] < -e && w[1] < -e && w[2] < -e && w[3] < -e;  // false on NaN: kept
}

// Whether the face (p = x0 y0 x1 y1, q = x2 y2 inv_area valid) may pass the
// inside test at a sample point of the rectangle px x py (header: Culling).
__device__ bool may_cover(float4 p, float4 q, const double px[2], const double py[2]) {
  if (!(q.w > 0.f)) return false;
  const double ia = q.z, abs_ia = fabs(ia);
  double w0[4], w1[4], w2[4], e0, e1;
  edge_cull(p.z, p.w, q.x, q.y, ia, abs_ia, px, py, w0, e0);
  edge_cull(q.x, q.y, p.x, p.y, ia, abs_ia, px, py, w1, e1);
#pragma unroll
  for (int c = 0; c < 4; ++c) w2[c] = __dsub_rn(__dsub_rn(1.0, w0[c]), w1[c]);
  const double m0 = dmax(dmax(fabs(w0[0]), fabs(w0[1])), dmax(fabs(w0[2]), fabs(w0[3])));
  const double m1 = dmax(dmax(fabs(w1[0]), fabs(w1[1])), dmax(fabs(w1[2]), fabs(w1[3])));
  const double e2 = __dadd_rn(__dadd_rn(e0, e1),
                              __dmul_rn(kCullW2, __dadd_rn(__dadd_rn(__dadd_rn(1.0, m0), e0),
                                                           __dadd_rn(m1, e1))));
  return !(all_below(w0, e0) || all_below(w1, e1) || all_below(w2, e2));
}

// geom [B, F, 3] float4 from face_setup_kernel; attrs [V, kChannels]; faces
// [F, 3]; origins [B, 2] -> depth [B, H, W], out [B, H, W, kChannels]
template <typename Index>
__global__ void __launch_bounds__(kThreads)
zbuffer_kernel(const float4* __restrict__ geom, const float* __restrict__ attrs,
               const Index* __restrict__ faces, const float* __restrict__ origins,
               float* __restrict__ depth, float* __restrict__ out, int nf, int h, int w) {
  __shared__ __align__(16) float4 stage[2][3 * kChunk];  // this chunk's records, the next's
  __shared__ __align__(16) float4 live[3 * kChunk];      // the chunk's kept faces, in order
  __shared__ int live_face[kChunk];
  __shared__ int warp_kept[kWarps];

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid % kThreadsX, ty = tid / kThreadsX;
  const int j0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile;
  const float ox = origins[2 * b], oy = origins[2 * b + 1];
  float px[2], py[2];  // this thread's columns j0 + tx + 8c and rows i0 + ty + 8r
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    px[k] = __fadd_rn(static_cast<float>(j0 + tx + kThreadsX * k), ox);
    py[k] = __fadd_rn(static_cast<float>(i0 + ty + kThreadsX * k), oy);
  }
  // the tile's sample rectangle: its first and last pixel inside the window
  const double rx[2] = {__fadd_rn(static_cast<float>(j0), ox),
                        __fadd_rn(static_cast<float>(min(j0 + kTile - 1, w - 1)), ox)};
  const double ry[2] = {__fadd_rn(static_cast<float>(i0), oy),
                        __fadd_rn(static_cast<float>(min(i0 + kTile - 1, h - 1)), oy)};

  const float4* gb = geom + 3 * static_cast<size_t>(b) * nf;
  const int n_chunks = (nf + kChunk - 1) / kChunk;
  auto copy_chunk = [&](int chunk) {
    const int base = chunk * kChunk;
    const int n = 3 * min(kChunk, nf - base);
    for (int k = tid; k < n; k += kThreads) {
      cp_async16(&stage[chunk & 1][k], gb + 3 * static_cast<size_t>(base) + k);
    }
    cp_async_commit();
  };

  float best[4], bw0[4], bw1[4];  // pixel n = 2 * r + c
  int bface[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    best[n] = bw0[n] = bw1[n] = 0.f;
    bface[n] = 0;
  }

  copy_chunk(0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait_all();
    __syncthreads();  // the chunk has landed; the other stage is no longer read
    if (chunk + 1 < n_chunks) copy_chunk(chunk + 1);
    const int f = chunk * kChunk + tid;
    float4 p = {}, q = {}, iz = {};
    bool keep = false;
    if (f < nf) {
      p = stage[chunk & 1][3 * tid];
      q = stage[chunk & 1][3 * tid + 1];
      iz = stage[chunk & 1][3 * tid + 2];
      keep = may_cover(p, q, rx, ry);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();  // the warp counts are in
    int slot = __popc(ballot & ((1u << lane) - 1u)), n_live = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      slot += k < warp ? warp_kept[k] : 0;
      n_live += warp_kept[k];
    }
    if (keep) {
      live[3 * slot] = p;
      live[3 * slot + 1] = q;
      live[3 * slot + 2] = iz;
      live_face[slot] = f;
    }
    __syncthreads();  // the live list is complete

    for (int k = 0; k < n_live; ++k) {
      const float4 a = live[3 * k];      // x0 y0 x1 y1
      const float4 c = live[3 * k + 1];  // x2 y2 inv_area valid
      const float4 z = live[3 * k + 2];  // iz0 iz1 iz2
      float dx0[2], dx1[2], dx2[2], dy0[2], dy1[2], dy2[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        dx0[m] = __fsub_rn(a.x, px[m]);
        dx1[m] = __fsub_rn(a.z, px[m]);
        dx2[m] = __fsub_rn(c.x, px[m]);
        dy0[m] = __fsub_rn(a.y, py[m]);
        dy1[m] = __fsub_rn(a.w, py[m]);
        dy2[m] = __fsub_rn(c.y, py[m]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int n = 2 * r + cc;
          // w0 = ((x1 - px)(y2 - py) - (y1 - py)(x2 - px)) * inv_area
          const float w0 = __fmul_rn(
              __fsub_rn(__fmul_rn(dx1[cc], dy2[r]), __fmul_rn(dy1[r], dx2[cc])), c.z);
          // w1 = ((x2 - px)(y0 - py) - (y2 - py)(x0 - px)) * inv_area
          const float w1 = __fmul_rn(
              __fsub_rn(__fmul_rn(dx2[cc], dy0[r]), __fmul_rn(dy2[r], dx0[cc])), c.z);
          const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
          const float frag = interp(w0, w1, w2, z.x, z.y, z.z);
          // kept faces are valid: the culling test dropped the others
          if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f && frag > best[n]) {
            best[n] = frag;
            bw0[n] = w0;
            bw1[n] = w1;
            bface[n] = live_face[k];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int n = 2 * r + cc;
      const int i = i0 + ty + kThreadsX * r, j = j0 + tx + kThreadsX * cc;
      if (i >= h || j >= w) continue;
      const size_t pix = (static_cast<size_t>(b) * h + i) * w + j;
      float* o = out + kChannels * pix;
      if (best[n] > 0.f) {
        const float safe = fmaxf(best[n], 1e-12f);
        const float bw2 = __fsub_rn(__fsub_rn(1.f, bw0[n]), bw1[n]);
        const Index* fv = faces + 3 * static_cast<size_t>(bface[n]);
        const float4 izf = gb[3 * static_cast<size_t>(bface[n]) + 2];
        const float* a0 = attrs + kChannels * static_cast<size_t>(fv[0]);
        const float* a1 = attrs + kChannels * static_cast<size_t>(fv[1]);
        const float* a2 = attrs + kChannels * static_cast<size_t>(fv[2]);
        depth[pix] = __fdiv_rn(1.f, safe);
#pragma unroll
        for (int ch = 0; ch < kChannels; ++ch) {
          // attrs * inv_z per vertex, one rounding, as the plain version
          o[ch] = __fdiv_rn(interp(bw0[n], bw1[n], bw2, __fmul_rn(a0[ch], izf.x),
                                   __fmul_rn(a1[ch], izf.y), __fmul_rn(a2[ch], izf.z)),
                            safe);
        }
      } else {
        depth[pix] = 0.f;
#pragma unroll
        for (int ch = 0; ch < kChannels; ++ch) o[ch] = 0.f;
      }
    }
  }
}

template <typename Index>
int launch(const float* verts, const Index* faces, const float* K, const float* R,
           const float* t, const float* origins, float4* geom, float* depth, float* xyz, int b,
           int nv, int nf, int h, int w, float z_near, cudaStream_t stream) {
  const dim3 setup_grid((nf + kSetupThreads - 1) / kSetupThreads, b);
  face_setup_kernel<Index><<<setup_grid, kSetupThreads, 0, stream>>>(verts, faces, K, R, t, geom,
                                                                       nv, nf, z_near);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  zbuffer_kernel<Index><<<grid, kThreads, 0, stream>>>(geom, verts, faces, origins, depth, xyz,
                                                       nf, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pixels per side of the tiles the z-buffer culls faces for.
int rasterize_xyz_tile() { return kTile; }

// Launches the face setup, then the z-buffer, on `stream`; returns
// cudaGetLastError() after each launch (0 = ok). verts [nv, 3], faces [nf, 3]
// (int64 if faces_int64, else int32), K and R [b, 3, 3], t [b, 3], origins
// [b, 2], geom [b, nf, 12] (scratch), depth [b, h, w], xyz [b, h, w, 3]:
// contiguous, f32 unless stated, on the current device.
int rasterize_xyz_launch(const void* verts, const void* faces, int faces_int64, const void* K,
                         const void* R, const void* t, const void* origins, void* geom,
                         void* depth, void* xyz, int b, int nv, int nf, int h, int w,
                         float z_near, void* stream) {
  if (b < 1 || b > 65535 || nv < 1 || nf < 1 || h < 1 || w < 1 ||
      (h + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* v = static_cast<const float*>(verts);
  const auto* k = static_cast<const float*>(K);
  const auto* r = static_cast<const float*>(R);
  const auto* tt = static_cast<const float*>(t);
  const auto* o = static_cast<const float*>(origins);
  auto* g = static_cast<float4*>(geom);
  auto* d = static_cast<float*>(depth);
  auto* x = static_cast<float*>(xyz);
  auto s = static_cast<cudaStream_t>(stream);
  if (faces_int64) {
    return launch(v, static_cast<const int64_t*>(faces), k, r, tt, o, g, d, x, b, nv, nf, h, w,
                  z_near, s);
  }
  return launch(v, static_cast<const int32_t*>(faces), k, r, tt, o, g, d, x, b, nv, nf, h, w,
                z_near, s);
}

const char* rasterize_xyz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
