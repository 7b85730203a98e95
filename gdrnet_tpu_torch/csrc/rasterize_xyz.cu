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
// attributes in a VMEM scratch across face chunks, and found the first
// maximum in a chunk with a lane-iota min, since it had no arg-max.
//
// What bounds it on an H100: the arithmetic. Every (pixel, face) pair costs
// about 25 f32 instructions (two edge functions, the third barycentric, the
// 1/z interpolation, four compares); a 128 x 128 window over a 448-face mesh
// is 7.3e6 pairs per pose. The inputs are the per-face table, 48 bytes a
// face, read once per 16 x 16 pixel block; the outputs 16 bytes a pixel.
//
// What the design does about that:
//  - one thread per pixel, blocks of 16 x 16 pixels, grid (W/16, H/16, B);
//    the ragged window edge is masked at the store only, so every thread
//    takes part in the block's loads;
//  - the per-face table (screen x0 y0 x1 y1 x2 y2, 1/area, valid, 1/z of the
//    three vertices) streams through shared memory in chunks of kFaceChunk
//    faces, three float4 per face, each read by the whole block as a
//    broadcast, so any face count fits and none is padded;
//  - each thread keeps the best 1/z, two barycentrics and the face index in
//    registers and replaces them on a strict > in face order, which picks the
//    same winner as the plain version's chunked first arg-max; the XYZ of the
//    winning face is interpolated once, at the end;
//  - every product and sum is written with __fmul_rn / __fadd_rn / __fsub_rn
//    / __fdiv_rn in the plain version's order of operations, so nvcc
//    contracts nothing into an FMA and the results equal the plain
//    version's bit for bit on the same table.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kThreads = kTileX * kTileY;
constexpr int kFaceChunk = 256;

__device__ __forceinline__ float edge(float xa, float ya, float xb, float yb, float px,
                                      float py) {
  // (xa - px) * (yb - py) - (ya - py) * (xb - px), rounded per operation
  return __fsub_rn(__fmul_rn(__fsub_rn(xa, px), __fsub_rn(yb, py)),
                   __fmul_rn(__fsub_rn(ya, py), __fsub_rn(xb, px)));
}

__device__ __forceinline__ float interp(float w0, float w1, float w2, float a0, float a1,
                                        float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a0), __fmul_rn(w1, a1)), __fmul_rn(w2, a2));
}

// geom [B, F, 3] float4: (x0 y0 x1 y1) (x2 y2 inv_area valid) (iz0 iz1 iz2 0)
// attr [B, F, 9]: x/z y/z z/z at vertex 0, 1, 2; origins [B, 2]
__global__ void __launch_bounds__(kThreads)
rasterize_xyz_kernel(const float4* __restrict__ geom, const float* __restrict__ attr,
                     const float* __restrict__ origins, float* __restrict__ depth,
                     float* __restrict__ xyz, int nf, int h, int w) {
  __shared__ float4 chunk[3 * kFaceChunk];

  const int b = blockIdx.z;
  const int j = blockIdx.x * kTileX + threadIdx.x;
  const int i = blockIdx.y * kTileY + threadIdx.y;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const float px = __fadd_rn(static_cast<float>(j), origins[2 * b]);
  const float py = __fadd_rn(static_cast<float>(i), origins[2 * b + 1]);
  const float4* gb = geom + static_cast<size_t>(b) * nf * 3;

  float best = 0.f, bw0 = 0.f, bw1 = 0.f;
  int bface = 0;
  for (int base = 0; base < nf; base += kFaceChunk) {
    const int n = min(kFaceChunk, nf - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = tid; k < 3 * n; k += kThreads) chunk[k] = gb[3 * static_cast<size_t>(base) + k];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float4 p = chunk[3 * k];
      const float4 q = chunk[3 * k + 1];
      const float4 iz = chunk[3 * k + 2];
      const float w0 = __fmul_rn(edge(p.z, p.w, q.x, q.y, px, py), q.z);
      const float w1 = __fmul_rn(edge(q.x, q.y, p.x, p.y, px, py), q.z);
      const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
      const float frag = interp(w0, w1, w2, iz.x, iz.y, iz.z);
      if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f && q.w > 0.f && frag > best) {
        best = frag;
        bw0 = w0;
        bw1 = w1;
        bface = base + k;
      }
    }
  }
  if (i >= h || j >= w) return;

  const size_t pix = (static_cast<size_t>(b) * h + i) * w + j;
  if (best > 0.f) {
    const float safe = fmaxf(best, 1e-12f);
    const float bw2 = __fsub_rn(__fsub_rn(1.f, bw0), bw1);
    const float* a = attr + (static_cast<size_t>(b) * nf + bface) * 9;
    depth[pix] = __fdiv_rn(1.f, safe);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xyz[3 * pix + c] = __fdiv_rn(interp(bw0, bw1, bw2, a[c], a[3 + c], a[6 + c]), safe);
    }
  } else {
    depth[pix] = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) xyz[3 * pix + c] = 0.f;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() of the launch (0 = ok).
// geom [b, nf, 12], attr [b, nf, 9], origins [b, 2], depth [b, h, w],
// xyz [b, h, w, 3]: contiguous f32 on the current device.
int rasterize_xyz_launch(const void* geom, const void* attr, const void* origins,
                         void* depth, void* xyz, int b, int nf, int h, int w,
                         void* stream) {
  if (b < 1 || b > 65535 || nf < 1 || h < 1 || w < 1 || (h + kTileY - 1) / kTileY > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, b);
  const dim3 block(kTileX, kTileY);
  rasterize_xyz_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(geom), static_cast<const float*>(attr),
      static_cast<const float*>(origins), static_cast<float*>(depth),
      static_cast<float*>(xyz), nf, h, w);
  return static_cast<int>(cudaGetLastError());
}

const char* rasterize_xyz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
