// Batched nearest-neighbour mean distance: the ADD-S / ADI core.
//
//   out[b] = mean_q min_r |query[b, q] - ref[b, r]|     query [B,NQ,3], ref [B,NR,3], f32
//
// Replaces the TPU kernel gdrnet_tpu/ops/pallas_kernels.py:_nn_kernel
// (launched by nn_min_dist_pallas). That kernel formed |q|^2 + |r|^2 - 2 q.r
// on the matrix unit, kept the whole reference set in VMEM, padded the
// queries to its tile by repeating point 0 and subtracted them afterwards,
// and carried the running sum across a sequential grid in SMEM.
//
// What bounds it on an H100: the arithmetic. One (query, ref) pair costs
// about 9 flops (3 sub, 3 mul, 2 add, 1 min); a 64-instance object with 3000
// model points is 64 * 3000 * 3000 = 5.8e8 pairs, 5.2 GFLOP, on the FP32
// pipes (the tensor cores gain nothing at d = 3). The inputs are 2 * 64 *
// 3000 * 12 B = 4.6 MB, read once from device memory.
//
// What the design does about that:
//  - each thread keeps kQueriesPerThread queries and their running minima in
//    registers, so one shared-memory read of a reference point feeds
//    kQueriesPerThread pairs;
//  - the block streams the reference set through shared memory in chunks of
//    kRefChunk points (padded to float4, read as one broadcast load), so any
//    NR fits and no size gate is needed;
//  - (q - r)^2 is formed directly in f32: no |a|^2 + |b|^2 - 2ab cancellation;
//  - ragged tails are masked: queries past NQ add nothing, the last chunk
//    loops only over the points that exist;
//  - each block writes one partial sum to partial[b, tile]; the caller sums
//    those in a fixed order, so results do not change from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQueriesPerThread = 4;
constexpr int kQueryTile = kThreads * kQueriesPerThread;
constexpr int kRefChunk = 1024;

__global__ void __launch_bounds__(kThreads)
nn_min_dist_kernel(const float* __restrict__ query, const float* __restrict__ ref,
                   float* __restrict__ partial, int nq, int nr) {
  __shared__ float4 chunk[kRefChunk];
  __shared__ float warp_sums[kThreads / 32];

  const int b = blockIdx.y;
  const int q_base = blockIdx.x * kQueryTile + threadIdx.x;
  const float* qb = query + static_cast<size_t>(b) * nq * 3;
  const float* rb = ref + static_cast<size_t>(b) * nr * 3;

  float qx[kQueriesPerThread], qy[kQueriesPerThread], qz[kQueriesPerThread];
  float best[kQueriesPerThread];
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    const int qi = q_base + k * kThreads;
    const bool valid = qi < nq;
    qx[k] = valid ? qb[3 * qi + 0] : 0.f;
    qy[k] = valid ? qb[3 * qi + 1] : 0.f;
    qz[k] = valid ? qb[3 * qi + 2] : 0.f;
    best[k] = __int_as_float(0x7f800000);  // +inf
  }

  for (int base = 0; base < nr; base += kRefChunk) {
    const int n = min(kRefChunk, nr - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* p = rb + 3 * static_cast<size_t>(base + j);
      chunk[j] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 r = chunk[j];
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) {
        const float dx = qx[k] - r.x;
        const float dy = qy[k] - r.y;
        const float dz = qz[k] - r.z;
        best[k] = fminf(best[k], dx * dx + dy * dy + dz * dz);
      }
    }
  }

  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    if (q_base + k * kThreads < nq) sum += sqrtf(best[k]);
  }
  // fixed-order block reduction: warp tree, then warp 0 over the warp sums
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    partial[static_cast<size_t>(b) * gridDim.x + blockIdx.x] = total;
  }
}

}  // namespace

extern "C" {

// Queries one block covers; the caller sizes partial as [B, ceil(NQ / tile)].
int nn_min_dist_query_tile() { return kQueryTile; }

// Launches on `stream` and returns cudaGetLastError() of the launch (0 = ok).
// query [b, nq, 3], ref [b, nr, 3], partial [b, ceil(nq / tile)]: contiguous
// f32 on the current device.
int nn_min_dist_partial_sums(const void* query, const void* ref, void* partial,
                             int b, int nq, int nr, void* stream) {
  if (b < 1 || b > 65535 || nq < 1 || nr < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nq + kQueryTile - 1) / kQueryTile, b);
  nn_min_dist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(ref),
      static_cast<float*>(partial), nq, nr);
  return static_cast<int>(cudaGetLastError());
}

const char* nn_min_dist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
