// Fixed-order reduction of per-thread moment sums to per-row sums, shared by
// the path kernels (exotic_mc.cu, exotic_greeks.cu).
//
// A CUDA block sums one row over one chunk of path blocks. Its threads'
// register sums are reduced by warp shuffles and shared memory into
// partials[m][row][chunk]; a second kernel sums each row's chunks in chunk
// order, in float64, so that a launch of many chunks (the QE ladder runs up
// to 1024 a row) adds no float32 rounding of its own. No float atomics: a
// result depends only on the seed and the geometry, never on the
// scheduling.
#pragma once

#include <cstddef>

namespace optionslab {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

// Block-wide sum of acc[0..kMom) into partials[(m * rows + row) * n_chunks + chunk].
template <int kMom, int kThreads>
__device__ __forceinline__ void store_block_moments(const float* acc, float* partials, int rows,
                                                    int row, int n_chunks, int chunk) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float warp_sums[kMom][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kMom; ++m) {
    const float v = warp_sum(acc[m]);
    if (lane == 0) warp_sums[m][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kMom) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_sums[threadIdx.x][w];
    partials[(static_cast<size_t>(threadIdx.x) * rows + row) * n_chunks + chunk] = t;
  }
}

namespace {
// out[m, r] = Σ_chunk partials[m, r, chunk], in chunk order, in float64.
__global__ void reduce_rows_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                   int n_mom, int rows, int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_mom * rows) return;
  const float* src = partials + static_cast<size_t>(i) * n_chunks;
  double t = 0.0;
  for (int c = 0; c < n_chunks; ++c) t += src[c];
  out[i] = static_cast<float>(t);
}
}  // namespace

}  // namespace optionslab
