// Shared walk over the K cluster means of the nomad_step (K1) and
// cauchy_mean (K4) kernels: one warp per head, eight heads per block, the
// means and their weights staged in shared memory in structure-of-arrays
// tiles of up to KT, so the 32 lanes of a warp read neighbouring words.
#pragma once

#include <cuda_runtime.h>

namespace meanstile {

constexpr int WARPS = 8;  // heads per block
constexpr int THREADS = WARPS * 32;
constexpr int KT = 2048;  // means per shared-memory tile

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage means [r0, r0 + nr) as mu_s[dd * kt + r] and their weights.
template <int D>
__device__ __forceinline__ void stage_means(const float* __restrict__ mu,
                                            const float* __restrict__ cw, float* mu_s,
                                            float* cw_s, int kt, int r0, int nr) {
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
#pragma unroll
    for (int dd = 0; dd < D; ++dd) mu_s[dd * kt + i] = mu[(long long)(r0 + i) * D + dd];
    cw_s[i] = cw[r0 + i];
  }
}

// Dynamic shared memory of one block: D coordinates and one weight per
// staged mean.
template <int D>
inline size_t smem_bytes(int K) {
  const int kt = K < KT ? K : KT;
  return sizeof(float) * (size_t)(D + 1) * kt;
}

}  // namespace meanstile
