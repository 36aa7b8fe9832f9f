// K2: fused k-means E-step, x (N, d) against centroids c (K, d) ->
// argmin (N,) int32 and min squared distance (N,) fp32.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign/kmeans_assign.py
// (assign_nearest_pallas / _kernel). The TPU grid carried the running
// (min, argmin) across sequential K steps in its output block; blocks on
// the card run in no order, so each block owns 64 rows of x and walks all
// K centroids itself, 64 at a time, with the running minimum in registers.
// No (N, K) matrix is ever written. Distances are clamped at 0 before the
// comparison and ties keep the lowest centroid index, as jnp.argmin does.
// The cross term is IEEE fp32 on CUDA cores (fp32_tile.cuh), never TF32,
// so the argmins match an fp32 reference.
#include <math.h>

#include "fp32_tile.cuh"

using namespace fp32tile;

__global__ void __launch_bounds__(THREADS)
    kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                         const float* __restrict__ x2, const float* __restrict__ c2,
                         int* __restrict__ arg_out, float* __restrict__ min_out, int n,
                         int k, int d) {
  __shared__ __align__(16) Smem sm;
  const int row0 = blockIdx.x * TM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float xr[4], best[4];
  int besti[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    xr[i] = r < n ? x2[r] : 0.f;
    best[i] = INFINITY;
    besti[i] = 0;
  }
  for (int col0 = 0; col0 < k; col0 += TN) {
    float acc[4][4];
    cross_tile(x, c, n, k, d, row0, col0, sm, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = INFINITY;
      int vi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx * 4 + j;
        if (col < k) {
          const float dd = fmaxf((xr[i] + c2[col]) - 2.f * acc[i][j], 0.f);
          if (dd < v) {
            v = dd;
            vi = col;
          }
        }
      }
      // the 16 lanes of a half-warp share these rows: lexicographic
      // (distance, index) minimum over them, the same result in every lane
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, vi, o);
        if (ov < v || (ov == v && oi < vi)) {
          v = ov;
          vi = oi;
        }
      }
      if (v < best[i]) {  // strict: an earlier tile holds the lower index
        best[i] = v;
        besti[i] = vi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < n) {
        arg_out[r] = besti[i];
        min_out[r] = best[i];
      }
    }
  }
}

// x2 (n) and c2 (k) are scratch the caller allocates.
extern "C" int kmeans_assign_f32(const float* x, const float* c, float* x2, float* c2,
                                 int* arg_out, float* min_out, int n, int k, int d,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_row_sqnorm(x, x2, n, d, s);
  launch_row_sqnorm(c, c2, k, d, s);
  kmeans_assign_kernel<<<(n + TM - 1) / TM, THREADS, 0, s>>>(x, c, x2, c2, arg_out,
                                                             min_out, n, k, d);
  return static_cast<int>(cudaGetLastError());
}
