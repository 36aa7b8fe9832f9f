// Shared fp32 tile routine of the pairwise (K3) and kmeans_assign (K2) kernels.
//
// Both compute ||x||^2 + ||y||^2 - 2 x.y over row-major (rows, d) operands.
// The cross term is an "NT" product on CUDA cores in IEEE fp32 (fmaf, never
// TF32): a 64x64 output tile per 256-thread block, the depth walked in
// 16-wide stages through shared memory, each thread holding a 4x4 register
// micro-tile. Row norms come from a separate one-warp-per-row pass so both
// kernels add exactly the same ||x||^2 and ||y||^2 to every tile.
//
// Bounds on an H100: at the main-path shapes (d = 768) the work is
// 2*N*M*d flops on (N+M)*d + N*M words, far above the fp32 ridge point, so
// the card's fp32 CUDA-core rate is the bound. This simple tile reads two
// float4 values from shared memory per 16 fmaf, which caps it well below
// that rate; wgmma/TMA tiles are later work.
#pragma once

#include <cuda_runtime.h>

namespace fp32tile {

constexpr int TM = 64;        // output rows (x rows) per block
constexpr int TN = 64;        // output columns (y rows) per block
constexpr int TK = 16;        // depth per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;        // keeps every shared row 16-byte aligned

struct Smem {
  float xs[TK][TM + PAD];  // x tile, transposed: xs[depth][row]
  float ys[TK][TN + PAD];  // y tile, transposed: ys[depth][row]
};

// out[r] = sum_k a[r][k]^2, one warp per row.
__global__ void row_sqnorm_kernel(const float* __restrict__ a, float* __restrict__ out,
                                  long long rows, int d) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp shares one row
  const float* p = a + row * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s = fmaf(p[i], p[i], s);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = s;
}

inline void launch_row_sqnorm(const float* a, float* out, long long rows, int d,
                              cudaStream_t stream) {
  const int rows_per_block = THREADS / 32;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  row_sqnorm_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(a, out, rows, d);
}

// acc[i][j] = x[row0 + 4*ty + i] . y[col0 + 4*tx + j] for the calling thread
// (tx = tid % 16, ty = tid / 16). Rows past n or m and depth past d read as
// zero. Every thread of the block must call it (it synchronises).
__device__ __forceinline__ void cross_tile(const float* __restrict__ x,
                                           const float* __restrict__ y, int n, int m,
                                           int d, int row0, int col0, Smem& sm,
                                           float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lk = tid % TK, lr = tid / TK;  // loader: depth lane, row group
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += TK) {
    const int kk = k0 + lk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lr + 16 * i;
      const int gx = row0 + r, gy = col0 + r;
      sm.xs[lk][r] = (gx < n && kk < d) ? x[(long long)gx * d + kk] : 0.f;
      sm.ys[lk][r] = (gy < m && kk < d) ? y[(long long)gy * d + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.xs[t][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.ys[t][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace fp32tile
