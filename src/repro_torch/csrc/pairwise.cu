// K3: blocked squared distances, (batch, N, d) x (batch, M, d) -> (batch, N, M).
//
// Replaces the TPU kernel src/repro/kernels/pairwise/pairwise.py
// (pairwise_dist2_pallas / _kernel). The TPU version accumulated the
// expansion over D tiles in an output block resident in VMEM; here one
// block owns a 64x64 output tile and walks all of D itself (fp32_tile.cuh),
// so nothing is carried between blocks. The optional batch dimension
// (gridDim.z) replaces the vmap over cells of the in-cell kNN.
#include "fp32_tile.cuh"

using namespace fp32tile;

__global__ void __launch_bounds__(THREADS)
    pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ x2, const float* __restrict__ y2,
                    float* __restrict__ out, int n, int m, int d) {
  __shared__ __align__(16) Smem sm;
  const long long b = blockIdx.z;
  x += b * n * d;
  y += b * m * d;
  x2 += b * n;
  y2 += b * m;
  out += b * n * m;
  const int row0 = blockIdx.x * TM, col0 = blockIdx.y * TN;
  float acc[4][4];
  cross_tile(x, y, n, m, d, row0, col0, sm, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) continue;
    const float xr = x2[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < m) out[(long long)r * m + c] = fmaxf((xr + y2[c]) - 2.f * acc[i][j], 0.f);
    }
  }
}

// x2 (batch*n) and y2 (batch*m) are scratch the caller allocates.
extern "C" int pairwise_dist2_f32(const float* x, const float* y, float* x2, float* y2,
                                  float* out, int batch, int n, int m, int d,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_row_sqnorm(x, x2, (long long)batch * n, d, s);
  launch_row_sqnorm(y, y2, (long long)batch * m, d, s);
  const dim3 grid((n + TM - 1) / TM, (m + TN - 1) / TN, batch);
  pairwise_kernel<<<grid, THREADS, 0, s>>>(x, y, x2, y2, out, n, m, d);
  return static_cast<int>(cudaGetLastError());
}
