// K3: blocked squared distances, (batch, N, d) x (batch, M, d) -> (batch, N, M),
// clamped at 0.
//
// Replaces the TPU kernel src/repro/kernels/pairwise/pairwise.py
// (pairwise_dist2_pallas / _kernel). The TPU version accumulated the
// expansion over D tiles in an output block resident in VMEM; here each
// output element is finished by one block, which walks all of d itself, so
// nothing is carried between blocks. The batch dimension replaces the vmap
// over cells of the in-cell kNN. Two routes, chosen by the wrapper from the
// shape (kernels/pairwise/ops.py:route):
//
// * tile route (N >= 16: the candidate pass, 16384 rows against 4096
//   centroids, and the in-cell batch, 305-row cells against themselves).
//   2*N*M*d flops on (N+M)*d words: the tensor cores bound it. It runs the
//   3xTF32 tile of tf32x3_tile.cuh (row norms in the same pass), BM x BN =
//   128 x 128 or 64 x 64 as the wrapper picks to limit padding, clamps, and
//   writes each output once. The batch is gridDim.z.
// * row route (N < 16: serving's query kNN, one query row against its
//   305-row cell). d*(M + N) words for 2*N*M*d flops: bound by reading y.
//   One warp per (batch, y row) walks d in float4s (scalars where rows are
//   not 16-byte aligned or d % 4 != 0) and sums x.y, ||x||^2 and ||y||^2 in
//   the same pass, so y is read once; the few x rows come through the L1
//   cache. IEEE fp32 fmaf, with a fixed lane order and a fixed shuffle tree,
//   so a query's distances depend on that query and its cell alone.
#include <math.h>

#include "tf32x3_tile.cuh"

using namespace tf32x3;

constexpr int ROW_MAX = 15;   // the row route takes N <= ROW_MAX
constexpr int ROW_WARPS = 8;  // y rows per block of the row route

template <class T, bool VEC>
__global__ void __launch_bounds__(T::THREADS, 1)
    pairwise_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         float* __restrict__ out, int n, int m, int d) {
  extern __shared__ __align__(16) float smem[];
  const long long b = blockIdx.z;
  x += b * n * d;
  y += b * m * d;
  out += b * n * m;
  const int row0 = blockIdx.x * T::BM, col0 = blockIdx.y * T::BN;
  float acc[T::MT][T::NT][4], xn[T::MT][2], yn[T::NT], cy[T::NT][2];
  cross_tile<T, VEC>(x, y, n, m, d, row0, col0, smem, acc, xn, yn);
  column_norms<T>(yn, cy);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * T::WM + mt * 16 + g + 8 * h;
      if (r >= n) continue;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = col0 + wn * T::WN + nt * 8 + 2 * t + j;
          if (c < m)
            out[(long long)r * m + c] =
                fmaxf((xn[mt][h] + cy[nt][j]) - 2.f * acc[mt][nt][2 * h + j], 0.f);
        }
    }
}

template <bool VEC>
__global__ void __launch_bounds__(32 * ROW_WARPS)
    pairwise_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         float* __restrict__ out, int n, int m, int d) {
  const long long b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (j >= m) return;  // the whole warp shares one y row
  const float* xb = x + b * n * d;
  const float* yj = y + (b * m + j) * d;
  float dot[ROW_MAX], xs[ROW_MAX], ys = 0.f;
#pragma unroll
  for (int r = 0; r < ROW_MAX; ++r) dot[r] = xs[r] = 0.f;
  if (VEC) {
    const int d4 = d / 4;
    const float4* y4 = reinterpret_cast<const float4*>(yj);
    const float4* x4 = reinterpret_cast<const float4*>(xb);
#pragma unroll 4
    for (int i = lane; i < d4; i += 32) {
      const float4 v = __ldg(y4 + i);
      ys = fmaf(v.w, v.w, fmaf(v.z, v.z, fmaf(v.y, v.y, fmaf(v.x, v.x, ys))));
#pragma unroll
      for (int r = 0; r < ROW_MAX; ++r) {
        if (r >= n) break;
        const float4 u = __ldg(x4 + (long long)r * d4 + i);
        dot[r] = fmaf(u.w, v.w, fmaf(u.z, v.z, fmaf(u.y, v.y, fmaf(u.x, v.x, dot[r]))));
        xs[r] = fmaf(u.w, u.w, fmaf(u.z, u.z, fmaf(u.y, u.y, fmaf(u.x, u.x, xs[r]))));
      }
    }
  } else {
#pragma unroll 4
    for (int i = lane; i < d; i += 32) {
      const float v = __ldg(yj + i);
      ys = fmaf(v, v, ys);
#pragma unroll
      for (int r = 0; r < ROW_MAX; ++r) {
        if (r >= n) break;
        const float u = __ldg(xb + (long long)r * d + i);
        dot[r] = fmaf(u, v, dot[r]);
        xs[r] = fmaf(u, u, xs[r]);
      }
    }
  }
  // butterfly: every lane ends with the same sums
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ys += __shfl_xor_sync(0xffffffffu, ys, o);
#pragma unroll
    for (int r = 0; r < ROW_MAX; ++r) {
      if (r >= n) break;  // n is the same in every lane
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
      xs[r] += __shfl_xor_sync(0xffffffffu, xs[r], o);
    }
  }
#pragma unroll
  for (int r = 0; r < ROW_MAX; ++r)
    if (r < n && lane == r) out[(b * n + r) * m + j] = fmaxf((xs[r] + ys) - 2.f * dot[r], 0.f);
}

template <class T, bool VEC>
static cudaError_t launch_tile(const float* x, const float* y, float* out, int batch, int n,
                               int m, int d, cudaStream_t s) {
  const cudaError_t opted = allow_smem<T>(pairwise_tile_kernel<T, VEC>);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((n + T::BM - 1) / T::BM, (m + T::BN - 1) / T::BN, batch);
  pairwise_tile_kernel<T, VEC><<<grid, T::THREADS, T::SMEM_BYTES, s>>>(x, y, out, n, m, d);
  return cudaGetLastError();
}

// route 0: the tile route with a tile x tile block tile (128 or 64);
// route 1: the row route (n <= 15). The wrapper checks the grid limits.
extern "C" int pairwise_dist2_f32(const float* x, const float* y, float* out, int batch, int n,
                                  int m, int d, int route, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(y);
  if (route == 1) {
    if (n > ROW_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((m + ROW_WARPS - 1) / ROW_WARPS, batch);
    if (vec)
      pairwise_rows_kernel<true><<<grid, 32 * ROW_WARPS, 0, s>>>(x, y, out, n, m, d);
    else
      pairwise_rows_kernel<false><<<grid, 32 * ROW_WARPS, 0, s>>>(x, y, out, n, m, d);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (route == 0 && tile == 128)
    err = vec ? launch_tile<Tile128, true>(x, y, out, batch, n, m, d, s)
              : launch_tile<Tile128, false>(x, y, out, batch, n, m, d, s);
  else if (route == 0 && tile == 64)
    err = vec ? launch_tile<Tile64, true>(x, y, out, batch, n, m, d, s)
              : launch_tile<Tile64, false>(x, y, out, batch, n, m, d, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
