// K2: fused k-means E-step, x (N, d) against centroids c (K, d) ->
// argmin (N,) int32 and min squared distance (N,) fp32.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign/kmeans_assign.py
// (assign_nearest_pallas / _kernel). The TPU grid carried the running
// (min, argmin) across sequential K steps in its output block; blocks on
// the card run in no order, so each block owns 128 rows of x and walks a
// contiguous chunk of the centroids itself, 128 at a time, with the running
// minimum in registers. No (N, K) matrix is ever written. Distances are
// clamped at 0 before the comparison and ties keep the lowest centroid
// index, as jnp.argmin does.
//
// Bound on an H100: 2*N*K*d flops on (N + K)*d words, so the tensor cores
// bound it at the main-path shapes (d = 768). The cross term and the row
// norms come from the 3xTF32 tile of tf32x3_tile.cuh, fp32-accurate on the
// tensor cores; the norms are summed in the same pass as the product, so x
// and c are each read once per tile and no norm pass runs before it.
//
// Centroid split: ceil(N/128) blocks leave most of the 132 SMs idle when
// N is small (serving's 1024-row batches: 8 blocks). The wrapper then
// gives each block one of `chunks` contiguous chunks of `chunk_cols`
// centroids (a multiple of 128); blocks write a per-(chunk, row) partial
// (min, argmin) to scratch, and a second kernel reduces the chunks of each
// row in ascending order, keeping the earlier chunk on a tie. The split
// never crosses d, so every distance is the same bits as unsplit, and the
// result equals the unsplit one bit for bit. No float atomics.
#include <math.h>

#include "tf32x3_tile.cuh"

using namespace tf32x3;
using T2 = Tile128;

// lexicographic (distance, index) minimum
__device__ __forceinline__ void keep_lower(float& v, int& vi, float ov, int oi) {
  if (ov < v || (ov == v && oi < vi)) {
    v = ov;
    vi = oi;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(T2::THREADS, 1)
    kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                         int* __restrict__ arg_out, float* __restrict__ min_out, int n, int k,
                         int d, int chunk_cols) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * T2::BM;
  const int chunk = blockIdx.y;
  const int col_begin = chunk * chunk_cols;
  const int col_end = min(k, col_begin + chunk_cols);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t = lane % 4, wm = warp / T2::WARPS_N, wn = warp % T2::WARPS_N;

  float best[T2::MT][2];
  int besti[T2::MT][2];
#pragma unroll
  for (int mt = 0; mt < T2::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[mt][h] = INFINITY;
      besti[mt][h] = col_begin;
    }

  for (int col0 = col_begin; col0 < col_end; col0 += T2::BN) {
    float acc[T2::MT][T2::NT][4], xn[T2::MT][2], yn[T2::NT], cy[T2::NT][2];
    cross_tile<T2, VEC>(x, c, n, k, d, row0, col0, smem, acc, xn, yn);
    column_norms<T2>(yn, cy);
    // columns ascend with nt, then j, and tiles ascend: a strict < keeps
    // the lowest index among equal distances
#pragma unroll
    for (int mt = 0; mt < T2::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < T2::NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = col0 + wn * T2::WN + nt * 8 + 2 * t + j;
            const float dd = fmaxf((xn[mt][h] + cy[nt][j]) - 2.f * acc[mt][nt][2 * h + j], 0.f);
            if (col < col_end && dd < best[mt][h]) {
              best[mt][h] = dd;
              besti[mt][h] = col;
            }
          }
  }

  // the four lanes of a quad share rows; then the WARPS_N warps that share
  // rows meet in shared memory (free again after cross_tile)
  float* red_v = smem;
  int* red_i = reinterpret_cast<int*>(smem + T2::BM * T2::WARPS_N);
#pragma unroll
  for (int mt = 0; mt < T2::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best[mt][h];
      int vi = besti[mt][h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        keep_lower(v, vi, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, vi, o));
      if (t == 0) {
        const int r = wm * T2::WM + mt * 16 + lane / 4 + 8 * h;
        red_v[r * T2::WARPS_N + wn] = v;
        red_i[r * T2::WARPS_N + wn] = vi;
      }
    }
  __syncthreads();
  if (threadIdx.x < T2::BM) {
    const int r = threadIdx.x;
    float v = red_v[r * T2::WARPS_N];
    int vi = red_i[r * T2::WARPS_N];
#pragma unroll
    for (int w = 1; w < T2::WARPS_N; ++w) keep_lower(v, vi, red_v[r * T2::WARPS_N + w], red_i[r * T2::WARPS_N + w]);
    const int row = row0 + r;
    if (row < n) {
      arg_out[(long long)chunk * n + row] = vi;
      min_out[(long long)chunk * n + row] = v;
    }
  }
}

// (min, argmin) over the chunks of each row, in ascending chunk order; a
// later chunk wins only with a strictly smaller distance.
__global__ void reduce_chunks_kernel(const int* __restrict__ part_arg,
                                     const float* __restrict__ part_min, int* __restrict__ arg_out,
                                     float* __restrict__ min_out, int n, int chunks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float v = part_min[row];
  int vi = part_arg[row];
  for (int ch = 1; ch < chunks; ++ch) {
    const float ov = part_min[(long long)ch * n + row];
    if (ov < v) {
      v = ov;
      vi = part_arg[(long long)ch * n + row];
    }
  }
  arg_out[row] = vi;
  min_out[row] = v;
}

template <bool VEC>
static cudaError_t launch(const float* x, const float* c, int* arg, float* mind, int n, int k,
                          int d, int chunks, int chunk_cols, cudaStream_t s) {
  const cudaError_t opted = allow_smem<T2>(kmeans_assign_kernel<VEC>);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((n + T2::BM - 1) / T2::BM, chunks);
  kmeans_assign_kernel<VEC><<<grid, T2::THREADS, T2::SMEM_BYTES, s>>>(x, c, arg, mind, n, k, d,
                                                                      chunk_cols);
  return cudaGetLastError();
}

// chunks == 1: the kernel writes arg_out/min_out directly and part_* are
// unused. chunks > 1: part_arg/part_min hold chunks * n entries each (the
// caller allocates them), and chunk_cols is a multiple of 128 with
// chunks = ceil(k / chunk_cols).
extern "C" int kmeans_assign_f32(const float* x, const float* c, int* part_arg, float* part_min,
                                 int* arg_out, float* min_out, int n, int k, int d, int chunks,
                                 int chunk_cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk_cols % T2::BN != 0 || (long long)chunks * chunk_cols < k ||
      (long long)(chunks - 1) * chunk_cols >= k)
    return static_cast<int>(cudaErrorInvalidValue);
  int* arg = chunks == 1 ? arg_out : part_arg;
  float* mind = chunks == 1 ? min_out : part_min;
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(c);
  cudaError_t err = vec ? launch<true>(x, c, arg, mind, n, k, d, chunks, chunk_cols, s)
                        : launch<false>(x, c, arg, mind, n, k, d, chunks, chunk_cols, s);
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  reduce_chunks_kernel<<<(n + 255) / 256, 256, 0, s>>>(part_arg, part_min, arg_out, min_out, n,
                                                       chunks);
  return static_cast<int>(cudaGetLastError());
}
