// Shared tensor-core tile of the pairwise (K3) and kmeans_assign (K2) kernels.
//
// Both compute ||x||^2 + ||y||^2 - 2 x.y over row-major (rows, d) operands.
// The cross term is the "NT" product x.y^T on Hopper's tensor cores with
// mma.sync.m16n8k8 in TF32, made fp32-accurate by the 3xTF32 split: each
// operand v becomes big = tf32(v) and small = tf32(v - big), both rounded
// to nearest with ties away from zero (as cvt.rna, done with integer ops),
// and every 8-deep k-step adds small.big, big.small and big.big, in that
// order. The products are exact; what is lost is the small.small term
// (below fp32's last place) and the rounding of the sums.
//
// The tensor cores truncate when they add into their accumulator, so a
// long chain of mma into one accumulator drifts toward zero: on an H100,
// the 288 additions of d = 768 put the self-distance of a row at up to
// half of pairwise/ops.py:allowed_error. Each k-step's three products are
// therefore summed from zero in their own fragment (a few truncations at
// the magnitude of eight products), and that fragment is added to the fp32
// accumulator with an IEEE add (round to nearest).
//
// Bounds on an H100: at the main-path shapes (d = 768) the product is
// 2*N*M*d flops on (N+M)*d words, so the tensor cores bound it: three
// TF32 passes at 495 TFLOP/s dense, an effective 165 TFLOP/s against the
// 67 TFLOP/s of fp32 on CUDA cores.
//
// Design:
// * a BM x BN block tile of WM x WN warp tiles (template parameters; the
//   wrappers pick the tile per shape);
// * operands staged through a STAGES-deep cp.async ring in shared memory,
//   BK = 32 deep a stage, rows padded to 36 floats so the fragment reads
//   are free of bank conflicts and every row stays 16-byte aligned. Rows
//   that are 16-byte aligned with d % 4 == 0 copy 16 bytes at a time
//   (cp.async.cg); other inputs copy 4 bytes at a time (cp.async.ca).
//   Rows past the edge and depth past d are zero-filled by the copy;
// * the row norms ||x||^2 and ||y||^2 are summed in the same pass, from
//   the fp32 fragments before the split, so each operand is read once.
//
// Every distance is summed over d in one fixed order (k-steps ascending,
// never split across blocks), and each output element uses only its own
// row and column: a distance does not depend on the tile, on the other
// rows of the call, or on how K2 splits its centroids.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int BK = 32;       // depth per shared-memory stage
constexpr int LDS = BK + 4;  // padded row stride of a staged tile, in floats
constexpr int STAGES = 3;    // depth of the cp.async ring

template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
  static constexpr int MT = WM / 16;  // m16 fragments per warp
  static constexpr int NT = WN / 8;   // n8 fragments per warp
  static constexpr int SMEM_BYTES = STAGES * (BM + BN) * LDS * 4;
};

using Tile128 = Tile<128, 128, 64, 32>;  // 8 warps, 110,592 bytes of shared memory
using Tile64 = Tile<64, 64, 32, 32>;     // 4 warps, 55,296 bytes

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// fp32 -> TF32, round to nearest, ties away from zero (cvt.rna.tf32.f32
// for finite v): add half of the 13 dropped bits to the magnitude, then
// clear them. Two integer ops instead of a conversion.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// big = tf32(v), small = tf32(v - big)
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// c += a.b for one m16n8k8 TF32 fragment, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a.b, from zero
__device__ __forceinline__ void mma_from_zero(float (&c)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// Copy depth [k0, k0 + BK) of x rows [row0, row0 + BM) and y rows
// [col0, col0 + BN) into one stage (x rows first, then y rows).
template <class T, bool VEC>
__device__ __forceinline__ void load_stage(const float* __restrict__ x, const float* __restrict__ y,
                                           int n, int m, int d, int row0, int col0, int k0,
                                           float* stage) {
  if (VEC) {
    constexpr int CHUNKS = BK / 4;
    static_assert((T::BM + T::BN) * CHUNKS % T::THREADS == 0, "whole copies per thread");
#pragma unroll
    for (int it = 0; it < (T::BM + T::BN) * CHUNKS / T::THREADS; ++it) {
      const int i = it * T::THREADS + threadIdx.x;
      const int r = i / CHUNKS, kk = k0 + (i % CHUNKS) * 4;
      const bool is_x = r < T::BM;
      const int g = is_x ? row0 + r : col0 + r - T::BM;
      const bool ok = g < (is_x ? n : m) && kk < d;  // d % 4 == 0: all four or none
      const float* base = is_x ? x : y;
      cp_async16(stage + r * LDS + (i % CHUNKS) * 4, ok ? base + (long long)g * d + kk : base,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 8
    for (int it = 0; it < (T::BM + T::BN) * BK / T::THREADS; ++it) {
      const int i = it * T::THREADS + threadIdx.x;
      const int r = i / BK, kk = k0 + i % BK;
      const bool is_x = r < T::BM;
      const int g = is_x ? row0 + r : col0 + r - T::BM;
      const bool ok = g < (is_x ? n : m) && kk < d;
      const float* base = is_x ? x : y;
      cp_async4(stage + r * LDS + i % BK, ok ? base + (long long)g * d + kk : base, ok ? 4 : 0);
    }
  }
}

// The warp's WM x WN block of x.y^T over all of d, plus the squared norms
// of its rows, for the block tile at (row0, col0). Fragment layout of
// m16n8k8 (g = lane / 4, t = lane % 4):
//   acc[mt][nt][2h + j] = x[row0 + wm*WM + mt*16 + g + 8h] . y[col0 + wn*WN + nt*8 + 2t + j]
//   xn[mt][h]           = ||x row (row0 + wm*WM + mt*16 + g + 8h)||^2
//   yn[nt]              = ||y row (col0 + wn*WN + nt*8 + g)||^2
// (warp = wm * WARPS_N + wn). Rows past n or m read as zero. Every thread
// of the block calls it; it leaves shared memory free for the caller.
template <class T, bool VEC>
__device__ __forceinline__ void cross_tile(const float* __restrict__ x, const float* __restrict__ y,
                                           int n, int m, int d, int row0, int col0, float* smem,
                                           float (&acc)[T::MT][T::NT][4], float (&xn)[T::MT][2],
                                           float (&yn)[T::NT]) {
  constexpr int STAGE = (T::BM + T::BN) * LDS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    xn[mt][0] = xn[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) yn[nt] = 0.f;

  const int ktiles = (d + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage<T, VEC>(x, y, n, m, d, row0, col0, s * BK, smem + s * STAGE);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is free again
    const int next = kt + STAGES - 1;
    if (next < ktiles)
      load_stage<T, VEC>(x, y, n, m, d, row0, col0, next * BK, smem + (next % STAGES) * STAGE);
    cp_async_commit();

    const float* xs = smem + (kt % STAGES) * STAGE + (wm * T::WM + g) * LDS + t;
    const float* ys = smem + (kt % STAGES) * STAGE + (T::BM + wn * T::WN + g) * LDS + t;
#pragma unroll
    for (int k8 = 0; k8 < BK; k8 += 8) {
      uint32_t ab[T::MT][4], as[T::MT][4], bb[T::NT][2], bs[T::NT][2];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const float* p = xs + mt * 16 * LDS + k8;
        const float v[4] = {p[0], p[8 * LDS], p[4], p[8 * LDS + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[e], ab[mt][e], as[mt][e]);
        xn[mt][0] = fmaf(v[2], v[2], fmaf(v[0], v[0], xn[mt][0]));
        xn[mt][1] = fmaf(v[3], v[3], fmaf(v[1], v[1], xn[mt][1]));
      }
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const float* p = ys + nt * 8 * LDS + k8;
        const float v[2] = {p[0], p[4]};
#pragma unroll
        for (int e = 0; e < 2; ++e) split(v[e], bb[nt][e], bs[nt][e]);
        yn[nt] = fmaf(v[1], v[1], fmaf(v[0], v[0], yn[nt]));
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          float p[4];  // this k-step's products, summed from zero
          mma_from_zero(p, as[mt], bb[nt]);
          mma(p, ab[mt], bs[nt]);
          mma(p, ab[mt], bb[nt]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the caller may reuse shared memory

  // each row's norm is split over the four lanes of its quad: sum them
  // (the same tree in every lane, so all four hold the same value)
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xn[mt][h] += __shfl_xor_sync(0xffffffffu, xn[mt][h], 1);
      xn[mt][h] += __shfl_xor_sync(0xffffffffu, xn[mt][h], 2);
    }
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    yn[nt] += __shfl_xor_sync(0xffffffffu, yn[nt], 1);
    yn[nt] += __shfl_xor_sync(0xffffffffu, yn[nt], 2);
  }
}

// ||y||^2 of the calling lane's accumulator columns: cy[nt][j] for column
// nt*8 + 2t + j, whose norm sits in the quad of lane (2t + j) * 4.
template <class T>
__device__ __forceinline__ void column_norms(const float (&yn)[T::NT], float (&cy)[T::NT][2]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) cy[nt][j] = __shfl_sync(0xffffffffu, yn[nt], (2 * t + j) * 4);
}

// Opt a kernel into T::SMEM_BYTES of dynamic shared memory (above 48 KB).
template <class T, class K>
inline cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace tf32x3
