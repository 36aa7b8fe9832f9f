// K5: the frozen-neighbour attraction of the serving step (forward) and its
// gradients to theta and the repulsive mass m (backward).
//
// Replaces the TPU kernels src/repro/kernels/frozen_attract/frozen_attract.py
// (frozen_attract_fwd_pallas / _fwd_kernel and frozen_attract_bwd_pallas /
// _bwd_kernel). Per query b over its k frozen neighbours s, with
// d2 = |th_b - nb_bs|^2 and q = 1 / (1 + d2):
//   loss_b = sum_s w_bs (log(q + m_b) + log1p(d2))
//   gt_b   = 2 gbar_b sum_s w_bs (q - q^2 / (q + m_b)) (th_b - nb_bs)
//   gm_b   = gbar_b sum_s w_bs / (q + m_b)
// No gradient reaches the neighbours or the weights: the map stays frozen.
//
// Bound on the card: bytes. A launch reads B*(d + k*d + k + 1) words and
// writes B (or B*(d + 1)) of them, about 200 KB at the serving shape
// (B 1024, k 15, d 2): 0.06 us at 3.35 TB/s, far below the ~0.85 us a
// launch of this kernel that returns at once takes on the card
// (tile_variants.py frozen, empty). So what a launch can save is the
// latency of its threads: the loads they wait for one after another, and
// the chain of arithmetic behind them.
//
// Design: a query's k neighbours are spread over LANES lanes of one warp
// (a power of two from k alone, kernels/frozen_attract/ops.py:plan; 16 at
// k = 15). Lane j takes the neighbours s = j, j + LANES, ... in ascending
// order, so one pass of global loads covers a query when k <= LANES, and
// the LANES lanes of a query read its nb[b, :, :] and w[b, :] rows as one
// contiguous stretch (each load instruction of the warp is coalesced; a
// float2 a lane at d = 2 measured the same). Each lane sums its own terms
// in order; the group's xor butterfly (LANES/2, ..., 1) adds them (d + 1
// sums in the backward), and the group's lane 0 writes the query's
// outputs. The order depends on k alone, never on B: a query's bits are
// the same in a batch of 512 and of 1024. No shared memory, no atomics.
// The inputs keep the public (B, d), (B, k, d), (B, k), (B,) layout; the
// TPU's transposed (d, B) lane layout is not carried over.
//
// Arithmetic: log1p(d2) is log1pf, as the oracle takes it, never log(1/q).
// The backward takes r = 1 / (q + m) once, for both q^2 r and w r. Both
// reciprocals are the SFU's rcp.approx.ftz.f32 (<= 1 ulp), as in K1 and K4:
// measured against the IEEE division it saves 0.14 us of the forward and
// 0.34 of the backward (tile_variants.py frozen), and it leaves out the
// division's slow-path call, around which ptxas spilled.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 64 blocks at B 1024; 128 and 512 measured slower
constexpr int MAX_LANES = 32;  // a query's lanes lie in one warp

__device__ __forceinline__ float inv(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The sum over the lanes of one query: an xor butterfly in its group. Every
// lane of the warp takes part (dead lanes add zeros), as the full mask asks.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This thread's query b and lane j of it.
struct Slot {
  long long b;
  int j;
  __device__ Slot(int lanes) {
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    b = t >> (__ffs(lanes) - 1);
    j = static_cast<int>(t & (lanes - 1));
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS)
    attract_fwd_kernel(const float* __restrict__ th, const float* __restrict__ nb,
                       const float* __restrict__ w, const float* __restrict__ m,
                       float* __restrict__ loss, int B, int k, int lanes) {
  const Slot sl(lanes);
  const bool live = sl.b < B;
  float acc = 0.f;
  if (live) {
    float t[D];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) t[dd] = th[sl.b * D + dd];
    const float mb = m[sl.b];
    for (int s = sl.j; s < k; s += lanes) {
      const long long e = sl.b * k + s;
      float d2 = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        const float df = t[dd] - nb[e * D + dd];
        d2 = fmaf(df, df, d2);
      }
      const float q = inv(1.f + d2);
      acc = fmaf(w[e], logf(q + mb) + log1pf(d2), acc);
    }
  }
  acc = group_sum(acc, lanes);
  if (live && sl.j == 0) loss[sl.b] = acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    attract_bwd_kernel(const float* __restrict__ th, const float* __restrict__ nb,
                       const float* __restrict__ w, const float* __restrict__ m,
                       const float* __restrict__ gbar, float* __restrict__ gth,
                       float* __restrict__ gm, int B, int k, int lanes) {
  const Slot sl(lanes);
  const bool live = sl.b < B;
  float g[D], gmass = 0.f;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) g[dd] = 0.f;
  if (live) {
    float t[D];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) t[dd] = th[sl.b * D + dd];
    const float mb = m[sl.b];
    for (int s = sl.j; s < k; s += lanes) {
      const long long e = sl.b * k + s;
      float diff[D], d2 = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        diff[dd] = t[dd] - nb[e * D + dd];
        d2 = fmaf(diff[dd], diff[dd], d2);
      }
      const float q = inv(1.f + d2);
      const float r = inv(q + mb);
      const float ws = w[e];
      const float f = ws * fmaf(-(q * q), r, q);  // w (q - q^2 / (q + m))
#pragma unroll
      for (int dd = 0; dd < D; ++dd) g[dd] = fmaf(f, diff[dd], g[dd]);
      gmass = fmaf(ws, r, gmass);
    }
  }
#pragma unroll
  for (int dd = 0; dd < D; ++dd) g[dd] = group_sum(g[dd], lanes);
  gmass = group_sum(gmass, lanes);
  if (live && sl.j == 0) {
    const float gb = gbar[sl.b];
    const float g2 = 2.f * gb;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) gth[sl.b * D + dd] = g2 * g[dd];
    gm[sl.b] = gb * gmass;
  }
}

bool valid_lanes(int lanes) {
  return lanes >= 1 && lanes <= MAX_LANES && (lanes & (lanes - 1)) == 0;
}

int blocks(int B, int lanes) {
  return static_cast<int>(((long long)B * lanes + THREADS - 1) / THREADS);
}

template <int D>
void launch_fwd(const float* th, const float* nb, const float* w, const float* m,
                float* loss, int B, int k, int lanes, cudaStream_t s) {
  attract_fwd_kernel<D><<<blocks(B, lanes), THREADS, 0, s>>>(th, nb, w, m, loss, B, k, lanes);
}

template <int D>
void launch_bwd(const float* th, const float* nb, const float* w, const float* m,
                const float* gbar, float* gth, float* gm, int B, int k, int lanes,
                cudaStream_t s) {
  attract_bwd_kernel<D><<<blocks(B, lanes), THREADS, 0, s>>>(th, nb, w, m, gbar, gth, gm, B,
                                                             k, lanes);
}

}  // namespace

extern "C" int frozen_attract_fwd_f32(const float* th, const float* nb, const float* w,
                                      const float* m, float* loss, int B, int k, int d,
                                      int lanes, void* stream) {
  if (!valid_lanes(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_fwd<1>(th, nb, w, m, loss, B, k, lanes, s); break;
    case 2: launch_fwd<2>(th, nb, w, m, loss, B, k, lanes, s); break;
    case 3: launch_fwd<3>(th, nb, w, m, loss, B, k, lanes, s); break;
    case 4: launch_fwd<4>(th, nb, w, m, loss, B, k, lanes, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int frozen_attract_bwd_f32(const float* th, const float* nb, const float* w,
                                      const float* m, const float* gbar, float* gth,
                                      float* gm, int B, int k, int d, int lanes,
                                      void* stream) {
  if (!valid_lanes(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_bwd<1>(th, nb, w, m, gbar, gth, gm, B, k, lanes, s); break;
    case 2: launch_bwd<2>(th, nb, w, m, gbar, gth, gm, B, k, lanes, s); break;
    case 3: launch_bwd<3>(th, nb, w, m, gbar, gth, gm, B, k, lanes, s); break;
    case 4: launch_bwd<4>(th, nb, w, m, gbar, gth, gm, B, k, lanes, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
