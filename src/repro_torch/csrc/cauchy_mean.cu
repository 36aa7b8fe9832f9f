// K4: the Cauchy-weighted sum over the K cluster means (forward) and its
// gradient to theta (backward), the M~ term of the serving step.
//
// Replaces the TPU kernels src/repro/kernels/cauchy_mean/cauchy_mean.py
// (cauchy_mean_fwd_pallas / _fwd_kernel and cauchy_mean_bwd_pallas /
// _bwd_kernel). Per head b, with q = 1 / (1 + |th_b - mu_r|^2):
//   s_b  = sum_r w_r [r != own_b] q
//   gt_b = -2 gbar_b sum_r w_r [r != own_b] q^2 (th_b - mu_r)
// No gradient reaches mu, w or own.
//
// Bound on the card: d = 2, so each head-mean pair is a handful of fmaf and
// one reciprocal on CUDA cores; B*K pairs (1024 * 4096 when serving) move
// only (B + K)*d words. At the serving shape that is ~42 MFLOP, under a
// microsecond of the card's fp32 rate, so each launch is held by launch
// latency and the walk over K, not by the card. The design is K1's forward
// without the k/S terms (means_tile.cuh): one warp per head, the means
// staged in shared memory as SoA tiles, lanes stride over r, shuffles
// reduce. The TPU padded B and K to its tiles; here heads past B and means
// past K are bounds checks. Each head's sum is taken in one fixed order by
// its own warp, with no atomics, so a head's result does not depend on B.
#include <math.h>

#include "means_tile.cuh"

namespace {

using namespace meanstile;

template <int D>
__global__ void __launch_bounds__(THREADS)
    cauchy_fwd_kernel(const float* __restrict__ th, const float* __restrict__ mu,
                      const float* __restrict__ w, const int* __restrict__ own,
                      float* __restrict__ out, int B, int K, int kt) {
  extern __shared__ float smem[];
  float* mu_s = smem;
  float* w_s = smem + D * kt;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool live = b < B;  // uniform over the warp
  float t[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) t[dd] = live ? th[(long long)b * D + dd] : 0.f;
  const int ob = live ? own[b] : -1;

  float acc = 0.f;
  for (int r0 = 0; r0 < K; r0 += kt) {
    const int nr = min(kt, K - r0);
    __syncthreads();
    stage_means<D>(mu, w, mu_s, w_s, kt, r0, nr);
    __syncthreads();
    if (live) {
      for (int r = lane; r < nr; r += 32) {
        float s = 0.f;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          const float df = t[dd] - mu_s[dd * kt + r];
          s = fmaf(df, df, s);
        }
        if (r0 + r != ob) acc = fmaf(w_s[r], 1.f / (1.f + s), acc);
      }
    }
  }
  if (!live) return;
  acc = warp_sum(acc);
  if (lane == 0) out[b] = acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    cauchy_bwd_kernel(const float* __restrict__ th, const float* __restrict__ mu,
                      const float* __restrict__ w, const int* __restrict__ own,
                      const float* __restrict__ gbar, float* __restrict__ gth, int B,
                      int K, int kt) {
  extern __shared__ float smem[];
  float* mu_s = smem;
  float* w_s = smem + D * kt;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool live = b < B;
  float t[D], g[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    t[dd] = live ? th[(long long)b * D + dd] : 0.f;
    g[dd] = 0.f;
  }
  const int ob = live ? own[b] : -1;

  for (int r0 = 0; r0 < K; r0 += kt) {
    const int nr = min(kt, K - r0);
    __syncthreads();
    stage_means<D>(mu, w, mu_s, w_s, kt, r0, nr);
    __syncthreads();
    if (live) {
      for (int r = lane; r < nr; r += 32) {
        float diff[D], s = 0.f;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          diff[dd] = t[dd] - mu_s[dd * kt + r];
          s = fmaf(diff[dd], diff[dd], s);
        }
        if (r0 + r != ob) {
          const float q = 1.f / (1.f + s);
          const float f = w_s[r] * q * q;
#pragma unroll
          for (int dd = 0; dd < D; ++dd) g[dd] = fmaf(f, diff[dd], g[dd]);
        }
      }
    }
  }
  if (!live) return;
  const float gb = gbar[b];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    const float a = warp_sum(g[dd]);
    if (lane == 0) gth[(long long)b * D + dd] = -2.f * gb * a;
  }
}

template <int D>
void launch_fwd(const float* th, const float* mu, const float* w, const int* own,
                float* out, int B, int K, cudaStream_t s) {
  const int kt = K < KT ? K : KT;
  cauchy_fwd_kernel<D><<<(B + WARPS - 1) / WARPS, THREADS, smem_bytes<D>(K), s>>>(
      th, mu, w, own, out, B, K, kt);
}

template <int D>
void launch_bwd(const float* th, const float* mu, const float* w, const int* own,
                const float* gbar, float* gth, int B, int K, cudaStream_t s) {
  const int kt = K < KT ? K : KT;
  cauchy_bwd_kernel<D><<<(B + WARPS - 1) / WARPS, THREADS, smem_bytes<D>(K), s>>>(
      th, mu, w, own, gbar, gth, B, K, kt);
}

}  // namespace

extern "C" int cauchy_mean_fwd_f32(const float* th, const float* mu, const float* w,
                                   const int* own, float* out, int B, int K, int d,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_fwd<1>(th, mu, w, own, out, B, K, s); break;
    case 2: launch_fwd<2>(th, mu, w, own, out, B, K, s); break;
    case 3: launch_fwd<3>(th, mu, w, own, out, B, K, s); break;
    case 4: launch_fwd<4>(th, mu, w, own, out, B, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cauchy_mean_bwd_f32(const float* th, const float* mu, const float* w,
                                   const int* own, const float* gbar, float* gth, int B,
                                   int K, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_bwd<1>(th, mu, w, own, gbar, gth, B, K, s); break;
    case 2: launch_bwd<2>(th, mu, w, own, gbar, gth, B, K, s); break;
    case 3: launch_bwd<3>(th, mu, w, own, gbar, gth, B, K, s); break;
    case 4: launch_bwd<4>(th, mu, w, own, gbar, gth, B, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
