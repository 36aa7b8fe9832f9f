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
// Bound on the card: d = 2, so each head-mean pair is a handful of fp32
// operations and one reciprocal, and B*K pairs (1024 * 4096 when serving)
// move only (B + K)*d words. At the serving shape that is ~42 MFLOP on the
// CUDA cores (0.63 us at 67 TFLOP/s) and 4.2 M reciprocals on the SFU
// (16 a clock an SM: ~1.0 us), so the SFU bounds it.
//
// Design: the walk over the means (csrc/cauchy_walk.cuh, shared with K1's
// forward). A block holds HEADS heads against one chunk of the means;
// plan() in kernels/cauchy_mean/ops.py cuts K into at most MAX_CLUSTER
// contiguous chunks of ~512 from K alone, so at the serving shape 512
// blocks of 128 threads take 64 pairs a thread, 4 heads a lane. The chunks
// of one head tile are one thread-block cluster; rank 0 sums their
// partials in rank order and writes the result: one launch a call, no
// atomics, and a head's bits do not depend on B. The forward sums m, the
// backward far, which it scales by -2 gbar.
//
// The reciprocal is the SFU's rcp.approx.ftz.f32 (<= 1 ulp): the extra
// 0.5 ulp a term against IEEE division sits far inside the spec's
// (rtol, atol) = (1e-5, 1e-6).
#include "cauchy_walk.cuh"

namespace {

using namespace cauchywalk;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int HEADS_PER_WARP = 4;
constexpr int HEADS = WARPS * HEADS_PER_WARP;  // heads of one block
constexpr int TILE = 512;                      // means staged at a time

// BWD: the backward, gbar applied to far; otherwise m.
template <int D, bool BWD>
__global__ void __launch_bounds__(THREADS)
    cauchy_kernel(const float* __restrict__ th, const float* __restrict__ mu,
                  const float* __restrict__ w, const int* __restrict__ own,
                  const float* __restrict__ gbar, float* __restrict__ out, int B, int K,
                  int chunk_len) {
  using W = Walk<D, WARPS, HEADS_PER_WARP, TILE, !BWD, BWD>;
  __shared__ typename W::Shared sh;
  if (!W::run(sh, th, mu, w, own, B, K, chunk_len)) return;
  if (threadIdx.x < HEADS * W::P) {
    const float s = W::total(sh, threadIdx.x);
    const int b = blockIdx.x * HEADS + threadIdx.x / W::P;
    if (b < B) {
      if constexpr (BWD)
        out[(long long)blockIdx.x * HEADS * D + threadIdx.x] = -2.f * gbar[b] * s;
      else
        out[b] = s;
    }
  }
}

template <int D, bool BWD>
int launch(const float* th, const float* mu, const float* w, const int* own,
           const float* gbar, float* out, int B, int K, int chunks, int chunk_len,
           cudaStream_t s) {
  return launch_cluster(cauchy_kernel<D, BWD>, (B + HEADS - 1) / HEADS, chunks, THREADS, s,
                        th, mu, w, own, gbar, out, B, K, chunk_len);
}

template <bool BWD>
int dispatch(const float* th, const float* mu, const float* w, const int* own,
             const float* gbar, float* out, int B, int K, int d, int chunks, int chunk_len,
             void* stream) {
  if (!valid_plan(B, K, chunks, chunk_len)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1, BWD>(th, mu, w, own, gbar, out, B, K, chunks, chunk_len, s);
    case 2: return launch<2, BWD>(th, mu, w, own, gbar, out, B, K, chunks, chunk_len, s);
    case 3: return launch<3, BWD>(th, mu, w, own, gbar, out, B, K, chunks, chunk_len, s);
    case 4: return launch<4, BWD>(th, mu, w, own, gbar, out, B, K, chunks, chunk_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int cauchy_mean_fwd_f32(const float* th, const float* mu, const float* w,
                                   const int* own, float* out, int B, int K, int d,
                                   int chunks, int chunk_len, void* stream) {
  return dispatch<false>(th, mu, w, own, nullptr, out, B, K, d, chunks, chunk_len, stream);
}

extern "C" int cauchy_mean_bwd_f32(const float* th, const float* mu, const float* w,
                                   const int* own, const float* gbar, float* gth, int B,
                                   int K, int d, int chunks, int chunk_len, void* stream) {
  return dispatch<true>(th, mu, w, own, gbar, gth, B, K, d, chunks, chunk_len, stream);
}
