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
// (B 1024, k 15, d 2), against ~15 operations per neighbour; that is well
// under a microsecond at 3.35 TB/s, so launch latency holds it. One thread
// per query walks its k neighbours in registers, in the oracle's order, and
// writes only its own outputs: no shared memory, no atomics, nothing that
// depends on B. The TPU's transposed (d, B) lane layout is not carried
// over: inputs keep the public (B, d), (B, k, d), (B, k), (B,) layout.
// log1p(d2) is log1pf, as the oracle takes it, never log(1/q).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;

template <int D>
__global__ void __launch_bounds__(THREADS)
    attract_fwd_kernel(const float* __restrict__ th, const float* __restrict__ nb,
                       const float* __restrict__ w, const float* __restrict__ m,
                       float* __restrict__ loss, int B, int k) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  float t[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) t[dd] = th[(long long)b * D + dd];
  const float mb = m[b];
  const float* nbb = nb + (long long)b * k * D;
  const float* wb = w + (long long)b * k;
  float acc = 0.f;
  for (int s = 0; s < k; ++s) {
    float d2 = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const float df = t[dd] - nbb[s * D + dd];
      d2 = fmaf(df, df, d2);
    }
    const float q = 1.f / (1.f + d2);
    acc = fmaf(wb[s], logf(q + mb) + log1pf(d2), acc);
  }
  loss[b] = acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    attract_bwd_kernel(const float* __restrict__ th, const float* __restrict__ nb,
                       const float* __restrict__ w, const float* __restrict__ m,
                       const float* __restrict__ gbar, float* __restrict__ gth,
                       float* __restrict__ gm, int B, int k) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  float t[D], g[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    t[dd] = th[(long long)b * D + dd];
    g[dd] = 0.f;
  }
  const float mb = m[b];
  const float* nbb = nb + (long long)b * k * D;
  const float* wb = w + (long long)b * k;
  float gmass = 0.f;
  for (int s = 0; s < k; ++s) {
    float diff[D], d2 = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      diff[dd] = t[dd] - nbb[s * D + dd];
      d2 = fmaf(diff[dd], diff[dd], d2);
    }
    const float q = 1.f / (1.f + d2);
    const float qm = q + mb;
    const float ws = wb[s];
    const float f = ws * (q - q * q / qm);
#pragma unroll
    for (int dd = 0; dd < D; ++dd) g[dd] = fmaf(f, diff[dd], g[dd]);
    gmass += ws / qm;
  }
  const float gb = gbar[b];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) gth[(long long)b * D + dd] = 2.f * gb * g[dd];
  gm[b] = gb * gmass;
}

template <int D>
void launch_fwd(const float* th, const float* nb, const float* w, const float* m,
                float* loss, int B, int k, cudaStream_t s) {
  attract_fwd_kernel<D><<<(B + THREADS - 1) / THREADS, THREADS, 0, s>>>(th, nb, w, m,
                                                                         loss, B, k);
}

template <int D>
void launch_bwd(const float* th, const float* nb, const float* w, const float* m,
                const float* gbar, float* gth, float* gm, int B, int k, cudaStream_t s) {
  attract_bwd_kernel<D><<<(B + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      th, nb, w, m, gbar, gth, gm, B, k);
}

}  // namespace

extern "C" int frozen_attract_fwd_f32(const float* th, const float* nb, const float* w,
                                      const float* m, float* loss, int B, int k, int d,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_fwd<1>(th, nb, w, m, loss, B, k, s); break;
    case 2: launch_fwd<2>(th, nb, w, m, loss, B, k, s); break;
    case 3: launch_fwd<3>(th, nb, w, m, loss, B, k, s); break;
    case 4: launch_fwd<4>(th, nb, w, m, loss, B, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int frozen_attract_bwd_f32(const float* th, const float* nb, const float* w,
                                      const float* m, const float* gbar, float* gth,
                                      float* gm, int B, int k, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_bwd<1>(th, nb, w, m, gbar, gth, gm, B, k, s); break;
    case 2: launch_bwd<2>(th, nb, w, m, gbar, gth, gm, B, k, s); break;
    case 3: launch_bwd<3>(th, nb, w, m, gbar, gth, gm, B, k, s); break;
    case 4: launch_bwd<4>(th, nb, w, m, gbar, gth, gm, B, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
