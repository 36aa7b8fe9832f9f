// K1: the fused NOMAD step loss (forward) and its gradient (backward).
//
// Replaces the TPU kernels src/repro/kernels/nomad_step/nomad_step.py
// (nomad_step_fwd_pallas / _fwd_kernel and nomad_step_bwd_pallas /
// _bwd_kernel). Per head b, with q = 1 / (1 + d^2):
//   m_b    = sum_r cw_r [r != own_b] q(th_b, mu_r) + sum_s nw_bs q(th_b, neg_bs)
//   loss_b = sum_j pw_bj (log(q_pj + m_b) + log1p(d^2_pj))
// and the backward takes m as its residual and returns the gradients to
// th, pos and neg only (none to pw, nw, mu, cw, own).
//
// Layout: one warp per head, eight heads per block. The out dimension d is
// tiny (2 on the main path), so this is pairwise Cauchy terms on CUDA cores,
// not tensor-core work; its bound on the card is instruction issue (one
// reciprocal per head-mean pair), with B*K = 8192*4096 pairs per call on
// the main path. The means and cell weights are staged in shared memory in
// tiles of up to 2048 (structure-of-arrays, so lanes read conflict-free),
// the 32 lanes stride over the means and the k positives / S negatives, and
// warp shuffles reduce m, the loss, G and the gradients. A warp per head
// gives B*32 threads, enough to fill 132 SMs where one thread per head would
// not. Every head writes only its own gradient slots: no atomics; the
// scatter into theta happens outside the kernel. Shapes need no padding:
// heads past B and means past K are bounds-checked.
#include <math.h>

#include "means_tile.cuh"

namespace {

using namespace meanstile;

template <int D>
__global__ void __launch_bounds__(THREADS)
    nomad_fwd_kernel(const float* __restrict__ th, const float* __restrict__ pos,
                     const float* __restrict__ pw, const float* __restrict__ neg,
                     const float* __restrict__ nw, const float* __restrict__ mu,
                     const float* __restrict__ cw, const int* __restrict__ own,
                     float* __restrict__ loss, float* __restrict__ m_out, int B, int k,
                     int S, int K, int kt) {
  extern __shared__ float smem[];
  float* mu_s = smem;
  float* cw_s = smem + D * kt;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool live = b < B;  // uniform over the warp
  float t[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) t[dd] = live ? th[(long long)b * D + dd] : 0.f;
  const int ob = live ? own[b] : -1;

  float acc = 0.f;  // this lane's share of m
  for (int r0 = 0; r0 < K; r0 += kt) {
    const int nr = min(kt, K - r0);
    __syncthreads();
    stage_means<D>(mu, cw, mu_s, cw_s, kt, r0, nr);
    __syncthreads();
    if (live) {
      for (int r = lane; r < nr; r += 32) {
        float s = 0.f;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          const float df = t[dd] - mu_s[dd * kt + r];
          s = fmaf(df, df, s);
        }
        if (r0 + r != ob) acc = fmaf(cw_s[r], 1.f / (1.f + s), acc);
      }
    }
  }
  if (!live) return;

  for (int j = lane; j < S; j += 32) {  // exact in-cell negatives
    const long long e = (long long)b * S + j;
    float s = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const float df = t[dd] - neg[e * D + dd];
      s = fmaf(df, df, s);
    }
    acc = fmaf(nw[e], 1.f / (1.f + s), acc);
  }
  const float m = warp_sum(acc);

  float l = 0.f;
  for (int j = lane; j < k; j += 32) {  // attraction + shared log-denominator
    const long long e = (long long)b * k + j;
    float s = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const float df = t[dd] - pos[e * D + dd];
      s = fmaf(df, df, s);
    }
    const float qp = 1.f / (1.f + s);
    l = fmaf(pw[e], logf(qp + m) + log1pf(s), l);
  }
  l = warp_sum(l);
  if (lane == 0) {
    loss[b] = l;
    m_out[b] = m;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    nomad_bwd_kernel(const float* __restrict__ th, const float* __restrict__ pos,
                     const float* __restrict__ pw, const float* __restrict__ neg,
                     const float* __restrict__ nw, const float* __restrict__ mu,
                     const float* __restrict__ cw, const int* __restrict__ own,
                     const float* __restrict__ m_in, const float* __restrict__ gbar,
                     float* __restrict__ gi, float* __restrict__ gpos,
                     float* __restrict__ gneg, int B, int k, int S, int K, int kt) {
  extern __shared__ float smem[];
  float* mu_s = smem;
  float* cw_s = smem + D * kt;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool live = b < B;
  float t[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) t[dd] = live ? th[(long long)b * D + dd] : 0.f;
  const int ob = live ? own[b] : -1;
  const float mb = live ? m_in[b] : 0.f;
  const float gb = live ? gbar[b] : 0.f;

  float G = 0.f;  // d loss_b / d m_b = sum_j pw_j / (q_pj + m_b)
  float ga[D];    // this lane's attraction and exact-negative part of g_i
#pragma unroll
  for (int dd = 0; dd < D; ++dd) ga[dd] = 0.f;
  if (live) {
    float gp = 0.f;
    for (int j = lane; j < k; j += 32) {
      const long long e = (long long)b * k + j;
      float diff[D], s = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        diff[dd] = t[dd] - pos[e * D + dd];
        s = fmaf(diff[dd], diff[dd], s);
      }
      const float qp = 1.f / (1.f + s);
      const float qpm = qp + mb;
      const float w = pw[e];
      gp += w / qpm;
      const float f = w * (qp - qp * qp / qpm);
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        ga[dd] = fmaf(f, diff[dd], ga[dd]);
        gpos[e * D + dd] = -2.f * gb * f * diff[dd];
      }
    }
    G = warp_sum(gp);
    for (int j = lane; j < S; j += 32) {
      const long long e = (long long)b * S + j;
      float diff[D], s = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        diff[dd] = t[dd] - neg[e * D + dd];
        s = fmaf(diff[dd], diff[dd], s);
      }
      const float qn = 1.f / (1.f + s);
      const float coef = G * nw[e] * qn * qn;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        gneg[e * D + dd] = 2.f * gb * coef * diff[dd];
        ga[dd] -= coef * diff[dd];
      }
    }
  }

  float mt[D];  // this lane's share of sum_r cw_r [r != own] q^2 (th - mu_r)
#pragma unroll
  for (int dd = 0; dd < D; ++dd) mt[dd] = 0.f;
  for (int r0 = 0; r0 < K; r0 += kt) {
    const int nr = min(kt, K - r0);
    __syncthreads();
    stage_means<D>(mu, cw, mu_s, cw_s, kt, r0, nr);
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
          const float f = cw_s[r] * q * q;
#pragma unroll
          for (int dd = 0; dd < D; ++dd) mt[dd] = fmaf(f, diff[dd], mt[dd]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    const float a = warp_sum(ga[dd]);
    const float mm = warp_sum(mt[dd]);
    if (lane == 0) gi[(long long)b * D + dd] = 2.f * gb * a - 2.f * gb * G * mm;
  }
}

template <int D>
void launch_fwd(const float* th, const float* pos, const float* pw, const float* neg,
                const float* nw, const float* mu, const float* cw, const int* own,
                float* loss, float* m, int B, int k, int S, int K, cudaStream_t s) {
  const int kt = K < KT ? K : KT;
  nomad_fwd_kernel<D><<<(B + WARPS - 1) / WARPS, THREADS, smem_bytes<D>(K), s>>>(
      th, pos, pw, neg, nw, mu, cw, own, loss, m, B, k, S, K, kt);
}

template <int D>
void launch_bwd(const float* th, const float* pos, const float* pw, const float* neg,
                const float* nw, const float* mu, const float* cw, const int* own,
                const float* m, const float* gbar, float* gi, float* gpos, float* gneg,
                int B, int k, int S, int K, cudaStream_t s) {
  const int kt = K < KT ? K : KT;
  nomad_bwd_kernel<D><<<(B + WARPS - 1) / WARPS, THREADS, smem_bytes<D>(K), s>>>(
      th, pos, pw, neg, nw, mu, cw, own, m, gbar, gi, gpos, gneg, B, k, S, K, kt);
}

}  // namespace

extern "C" int nomad_step_fwd_f32(const float* th, const float* pos, const float* pw,
                                  const float* neg, const float* nw, const float* mu,
                                  const float* cw, const int* own, float* loss,
                                  float* m, int B, int k, int S, int K, int d,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_fwd<1>(th, pos, pw, neg, nw, mu, cw, own, loss, m, B, k, S, K, s); break;
    case 2: launch_fwd<2>(th, pos, pw, neg, nw, mu, cw, own, loss, m, B, k, S, K, s); break;
    case 3: launch_fwd<3>(th, pos, pw, neg, nw, mu, cw, own, loss, m, B, k, S, K, s); break;
    case 4: launch_fwd<4>(th, pos, pw, neg, nw, mu, cw, own, loss, m, B, k, S, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nomad_step_bwd_f32(const float* th, const float* pos, const float* pw,
                                  const float* neg, const float* nw, const float* mu,
                                  const float* cw, const int* own, const float* m,
                                  const float* gbar, float* gi, float* gpos, float* gneg,
                                  int B, int k, int S, int K, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_bwd<1>(th, pos, pw, neg, nw, mu, cw, own, m, gbar, gi, gpos, gneg, B, k, S, K, s); break;
    case 2: launch_bwd<2>(th, pos, pw, neg, nw, mu, cw, own, m, gbar, gi, gpos, gneg, B, k, S, K, s); break;
    case 3: launch_bwd<3>(th, pos, pw, neg, nw, mu, cw, own, m, gbar, gi, gpos, gneg, B, k, S, K, s); break;
    case 4: launch_bwd<4>(th, pos, pw, neg, nw, mu, cw, own, m, gbar, gi, gpos, gneg, B, k, S, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
