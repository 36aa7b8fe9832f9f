// K1: the fused NOMAD step loss (forward) and its gradient (backward).
//
// Replaces the TPU kernels src/repro/kernels/nomad_step/nomad_step.py
// (nomad_step_fwd_pallas / _fwd_kernel and nomad_step_bwd_pallas /
// _bwd_kernel). Per head b, with q = 1 / (1 + d^2):
//   m_b    = sum_r cw_r [r != own_b] q(th_b, mu_r) + sum_s nw_bs q(th_b, neg_bs)
//   far_b  = sum_r cw_r [r != own_b] q(th_b, mu_r)^2 (th_b - mu_r)
//   loss_b = sum_j pw_bj (log(q_pj + m_b) + log1p(d^2_pj))
//   g_i    = 2 gbar_b (a_b - G_b far_b),  G_b = sum_j pw_bj / (q_pj + m_b)
// where a_b sums the k positive and S negative terms of the gradient. The
// backward returns the gradients to th, pos and neg only (none to pw, nw,
// mu, cw, own).
//
// Bound on the card: d = 2, so the work is the B*K head-mean pairs (8192 *
// 4096 a step of the fit): one reciprocal each on the SFU, 4.18 T a second
// over the card, and ~14 fp32 operations on the CUDA cores, with only
// O(B*(k + S)*d + K*d) words moved. The SFU bounds the forward; the
// backward, B*(k + S) terms, is bound by its bytes.
//
// Design:
// - One walk over the means a step. The forward walks them once
//   (csrc/cauchy_walk.cuh, shared with K4) and, when a gradient is wanted,
//   sums far from the same q as m; the backward takes m and far as its
//   residuals and walks only the k positives and S negatives of a head.
// - The walk: 4 heads a lane over 16-byte (mu_r, cw_r) records, the means
//   cut into chunks from K alone (kernels/nomad_step/ops.py:plan), the
//   chunks of a 16-head tile one cluster whose rank 0 adds them in rank
//   order, then takes the negatives and positives of its heads.
// - The k positives and S negatives of a head: LANES lanes a head, each
//   lane a chain over j = lane (mod LANES), the group's xor butterfly. The
//   negatives' reciprocal is rcp.approx on the SFU, as the walk's; the
//   positives keep the IEEE division, logf and log1pf (3 B k of them).
// - No atomics; a head writes only its own slots, so the scatter into
//   theta happens outside, and a head's bits do not depend on B.
#include <math.h>

#include "cauchy_walk.cuh"

namespace {

using namespace cauchywalk;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int HEADS_PER_WARP = 4;
constexpr int HEADS = WARPS * HEADS_PER_WARP;  // heads of one block
constexpr int LANES = 32 / HEADS_PER_WARP;     // lanes of a head over its k + S terms
constexpr int TILE = 1024;                     // means staged at a time

// The sum over the LANES lanes of one head (an xor butterfly in the group).
__device__ __forceinline__ float group_sum(float v) {
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// FAR: also far (B, d), for the backward.
template <int D, bool FAR>
__global__ void __launch_bounds__(THREADS)
    nomad_fwd_kernel(const float* __restrict__ th, const float* __restrict__ pos,
                     const float* __restrict__ pw, const float* __restrict__ neg,
                     const float* __restrict__ nw, const float* __restrict__ mu,
                     const float* __restrict__ cw, const int* __restrict__ own,
                     float* __restrict__ loss, float* __restrict__ m_out,
                     float* __restrict__ far_out, int B, int k, int S, int K, int chunk_len) {
  using W = Walk<D, WARPS, HEADS_PER_WARP, TILE, true, FAR>;
  __shared__ typename W::Shared sh;
  if (!W::run(sh, th, mu, cw, own, B, K, chunk_len)) return;
  // rank 0: each slot's sum over the chunks, in place (slot i reads only
  // slots i + c * HEADS * P)
  if (threadIdx.x < HEADS * W::P) sh.part[threadIdx.x] = W::total(sh, threadIdx.x);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int h = (threadIdx.x >> 5) * HEADS_PER_WARP + lane / LANES;  // head of the tile
  const int sub = lane % LANES;
  const int b = blockIdx.x * HEADS + h;
  const bool live = b < B;
  float t[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) t[dd] = live ? th[(long long)b * D + dd] : 0.f;

  float mn = 0.f;  // exact in-cell negatives
  if (live) {
    for (int j = sub; j < S; j += LANES) {
      const long long e = (long long)b * S + j;
      float s = 1.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        const float df = t[dd] - neg[e * D + dd];
        s = fmaf(df, df, s);
      }
      mn = fmaf(nw[e], rcp_sfu(s), mn);
    }
  }
  const float m = sh.part[h * W::P] + group_sum(mn);

  float l = 0.f;  // attraction + shared log-denominator
  if (live) {
    for (int j = sub; j < k; j += LANES) {
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
  }
  l = group_sum(l);
  if (live && sub == 0) {
    loss[b] = l;
    m_out[b] = m;
    if constexpr (FAR) {
#pragma unroll
      for (int dd = 0; dd < D; ++dd) far_out[(long long)b * D + dd] = sh.part[h * W::P + 1 + dd];
    }
  }
}

// gi == nullptr (and far == nullptr): no gradient to th_i.
template <int D>
__global__ void __launch_bounds__(THREADS)
    nomad_bwd_kernel(const float* __restrict__ th, const float* __restrict__ pos,
                     const float* __restrict__ pw, const float* __restrict__ neg,
                     const float* __restrict__ nw, const float* __restrict__ m_in,
                     const float* __restrict__ far, const float* __restrict__ gbar,
                     float* __restrict__ gi, float* __restrict__ gpos,
                     float* __restrict__ gneg, int B, int k, int S) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * HEADS + (threadIdx.x >> 5) * HEADS_PER_WARP + lane / LANES;
  const int sub = lane % LANES;
  const bool live = b < B;
  float t[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) t[dd] = live ? th[(long long)b * D + dd] : 0.f;
  const float mb = live ? m_in[b] : 0.f;
  const float gb = live ? gbar[b] : 0.f;

  float gp = 0.f;  // this lane's share of G = d loss_b / d m_b
  float a[D];      // this lane's share of a
#pragma unroll
  for (int dd = 0; dd < D; ++dd) a[dd] = 0.f;
  if (live) {
    for (int j = sub; j < k; j += LANES) {
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
        a[dd] = fmaf(f, diff[dd], a[dd]);
        gpos[e * D + dd] = -2.f * gb * f * diff[dd];
      }
    }
  }
  const float G = group_sum(gp);
  if (live) {
    for (int j = sub; j < S; j += LANES) {
      const long long e = (long long)b * S + j;
      float diff[D], s = 1.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        diff[dd] = t[dd] - neg[e * D + dd];
        s = fmaf(diff[dd], diff[dd], s);
      }
      const float qn = rcp_sfu(s);
      const float coef = G * nw[e] * qn * qn;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        gneg[e * D + dd] = 2.f * gb * coef * diff[dd];
        a[dd] -= coef * diff[dd];
      }
    }
  }
  if (gi == nullptr) return;  // uniform over the grid
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    const float ad = group_sum(a[dd]);
    if (live && sub == 0)
      gi[(long long)b * D + dd] = 2.f * gb * ad - 2.f * gb * G * far[(long long)b * D + dd];
  }
}

template <int D>
int launch_fwd(const float* th, const float* pos, const float* pw, const float* neg,
               const float* nw, const float* mu, const float* cw, const int* own, float* loss,
               float* m, float* far, int B, int k, int S, int K, int chunks, int chunk_len,
               cudaStream_t s) {
  const int tiles = (B + HEADS - 1) / HEADS;
  if (far != nullptr)
    return launch_cluster(nomad_fwd_kernel<D, true>, tiles, chunks, THREADS, s, th, pos, pw,
                          neg, nw, mu, cw, own, loss, m, far, B, k, S, K, chunk_len);
  return launch_cluster(nomad_fwd_kernel<D, false>, tiles, chunks, THREADS, s, th, pos, pw,
                        neg, nw, mu, cw, own, loss, m, far, B, k, S, K, chunk_len);
}

template <int D>
int launch_bwd(const float* th, const float* pos, const float* pw, const float* neg,
               const float* nw, const float* m, const float* far, const float* gbar, float* gi,
               float* gpos, float* gneg, int B, int k, int S, cudaStream_t s) {
  nomad_bwd_kernel<D><<<(B + HEADS - 1) / HEADS, THREADS, 0, s>>>(
      th, pos, pw, neg, nw, m, far, gbar, gi, gpos, gneg, B, k, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// far == nullptr: loss and m only (no gradient wanted).
extern "C" int nomad_step_fwd_f32(const float* th, const float* pos, const float* pw,
                                  const float* neg, const float* nw, const float* mu,
                                  const float* cw, const int* own, float* loss, float* m,
                                  float* far, int B, int k, int S, int K, int d, int chunks,
                                  int chunk_len, void* stream) {
  if (!valid_plan(B, K, chunks, chunk_len)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_fwd<1>(th, pos, pw, neg, nw, mu, cw, own, loss, m, far, B, k, S, K, chunks, chunk_len, s);
    case 2: return launch_fwd<2>(th, pos, pw, neg, nw, mu, cw, own, loss, m, far, B, k, S, K, chunks, chunk_len, s);
    case 3: return launch_fwd<3>(th, pos, pw, neg, nw, mu, cw, own, loss, m, far, B, k, S, K, chunks, chunk_len, s);
    case 4: return launch_fwd<4>(th, pos, pw, neg, nw, mu, cw, own, loss, m, far, B, k, S, K, chunks, chunk_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// far == gi == nullptr: the gradients to pos and neg only.
extern "C" int nomad_step_bwd_f32(const float* th, const float* pos, const float* pw,
                                  const float* neg, const float* nw, const float* m,
                                  const float* far, const float* gbar, float* gi, float* gpos,
                                  float* gneg, int B, int k, int S, int d, void* stream) {
  if (B < 1 || (far == nullptr) != (gi == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_bwd<1>(th, pos, pw, neg, nw, m, far, gbar, gi, gpos, gneg, B, k, S, s);
    case 2: return launch_bwd<2>(th, pos, pw, neg, nw, m, far, gbar, gi, gpos, gneg, B, k, S, s);
    case 3: return launch_bwd<3>(th, pos, pw, neg, nw, m, far, gbar, gi, gpos, gneg, B, k, S, s);
    case 4: return launch_bwd<4>(th, pos, pw, neg, nw, m, far, gbar, gi, gpos, gneg, B, k, S, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
