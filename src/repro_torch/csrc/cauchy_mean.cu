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
// Design: the grid is (head tile, K chunk). A block holds HEADS heads
// against one chunk of the means; plan() in kernels/cauchy_mean/ops.py cuts
// K into at most MAX_CLUSTER contiguous chunks of ~512 from K alone. The
// block stages its chunk in shared memory in tiles of TILE, one 16-byte
// record (mu_r, w_r) a mean, read back with one vector load a mean; each
// of its WARPS warps owns HEADS_PER_WARP heads, so a lane keeps one
// accumulator per head and reads each mean once for all of them, and the
// lanes stride over the chunk (at the serving shape: 512 blocks of 128
// threads, 64 pairs a thread). A pair costs two subtractions, two fmaf (1 + |th - mu|^2), one
// reciprocal and one predicated fmaf (forward). The chunks of one head tile
// are one thread-block cluster: each block stores its per-head partials
// into rank 0's shared memory (distributed shared memory), in the slot of
// its rank, and arrives at the cluster barrier; rank 0 waits, sums the
// slots in rank order and writes the result. The barrier's first phase,
// split around the work, proves every block of the cluster has started
// before any store reaches another block. One launch a call, no atomics,
// and the order of every sum (a lane's chain over the means
// r = lane (mod 32) of its chunk, the warp's xor butterfly, then the chunks
// in ascending order) depends on K alone: a head's bits do not depend on B
// or on where the head sits in its tile.
//
// The reciprocal is one SFU instruction (rcp.approx.ftz.f32): at most 1 ulp
// from 1/x (PTX ISA), where the IEEE division nvcc emits without
// --use_fast_math is correctly rounded (0.5 ulp) but a multi-instruction
// sequence with a slow-path branch. The extra 0.5 ulp a term sits far
// inside the spec's (rtol, atol) = (1e-5, 1e-6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int HEADS_PER_WARP = 4;
constexpr int HEADS = WARPS * HEADS_PER_WARP;  // heads of one block
constexpr int TILE = 512;                      // means staged at a time
constexpr int MAX_CLUSTER = 8;                 // the portable cluster size

__device__ __forceinline__ float rcp_sfu(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The cluster barrier in its two halves (PTX barrier.cluster): every thread
// of the cluster arrives once a phase; wait returns when all threads that
// have not exited have arrived. release/acquire order the shared-memory
// stores before the arrival against the loads after the wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Mean r's D coordinates; one vector load at d = 2 and d = 4 when aligned.
template <int D>
__device__ __forceinline__ void load_mean(const float* __restrict__ mu, long long r,
                                          bool vec, float (&v)[D]) {
  const float* p = mu + r * D;
  if constexpr (D == 2) {
    if (vec) {
      const float2 a = *reinterpret_cast<const float2*>(p);
      v[0] = a.x;
      v[1] = a.y;
      return;
    }
  } else if constexpr (D == 4) {
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      v[0] = a.x;
      v[1] = a.y;
      v[2] = a.z;
      v[3] = a.w;
      return;
    }
  }
#pragma unroll
  for (int dd = 0; dd < D; ++dd) v[dd] = p[dd];
}

// One block: heads [blockIdx.x * HEADS, +HEADS) against chunk blockIdx.y of
// the means, [blockIdx.y * chunk_len, +chunk_len) cut at K. The blocks of a
// head tile form one cluster along y, so a block's cluster rank is its
// chunk. BWD: the backward, with D partial sums a head and gbar applied.
template <int D, bool BWD>
__global__ void __launch_bounds__(THREADS)
    cauchy_kernel(const float* __restrict__ th, const float* __restrict__ mu,
                  const float* __restrict__ w, const int* __restrict__ own,
                  const float* __restrict__ gbar, float* __restrict__ out, int B, int K,
                  int chunk_len) {
  constexpr int P = BWD ? D : 1;         // partial sums of one head
  constexpr int NV = D + 1 <= 4 ? 1 : 2;  // float4s of one record (mu_r, w_r)
  __shared__ float4 rec_s[TILE * NV];
  __shared__ float part_s[MAX_CLUSTER * HEADS * P];  // rank 0's: one slot a chunk

  cluster_arrive_relaxed();  // phase 1: this block has started

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int head0 = blockIdx.x * HEADS + warp * HEADS_PER_WARP;
  float t[HEADS_PER_WARP][D], acc[HEADS_PER_WARP][P];
  int ob[HEADS_PER_WARP];
#pragma unroll
  for (int h = 0; h < HEADS_PER_WARP; ++h) {
    const int b = head0 + h;
    const bool live = b < B;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) t[h][dd] = live ? th[(long long)b * D + dd] : 0.f;
    ob[h] = live ? own[b] : -1;
#pragma unroll
    for (int p = 0; p < P; ++p) acc[h][p] = 0.f;
  }

  // head h against mean r of the staged tile (r0: the tile's first mean)
  auto pair = [&](int r, int r0) {
    float rec[4 * NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float4 a = rec_s[r * NV + k];
      rec[4 * k] = a.x;
      rec[4 * k + 1] = a.y;
      rec[4 * k + 2] = a.z;
      rec[4 * k + 3] = a.w;
    }
    const float wr = rec[D];
#pragma unroll
    for (int h = 0; h < HEADS_PER_WARP; ++h) {
      float diff[D], s = 1.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        diff[dd] = t[h][dd] - rec[dd];
        s = fmaf(diff[dd], diff[dd], s);
      }
      const float q = rcp_sfu(s);
      if (r0 + r != ob[h]) {  // the own cell's term is skipped
        if constexpr (BWD) {
          const float f = wr * q * q;
#pragma unroll
          for (int dd = 0; dd < D; ++dd) acc[h][dd] = fmaf(f, diff[dd], acc[h][dd]);
        } else {
          acc[h][0] = fmaf(wr, q, acc[h][0]);
        }
      }
    }
  };

  const bool vec = reinterpret_cast<uintptr_t>(mu) % (sizeof(float) * D) == 0;
  const int c0 = blockIdx.y * chunk_len;
  const int c1 = min(K, c0 + chunk_len);
  for (int t0 = c0; t0 < c1; t0 += TILE) {
    const int n = min(TILE, c1 - t0);
    if (t0 > c0) __syncthreads();  // the previous tile is read
    for (int i = threadIdx.x; i < n; i += THREADS) {
      float v[D], rec[4 * NV] = {};
      load_mean<D>(mu, t0 + i, vec, v);
#pragma unroll
      for (int dd = 0; dd < D; ++dd) rec[dd] = v[dd];
      rec[D] = w[t0 + i];
#pragma unroll
      for (int k = 0; k < NV; ++k)
        rec_s[i * NV + k] = make_float4(rec[4 * k], rec[4 * k + 1], rec[4 * k + 2], rec[4 * k + 3]);
    }
    __syncthreads();
    if (head0 >= B) continue;  // uniform over the warp
    if (n == TILE) {
#pragma unroll
      for (int j = 0; j < TILE / 32; ++j) pair(lane + 32 * j, t0);
    } else {
#pragma unroll 4
      for (int r = lane; r < n; r += 32) pair(r, t0);
    }
  }

  float v[HEADS_PER_WARP][P];
#pragma unroll
  for (int h = 0; h < HEADS_PER_WARP; ++h)
#pragma unroll
    for (int p = 0; p < P; ++p) v[h][p] = warp_sum(acc[h][p]);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_wait();  // phase 1: every block of the cluster has started
  if (lane == 0) {
    float* slot = cluster.map_shared_rank(part_s, 0) + rank * HEADS * P;
#pragma unroll
    for (int h = 0; h < HEADS_PER_WARP; ++h)
#pragma unroll
      for (int p = 0; p < P; ++p) slot[(warp * HEADS_PER_WARP + h) * P + p] = v[h][p];
  }
  cluster_arrive_release();  // phase 2: this block's partials are in rank 0
  if (rank != 0) return;
  cluster_wait();
  if (threadIdx.x < HEADS * P) {
    const int chunks = static_cast<int>(cluster.num_blocks());
    float s = part_s[threadIdx.x];
    for (int c = 1; c < chunks; ++c) s += part_s[c * HEADS * P + threadIdx.x];
    const int b = blockIdx.x * HEADS + threadIdx.x / P;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + HEADS - 1) / HEADS, chunks, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = chunks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cauchy_kernel<D, BWD>, th, mu, w, own,
                                             gbar, out, B, K, chunk_len);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool BWD>
int dispatch(const float* th, const float* mu, const float* w, const int* own,
             const float* gbar, float* out, int B, int K, int d, int chunks, int chunk_len,
             void* stream) {
  // the plan must cover [0, K) with no empty chunk, in at most one cluster
  if (B < 1 || K < 1 || chunks < 1 || chunks > MAX_CLUSTER || chunk_len < 1 ||
      (long long)chunks * chunk_len < K || (long long)(chunks - 1) * chunk_len >= K)
    return static_cast<int>(cudaErrorInvalidValue);
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
