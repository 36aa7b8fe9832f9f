// The walk over the K cluster means shared by K1 (nomad_step.cu, forward)
// and K4 (cauchy_mean.cu, forward and backward). For each head b of a block
// and each mean r of the block's chunk of the means, with
// q = 1 / (1 + |th_b - mu_r|^2), it sums
//   m_b   = sum_r w_r [r != own_b] q                  (M)
//   far_b = sum_r w_r [r != own_b] q^2 (th_b - mu_r)  (FAR)
// K4's forward takes m, its backward far, and K1's forward both from the
// same q (far only when a gradient is wanted).
//
// Layout: the grid is (head tile, K chunk); a plan made from K alone
// (kernels/cauchy_mean/ops.py:split_means) cuts the means into at most
// MAX_CLUSTER contiguous chunks. A block stages its chunk in shared memory
// in tiles of TILE, one 16-byte record (mu_r, w_r) a mean at d <= 3, read
// back with one vector load a mean; each of its WARPS warps owns
// HEADS_PER_WARP heads, so a lane keeps one accumulator a head and reads
// each mean once for all of them, and the lanes stride over the chunk. A
// pair costs two subtractions, two fmaf (1 + |th - mu|^2 from 1), one
// reciprocal, a compare and a predicated fmaf (M), plus two products and
// two fmaf (FAR).
//
// Reduction: the chunks of one head tile are one thread-block cluster.
// Each block sums its lanes by the xor butterfly, stores its per-head
// partials into rank 0's shared memory (distributed shared memory), in the
// slot of its rank, and arrives at the cluster barrier; rank 0 waits and
// adds the slots in rank order (total). The barrier's first phase, split
// around the work, proves every block of the cluster has started before
// any store reaches another block. No atomics, and the order of every sum
// (a lane's chain over the means r = lane (mod 32) of its chunk, the warp's
// xor butterfly, then the chunks in ascending order) depends on K alone: a
// head's bits do not depend on B or on where the head sits in its tile.
//
// The reciprocal is one SFU instruction (rcp.approx.ftz.f32): at most 1 ulp
// from 1/x (PTX ISA), where the IEEE division nvcc emits without
// --use_fast_math is correctly rounded (0.5 ulp) but a multi-instruction
// sequence with a slow-path branch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cauchywalk {

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 8;  // the portable cluster size

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

// One block's walk: heads [blockIdx.x * HEADS, +HEADS) against chunk
// blockIdx.y of the means, [blockIdx.y * chunk_len, +chunk_len) cut at K.
// The blocks of a head tile form one cluster along y, so a block's cluster
// rank is its chunk. A head's sums are P floats: m first (M), then far's D
// coordinates (FAR).
template <int D, int WARPS, int HEADS_PER_WARP, int TILE, bool M, bool FAR>
struct Walk {
  static constexpr int THREADS = WARPS * 32;
  static constexpr int HEADS = WARPS * HEADS_PER_WARP;
  static constexpr int P = (M ? 1 : 0) + (FAR ? D : 0);
  static constexpr int NV = D + 1 <= 4 ? 1 : 2;  // float4s of one record (mu_r, w_r)
  static_assert(P > 0 && TILE % 32 == 0, "a walk sums something, a tile is whole warps");

  struct Shared {
    float4 rec[TILE * NV];
    float part[MAX_CLUSTER * HEADS * P];  // rank 0's: one slot a chunk
  };

  // The whole walk, from the first statement of the kernel. Returns true
  // in rank 0 of the cluster, where every block's partials are then in
  // sh.part (read them with total); the other blocks are done.
  __device__ static bool run(Shared& sh, const float* __restrict__ th,
                             const float* __restrict__ mu, const float* __restrict__ w,
                             const int* __restrict__ own, int B, int K, int chunk_len) {
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
        const float4 a = sh.rec[r * NV + k];
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
          if constexpr (M) acc[h][0] = fmaf(wr, q, acc[h][0]);
          if constexpr (FAR) {
            const float f = wr * q * q;
#pragma unroll
            for (int dd = 0; dd < D; ++dd)
              acc[h][P - D + dd] = fmaf(f, diff[dd], acc[h][P - D + dd]);
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
          sh.rec[i * NV + k] = make_float4(rec[4 * k], rec[4 * k + 1], rec[4 * k + 2], rec[4 * k + 3]);
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
      float* slot = cluster.map_shared_rank(sh.part, 0) + rank * HEADS * P;
#pragma unroll
      for (int h = 0; h < HEADS_PER_WARP; ++h)
#pragma unroll
        for (int p = 0; p < P; ++p) slot[(warp * HEADS_PER_WARP + h) * P + p] = v[h][p];
    }
    cluster_arrive_release();  // phase 2: this block's partials are in rank 0
    if (rank != 0) return false;
    cluster_wait();
    return true;
  }

  // In rank 0 after run: sum i % P of head i / P of the tile, the chunks
  // added in rank order.
  __device__ static float total(const Shared& sh, int i) {
    const int chunks = static_cast<int>(cg::this_cluster().num_blocks());
    float s = sh.part[i];
    for (int c = 1; c < chunks; ++c) s += sh.part[c * HEADS * P + i];
    return s;
  }
};

// The plan (chunks, chunk_len) must cover [0, K) with no empty chunk, in at
// most one cluster.
inline bool valid_plan(int B, int K, int chunks, int chunk_len) {
  return B >= 1 && K >= 1 && chunks >= 1 && chunks <= MAX_CLUSTER && chunk_len >= 1 &&
         (long long)chunks * chunk_len >= K && (long long)(chunks - 1) * chunk_len < K;
}

// One launch of a walking kernel: a grid of (head tiles, chunks) with the
// chunks of a head tile as one cluster.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int tiles, int chunks, int threads,
                   cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, chunks, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = chunks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace cauchywalk
