// Ray - hair-cluster intersection kernels for NVIDIA Hopper (sm_90a).
//
// hit_kernel replaces the TPU kernel yhair_tpu/ops/intersect_kernel.py:
// _hit_kernel (launched by _hit_pass through _common_call's
// pl.pallas_call); any_kernel replaces _any_kernel in the same file
// (launched by any_hit.run_pass). Both share segment_test, which is
// _segment_test operation for operation.
//
// Layout: one CUDA block of 128 threads per 128-ray block, one thread per
// ray. The block walks its own front-to-back cluster-id list (row b of a
// plain (nb, k_cap) int32 array); counts[b] > k_cap is the sentinel for
// "scan every cluster in order". For each visit the 128 threads stage
// rows 0-9 of the cluster's (16, 128) tile in shared memory (5 KB) and
// each thread tests its ray against the 128 segments.
//
// Exactness: this file is compiled with -fmad=false and IEEE division and
// square root, so every product and sum rounds on its own as the torch
// ops of the port's _closest_approach do. That keeps a hit's t bit-equal
// to the integrator's recompute of the winning segment, and the winner
// equal to the brute-force search under the (t, original id) tie-break.
//
// What bounds it on an H100: each ray-segment test is about 55 FP32
// operations, so a visited (block, cluster) pair costs 128 x 128 x 55
// FLOP, while the tiles (8 MB for the 10k-strand hairball) sit in the
// 50 MB L2. The kernel is compute-bound: the least time is
// visits x 128^2 x 55 / (67 TFLOP/s FP32). This first version is the
// simple, correct one: each thread keeps its own running best, so the
// TPU's per-lane state and cross-lane reduction are gone (the (t, id)
// minimum is associative, so the winner is the same), and the tile is
// read from shared memory as broadcasts. Overlapping the next tile's load
// with the current tests (cp.async / TMA double buffering) and splitting
// the 128 segments over more threads are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;      // rays per block = threads per block
constexpr int K = 128;          // segments per cluster (tile lanes)
constexpr int TILE_ROWS = 16;   // rows per tile in device memory
constexpr int USED_ROWS = 10;   // p0.xyz, r0, d2.xyz, dr, |d2|^2, oid
constexpr float T_MIN = 1e-4f;
constexpr float NO_HIT = 1e30f;
constexpr float NO_ID = 3.4e38f;

__device__ __forceinline__ int cluster_at(const int* ids_row, int i,
                                          int k_cap, bool use_all) {
  return use_all ? i : ids_row[min(i, k_cap - 1)];
}

__device__ __forceinline__ void stage_tile(float (*tile)[K],
                                           const float* __restrict__ tc,
                                           int cid) {
  const float* src = tc + static_cast<size_t>(cid) * TILE_ROWS * K;
  for (int row = 0; row < USED_ROWS; ++row)
    tile[row][threadIdx.x] = src[row * K + threadIdx.x];
}

// _segment_test for one (ray, lane): closest approach, subtract-then-
// square distance, inclusive s <= t_cap.
__device__ __forceinline__ bool segment_test(float (*tile)[K], int k,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float t_cap, float* s_out) {
  const float p0x = tile[0][k], p0y = tile[1][k], p0z = tile[2][k];
  const float r0 = tile[3][k];
  const float d2x = tile[4][k], d2y = tile[5][k], d2z = tile[6][k];
  const float dr = tile[7][k];
  const float c_seg = tile[8][k];
  const float w0x = ox - p0x, w0y = oy - p0y, w0z = oz - p0z;
  const float B = dx * d2x + dy * d2y + dz * d2z;
  const float dd = dx * w0x + dy * w0y + dz * w0z;
  const float e = d2x * w0x + d2y * w0y + d2z * w0z;
  const float denom = fmaxf(c_seg - B * B, 1e-12f);
  const float u = fminf(fmaxf((e - B * dd) / denom, 0.0f), 1.0f);
  const float s = B * u - dd;
  const float off0 = (ox + s * dx) - (p0x + u * d2x);
  const float off1 = (oy + s * dy) - (p0y + u * d2y);
  const float off2 = (oz + s * dz) - (p0z + u * d2z);
  const float dist2 = off0 * off0 + off1 * off1 + off2 * off2;
  const float r = r0 + dr * u;
  *s_out = s;
  return (dist2 <= r * r) && (s > T_MIN) && (s <= t_cap);
}

__global__ void __launch_bounds__(BLOCK)
hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t0, const int* __restrict__ i0,
           const float* __restrict__ oid0, const int* __restrict__ ids,
           const int* __restrict__ counts, const float* __restrict__ tc,
           int k_cap, float* __restrict__ t_out, int* __restrict__ idx_out,
           float* __restrict__ oid_out) {
  __shared__ float tile[USED_ROWS][K];
  const int b = blockIdx.x;
  const int r = b * BLOCK + threadIdx.x;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  // the candidate bound stays the pass seed, never tightened in the loop:
  // the inclusive <= keeps equal-t candidates for the (t, id) tie-break
  const float t_seed = t0[r];
  const int n_hit = counts[b];
  const bool use_all = n_hit > k_cap;
  const int* ids_row = ids + static_cast<size_t>(b) * k_cap;

  float best_t = NO_HIT, best_oid = NO_ID;
  int best_idx = 0;
  for (int i = 0; i < n_hit; ++i) {
    const int cid = cluster_at(ids_row, i, k_cap, use_all);
    __syncthreads();  // every thread is done with the previous tile
    stage_tile(tile, tc, cid);
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      float s;
      if (segment_test(tile, k, ox, oy, oz, dx, dy, dz, t_seed, &s)) {
        const float oid = tile[9][k];
        if (s < best_t || (s == best_t && oid < best_oid)) {
          best_t = s;
          best_oid = oid;
          best_idx = cid * K + k;
        }
      }
    }
  }
  // merge with the pass seeds (pass 1: none; pass 2: the prefix result)
  const float ts = t0[r], os = oid0[r];
  const bool has = best_t < NO_HIT;
  const bool better =
      best_t < ts || (has && best_t == ts && best_oid < os);
  t_out[r] = better ? best_t : ts;
  idx_out[r] = better ? best_idx : i0[r];
  oid_out[r] = better ? best_oid : os;
}

__global__ void __launch_bounds__(BLOCK)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_cap, const int* __restrict__ ids,
           const int* __restrict__ counts, const float* __restrict__ tc,
           int k_cap, int* __restrict__ occ_out, int* __restrict__ visits) {
  __shared__ float tile[USED_ROWS][K];
  const int b = blockIdx.x;
  const int r = b * BLOCK + threadIdx.x;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float cap = t_cap[r];
  const int n_hit = counts[b];
  const bool use_all = n_hit > k_cap;
  const int* ids_row = ids + static_cast<size_t>(b) * k_cap;

  int occ = 0;
  int visited = 0;
  for (int i = 0; i < n_hit; ++i) {
    // the block-wide barrier that ends the previous visit also guards
    // this overwrite of the tile
    stage_tile(tile, tc, cluster_at(ids_row, i, k_cap, use_all));
    __syncthreads();
    if (!occ) {
      for (int k = 0; k < K; ++k) {
        float s;
        if (segment_test(tile, k, ox, oy, oz, dx, dy, dz, cap, &s)) {
          occ = 1;
          break;
        }
      }
    }
    visited = i + 1;
    // occlusion is monotone, so stopping once the whole block is dark
    // changes no result; the exit is uniform across the block
    if (__syncthreads_and(occ)) break;
  }
  occ_out[r] = occ;
  if (visits != nullptr && threadIdx.x == 0) visits[b] = visited;
}

}  // namespace

extern "C" int yhair_hit_pass(const float* o, const float* d,
                              const float* t0, const int* i0,
                              const float* oid0, const int* ids,
                              const int* counts, const float* tc,
                              int n_blocks, int k_cap, float* t_out,
                              int* idx_out, float* oid_out, void* stream) {
  hit_kernel<<<n_blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, t0, i0, oid0, ids, counts, tc, k_cap, t_out, idx_out, oid_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int yhair_any_pass(const float* o, const float* d,
                              const float* t_cap, const int* ids,
                              const int* counts, const float* tc,
                              int n_blocks, int k_cap, int* occ_out,
                              int* visits, void* stream) {
  any_kernel<<<n_blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, t_cap, ids, counts, tc, k_cap, occ_out, visits);
  return static_cast<int>(cudaGetLastError());
}
