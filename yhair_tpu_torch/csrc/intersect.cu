// Ray - hair-cluster intersection kernels for NVIDIA Hopper (sm_90a),
// and after them the ray - triangle search (tri_hit_kernel and
// tri_any_kernel, with a note of their own).
//
// A search has two phases: lists_kernel builds each 128-ray block's
// front-to-back list of the clusters its rays enter (phase 1, at the end
// of this file), then hit_kernel or any_kernel tests the block's rays
// against the listed clusters' segments (phase 2).
//
// hit_kernel (with its merge, hit_merge_kernel) replaces the TPU kernel
// yhair_tpu/ops/intersect_kernel.py:_hit_kernel (launched by _hit_pass
// through _common_call's pl.pallas_call); any_kernel replaces
// _any_kernel in the same file (launched by any_hit.run_pass). Both share
// segment_test, which is _segment_test operation for operation.
//
// What bounds them on an H100: each ray-segment test is about 55 FP32
// operations, a visited (128-ray block, cluster) pair is 128 x 128 tests,
// and the tiles (8 MB for the 10k-strand hairball) sit in the 50 MB L2.
// So the least time is visits x 128^2 x 55 / (67 TFLOP/s FP32): the
// kernels are bound by operations. With FMA contraction off (below) half
// of that peak is the practical ceiling. Three things kept a first design
// (one 128-thread block walking each ray block's list) far from it:
//
// 1. One partial wave paced by the longest list. 512 ray blocks made 512
//    blocks of 4 warps on 132 SMs, and a block whose list held hundreds
//    of clusters walked them alone. Here each list is cut into work
//    items of `chunk` consecutive list positions (a ray block, a start, a
//    length; the wrapper builds the inclusive prefix sum of the items per
//    block). A persistent grid of as many CTAs as fit on the card takes
//    items from a global atomic counter and finds an item's block by a
//    binary search of the prefix sum. Long lists spread over many CTAs
//    and the SMs finish together. counts > k_cap is the sentinel "scan
//    every cluster in order": its items run over 0..C-1.
// 2. Too few warps to hide the latency of a dependent ~55-operation
//    test with an IEEE division. TPR threads test each ray, each VEC
//    consecutive lanes per shared-memory load (lanes (i * TPR + h) *
//    VEC + l of the 128), so a CTA has 128 x TPR consumer threads, and
//    several CTAs share an SM.
// 3. A stalled tile load between two block barriers on every visit.
//    Rows 0-9 of a tile are 5,120 contiguous bytes on an 8,192-byte
//    boundary, so one producer thread fetches a visit's tile with one
//    1-D bulk copy (cp.async.bulk, completed on an mbarrier) into a ring
//    of STAGES buffers, running ahead of the consumers. Consumers wait on
//    the stage's "full" barrier and release it on its "empty" barrier;
//    no block-wide barrier remains in the loop.
//
// Merging items exactly. hit: each item writes, per ray, the
// lexicographic minimum of (t, original id) over its visits (ties, which
// only padding lanes can make, go to the earlier (list position, lane),
// as in a sequential walk) into scratch slot `item`; hit_merge_kernel
// then folds a block's items in item order and merges the pass seeds.
// The result is the sequential walk's, bit for bit, whatever order the
// items ran in. The wrapper cannot know the item count without a host
// sync, so it sizes the partials for the most the packed counts allow:
// nb x ceil(max(k_cap, C) / chunk) items x 128 rays x 12 bytes, 201 MB
// for the bench hairball (512 blocks, C = 1,024, chunk 4), of which a
// launch writes under 5%. It grows with the ray blocks and the clusters
// and inversely with the chunk. any: occlusion is an OR, so an item stores 1 into the
// ray's flag. A ray whose flag another item already set counts as dark,
// and an item stops once all 128 of its rays are dark; occlusion is
// monotone, so a stale read only costs work.
//
// Exactness: this file is compiled with -fmad=false and IEEE division and
// square root, so every product and sum rounds on its own as the torch
// ops of the port's _closest_approach do. That keeps a hit's t bit-equal
// to the integrator's recompute of the winning segment, and the winner
// equal to the brute-force search under the (t, original id) tie-break.
//
// lists_kernel replaces no Pallas kernel: the JAX package's
// _block_cluster_lists is jnp that XLA fuses, so its (rays, C) slab-test
// intermediates never reach HBM; the port's torch ops made them in
// device memory, some 33 launches per 8,192-ray chunk. What bounds it on
// an H100: about 28 FP32 operations a (ray, cluster) pair (6 sub, 6 mul,
// 12 min/max, the compares and the running minimum), 128 x C pairs a
// block, against writes of 4-8 bytes a (block, cluster): so operations,
// rays x C x 28 / (67 TFLOP/s). The design keeps every pair in registers:
// one CTA per ray block stages the block's live rays (o, t_max, 1 / d) in
// shared memory; each thread holds CPT cluster boxes and walks the rays,
// keeping per cluster the least entry distance of the rays that hit, so
// no cross-thread reduction is needed. A ray with t_max < T_MIN (resolved
// by a prefix pass, or padding) can list nothing and is left out. The
// block's keys then go through one scan that places the clusters it
// missed, in id order, after its hits, and a bitonic sort of the hits'
// (key bits, id) pairs; both live in shared memory, or in a per-block
// slice of global scratch when C is too large for it. Exactness: the
// same separate sub and mul a slab as the torch ops, min and max that
// propagate NaN as torch.minimum / torch.maximum do, and keys >= T_MIN >
// 0, whose bit patterns sort as the floats do: ids, counts and keys equal
// the plain twin's bit for bit, with its stable argsort's order.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int RAYS = 128;       // rays per ray block
constexpr int K = 128;          // segments per cluster (tile lanes)
constexpr int TILE_ROWS = 16;   // rows per tile in device memory
constexpr int USED_ROWS = 10;   // p0.xyz, r0, d2.xyz, dr, |d2|^2, oid
constexpr int TILE_BYTES = USED_ROWS * K * 4;
// TPR, VEC and the wrapper's CHUNK were chosen by timing the bench strip's
// launches on an H100 at other values (PERF.md has the times)
constexpr int TPR = 2;          // threads per ray
constexpr int VEC = 4;          // lanes per shared-memory load
constexpr int GROUPS = K / (TPR * VEC);  // loads per row and thread
constexpr int CONSUMERS = RAYS * TPR;
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int STAGES = 4;       // tile ring depth
constexpr int SLOTS = STAGES + 1;  // items a ring can span, +1
constexpr float T_MIN = 1e-4f;
constexpr float NO_HIT = 1e30f;
constexpr float NO_ID = 3.4e38f;
constexpr int FIRST = 1, LAST = 2, END = 4;

static_assert(K % TPR == 0 && (TPR & (TPR - 1)) == 0 && TPR <= 32,
              "TPR must be a power of two dividing the tile width");
static_assert(VEC == 1 || VEC == 2 || VEC == 4, "VEC lanes per load");

// VEC consecutive lanes of one tile row, read with one load
struct __align__(4 * VEC) Lanes {
  float x[VEC];
};

// rows 0-8 of a thread's VEC lanes k0.. of a staged tile; the lanes of
// a warp's threads lie side by side, so a warp reads each row without a
// bank conflict
struct Group {
  Lanes row[USED_ROWS - 1];
};

__device__ __forceinline__ Group load_group(const float (*tile)[K],
                                            int k0) {
  Group g;
#pragma unroll
  for (int r = 0; r < USED_ROWS - 1; ++r)
    g.row[r] = *reinterpret_cast<const Lanes*>(&tile[r][k0]);
  return g;
}

// one published visit: the producer writes it before it arrives on the
// stage's full barrier, which releases it to the consumers
struct Visit {
  int b, j, cid, item, slot, flags;
};

struct __align__(128) Shared {
  float tile[STAGES][USED_ROWS][K];
  unsigned long long full[STAGES];
  unsigned long long empty[STAGES];
  Visit meta[STAGES];
  int dark[SLOTS];  // any: dark rays of the item in each slot
};

// the work-item plan shared by both kernels
struct Plan {
  const int* ids;      // (nb, k_cap) front-to-back cluster lists
  const int* counts;   // (nb,), > k_cap = scan every cluster
  const int* prefix;   // (nb,) inclusive sum of ceil(counts / chunk)
  const float* tc;     // (C, 16, 128) tiles
  int* next_item;      // global item counter, zero at launch
  int nb, k_cap, chunk;
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one thread: expect TILE_BYTES on the full barrier, then copy rows 0-9
// of tile `cid` into the stage with one bulk copy that completes there
__device__ __forceinline__ void load_tile(float* dst, const float* tc,
                                          int cid,
                                          unsigned long long* full) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem(full)),
      "r"(TILE_BYTES)
      : "memory");
  const float* src = tc + static_cast<size_t>(cid) * TILE_ROWS * K;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(TILE_BYTES),
      "r"(smem(full))
      : "memory");
}

// the block, first list position and length of work item `item`; false
// past the last item
__device__ bool decode(const Plan& p, int item, int* b, int* j0, int* n) {
  if (item >= p.prefix[p.nb - 1]) return false;
  int lo = 0, hi = p.nb - 1;  // the first block whose prefix exceeds item
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p.prefix[mid] > item) hi = mid; else lo = mid + 1;
  }
  *b = lo;
  *j0 = (item - (lo ? p.prefix[lo - 1] : 0)) * p.chunk;
  *n = min(p.chunk, p.counts[lo] - *j0);
  return true;
}

// the producer: one thread takes items from the counter and publishes
// their visits into the ring. any: it stops an item once the item's 128
// rays are dark, and counts the visits it publishes per block.
template <bool ANY>
__device__ void produce(Shared& sh, const Plan& p, int* visits) {
  int stage = 0;
  uint32_t parity = 1;  // a fresh empty barrier counts as released
  int b, j0, n;
  int item = atomicAdd(p.next_item, 1);
  bool have = decode(p, item, &b, &j0, &n);
  for (int seq = 0; have; ++seq) {
    int nb_, nj0, nn;
    const int next = atomicAdd(p.next_item, 1);
    const bool next_have = decode(p, next, &nb_, &nj0, &nn);
    const int slot = seq % SLOTS;
    const bool use_all = p.counts[b] > p.k_cap;
    const int* row = p.ids + static_cast<size_t>(b) * p.k_cap;
    for (int j = j0; j < j0 + n; ++j) {
      const int cid = use_all ? j : row[j];
      mbar_wait(&sh.empty[stage], parity);
      if (ANY) {
        // the slot's previous item ended STAGES + 1 items ago, before
        // the visit this wait released
        if (j == j0) sh.dark[slot] = 0;
        else if (*static_cast<volatile int*>(&sh.dark[slot]) >= RAYS) break;
      }
      sh.meta[stage] = Visit{b, j, cid, item, slot,
                             (j == j0 ? FIRST : 0) |
                                 (j == j0 + n - 1 ? LAST : 0)};
      load_tile(&sh.tile[stage][0][0], p.tc, cid, &sh.full[stage]);
      if (ANY && visits != nullptr) atomicAdd(visits + b, 1);
      if (++stage == STAGES) {
        stage = 0;
        parity ^= 1;
      }
    }
    item = next;
    b = nb_;
    j0 = nj0;
    n = nn;
    have = next_have;
  }
  mbar_wait(&sh.empty[stage], parity);
  sh.meta[stage].flags = END;
  mbar_arrive(&sh.full[stage]);
}

// _segment_test for one (ray, lane v of a group): closest approach,
// subtract-then-square distance, inclusive s <= t_cap.
__device__ __forceinline__ bool segment_test(const Group& g, int v,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float t_cap, float* s_out) {
  const float p0x = g.row[0].x[v], p0y = g.row[1].x[v];
  const float p0z = g.row[2].x[v], r0 = g.row[3].x[v];
  const float d2x = g.row[4].x[v], d2y = g.row[5].x[v];
  const float d2z = g.row[6].x[v], dr = g.row[7].x[v];
  const float c_seg = g.row[8].x[v];
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

__device__ __forceinline__ void init_ring(Shared& sh) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sh.full[s], 1);
      mbar_init(&sh.empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// a consumer warp releases the stage once all its lanes are done with it
__device__ __forceinline__ void release(Shared& sh, int stage) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&sh.empty[stage]);
}

// Per item and ray: the lexicographic minimum of (t, original id) over
// the item's visits, candidates T_MIN < s <= the pass seed t0, written
// to slot `item` of the partials; ties go to the earlier (j, lane).
__global__ void __launch_bounds__(THREADS)
hit_kernel(Plan p, const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t0, float* __restrict__ part_t,
           float* __restrict__ part_oid, int* __restrict__ part_idx) {
  __shared__ Shared sh;
  init_ring(sh);
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) produce<false>(sh, p, nullptr);
    return;
  }
  const int ray = threadIdx.x / TPR, h = threadIdx.x % TPR;
  float ox = 0, oy = 0, oz = 0, dx = 0, dy = 0, dz = 0, cap = 0;
  float best_t = NO_HIT, best_oid = NO_ID;
  int best_idx = 0, best_pos = INT_MAX;
  uint32_t parity = 0;
  for (int stage = 0;;) {
    mbar_wait(&sh.full[stage], parity);
    const Visit v = sh.meta[stage];
    if (v.flags & END) break;
    if (v.flags & FIRST) {
      const int r = v.b * RAYS + ray;
      ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
      dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
      // the candidate bound stays the pass seed, never tightened: the
      // inclusive <= keeps equal-t candidates for the (t, id) tie-break
      cap = t0[r];
      best_t = NO_HIT, best_oid = NO_ID, best_idx = 0, best_pos = INT_MAX;
    }
    const float(*tile)[K] = sh.tile[stage];
#pragma unroll(4 / VEC)
    for (int i = 0; i < GROUPS; ++i) {
      const int k0 = (i * TPR + h) * VEC;
      const Group g = load_group(tile, k0);
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        float s;
        if (segment_test(g, l, ox, oy, oz, dx, dy, dz, cap, &s)) {
          const int k = k0 + l;
          const float oid = tile[9][k];
          if (s < best_t || (s == best_t && oid < best_oid)) {
            best_t = s;
            best_oid = oid;
            best_idx = v.cid * K + k;
            best_pos = v.j * K + k;
          }
        }
      }
    }
    release(sh, stage);
    if (v.flags & LAST) {
      for (int m = 1; m < TPR; m <<= 1) {
        const float t2 = __shfl_xor_sync(0xffffffffu, best_t, m);
        const float o2 = __shfl_xor_sync(0xffffffffu, best_oid, m);
        const int i2 = __shfl_xor_sync(0xffffffffu, best_idx, m);
        const int p2 = __shfl_xor_sync(0xffffffffu, best_pos, m);
        if (t2 < best_t || (t2 == best_t && (o2 < best_oid ||
                                             (o2 == best_oid &&
                                              p2 < best_pos)))) {
          best_t = t2, best_oid = o2, best_idx = i2, best_pos = p2;
        }
      }
      if (h == 0) {
        const size_t slot = static_cast<size_t>(v.item) * RAYS + ray;
        part_t[slot] = best_t;
        part_oid[slot] = best_oid;
        part_idx[slot] = best_idx;
      }
    }
    if (++stage == STAGES) {
      stage = 0;
      parity ^= 1;
    }
  }
}

// One thread per ray: fold the block's items in item order (the strict
// minimum keeps the earlier item on a tie, as the sequential walk
// does), then merge with the pass seeds (pass 1: none; pass 2: the
// prefix result).
__global__ void __launch_bounds__(RAYS)
hit_merge_kernel(const int* __restrict__ prefix,
                 const float* __restrict__ part_t,
                 const float* __restrict__ part_oid,
                 const int* __restrict__ part_idx,
                 const float* __restrict__ t0, const int* __restrict__ i0,
                 const float* __restrict__ oid0, float* __restrict__ t_out,
                 int* __restrict__ idx_out, float* __restrict__ oid_out) {
  const int b = blockIdx.x;
  const int r = b * RAYS + threadIdx.x;
  float best_t = NO_HIT, best_oid = NO_ID;
  int best_idx = 0;
  for (int q = b ? prefix[b - 1] : 0; q < prefix[b]; ++q) {
    const size_t slot = static_cast<size_t>(q) * RAYS + threadIdx.x;
    const float t = part_t[slot], oid = part_oid[slot];
    if (t < best_t || (t == best_t && oid < best_oid)) {
      best_t = t;
      best_oid = oid;
      best_idx = part_idx[slot];
    }
  }
  const float ts = t0[r], os = oid0[r];
  const bool has = best_t < NO_HIT;
  const bool better = best_t < ts || (has && best_t == ts && best_oid < os);
  t_out[r] = better ? best_t : ts;
  idx_out[r] = better ? best_idx : i0[r];
  oid_out[r] = better ? best_oid : os;
}

// Occlusion: occ[r] = 1 where some listed segment has T_MIN < s <=
// t_cap[r]. occ is zero at launch; items only ever store 1.
__global__ void __launch_bounds__(THREADS)
any_kernel(Plan p, const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_cap, int* occ, int* visits) {
  __shared__ Shared sh;
  init_ring(sh);
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) produce<true>(sh, p, visits);
    return;
  }
  const int ray = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int leader = (threadIdx.x & 31) & ~(TPR - 1);
  float ox = 0, oy = 0, oz = 0, dx = 0, dy = 0, dz = 0, cap = 0;
  bool dark = false;
  uint32_t parity = 0;
  for (int stage = 0;;) {
    mbar_wait(&sh.full[stage], parity);
    const Visit v = sh.meta[stage];
    if (v.flags & END) break;
    const int r = v.b * RAYS + ray;
    if (v.flags & FIRST) {
      ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
      dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
      cap = t_cap[r];
      dark = false;
    }
    // a flag another item set darkens the ray here too; the pair's
    // leader reads it so that both threads agree
    int seen = dark ? 0 : *static_cast<volatile int*>(occ + r);
    seen = __shfl_sync(0xffffffffu, seen, leader);
    if (seen) {
      dark = true;
      if (h == 0) atomicAdd(&sh.dark[v.slot], 1);
    }
    // occlusion is monotone: a dark ray skips the test, and the producer
    // stops the item once its 128 rays are dark
    int hit = 0;
    if (!dark) {
      const float(*tile)[K] = sh.tile[stage];
      for (int i = 0; i < GROUPS && !hit; ++i) {
        const Group g = load_group(tile, (i * TPR + h) * VEC);
#pragma unroll
        for (int l = 0; l < VEC; ++l) {
          float s;
          if (segment_test(g, l, ox, oy, oz, dx, dy, dz, cap, &s)) {
            hit = 1;
            break;
          }
        }
      }
    }
    for (int m = 1; m < TPR; m <<= 1)
      hit |= __shfl_xor_sync(0xffffffffu, hit, m);
    if (hit) {
      dark = true;
      if (h == 0) {
        occ[r] = 1;
        atomicAdd(&sh.dark[v.slot], 1);
      }
    }
    // the slot's count is final for this visit before the stage goes
    // back to the producer
    release(sh, stage);
    if (++stage == STAGES) {
      stage = 0;
      parity ^= 1;
    }
  }
}

// ---------------------------------------------------------------------------
// phase 1: lists_kernel

constexpr int LIST_THREADS = 256;
constexpr int CPT = 4;  // cluster boxes a thread tests per staged ray
constexpr int LIST_WARPS = LIST_THREADS / 32;
constexpr uint32_t NO_HIT_BITS = 0x7149f2cau;  // the bits of NO_HIT

static_assert(LIST_THREADS >= RAYS && LIST_THREADS % 32 == 0,
              "a list CTA stages its block's rays with one thread each");

struct ListShared {
  float4 ray_o[RAYS];    // the block's live rays: o.xyz, t_max
  float4 ray_inv[RAYS];  // 1 / d
  int warp_sum[LIST_WARPS];
};

// torch.maximum / torch.minimum: a NaN operand gives NaN (fmaxf and fminf
// would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// one axis of the slab test, as the plain twin's torch ops
__device__ __forceinline__ void slab(float lo, float hi, float o, float inv,
                                     float& tn, float& tf) {
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  tn = max_nan(tn, min_nan(t0, t1));
  tf = min_nan(tf, max_nan(t0, t1));
}

// v: a warp-uniform value. -> its sum over the CTA's warps; *before: the
// sum over the warps before this one. Opens with a barrier, so that
// earlier readers of the warp sums are done.
__device__ __forceinline__ int cta_sum(ListShared& sh, int v, int* before) {
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.warp_sum[warp] = v;
  __syncthreads();
  int pre = 0, all = 0;
#pragma unroll
  for (int w = 0; w < LIST_WARPS; ++w) {
    pre += w < warp ? sh.warp_sum[w] : 0;
    all += sh.warp_sum[w];
  }
  *before = pre;
  return all;
}

// One CTA per 128-ray block. ids (nb, C): the clusters in the order of
// torch.argsort(key, stable=True); counts (nb,): the clusters listed;
// key (nb, C, optional): the block's entry distance, NO_HIT where it
// lists nothing. A cluster counts for a ray when T_MIN <= tn <= tf and
// tn <= t_max; exclude drops a cluster whose block entry distance lies
// strictly below exclude[b]. GLOBAL: the sort buffer and the keys live
// in the block's slice of scratch instead of shared memory.
template <bool GLOBAL>
__global__ void __launch_bounds__(LIST_THREADS)
lists_kernel(const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ cmin, const float* __restrict__ cmax,
             const float* __restrict__ t_max,
             const float* __restrict__ exclude, int n_clusters, int sort_cap,
             unsigned long long* __restrict__ scratch,
             int* __restrict__ ids, int* __restrict__ counts,
             float* __restrict__ key) {
  __shared__ ListShared sh;
  extern __shared__ unsigned long long dyn[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int C = n_clusters;
  const unsigned below = (1u << lane) - 1;
  const size_t row = static_cast<size_t>(b) * C;
  // sort_cap (key bits, id) pairs, then the C key bit patterns
  unsigned long long* pairs =
      GLOBAL ? scratch + b * (static_cast<size_t>(sort_cap) + (C + 1) / 2)
             : dyn;
  uint32_t* bits = reinterpret_cast<uint32_t*>(pairs + sort_cap);
  const float inf = __int_as_float(0x7f800000);

  // 1. the live rays into shared memory, in any order (a minimum does
  // not depend on it). Every entry distance is at least T_MIN, so a ray
  // with t_max < T_MIN (or NaN) lists nothing.
  float ro[3] = {0.0f, 0.0f, 0.0f}, ri[3] = {0.0f, 0.0f, 0.0f};
  float tm = 0.0f;
  bool live = false;
  if (tid < RAYS) {
    const int r = b * RAYS + tid;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      ro[ax] = o[3 * r + ax];
      const float dv = d[3 * r + ax];
      const float small = dv < 0.0f ? -1e-12f : 1e-12f;
      ri[ax] = 1.0f / (fabsf(dv) < 1e-12f ? small : dv);
    }
    tm = t_max != nullptr ? t_max[r] : inf;
    live = tm >= T_MIN;
  }
  const unsigned live_mask = __ballot_sync(0xffffffffu, live);
  int slot;
  const int n_live = cta_sum(sh, __popc(live_mask), &slot);
  if (live) {
    slot += __popc(live_mask & below);
    sh.ray_o[slot] = make_float4(ro[0], ro[1], ro[2], tm);
    sh.ray_inv[slot] = make_float4(ri[0], ri[1], ri[2], 0.0f);
  }
  __syncthreads();

  // 2. per cluster, the least entry distance of the rays that hit it;
  // thread tid owns clusters base + k * LIST_THREADS + tid
  const float ex = exclude != nullptr ? exclude[b] : -inf;
  int n_hit = 0, n_fin = 0;
  for (int base = 0; base < C; base += LIST_THREADS * CPT) {
    float lo[CPT][3], hi[CPT][3], best[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = min(base + k * LIST_THREADS + tid, C - 1);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        lo[k][ax] = cmin[3 * c + ax];
        hi[k][ax] = cmax[3 * c + ax];
      }
      best[k] = inf;
    }
    for (int i = 0; i < n_live; ++i) {
      const float4 p = sh.ray_o[i], q = sh.ray_inv[i];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        float tn = T_MIN, tf = NO_HIT;
        slab(lo[k][0], hi[k][0], p.x, q.x, tn, tf);
        slab(lo[k][1], hi[k][1], p.y, q.y, tn, tf);
        slab(lo[k][2], hi[k][2], p.z, q.z, tn, tf);
        // a hit's tn is a number <= NO_HIT, so best < inf marks a hit
        if (tn <= tf && tn <= p.w) best[k] = fminf(best[k], tn);
      }
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = base + k * LIST_THREADS + tid;
      if (c < C) {
        const bool keep = best[k] < inf && !(best[k] < ex);
        const float kv = keep ? best[k] : NO_HIT;
        if (key != nullptr) key[row + c] = kv;
        bits[c] = __float_as_uint(kv);
        n_hit += keep;
        n_fin += __float_as_uint(kv) < NO_HIT_BITS;
      }
    }
  }
  int before;
  const int total_hit =
      cta_sum(sh, __reduce_add_sync(0xffffffffu, n_hit), &before);
  const int total_fin =
      cta_sum(sh, __reduce_add_sync(0xffffffffu, n_fin), &before);
  if (tid == 0) counts[b] = total_hit;

  // 3. in id order: clusters with a key below NO_HIT go to the sort
  // buffer, the others straight to their places after them. Thread tid
  // reads bits[c] for c = tid (mod LIST_THREADS), which it wrote itself.
  int done = 0;  // keys below NO_HIT among the earlier chunks
  for (int base = 0; base < C; base += LIST_THREADS) {
    const int c = base + tid;
    const uint32_t kb = c < C ? bits[c] : NO_HIT_BITS;
    const bool fin = kb < NO_HIT_BITS;
    const unsigned m = __ballot_sync(0xffffffffu, fin);
    int pre;
    const int chunk = cta_sum(sh, __popc(m), &pre);
    pre += done + __popc(m & below);
    if (fin) {
      pairs[pre] = (static_cast<unsigned long long>(kb) << 32) |
                   static_cast<uint32_t>(c);
    } else if (c < C) {
      ids[row + total_fin + (c - pre)] = c;
    }
    done += chunk;
  }

  // 4. bitonic sort of the (key bits, id) pairs, padded to a power of two
  int p = 1;
  while (p < total_fin) p <<= 1;
  for (int i = total_fin + tid; i < p; i += LIST_THREADS) pairs[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < p / 2; t += LIST_THREADS) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const unsigned long long x = pairs[i], y = pairs[i + j];
        if ((x > y) == ((i & k) == 0)) {
          pairs[i] = y;
          pairs[i + j] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < total_fin; i += LIST_THREADS)
    ids[row + i] = static_cast<int>(pairs[i] & 0xffffffffu);
}

// ---------------------------------------------------------------------------
// The triangle search: tri_hit_kernel and tri_any_kernel
//
// They replace no Pallas kernel: the JAX package's triangle search
// (yhair_tpu/geometry/triangles.py:nearest_hit, a lax.scan of jnp
// Moller-Trumbore over triangle chunks) is left to XLA, and the port's
// plain twin (geometry/triangles.py:_search) runs it as some 40 torch
// ops over (8,192 rays, 2,048 triangles) temporaries in device memory.
// tri_hit_kernel serves nearest_hit: per ray the least t over the
// triangles whose test passes, or NO_HIT, and the first triangle at that
// t (0 where none). tri_any_kernel serves occluded: least t < limit =
// dist * (1 - 1e-4); a ray stops at its first valid t under its limit,
// which is the same answer, since the least valid t lies under the limit
// exactly when some valid t does.
//
// What bounds them on an H100: about 55 FP32 operations a (ray,
// triangle) test and no bytes beyond the rays, the triangles and one
// result a ray, so rays x triangles x 55 / (67 TFLOP/s). The design
// keeps every temporary in registers: a CTA stages a tile of up to
// TRI_TILE triangles in shared memory (v0, e1 = v1 - v0, e2 = v2 - v0,
// rounded as the twin rounds them, packed into two float4 arrays and a
// float array, so a test reads them with three loads and neighbouring
// threads read neighbouring words), and each ray lives in the registers
// of `lanes` neighbouring threads of a warp, each testing every
// lanes-th triangle of the tile. lanes grows (a power of two up to 32)
// while the rays alone would leave the card's SMs short of threads and
// each lane keeps at least TRI_MIN_PER_LANE triangles: a bunny5 strip's
// 65,536 rays over 800 triangles take 4. The lanes of a ray merge
// (least t, then least index) with warp shuffles.
//
// Exactness: the twin's _mt, operation for operation as ATen computes
// it on the card. The cross products are ATen's cross kernel, whose
// a[j] * b[k] - a[k] * b[j] nvcc contracts into one fused multiply-add
// of the first product with the rounded second (cross3); the three-term
// sums are ATen's sum over a last dimension of 3, which two threads
// share, so element 1 is added last (dot3); the reciprocal is IEEE, its
// product with 1.0 exact. Both orders were read from the card against
// the twin (PERF.md). So t, idx and occlusion equal the twin's bit for
// bit, ties and misses included.

constexpr int TRI_THREADS = 256;
constexpr int TRI_TILE = 1024;         // triangles a tile (36 KB)
constexpr int TRI_MIN_PER_LANE = 16;   // least triangles a lane
constexpr int TRI_THREADS_PER_SM = 1024;  // threads to aim for on an SM
constexpr float TRI_EPS = 1e-12f;
// 1 - 1e-4 as the twin's float32 multiply takes it
constexpr float TRI_LIMIT_SCALE = static_cast<float>(1.0 - 1e-4);

struct TriTile {
  float4 a[TRI_TILE];  // v0.xyz, e1.x
  float4 b[TRI_TILE];  // e1.yz, e2.xy
  float c[TRI_TILE];   // e2.z
};

// triangles base .. base + m - 1 into the tile; the caller syncs
__device__ __forceinline__ void stage_triangles(
    TriTile& s, const float* __restrict__ v0, const float* __restrict__ v1,
    const float* __restrict__ v2, int base, int m) {
  for (int k = threadIdx.x; k < m; k += TRI_THREADS) {
    const size_t j = 3 * static_cast<size_t>(base + k);
    float a[3], e1[3], e2[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      a[ax] = v0[j + ax];
      e1[ax] = v1[j + ax] - a[ax];
      e2[ax] = v2[j + ax] - a[ax];
    }
    s.a[k] = make_float4(a[0], a[1], a[2], e1[0]);
    s.b[k] = make_float4(e1[1], e1[2], e2[0], e2[1]);
    s.c[k] = e2[2];
  }
}

// ATen's cross kernel on the card: r[i] = fma(a[j], b[k], -(a[k] * b[j]))
__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float r[3]) {
  r[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  r[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  r[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// ATen's (a * b).sum(-1) over 3 on the card: (p0 + p2) + p1
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return (a[0] * b[0] + a[2] * b[2]) + a[1] * b[1];
}

// _mt_hit of ray (o, d) and staged triangle k: t where the test passes,
// else NO_HIT
__device__ __forceinline__ float tri_test(const TriTile& s, int k,
                                          const float o[3], const float d[3],
                                          float t_min, float t_max) {
  const float4 a = s.a[k], b = s.b[k];
  const float v0[3] = {a.x, a.y, a.z}, e1[3] = {a.w, b.x, b.y},
              e2[3] = {b.z, b.w, s.c[k]};
  float pv[3], tv[3], qv[3];
  cross3(d, e2, pv);
  const float det = dot3(e1, pv);
  const float inv = __frcp_rn(fabsf(det) < TRI_EPS ? TRI_EPS : det);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) tv[ax] = o[ax] - v0[ax];
  const float u = dot3(tv, pv) * inv;
  cross3(tv, e1, qv);
  const float v = dot3(d, qv) * inv;
  const float t = dot3(e2, qv) * inv;
  const bool ok = fabsf(det) > TRI_EPS && u >= 0.0f && v >= 0.0f &&
                  u + v <= 1.0f && t > t_min && t < t_max;
  return ok ? t : NO_HIT;
}

// this thread's ray (clamped to the last one past n) and its lane
struct TriRay {
  float o[3], d[3];
  int r, g;
  bool live;
};

__device__ __forceinline__ TriRay tri_ray(const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          int n, int lanes) {
  TriRay ray;
  ray.r = blockIdx.x * (TRI_THREADS / lanes) + threadIdx.x / lanes;
  ray.g = threadIdx.x & (lanes - 1);
  ray.live = ray.r < n;
  const size_t r = 3 * static_cast<size_t>(ray.live ? ray.r : n - 1);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    ray.o[ax] = o[r + ax];
    ray.d[ax] = d[r + ax];
  }
  return ray;
}

__global__ void __launch_bounds__(TRI_THREADS)
tri_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ v0, const float* __restrict__ v1,
               const float* __restrict__ v2, int n, int n_tri, int lanes,
               float t_min, float t_max, float* __restrict__ t_out,
               long long* __restrict__ idx_out) {
  __shared__ TriTile s;
  const TriRay ray = tri_ray(o, d, n, lanes);
  // each lane walks its triangles in index order, so the strict minimum
  // keeps the first of equal t
  float best = NO_HIT;
  int best_i = 0;
  for (int base = 0; base < n_tri; base += TRI_TILE) {
    const int m = min(TRI_TILE, n_tri - base);
    __syncthreads();
    stage_triangles(s, v0, v1, v2, base, m);
    __syncthreads();
    for (int k = ray.g; k < m; k += lanes) {
      const float t = tri_test(s, k, ray.o, ray.d, t_min, t_max);
      if (t < best) {
        best = t;
        best_i = base + k;
      }
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    const float t = __shfl_xor_sync(0xffffffffu, best, off);
    const int i = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (t < best || (t == best && i < best_i)) {
      best = t;
      best_i = i;
    }
  }
  if (ray.live && ray.g == 0) {
    t_out[ray.r] = best;
    idx_out[ray.r] = best_i;
  }
}

// whether any lane of this thread's ray has occ set (every lane of a
// warp calls it)
__device__ __forceinline__ bool ray_any(bool occ, int lanes) {
  const unsigned votes = __ballot_sync(0xffffffffu, occ);
  const unsigned group = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1;
  return (votes >> ((threadIdx.x & 31) & ~(lanes - 1))) & group;
}

__global__ void __launch_bounds__(TRI_THREADS)
tri_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ dist, const float* __restrict__ v0,
               const float* __restrict__ v1, const float* __restrict__ v2,
               int n, int n_tri, int lanes, float t_min,
               bool* __restrict__ occ_out) {
  __shared__ TriTile s;
  const TriRay ray = tri_ray(o, d, n, lanes);
  const float limit = dist[ray.live ? ray.r : n - 1] * TRI_LIMIT_SCALE;
  // the twin's least t is NO_HIT where no test passes; the lanes past n
  // count as decided
  bool occ = !ray.live || NO_HIT < limit;
  for (int base = 0; base < n_tri; base += TRI_TILE) {
    // the barrier before the tile is overwritten; the CTA stops once
    // every ray is decided
    if (__syncthreads_and(ray_any(occ, lanes))) break;
    const int m = min(TRI_TILE, n_tri - base);
    stage_triangles(s, v0, v1, v2, base, m);
    __syncthreads();
    // every thread of a warp runs the same steps and votes in each
    for (int k0 = 0; k0 < m; k0 += lanes) {
      const bool done = ray_any(occ, lanes);
      if (__all_sync(0xffffffffu, done)) break;
      const int k = k0 + ray.g;
      if (!done && k < m)
        occ = tri_test(s, k, ray.o, ray.d, t_min, NO_HIT) < limit;
    }
  }
  const bool any = ray_any(occ, lanes);
  if (ray.live && ray.g == 0) occ_out[ray.r] = any;
}

// threads a ray for n rays over n_tri triangles on the current device
int tri_lanes(int n, int n_tri) {
  static const int target = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms * TRI_THREADS_PER_SM;
  }();
  int lanes = 1;
  while (lanes < 32 && static_cast<long long>(n) * lanes < target &&
         n_tri >= 2 * lanes * TRI_MIN_PER_LANE)
    lanes <<= 1;
  return lanes;
}

// CTAs of `kernel` that fit on the current device at once
template <typename F>
int persistent_grid(F kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// scratch: one int, the item counter. partials: 2 x max_items x 128
// floats and max_items x 128 ints, the per-item results.
extern "C" int yhair_hit_pass(const float* o, const float* d,
                              const float* t0, const int* i0,
                              const float* oid0, const int* ids,
                              const int* counts, const int* prefix,
                              const float* tc, int n_blocks, int k_cap,
                              int chunk, int max_items, int* scratch,
                              float* partials, float* t_out, int* idx_out,
                              float* oid_out, void* stream) {
  if (n_blocks == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  static const int grid = persistent_grid(hit_kernel);
  cudaMemsetAsync(scratch, 0, sizeof(int), s);
  const size_t n_part = static_cast<size_t>(max_items) * RAYS;
  float* part_t = partials;
  float* part_oid = partials + n_part;
  int* part_idx = reinterpret_cast<int*>(partials + 2 * n_part);
  const Plan p{ids, counts, prefix, tc, scratch, n_blocks, k_cap, chunk};
  hit_kernel<<<grid, THREADS, 0, s>>>(p, o, d, t0, part_t, part_oid,
                                       part_idx);
  hit_merge_kernel<<<n_blocks, RAYS, 0, s>>>(prefix, part_t, part_oid,
                                             part_idx, t0, i0, oid0, t_out,
                                             idx_out, oid_out);
  return static_cast<int>(cudaGetLastError());
}

// visits (optional, nb ints): the visits each block's items made, the
// work this launch did (a parallel walk may exceed a sequential one's).
extern "C" int yhair_any_pass(const float* o, const float* d,
                              const float* t_cap, const int* ids,
                              const int* counts, const int* prefix,
                              const float* tc, int n_blocks, int k_cap,
                              int chunk, int* scratch, int* occ_out,
                              int* visits, void* stream) {
  if (n_blocks == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  static const int grid = persistent_grid(any_kernel);
  cudaMemsetAsync(scratch, 0, sizeof(int), s);
  cudaMemsetAsync(occ_out, 0, sizeof(int) * n_blocks * RAYS, s);
  if (visits != nullptr)
    cudaMemsetAsync(visits, 0, sizeof(int) * n_blocks, s);
  const Plan p{ids, counts, prefix, tc, scratch, n_blocks, k_cap, chunk};
  any_kernel<<<grid, THREADS, 0, s>>>(p, o, d, t_cap, occ_out, visits);
  return static_cast<int>(cudaGetLastError());
}

// Phase 1 of a search: n_blocks CTAs. t_max, exclude and key may be null
// (no bound, no exclusion, no key output). sort_cap: the next power of
// two >= n_clusters. scratch: null to keep a block's sort_cap pairs and
// n_clusters key bits in dynamic shared memory, else n_blocks slices of
// that many bytes (rounded up to 8) in global memory.
extern "C" int yhair_block_lists(const float* o, const float* d,
                                 const float* cmin, const float* cmax,
                                 const float* t_max, const float* exclude,
                                 int n_blocks, int n_clusters, int sort_cap,
                                 void* scratch, int* ids, int* counts,
                                 float* key, void* stream) {
  if (n_blocks == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* global = static_cast<unsigned long long*>(scratch);
  if (global != nullptr) {
    lists_kernel<true><<<n_blocks, LIST_THREADS, 0, s>>>(
        o, d, cmin, cmax, t_max, exclude, n_clusters, sort_cap, global, ids,
        counts, key);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes =
      8 * (static_cast<size_t>(sort_cap) + (n_clusters + 1) / 2);
  // without opting in, static and dynamic shared memory share 48 KB
  static size_t allowed = 48 * 1024 - sizeof(ListShared);
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        lists_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = bytes;
  }
  lists_kernel<false><<<n_blocks, LIST_THREADS, bytes, s>>>(
      o, d, cmin, cmax, t_max, exclude, n_clusters, sort_cap, nullptr, ids,
      counts, key);
  return static_cast<int>(cudaGetLastError());
}

// The triangle search over n rays (o, d: (n, 3)) and n_tri triangles (v0,
// v1, v2: (n_tri, 3)). t_out (n,): the least t in (t_min, t_max) or
// NO_HIT; idx_out (n,): the first triangle at that t, 0 where none.
extern "C" int yhair_tri_hit(const float* o, const float* d, const float* v0,
                             const float* v1, const float* v2, int n,
                             int n_tri, float t_min, float t_max,
                             float* t_out, long long* idx_out,
                             void* stream) {
  if (n == 0) return 0;
  const int lanes = tri_lanes(n, n_tri), rays = TRI_THREADS / lanes;
  tri_hit_kernel<<<(n + rays - 1) / rays, TRI_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      o, d, v0, v1, v2, n, n_tri, lanes, t_min, t_max, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

// occ_out (n,): whether the least t over the triangles in (t_min, NO_HIT),
// or NO_HIT where there is none, lies below dist * (1 - 1e-4).
extern "C" int yhair_tri_any(const float* o, const float* d,
                             const float* dist, const float* v0,
                             const float* v1, const float* v2, int n,
                             int n_tri, float t_min, bool* occ_out,
                             void* stream) {
  if (n == 0) return 0;
  const int lanes = tri_lanes(n, n_tri), rays = TRI_THREADS / lanes;
  tri_any_kernel<<<(n + rays - 1) / rays, TRI_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      o, d, dist, v0, v1, v2, n, n_tri, lanes, t_min, occ_out);
  return static_cast<int>(cudaGetLastError());
}

// the threads a ray that both triangle kernels take for these sizes
extern "C" int yhair_tri_lanes(int n, int n_tri) {
  return tri_lanes(n, n_tri);
}
