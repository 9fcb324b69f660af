// Exact greedy placement scan, one thread block per eval, for Hopper.
//
// Replaces the XLA program nomad_tpu/ops/binpack.py solve_greedy and its
// eval-axis vmaps solve_greedy_batched / solve_greedy_batched_shared
// (:115-199): a lax.scan of k <= 128 steps, each computing fit + BestFit
// score + anti-affinity penalty for every node (_greedy_step_state,
// :89-111), taking the argmax (lowest index on ties, as jnp.argmax does)
// and adding one copy of the ask to the chosen node. It is not a port of
// a Pallas kernel: the JAX package left this scan to XLA. Eager PyTorch
// would launch about 15 kernels a step, some 2000 an eval; here the whole
// scan is one launch.
//
// Design: incremental. A step changes the state of one node only, the one
// it placed on, and a node's score depends on its own state alone. So the
// scan needs N + k scores, not N x k:
//
// 1. One full scoring pass. All 1024 threads of the eval's block score the
//    N nodes into a per-eval score cache: dynamic shared memory for
//    N <= kSmemCacheRows (64 KB), else a [B, N] device scratch from the
//    wrapper (512 KB an eval at the 131072-row bucket, L2-resident). The
//    node axis is cut into S = ceil(N / W) contiguous slots of
//    W = ceil(N / 1024) nodes, and each slot's best (score, index) is kept
//    in shared memory (8 KB).
// 2. k steps by warp 0 alone, with no __syncthreads: the argmax over the
//    slot bests (32 a lane, then two redux.sync; slots are contiguous, so
//    a tie between slots goes to the lower slot and only the winner's
//    index is read); the step's outputs; and, if it placed, the placed
//    node's rescore and its slot's new best (W / 32 cached scores a lane,
//    then two redux.sync). No step passes over the node axis.
//
// Why it stays exact: the rescore calls the same node_score as the first
// pass, so every cached score is bit for bit the value a full recompute
// would give, and the (score, index) order is total, so the argmax does not
// depend on the shape of the reduction. Scores are compared as
// order-preserving unsigned keys, so a warp's argmax is two redux.sync
// (the highest key, then the lowest index holding it) in place of five
// rounds of two shuffles. Padding slot entries hold (-inf, INT_MAX) and
// stand after every real slot: they never beat a real -inf row, and an all
// -inf step returns index 0, as jnp.argmax does.
//
// What bounds it on the H100: neither bytes nor operations. The k steps are
// a chain of dependent on-chip reductions, each with one L2 round trip for
// the placed node's inputs and two powf, plus the first pass over N nodes.
//
// The carried state is one int per node: how many copies this scan has
// placed there so far. used, job_count, tg_count and bw_used are the inputs
// plus that count times the ask, which is exactly the one-hot sums of the
// scan. The inputs are never written.
//
// Arithmetic follows ops/waterfill.cu: IEEE float32, accurate powf, _rn
// intrinsics so nothing is contracted into an FMA.
//
// The file also holds the merge of node-shard scans (merge_kernel, below),
// with its own notes.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "device_once.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 1024;  // most slots an eval's node axis is cut into
constexpr int kSmemCacheRows = 16384;  // ops/greedy.py SMEM_CACHE_ROWS
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSlots == kThreads, "one padding slot entry per thread");

__device__ __forceinline__ float bestfit_score(int used_cpu, int used_mem,
                                               float cap_cpu, float cap_mem,
                                               float penalty, int job_count) {
  const float u[2] = {(float)used_cpu, (float)used_mem};
  const float c[2] = {cap_cpu, cap_mem};
  float p[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float safe = fmaxf(c[d], 1.0f);
    float free_frac = __fsub_rn(1.0f, __fdiv_rn(u[d], safe));
    if (!(c[d] > 0.0f)) free_frac = -INFINITY;
    p[d] = powf(10.0f, free_frac);
  }
  float s = __fsub_rn(20.0f, __fadd_rn(p[0], p[1]));
  s = fminf(fmaxf(s, 0.0f), 18.0f);
  return __fsub_rn(s, __fmul_rn(penalty, (float)job_count));
}

// Score of node i after p earlier placements on it: fit + BestFit score +
// anti-affinity penalty of one more copy of the ask, -inf where it does not
// fit. The first pass and every rescore go through here.
__device__ __forceinline__ float node_score(
    int i, int p, const int4* __restrict__ total,
    const float2* __restrict__ sched_cap, const int* __restrict__ bw_avail,
    const int4* __restrict__ used0, const int* __restrict__ job_count0,
    const int* __restrict__ tg_count0, const int* __restrict__ bw_used0,
    const unsigned char* __restrict__ eligible, int4 ask, int bw_ask,
    float penalty, int job_distinct, int tg_distinct) {
  const int4 t = total[i];
  const int4 u = used0[i];
  const int up0 = u.x + p * ask.x + ask.x;
  const int up1 = u.y + p * ask.y + ask.y;
  const int up2 = u.z + p * ask.z + ask.z;
  const int up3 = u.w + p * ask.w + ask.w;
  const int jc = job_count0[i] + p;
  bool fit = up0 <= t.x && up1 <= t.y && up2 <= t.z && up3 <= t.w &&
             (bw_used0[i] + p * bw_ask + bw_ask) <= bw_avail[i] &&
             eligible[i];
  if (job_distinct) fit = fit && jc == 0;
  if (tg_distinct) fit = fit && (tg_count0[i] + p) == 0;
  // Loaded whether or not the node fits: under the branch it would be a
  // second L2 round trip after the others on every step's rescore.
  const float2 sc = sched_cap[i];
  if (!fit) return -INFINITY;
  return bestfit_score(up0, up1, sc.x, sc.y, penalty, jc);
}

// Order-preserving unsigned key of a score: a > b as floats iff
// key(a) > key(b), and equal scores have equal keys (-0 is taken as +0).
// Every key, -inf's included, is above 0.
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(__fadd_rn(s, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// (key, index) order of jnp.argmax: higher score wins, then lower index.
__device__ __forceinline__ void take(unsigned key, int i, unsigned& bk,
                                     int& bi) {
  if (key > bk || (key == bk && i < bi)) {
    bk = key;
    bi = i;
  }
}

// Warp argmax: every lane gets the highest key and, of the lanes holding
// it, the lowest index.
__device__ __forceinline__ int warp_best(unsigned key, int i,
                                         unsigned& best_key) {
  best_key = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, key == best_key ? i : INT_MAX);
}

// Best (key, index) of slot `slot` (nodes [slot * w, min(slot * w + w, n)))
// on every lane of the calling warp, reading the cache except at node
// `fresh`, whose new score `fresh_s` the caller holds in a register. A
// lane's nodes rise, so a strict > keeps its first maximum; a lane with no
// node holds key 0, below every score's.
__device__ __forceinline__ int slot_best(const float* cache, int slot, int w,
                                         int n, int lane, int fresh,
                                         float fresh_s, unsigned& key) {
  unsigned bk = 0;
  int bi = INT_MAX;
  const int hi = min(slot * w + w, n);
  for (int j = slot * w + lane; j < hi; j += 32) {
    const unsigned kj = score_key(j == fresh ? fresh_s : cache[j]);
    if (kj > bk) {
      bk = kj;
      bi = j;
    }
  }
  return warp_best(bk, bi, key);
}

template <bool kSmemCache>
__global__ void __launch_bounds__(kThreads, 1)
greedy_kernel(const int4* __restrict__ total, const float2* __restrict__ sched_cap,
              const int* __restrict__ bw_avail, const int4* __restrict__ used0,
              const int* __restrict__ job_count0,
              const int* __restrict__ tg_count0,
              const int* __restrict__ bw_used0,
              const unsigned char* __restrict__ eligible,
              const int4* __restrict__ ask_all,
              const int* __restrict__ bw_ask_all,
              const unsigned char* __restrict__ active_all,
              const float* __restrict__ penalty_all, int* __restrict__ idx_out,
              unsigned char* __restrict__ ok_out,
              float* __restrict__ score_out, int* placed_scratch,
              float* score_scratch, int n, int k, int job_distinct,
              int tg_distinct) {
  extern __shared__ float smem_cache[];
  __shared__ unsigned slot_k[kSlots];
  __shared__ int slot_i[kSlots];

  const int b = blockIdx.x;
  const size_t off = (size_t)b * (size_t)n;
  used0 += off;
  job_count0 += off;
  tg_count0 += off;
  bw_used0 += off;
  eligible += off;
  int* placed = placed_scratch + off;
  float* cache = kSmemCache ? smem_cache : score_scratch + off;
  const unsigned char* active = active_all + (size_t)b * k;

  const int4 ask = ask_all[b];
  const int bw_ask = bw_ask_all[b];
  const float penalty = penalty_all[b];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 1. The one full scoring pass (no placements yet: p = 0).
  slot_k[threadIdx.x] = score_key(-INFINITY);
  slot_i[threadIdx.x] = INT_MAX;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    placed[i] = 0;
    cache[i] = node_score(i, 0, total, sched_cap, bw_avail, used0, job_count0,
                          tg_count0, bw_used0, eligible, ask, bw_ask, penalty,
                          job_distinct, tg_distinct);
  }
  __syncthreads();
  const int w = (n + kSlots - 1) / kSlots;
  const int n_slots = (n + w - 1) / w;
  for (int slot = warp; slot < n_slots; slot += kWarps) {
    unsigned sk;
    const int si = slot_best(cache, slot, w, n, lane, -1, 0.0f, sk);
    if (lane == 0) {
      slot_k[slot] = sk;
      slot_i[slot] = si;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // 2. The k steps, warp 0 alone. The argmax runs over (score, slot
  // position): slot j's nodes all precede slot j + 1's, so this order is
  // the (score, index) order of the slot bests.
  for (int step = 0; step < k; ++step) {
    const bool act = active[step] != 0;
    unsigned bk[4] = {0, 0, 0, 0};
    int bj[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll 8
    for (int m = 0; m < kSlots / 32; ++m) {
      const int j = lane + 32 * m;
      const unsigned kj = slot_k[j];
      if (kj > bk[m & 3]) {
        bk[m & 3] = kj;
        bj[m & 3] = j;
      }
    }
    take(bk[1], bj[1], bk[0], bj[0]);
    take(bk[3], bj[3], bk[2], bj[2]);
    take(bk[2], bj[2], bk[0], bj[0]);
    unsigned best_key;
    const int best_i = slot_i[warp_best(bk[0], bj[0], best_key)];
    const float best_s = key_score(best_key);
    const bool ok = best_s > -INFINITY && act;  // the same on every lane
    if (lane == 0) {
      idx_out[(size_t)b * k + step] = best_i;
      ok_out[(size_t)b * k + step] = ok ? 1 : 0;
      score_out[(size_t)b * k + step] = best_s;
    }
    if (ok) {
      const int p = placed[best_i] + 1;
      const float fresh = node_score(
          best_i, p, total, sched_cap, bw_avail, used0, job_count0,
          tg_count0, bw_used0, eligible, ask, bw_ask, penalty, job_distinct,
          tg_distinct);
      const int slot = best_i / w;
      unsigned sk;
      const int si = slot_best(cache, slot, w, n, lane, best_i, fresh, sk);
      __syncwarp();  // every lane has read placed[best_i] and the cache
      if (lane == 0) {
        placed[best_i] = p;
        cache[best_i] = fresh;
        slot_k[slot] = sk;
        slot_i[slot] = si;
      }
    }
    __syncwarp();  // the step's writes are visible to the next step
  }
}

// -- the merge of node-shard scans (ops/greedy.py solve_greedy_sharded) --
//
// A node's score depends on its own state alone, so the global scan,
// restricted to one shard's rows, picks them in the order the shard's own
// k-step scan does. Each shard scans its rows for all k steps (the kernel
// above, on the shard's rows alone); this kernel interleaves the S
// sequences back into the global one: at each step the shard whose next
// pick has the highest score key, ties to the lower shard (shards are
// contiguous, so that is the lowest global index, jnp.argmax's rule); an
// active step that places advances that shard's head. When every head is
// -inf the step gives index 0, score -inf and ok false, as the unsharded
// scan does.
//
// What bounds it on the H100: the chain of k dependent steps, not bytes
// (S x k x 8 bytes an eval, 4 KB at S = 4, k = 128). So nothing of a step
// waits on memory beyond the SM:
//
// 1. Before the first step, every thread of the block stages the eval's
//    [S, k] scores and indices into shared memory with cp.async (16-byte
//    copies where k allows, else 4-byte), and the active row beside them.
// 2. Warp 0 runs the steps. Lane l owns shards l, l + 32, ...: their
//    heads (score, index, key) and the entries after them live in
//    registers (kSpl a lane, the power of two from 1 that covers S / 32),
//    with the lane's best (key, shard). A step is the warp argmax (one
//    redux.sync and a ballot where a lane holds one shard, else
//    warp_best's two redux.sync), the winning lane's outputs from its
//    registers, its next entry moved up and a register compare over its
//    kSpl keys. The one shared-memory read of a step, the entry after the
//    new head, lands while the next step's argmax runs.
// 3. Where S x k x 8 bytes does not fit the block's shared memory (S k
//    above about 29,000), a window of each shard's entries is staged
//    instead (merge_window, from the shape) and refilled by the warp, one
//    coalesced read, when the entry a shard needs next crosses it.
constexpr int kMaxShards = 512;         // ops/greedy.py MAX_SHARDS
constexpr int kMergeThreads = 256;      // stagers; then warp 0
constexpr int kMergeSmem = 227 * 1024;  // a block's shared memory on H100

// Entries of each shard staged at a time: all k where they fit, else the
// largest power of two from 32 below k that fits; 0 where none does.
int merge_window(int n_shards, int k) {
  const size_t act = (size_t)k;  // the active row
  if ((size_t)n_shards * k * 8 + act <= (size_t)kMergeSmem) return k;
  int w = 32;
  while (2 * w < k && (size_t)n_shards * 2 * w * 8 + act <= (size_t)kMergeSmem)
    w *= 2;
  return (size_t)n_shards * w * 8 + act <= (size_t)kMergeSmem ? w : 0;
}

__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void copy_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// The merge's shared memory: [S][window] scores, [S][window] indices, [k]
// active flags.
struct MergeSmem {
  float* score;
  int* idx;
  unsigned char* act;
};

// Every thread of the block: stage each shard's first `window` entries of
// eval blockIdx.x and its active row; returns when they have all landed.
__device__ __forceinline__ MergeSmem stage(
    unsigned char* smem, const int* __restrict__ idx,
    const float* __restrict__ score, const unsigned char* __restrict__ active,
    int n_shards, int batch, int k, int window, int vec16) {
  const MergeSmem m = {
      reinterpret_cast<float*>(smem),
      reinterpret_cast<int*>(smem + (size_t)n_shards * window * 4),
      smem + (size_t)n_shards * window * 8};
  const int b = blockIdx.x;
  const int per_copy = vec16 ? 4 : 1;
  const int row_copies = window / per_copy;
  for (int c = threadIdx.x; c < n_shards * row_copies; c += kMergeThreads) {
    const int s = c / row_copies;
    const int e = (c - s * row_copies) * per_copy;
    const size_t src = ((size_t)s * batch + b) * k + e;
    const int dst = s * window + e;
    if (vec16) {
      copy_async16(&m.score[dst], &score[src]);
      copy_async16(&m.idx[dst], &idx[src]);
    } else {
      copy_async4(&m.score[dst], &score[src]);
      copy_async4(&m.idx[dst], &idx[src]);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int t = threadIdx.x; t < k; t += kMergeThreads)
    m.act[t] = active[(size_t)b * k + t];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  return m;
}

// The lane's best (key, shard) over its kSpl heads: its shards rise, so a
// strict > keeps the lowest shard on ties; no shard holds key 0.
template <int kSpl>
__device__ __forceinline__ void lane_best(const unsigned (&key)[kSpl],
                                          int lane, unsigned& bk, int& bs) {
  bk = 0;
  bs = INT_MAX;
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    if (key[j] > bk) {
      bk = key[j];
      bs = lane + 32 * j;
    }
  }
}

// One block an eval, any S: warp 0 runs the steps. Each of a lane's
// shards keeps its head (score, index, key) and the entry after it in
// registers, so a step reads nothing on its chain: the warp argmax, the
// outputs and, where it places, the winner's next entry moved up from a
// register; the entry after that is read from shared memory after the
// step, while the next step's argmax runs.
template <int kSpl, bool kWindowed>
__global__ void __launch_bounds__(kMergeThreads, 1)
merge_kernel(const int* __restrict__ idx, const float* __restrict__ score,
             const unsigned char* __restrict__ active,
             int* __restrict__ idx_out, unsigned char* __restrict__ ok_out,
             float* __restrict__ score_out, int n_shards, int batch, int k,
             int n_s, int window, int vec16) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  const MergeSmem m = stage(merge_smem, idx, score, active, n_shards, batch,
                            k, window, vec16);
  if (threadIdx.x >= 32) return;
  float* s_score = m.score;
  int* s_idx = m.idx;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;

  unsigned key[kSpl];
  float cur_s[kSpl], nxt_s[kSpl];
  int cur_i[kSpl], nxt_i[kSpl], head[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    const int s = lane + 32 * j;
    const bool live = s < n_shards;
    head[j] = 0;
    cur_s[j] = live ? s_score[s * window] : 0.0f;
    cur_i[j] = live ? s_idx[s * window] : 0;
    key[j] = live ? score_key(cur_s[j]) : 0u;
    nxt_s[j] = live && k > 1 ? s_score[s * window + 1] : 0.0f;
    nxt_i[j] = live && k > 1 ? s_idx[s * window + 1] : 0;
  }
  unsigned lk;
  int ls;
  lane_best(key, lane, lk, ls);
  const unsigned dead = score_key(-INFINITY);
  for (int step = 0; step < k; ++step) {
    const bool ok = m.act[step] != 0;  // warp-uniform, off the chain
    unsigned best_key;
    int best_s;
    if (kSpl == 1) {
      // Lane l holds shard l alone: the lowest lane holding the best key
      // is the lowest shard.
      best_key = __reduce_max_sync(kFull, lk);
      best_s = __ffs(__ballot_sync(kFull, lk == best_key)) - 1;
    } else {
      best_s = warp_best(lk, ls, best_key);
    }
    const size_t o = (size_t)b * k + step;
    if (best_key <= dead) {  // every head is -inf (warp-uniform)
      if (lane == 0) {
        idx_out[o] = 0;
        ok_out[o] = 0;
        score_out[o] = -INFINITY;
      }
      continue;
    }
    const int owner = best_s & 31;
    const int js = best_s >> 5;
    int h = 0;  // the winner's new head, on its lane
    if (lane == owner) {
      float bsc = 0.0f;
      int bix = 0;
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        if (j == js) {
          bsc = cur_s[j];
          bix = cur_i[j];
          h = head[j] + 1;
        }
      }
      idx_out[o] = best_s * n_s + bix;
      ok_out[o] = ok ? 1 : 0;
      score_out[o] = bsc;
      if (ok) {
#pragma unroll
        for (int j = 0; j < kSpl; ++j) {
          if (j == js) {
            head[j] = h;
            cur_s[j] = nxt_s[j];
            cur_i[j] = nxt_i[j];
            key[j] = h < k ? score_key(nxt_s[j]) : 0u;
          }
        }
        lane_best(key, lane, lk, ls);
      }
    }
    if (!ok) continue;
    // The entry after the new head, into the winner's next registers.
    if (kWindowed) {
      h = __shfl_sync(kFull, h, owner);
      if (h + 1 < k && (h + 1) % window == 0) {
        // The shard's window is spent: the warp reads its next one.
        __syncwarp();  // the owner's reads of the old one come first
        const size_t row = ((size_t)best_s * batch + b) * k + h + 1;
        for (int e = lane; e < window && h + 1 + e < k; e += 32) {
          s_score[best_s * window + e] = score[row + e];
          s_idx[best_s * window + e] = idx[row + e];
        }
        __syncwarp();
      }
    }
    if (lane == owner) {
      const bool more = h + 1 < k;
      const int at = best_s * window + (kWindowed ? (h + 1) % window : h + 1);
      const float ns = more ? s_score[at] : 0.0f;
      const int ni = more ? s_idx[at] : 0;
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        if (j == js) {
          nxt_s[j] = ns;
          nxt_i[j] = ni;
        }
      }
    }
  }
}

template <int kSpl, bool kWindowed>
cudaError_t launch_merge(const void* idx, const void* score,
                         const void* active, void* idx_out, void* ok_out,
                         void* score_out, int n_shards, int batch, int k,
                         int n_s, int window, int vec16, size_t smem,
                         cudaStream_t stream) {
  static std::atomic<int> attr[kMaxDevices];  // this instantiation's
  const cudaError_t err =
      smem_opt_in(attr, merge_kernel<kSpl, kWindowed>, kMergeSmem);
  if (err != cudaSuccess) return err;
  merge_kernel<kSpl, kWindowed><<<batch, kMergeThreads, smem, stream>>>(
      (const int*)idx, (const float*)score, (const unsigned char*)active,
      (int*)idx_out, (unsigned char*)ok_out, (float*)score_out, n_shards,
      batch, k, n_s, window, vec16);
  return cudaGetLastError();
}

template <bool kWindowed>
cudaError_t launch_merge_spl(int spl, const void* idx, const void* score,
                             const void* active, void* idx_out, void* ok_out,
                             void* score_out, int n_shards, int batch, int k,
                             int n_s, int window, int vec16, size_t smem,
                             cudaStream_t stream) {
#define NOMAD_MERGE(S)                                                     \
  launch_merge<S, kWindowed>(idx, score, active, idx_out, ok_out,          \
                             score_out, n_shards, batch, k, n_s, window,   \
                             vec16, smem, stream)
  switch (spl) {
    case 1: return NOMAD_MERGE(1);
    case 2: return NOMAD_MERGE(2);
    case 4: return NOMAD_MERGE(4);
    case 8: return NOMAD_MERGE(8);
    default: return NOMAD_MERGE(16);
  }
#undef NOMAD_MERGE
}

}  // namespace

extern "C" int nomad_greedy(
    const void* total, const void* sched_cap, const void* bw_avail,
    const void* used0, const void* job_count0, const void* tg_count0,
    const void* bw_used0, const void* eligible, const void* ask,
    const void* bw_ask, const void* active, const void* penalty,
    void* idx_out, void* ok_out, void* score_out, void* placed_scratch,
    void* score_scratch, int batch, int n, int k, int job_distinct,
    int tg_distinct, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= kSmemCacheRows) {
    // Above 48 KB a block's dynamic shared memory must be asked for, once
    // per device.
    static std::atomic<int> attr[kMaxDevices];
    const cudaError_t err = smem_opt_in(attr, greedy_kernel<true>,
                                        kSmemCacheRows * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    greedy_kernel<true><<<batch, kThreads, (size_t)n * sizeof(float), s>>>(
        (const int4*)total, (const float2*)sched_cap, (const int*)bw_avail,
        (const int4*)used0, (const int*)job_count0, (const int*)tg_count0,
        (const int*)bw_used0, (const unsigned char*)eligible,
        (const int4*)ask, (const int*)bw_ask, (const unsigned char*)active,
        (const float*)penalty, (int*)idx_out, (unsigned char*)ok_out,
        (float*)score_out, (int*)placed_scratch, nullptr, n, k, job_distinct,
        tg_distinct);
  } else {
    if (score_scratch == nullptr) return (int)cudaErrorInvalidValue;
    greedy_kernel<false><<<batch, kThreads, 0, s>>>(
        (const int4*)total, (const float2*)sched_cap, (const int*)bw_avail,
        (const int4*)used0, (const int*)job_count0, (const int*)tg_count0,
        (const int*)bw_used0, (const unsigned char*)eligible,
        (const int4*)ask, (const int*)bw_ask, (const unsigned char*)active,
        (const float*)penalty, (int*)idx_out, (unsigned char*)ok_out,
        (float*)score_out, (int*)placed_scratch, (float*)score_scratch, n, k,
        job_distinct, tg_distinct);
  }
  return (int)cudaGetLastError();
}

// Entries of each shard the merge stages at a time (k: all of them).
extern "C" int nomad_greedy_merge_window(int n_shards, int k) {
  return merge_window(n_shards, k);
}

// idx and score: [S, B, k] shard-local picks of S scans of n_s rows each;
// active [B, k]; outputs [B, k].
extern "C" int nomad_greedy_merge(const void* idx, const void* score,
                                  const void* active, void* idx_out,
                                  void* ok_out, void* score_out,
                                  int n_shards, int batch, int k, int n_s,
                                  void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || batch <= 0 || k <= 0 ||
      n_s <= 0)
    return (int)cudaErrorInvalidValue;
  const int window = merge_window(n_shards, k);
  if (window == 0) return (int)cudaErrorInvalidValue;
  const int vec16 = window % 4 == 0 && k % 4 == 0 &&
                    (uintptr_t)idx % 16 == 0 && (uintptr_t)score % 16 == 0;
  const size_t smem = (size_t)n_shards * window * 8 + (size_t)k;
  const cudaStream_t s = (cudaStream_t)stream;
  int spl = 1;  // shards a lane, a power of two
  while (32 * spl < n_shards) spl *= 2;
  const cudaError_t err =
      window < k
          ? launch_merge_spl<true>(spl, idx, score, active, idx_out, ok_out,
                                   score_out, n_shards, batch, k, n_s,
                                   window, vec16, smem, s)
          : launch_merge_spl<false>(spl, idx, score, active, idx_out, ok_out,
                                    score_out, n_shards, batch, k, n_s,
                                    window, vec16, smem, s);
  return (int)err;
}
