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

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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
    // per process (thread-safe static initialisation; one card a process).
    static const cudaError_t attr = cudaFuncSetAttribute(
        greedy_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemCacheRows * (int)sizeof(float));
    if (attr != cudaSuccess) return (int)attr;
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
