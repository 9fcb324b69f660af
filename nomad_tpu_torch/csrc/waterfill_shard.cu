// Node-sharded water-fill for Hopper: the passes of one node shard, one
// launch a pass, with every cross-shard combine between launches.
//
// Replaces what XLA's SPMD partitioner makes of nomad_tpu/ops/binpack.py
// solve_waterfill (:269-372) under node-axis shardings
// (nomad_tpu/parallel/mesh.py shard_waterfill_args and
// shard_waterfill_batch_args, reached from nomad_tpu/ops/coalesce.py
// :543-548 and :618-626; with a mesh, nomad_tpu skips its Pallas kernel).
// nomad_tpu's sharded solve takes both searches by bisection, each step a
// cross-shard psum; here the rounds are the unsharded kernel's sync points.
//
// Design. The unsharded kernel (waterfill.cu) decides the max cap, the
// level (8 bits a pass), the threshold (a radix select, 8 bits a pass) and
// the tie fill's boundary offsets from digit histograms combined across
// the blocks of a cluster. Here that combine moves between launches:
//
// - A pass of a shard writes one partial row per eval ([512] int64): the
//   shard's max cap, or its [256] bin counts and [256] int64 sums, or its
//   boundary count in the column of its shard index.
// - The caller's reduction seam adds (or maxes) the partials of every
//   shard: parallel/mesh.py MeshReduce for shards in one process,
//   parallel/dcn.py DistReduce (torch.distributed.all_reduce) across
//   processes. The boundary round's sum is an all-gather: every shard
//   writes zeros outside its own column.
// - Warp 0 of every shard's next pass takes the same decision from the
//   same combined row, so the shards never disagree and need no broadcast.
//
// Rounds a solve, each one launch a shard and one combine: 1 (max cap) +
// ceil(bits(max count) / 8), at least 1 (level) + 4 (threshold; the first
// radix pass is folded into the key pass) + 1 (boundary prefix); then the
// counts pass, with no combine. The level's passes start from the largest
// count of the batch, which the host knows, not from the max cap, which
// only the device knows: a top pass above an eval's own needs only decides
// zero digits, and the level is the same unique largest L.
//
// Layout: one block of 512 threads an eval of the shard (grid = B);
// thread t holds the shard's rows t, t + 512, ...: reads are coalesced,
// and the tie fill's node order is (iteration, warp, lane), as in
// waterfill.cu. The caps and keys live in [B, n] device scratch between
// passes, the decisions in a [B, 16] int64 state row per eval that only
// the eval's block reads and writes.
//
// What bounds it on the H100: neither bytes nor operations. A shard reads
// each node's inputs once (the caps pass) and a candidate's once more (the
// key pass); every other pass reads 4 or 8 bytes a row of scratch. The
// time goes to the chain of dependent launches and combines: 9 rounds at
// the headline's 100,000 tasks.
//
// Every decision is on integers, so the order in which the seam adds the
// partials cannot change an output, and the scores come from the same
// bestfit_score as the unsharded kernel (waterfill_common.cuh), built with
// --fmad=false: a sharded solve equals the unsharded kernel bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "waterfill_common.cuh"

namespace {

constexpr int kPartWidth = 512;  // ops/waterfill.py PART_WIDTH
// 512 threads a block, not waterfill.cu's 1024: a phase's decision and
// histogram pass need more than the 64 registers a thread of a 1024-thread
// block has, and one block an eval of a shard leaves the SMs idle anyway.
constexpr int kShardThreads = 512;
constexpr int kShardWarps = kShardThreads / 32;
constexpr int kState = 16;       // ops/waterfill.py N_STATE

// ops/waterfill.py _PHASES
enum Phase {
  kCaps = 0,
  kLevelFirst = 1,
  kLevel = 2,
  kKeys = 3,
  kRadix = 4,
  kBoundary = 5,
  kCounts = 6,
};

// The state row of an eval (int64 slots).
enum Slot {
  sHcap = 0,     // H = min(count, max cap)
  sPrefix,       // level: the bits of L decided so far
  sSumBelow,     // level: sum of the caps below the bins
  sNAbove,       // level: count of the caps above the bins
  sBaseSum,      // f(level)
  sLevel,
  sRemaining,    // count - f(level)
  sKAbove,       // threshold: candidate keys above the bins
  sTPrefix,      // threshold: the key bits decided so far
  sDone,         // the threshold search has its answer
  sTie,          // the boundary is cut: take its first `fill` rows
  sTEff,         // selected: key > t_eff ...
  sFill,         // ... plus the first `fill` boundary rows (tie)
  sNSel,         // rows the partial round selects
  sDstar,        // the threshold's last digit (its bin in the last pass)
};

struct Args {
  const int4* total;
  const int4* used;
  const float2* sched_cap;
  const int* job_count;
  const int* tg_count;
  const int* bw_avail;
  const int* bw_used;
  const unsigned char* eligible;
  const int4* ask;
  const int* bw_ask;
  const int* count;
  const float* penalty;
  int* cap;
  unsigned* key;
  long long* state;
  const long long* comb;      // the combined row of the last round
  const long long* own_prev;  // this shard's own partial of the last round
  long long* part;            // this pass's partial
  int* counts_out;
  int* remaining_out;
  int n;
  int index;
  int job_distinct;
  int tg_distinct;
};

// Warp 0: the level step of waterfill.cu from the combined histogram of a
// pass at shift s -- the largest bin edge L = P + d 2^s with L <= H and
// f(L) = (sum of caps < L) + L #{cap >= L} <= count.
__device__ __forceinline__ void decide_level(const long long* c, int s,
                                             long long count,
                                             long long* st) {
  const int lane = threadIdx.x & 31;
  const long long prefix = st[sPrefix];
  const long long sum_below = st[sSumBelow];
  const long long n_above = st[sNAbove];
  const long long hcap = st[sHcap];
  // The lane's bins are read twice rather than held: 16 int64 in
  // registers would crowd the phase out of its 64.
  long long lc = 0, ls = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    lc += c[8 * lane + k];
    ls += c[kBins + 8 * lane + k];
  }
  const long long pc = warp_incl_scan(lc);
  const long long ps = warp_incl_scan(ls);
  const long long tot = __shfl_sync(kFull, pc, 31);
  long long below_c = pc - lc;
  long long below_s = ps - ls;
  int best = -1;
  long long best_f = 0, best_below = 0, best_above = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int d = 8 * lane + k;
    const long long lv = prefix + ((long long)d << s);
    const long long ge = n_above + tot - below_c;  // caps >= lv
    const long long f = sum_below + below_s + lv * ge;
    const long long ck = c[d];
    if (lv <= hcap && f <= count) {
      best = d;
      best_f = f;
      best_below = sum_below + below_s;
      best_above = ge - ck;
    }
    below_c += ck;
    below_s += c[kBins + d];
  }
  const int dstar = __reduce_max_sync(kFull, best);  // edge 0 is valid
  const int src = dstar >> 3;
  const long long nb = __shfl_sync(kFull, best_below, src);
  const long long na = __shfl_sync(kFull, best_above, src);
  const long long f = __shfl_sync(kFull, best_f, src);
  __syncwarp();  // every lane has read the state
  if (lane == 0) {
    st[sPrefix] = prefix + ((long long)dstar << s);
    st[sBaseSum] = f;
    st[sSumBelow] = nb;
    st[sNAbove] = na;
  }
}

// Warp 0: the radix step of waterfill.cu from the combined histogram of a
// pass at shift s, for an eval whose threshold is still open.
__device__ __forceinline__ void decide_radix(const long long* c, int s,
                                             long long* st) {
  const int lane = threadIdx.x & 31;
  const long long remaining = st[sRemaining];
  const long long k_above = st[sKAbove];
  const long long tprefix = st[sTPrefix];
  long long lc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) lc += c[8 * lane + k];
  const long long pc = warp_incl_scan(lc);
  const long long tot = __shfl_sync(kFull, pc, 31);
  if (s == 24 && remaining >= tot) {  // every candidate is selected
    __syncwarp();
    if (lane == 0) {
      st[sDone] = 1;
      st[sTie] = 0;
      st[sTEff] = 0;
      st[sFill] = 0;
      st[sNSel] = tot;
    }
    return;
  }
  long long gt = k_above + tot - pc;  // keys above this lane's bins
  int best = -1;
  long long best_gt = 0, best_c = 0;
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    const int d = 8 * lane + k;
    const long long ck = c[d];
    if (gt < remaining && remaining <= gt + ck) {
      best = d;
      best_gt = gt;
      best_c = ck;
    }
    gt += ck;
  }
  const int dstar = __reduce_max_sync(kFull, best);
  const int src = dstar >> 3;
  const long long ka = __shfl_sync(kFull, best_gt, src);
  const long long n_at = __shfl_sync(kFull, best_c, src);
  const long long tp = tprefix | ((long long)dstar << s);
  __syncwarp();
  if (lane != 0) return;
  st[sKAbove] = ka;
  if (s == 0) {
    // tp is the remaining-th largest key; fill >= 1 take it.
    const long long f = remaining - ka;
    st[sDone] = 1;
    st[sTie] = f < n_at;
    st[sTEff] = f < n_at ? tp : tp - 1;
    st[sFill] = f;
    st[sNSel] = remaining;
    st[sDstar] = dstar;
  } else {
    st[sTPrefix] = tp;
  }
}

// One instantiation a phase: each compiles only its own pass and decision.
template <int phase>
__global__ void __launch_bounds__(kShardThreads, 1)
shard_kernel(Args a, int shift) {
  __shared__ __align__(16) unsigned h_cnt[kBins];
  __shared__ __align__(16) unsigned long long h_sum[kBins];
  __shared__ unsigned tie_cnt[kTieIters][kShardWarps];
  __shared__ Divisor divs[5];
  __shared__ long long st[kState];
  __shared__ long long block_off;

  const int b = blockIdx.x;
  const int n = a.n;
  const size_t off = (size_t)b * (size_t)n;
  int* cap = a.cap + off;
  unsigned* key = a.key + off;
  const long long* comb = a.comb ? a.comb + (size_t)b * kPartWidth : nullptr;
  long long* part = a.part + (size_t)b * kPartWidth;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int iters = (n + kShardThreads - 1) / kShardThreads;
  const int4 ask = a.ask[b];
  const int count = a.count[b];

  for (int t = threadIdx.x; t < kBins; t += kShardThreads) {
    h_cnt[t] = 0;
    h_sum[t] = 0;
  }
  if (threadIdx.x < kState) {
    st[threadIdx.x] =
        phase == kCaps ? 0 : a.state[(size_t)b * kState + threadIdx.x];
  }
  __syncthreads();

  // -- the decision of the last round, the same on every shard -----------
  if (warp == 0) {
    if (phase == kLevelFirst) {
      if (lane == 0) {
        st[sHcap] = min((long long)count, comb[0]);
        st[sPrefix] = 0;
        st[sSumBelow] = 0;
        st[sNAbove] = 0;
        st[sBaseSum] = 0;
      }
    } else if (phase == kLevel) {
      decide_level(comb, shift + 8, count, st);
    } else if (phase == kKeys) {
      decide_level(comb, 0, count, st);
      __syncwarp();
      if (lane == 0) {
        const long long rem = (long long)count - st[sBaseSum];
        st[sLevel] = st[sPrefix];
        st[sRemaining] = rem;
        st[sKAbove] = 0;
        st[sTPrefix] = 0;
        st[sDone] = rem <= 0;
        st[sTie] = 0;
        st[sTEff] = 0;
        st[sFill] = 0;
        st[sNSel] = 0;
        st[sDstar] = 0;
      }
    } else if (phase == kRadix || phase == kBoundary) {
      if (!st[sDone]) decide_radix(comb, phase == kRadix ? shift + 8 : 0, st);
    } else if (phase == kCounts) {
      long long v = 0;
      for (int j = lane; j < a.index; j += 32) v += comb[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      if (lane == 0) block_off = v;
    }
  }
  if (phase == kCaps && threadIdx.x < 5) {
    const int t = threadIdx.x;
    const int d = t == 0 ? ask.x : t == 1 ? ask.y : t == 2 ? ask.z
                : t == 3 ? ask.w : a.bw_ask[b];
    divs[t] = make_divisor(max(d, 1));
  }
  __syncthreads();

  // -- this pass over the shard's rows ------------------------------------
  if (phase == kCaps) {
    const int bw_ask = a.bw_ask[b];
    const int av_ask[4] = {ask.x, ask.y, ask.z, ask.w};
    const Divisor dv[5] = {divs[0], divs[1], divs[2], divs[3], divs[4]};
    const int4* total = a.total + off;
    const int4* used = a.used + off;
    const int* bw_avail = a.bw_avail + off;
    const int* bw_used = a.bw_used + off;
    const int* job_count = a.job_count + off;
    const int* tg_count = a.tg_count + off;
    const unsigned char* eligible = a.eligible + off;
    int local_max = 0;
    for (int j = 0; j < iters; ++j) {
      const int i = threadIdx.x + kShardThreads * j;
      if (i >= n) break;
      const int4 t = total[i];
      const int4 u = used[i];
      const int av[4] = {t.x - u.x, t.y - u.y, t.z - u.z, t.w - u.w};
      bool nonneg = true;
      int c = kBig;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        nonneg = nonneg && av[d] >= 0;
        if (av_ask[d] > 0) c = min(c, divide(av[d], dv[d]));
      }
      const int bw_free = bw_avail[i] - bw_used[i];
      nonneg = nonneg && bw_free >= 0;
      if (bw_ask > 0) c = min(c, divide(bw_free, dv[4]));
      if (a.job_distinct) c = min(c, job_count[i] == 0 ? 1 : 0);
      if (a.tg_distinct) c = min(c, tg_count[i] == 0 ? 1 : 0);
      c = (eligible[i] && nonneg) ? min(max(c, 0), count) : 0;
      cap[i] = c;
      local_max = max(local_max, c);
    }
    local_max = __reduce_max_sync(kFull, local_max);
    if (lane == 0) atomicMax(&h_cnt[0], (unsigned)local_max);
  } else if (phase == kLevelFirst || phase == kLevel) {
    level_hist<true, kShardThreads>(cap, n, iters, st[sPrefix], shift,
                                     h_cnt, h_sum);
  } else if (phase == kKeys) {
    if (st[sRemaining] > 0) {
      // cap > level implies the fit test (waterfill.cu's key pass), so a
      // candidate reads only what its score needs.
      const int level = (int)st[sLevel];
      const float penalty = a.penalty[b];
      const int4* used = a.used + off;
      const float2* sched_cap = a.sched_cap + off;
      const int* job_count = a.job_count + off;
      RunHist<false> top(h_cnt, nullptr);
      for (int j = 0; j < iters; ++j) {
        const int i = threadIdx.x + kShardThreads * j;
        unsigned k = 0;
        if (i < n) {
          if (cap[i] > level) {
            const int2 u = *reinterpret_cast<const int2*>(&used[i]);
            const float2 sc = sched_cap[i];
            k = monotone_key(bestfit_score(
                u.x + level * ask.x + ask.x, u.y + level * ask.y + ask.y,
                sc.x, sc.y, penalty, job_count[i] + level));
          }
          key[i] = k;
        }
        top.add(k ? (int)(k >> 24) : -1, 0u);
      }
      top.flush();
    }
  } else if (phase == kRadix) {
    if (!st[sDone]) {
      const unsigned tprefix = (unsigned)st[sTPrefix];
      RunHist<false> h(h_cnt, nullptr);
      for (int j = 0; j < iters; ++j) {
        const int i = threadIdx.x + kShardThreads * j;
        int bin = -1;
        if (i < n) {
          const unsigned k = key[i];
          if (k != 0u && (k >> (shift + 8)) == (tprefix >> (shift + 8)))
            bin = (int)((k >> shift) & 0xffu);
        }
        h.add(bin, 0u);
      }
      h.flush();
    }
  } else if (phase == kCounts) {
    // Base + selected; the tie fill in global node order: shard `index`
    // starts after the boundary rows of the shards before it (block_off,
    // from the boundary round's all-gather), then (iteration, warp, lane)
    // as in waterfill.cu.
    const long long remaining = st[sRemaining];
    const int level = (int)st[sLevel];
    const long long t_eff = st[sTEff];
    const bool tie = st[sTie] != 0;
    const long long fill = st[sFill];
    const unsigned thresh = (unsigned)t_eff;
    int* counts_out = a.counts_out + off;
    const unsigned lt_mask = (1u << lane) - 1u;
    long long order = block_off;
    for (int j0 = 0; j0 < iters; j0 += kTieIters) {
      const int j1 = min(iters, j0 + kTieIters);
      if (tie) {
        for (int j = j0; j < j1; ++j) {
          const int i = threadIdx.x + kShardThreads * j;
          const unsigned bal =
              __ballot_sync(kFull, i < n && key[i] == thresh);
          if (lane == 0) tie_cnt[j - j0][warp] = __popc(bal);
        }
        __syncthreads();
      }
      for (int j = j0; j < j1; ++j) {
        const int i = threadIdx.x + kShardThreads * j;
        const bool valid = i < n;
        const unsigned k = (valid && remaining > 0) ? key[i] : 0u;
        int sel = remaining > 0 && (long long)k > t_eff;
        if (tie) {
          const unsigned v = lane < kShardWarps ? tie_cnt[j - j0][lane] : 0u;
          const unsigned lower =
              __reduce_add_sync(kFull, lane < warp ? v : 0u);
          const unsigned all = __reduce_add_sync(kFull, v);
          const bool at = valid && k == thresh;
          const unsigned bal = __ballot_sync(kFull, at);
          if (at) sel = order + lower + __popc(bal & lt_mask) < fill;
          order += all;
        }
        if (valid) counts_out[i] = min(cap[i], level) + sel;
      }
      if (tie) __syncthreads();  // the next chunk rewrites tie_cnt
    }
    if (threadIdx.x == 0) {
      a.remaining_out[b] = (int)(remaining - st[sNSel]);
    }
  }
  __syncthreads();

  // -- this pass's partial and the state for the next --------------------
  if (phase == kBoundary) {
    const long long own =
        st[sTie] ? a.own_prev[(size_t)b * kPartWidth + st[sDstar]] : 0;
    for (int t = threadIdx.x; t < kPartWidth; t += kShardThreads) {
      part[t] = t == a.index ? own : 0;
    }
  } else if (phase != kCounts) {
    for (int t = threadIdx.x; t < kBins; t += kShardThreads) {
      part[t] = phase == kCaps && t > 0 ? 0 : (long long)h_cnt[t];
      part[kBins + t] = (long long)h_sum[t];
    }
  }
  if (threadIdx.x < kState) {
    a.state[(size_t)b * kState + threadIdx.x] = st[threadIdx.x];
  }
}

}  // namespace

// One pass of one node shard over its B evals ([B, n] rows each). `comb`
// is the combined partial of the last round ([B, 512] int64; unread by the
// caps pass), `own_prev` this shard's own partial of the last round (read
// by the boundary pass), `part` this pass's partial ([B, 512] int64;
// unwritten by the counts pass). `index` is the shard's position in the
// global node order, `n_shards` the number of shards.
extern "C" int nomad_waterfill_shard(
    const void* total, const void* used, const void* sched_cap,
    const void* job_count, const void* tg_count, const void* bw_avail,
    const void* bw_used, const void* eligible, const void* ask,
    const void* bw_ask, const void* count, const void* penalty, void* cap,
    void* key, void* state, const void* comb, const void* own_prev,
    void* part, void* counts_out, void* remaining_out, int phase, int shift,
    int batch, int n, int index, int n_shards, int job_distinct,
    int tg_distinct, void* stream) {
  if (batch <= 0 || n <= 0 || phase < kCaps || phase > kCounts ||
      n_shards < 1 || n_shards > kPartWidth || index < 0 ||
      index >= n_shards || shift < 0 || shift > 24 ||
      (phase != kCaps && comb == nullptr) ||
      (phase == kBoundary && own_prev == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.total = (const int4*)total;
  a.used = (const int4*)used;
  a.sched_cap = (const float2*)sched_cap;
  a.job_count = (const int*)job_count;
  a.tg_count = (const int*)tg_count;
  a.bw_avail = (const int*)bw_avail;
  a.bw_used = (const int*)bw_used;
  a.eligible = (const unsigned char*)eligible;
  a.ask = (const int4*)ask;
  a.bw_ask = (const int*)bw_ask;
  a.count = (const int*)count;
  a.penalty = (const float*)penalty;
  a.cap = (int*)cap;
  a.key = (unsigned*)key;
  a.state = (long long*)state;
  a.comb = (const long long*)comb;
  a.own_prev = (const long long*)own_prev;
  a.part = (long long*)part;
  a.counts_out = (int*)counts_out;
  a.remaining_out = (int*)remaining_out;
  a.n = n;
  a.index = index;
  a.job_distinct = job_distinct;
  a.tg_distinct = tg_distinct;
  const dim3 grid((unsigned)batch);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (phase) {
    case kCaps:
      shard_kernel<kCaps><<<grid, kShardThreads, 0, s>>>(a, shift);
      break;
    case kLevelFirst:
      shard_kernel<kLevelFirst><<<grid, kShardThreads, 0, s>>>(a, shift);
      break;
    case kLevel:
      shard_kernel<kLevel><<<grid, kShardThreads, 0, s>>>(a, shift);
      break;
    case kKeys:
      shard_kernel<kKeys><<<grid, kShardThreads, 0, s>>>(a, shift);
      break;
    case kRadix:
      shard_kernel<kRadix><<<grid, kShardThreads, 0, s>>>(a, shift);
      break;
    case kBoundary:
      shard_kernel<kBoundary><<<grid, kShardThreads, 0, s>>>(a, shift);
      break;
    default:
      shard_kernel<kCounts><<<grid, kShardThreads, 0, s>>>(a, shift);
  }
  return (int)cudaGetLastError();
}
