// Node-sharded water-fill for Hopper: a solve whose node shards are each
// their own tensor, by one of two routes that ops/waterfill.py
// shard_route picks from the shards' devices and shapes before any launch.
//
// Replaces what XLA's SPMD partitioner makes of nomad_tpu/ops/binpack.py
// solve_waterfill (:269-372) under node-axis shardings
// (nomad_tpu/parallel/mesh.py shard_waterfill_args and
// shard_waterfill_batch_args, reached from nomad_tpu/ops/coalesce.py
// :543-548 and :618-626, and nomad_tpu/parallel/dcn.py run_dcn_solve;
// with a mesh, nomad_tpu skips its Pallas kernel). nomad_tpu's sharded
// solve takes both searches by bisection, each step a cross-shard psum.
//
// 1. Every shard of the solve on this device (a mesh of one card, a group
//    of one process), at most kMaxCluster blocks an eval: ONE launch,
//    solve_kernel. One thread-block cluster an eval, as in waterfill.cu:
//    a shard of n_s rows is spread over bps = cluster_size(n_s) blocks
//    under waterfill.cu's rule, rank r of the cluster holds part r % bps
//    of shard r / bps, read from that shard's own tensor (the shards'
//    pointers are in the kernel's parameters), and every combine is in
//    distributed shared memory under cluster.sync(). The body is
//    waterfill.cu's (solve_cluster, waterfill_cluster.cuh); ranks hold
//    consecutive rows in node order, so the tie fill keeps global node
//    order and the output is the unsharded kernel's bit for bit. Caps
//    and keys stay in shared memory up to 16,384 rows a block; above, in
//    a [B, N] device scratch.
//
// 2. Shards on other devices or in other processes (or more than
//    kMaxCluster blocks an eval): the per-pass protocol, pass_kernel. A
//    pass is one launch for all of this device's shards of the solve (at
//    most kGroupShards, consecutive in node order): grid = B x G blocks of
//    512 threads, G = shards x bps, so a shard's rows are spread over up
//    to 8 blocks. Each block adds its histogram (or max) into the
//    device's one partial row per eval ([B, 512] int64) with integer
//    atomics, so the caller's seam (parallel/mesh.py MeshReduce across a
//    mesh's cards, parallel/dcn.py DistReduce across processes) sees one
//    already-combined row per device. Warp 0 of every block of the next
//    pass takes the same decision from the combined row. Between passes
//    the caps and keys live in [B, S, n_s] scratch and the decisions in
//    a double-buffered [2, B, 16] state (read one, written by block 0 to
//    the other, so no block reads a state another block of its pass has
//    already overwritten). The partial rows rotate over three buffers:
//    pass p adds into buffer p % 3 while block 0 zeroes buffer (p + 1) %
//    3, which no one reads in pass p (its combine was read in pass p - 1).
//    The boundary round is an all-gather written as a sum: this device's
//    boundary count at the threshold (the sum of its blocks' last radix
//    counts, kept in [B, G, 256]) in the column of its first shard, zeros
//    elsewhere; a block's tie fill starts after the columns before its
//    device's and the boundary rows of the device's blocks before it.
//
//    Rounds a solve, one launch a device and one combine each: 1 (max cap)
//    + ceil(bits(max count) / 8), at least 1 (level) + 4 (threshold; the
//    first radix pass is folded into the key pass) + 1 (boundary prefix);
//    then the counts pass, with no combine. The level's passes start from
//    the largest count of the batch, which the host knows: a top pass
//    above an eval's own needs only decides zero digits.
//
// What bounds it on the H100: neither bytes nor operations. Route 1 is the
// unsharded kernel's chain of 2 to 10 cluster barriers, with the rows
// spread over up to 8 SMs. Route 2 reads each node's inputs once (the caps
// pass) and a candidate's once more (the key pass), and every other pass
// 4 or 8 bytes a row of scratch; its time is the chain of dependent
// launches and combines, 9 rounds at the headline's 100,000 tasks, which
// this design keeps to one launch a device a round and one ctypes call a
// pass (the wrapper binds every pointer once a solve, in a word table).
//
// Every decision is on integers, so the order in which the partials are
// added (atomics, the seam) cannot change an output, and the scores come
// from the same bestfit_score as the unsharded kernel
// (waterfill_common.cuh), built with --fmad=false: a sharded solve equals
// the unsharded kernel bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "waterfill_cluster.cuh"

namespace {

constexpr int kPartWidth = 512;   // ops/waterfill.py PART_WIDTH
constexpr int kGroupShards = 16;  // ops/waterfill.py GROUP_SHARDS
// 512 threads a block in the pass kernel, not waterfill.cu's 1024: a
// phase's decision and histogram pass need more than the 64 registers a
// thread of a 1024-thread block has.
constexpr int kShardThreads = 512;
constexpr int kShardWarps = kShardThreads / 32;
constexpr int kState = 16;  // ops/waterfill.py N_STATE

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

// A solve's binding on one device, built once a solve by the wrapper
// (ops/waterfill.py _WORDS): int64 words in this order.
constexpr int kShardPtrs = 9;  // a shard's 8 inputs, then its counts
enum Word {
  wShards = 0,  // kGroupShards x kShardPtrs
  wAsk = wShards + kGroupShards * kShardPtrs,  // [B, 4] int32
  wBwAsk,       // [B] int32
  wCount,       // [B] int32
  wPenalty,     // [B] float32
  wCap,         // [B, S, n_s] int32 (route 1: only above kSmemRows a block)
  wKey,         // [B, S, n_s] int32 (likewise)
  wState,       // route 2: [2, B, 16] int64
  wParts,       // route 2: [3, B, 512] int64, zero at the first pass
  wBlockHist,   // route 2: [B, G, 256] int32
  wRemaining,   // [B] int32
  wStream,
  wBatch,
  wRows,        // n_s, every shard's rows
  wGroup,       // S: the shards bound here, consecutive in node order
  wColumn,      // the first one's index in the solve's node order
  wNShards,     // the solve's shards, on every device
  wJobDistinct,
  wTgDistinct,
  wDevice,
  kWords
};

// The shards' pointers, by value in the kernels' parameters.
struct ShardTable {
  const int4* total[kGroupShards];
  const int4* used[kGroupShards];
  const float2* sched_cap[kGroupShards];
  const int* job_count[kGroupShards];
  const int* tg_count[kGroupShards];
  const int* bw_avail[kGroupShards];
  const int* bw_used[kGroupShards];
  const unsigned char* eligible[kGroupShards];
  int* counts_out[kGroupShards];
};

struct Small {
  const int4* ask;
  const int* bw_ask;
  const int* count;
  const float* penalty;
};

struct PassArgs {
  ShardTable t;
  Small sm;
  int* cap;
  unsigned* key;
  long long* state;
  long long* parts;
  unsigned* block_hist;
  int* remaining_out;
  int batch;
  int n_s;
  int group;
  int bps;
  int m;
  int column;
  int job_distinct;
  int tg_distinct;
};

// -- route 1: the solve in one launch ---------------------------------------

// Grid = B clusters of ncl = S x bps blocks; rank r holds part r % bps of
// shard r / bps.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
solve_kernel(const __grid_constant__ ShardTable t, Small sm, int* cap_scratch,
             unsigned* key_scratch, int* remaining_out, int n_s, int ncl,
             int bps, int m, int job_distinct, int tg_distinct) {
  extern __shared__ int smem_rows[];  // kSmem: [m] caps, then [m] keys
  // The block's input pointers sit in shared memory, read where a pass
  // needs them: picked from the table by a computed shard index, they
  // could not be rematerialised from the parameters, and held in
  // registers across the passes they spill.
  __shared__ BlockRows r;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / ncl;
  const int q = rank / bps;
  const int row0 = (rank % bps) * m;
  const size_t off = (size_t)b * (size_t)n_s + (size_t)row0;
  if (threadIdx.x == 0) {
    r = {t.total[q] + off, t.used[q] + off, t.sched_cap[q] + off,
         t.job_count[q] + off, t.tg_count[q] + off, t.bw_avail[q] + off,
         t.bw_used[q] + off, t.eligible[q] + off, t.counts_out[q] + off,
         remaining_out + b};
  }
  __syncthreads();
  const size_t soff = ((size_t)b * (ncl / bps) + q) * (size_t)n_s + row0;
  solve_cluster(
      cluster, ncl, rank, r, kSmem ? smem_rows : cap_scratch + soff,
      kSmem ? reinterpret_cast<unsigned*>(smem_rows + m) : key_scratch + soff,
      max(0, min(m, n_s - row0)), m, sm.ask[b], sm.bw_ask[b], sm.count[b],
      sm.penalty[b], job_distinct, tg_distinct);
}

// -- route 2: the passes ----------------------------------------------------

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
  // registers would crowd the phase out of its registers.
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

// One pass of this device's shards; one instantiation a phase, each
// compiling only its own pass and decision. Grid = B x G blocks, block g
// of an eval holding part g % bps of shard g / bps.
template <int phase>
__global__ void __launch_bounds__(kShardThreads, 1)
pass_kernel(const __grid_constant__ PassArgs a, const long long* comb_all,
            int shift, int turn) {
  __shared__ __align__(16) unsigned h_cnt[kBins];
  __shared__ __align__(16) unsigned long long h_sum[kBins];
  __shared__ unsigned tie_cnt[kTieIters][kShardWarps];
  __shared__ Divisor divs[5];
  __shared__ long long st[kState];
  __shared__ long long block_off;

  const int blocks = a.group * a.bps;  // an eval's blocks on this device
  const int b = blockIdx.x / blocks;
  const int g = blockIdx.x % blocks;   // in node order
  const int q = g / a.bps;
  const int row0 = (g % a.bps) * a.m;
  const int n = max(0, min(a.m, a.n_s - row0));  // this block's rows
  const size_t off = (size_t)b * (size_t)a.n_s + (size_t)row0;
  const size_t soff = ((size_t)b * a.group + q) * (size_t)a.n_s + row0;
  int* cap = a.cap + soff;
  unsigned* key = a.key + soff;
  const size_t nb = (size_t)a.batch;
  const long long* st_in = a.state + ((size_t)(turn & 1) * nb + b) * kState;
  long long* st_out =
      a.state + ((size_t)((turn + 1) & 1) * nb + b) * kState;
  unsigned long long* part = reinterpret_cast<unsigned long long*>(
      a.parts + ((size_t)(turn % 3) * nb + b) * kPartWidth);
  long long* next = a.parts + ((size_t)((turn + 1) % 3) * nb + b) * kPartWidth;
  const long long* comb =
      comb_all ? comb_all + (size_t)b * kPartWidth : nullptr;
  unsigned* hist = a.block_hist + (size_t)b * blocks * kBins;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int iters = (n + kShardThreads - 1) / kShardThreads;
  const int4 ask = a.sm.ask[b];
  const int count = a.sm.count[b];

  for (int t = threadIdx.x; t < kBins; t += kShardThreads) {
    h_cnt[t] = 0;
    h_sum[t] = 0;
  }
  if (threadIdx.x < kState) {
    st[threadIdx.x] = phase == kCaps ? 0 : st_in[threadIdx.x];
  }
  __syncthreads();

  // -- the decision of the last round, the same on every block -----------
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
      // Boundary rows before this block: the devices before this one (the
      // all-gather's columns), then this device's blocks before it.
      long long v = 0;
      for (int j = lane; j < a.column; j += 32) v += comb[j];
      if (st[sTie]) {
        const int d = (int)st[sDstar];
        for (int h = lane; h < g; h += 32) v += hist[h * kBins + d];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      if (lane == 0) block_off = v;
    }
  }
  if (phase == kCaps && threadIdx.x < 5) {
    const int t = threadIdx.x;
    const int d = t == 0 ? ask.x : t == 1 ? ask.y : t == 2 ? ask.z
                : t == 3 ? ask.w : a.sm.bw_ask[b];
    divs[t] = make_divisor(max(d, 1));
  }
  __syncthreads();

  // -- this pass over the block's rows -------------------------------------
  if (phase == kCaps) {
    const int bw_ask = a.sm.bw_ask[b];
    const int av_ask[4] = {ask.x, ask.y, ask.z, ask.w};
    const Divisor dv[5] = {divs[0], divs[1], divs[2], divs[3], divs[4]};
    const int4* __restrict__ total = a.t.total[q] + off;
    const int4* __restrict__ used = a.t.used[q] + off;
    const int* __restrict__ bw_avail = a.t.bw_avail[q] + off;
    const int* __restrict__ bw_used = a.t.bw_used[q] + off;
    const int* __restrict__ job_count = a.t.job_count[q] + off;
    const int* __restrict__ tg_count = a.t.tg_count[q] + off;
    const unsigned char* __restrict__ eligible = a.t.eligible[q] + off;
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
      const float penalty = a.sm.penalty[b];
      const int4* __restrict__ used = a.t.used[q] + off;
      const float2* __restrict__ sched_cap = a.t.sched_cap[q] + off;
      const int* __restrict__ job_count = a.t.job_count[q] + off;
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
    // Base + selected; the tie fill in global node order: this block
    // starts after the boundary rows before it (block_off), then
    // (iteration, warp, lane) as in waterfill.cu.
    const long long remaining = st[sRemaining];
    const int level = (int)st[sLevel];
    const long long t_eff = st[sTEff];
    const bool tie = st[sTie] != 0;
    const long long fill = st[sFill];
    const unsigned thresh = (unsigned)t_eff;
    int* __restrict__ counts_out = a.t.counts_out[q] + off;
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
    if (g == 0 && threadIdx.x == 0) {
      a.remaining_out[b] = (int)(remaining - st[sNSel]);
    }
  }
  __syncthreads();

  // -- this pass's partial, the next pass's zeroed row and state ----------
  if (phase == kCaps) {
    if (threadIdx.x == 0 && h_cnt[0] != 0u)
      atomicMax(&part[0], (unsigned long long)h_cnt[0]);
  } else if (phase == kBoundary) {
    // The device's boundary rows at the threshold, in its column.
    if (g == 0 && threadIdx.x == 0 && st[sTie]) {
      const int d = (int)st[sDstar];
      unsigned long long own = 0;
      for (int h = 0; h < blocks; ++h) own += hist[h * kBins + d];
      part[a.column] = own;
    }
  } else if (phase != kCounts) {
    for (int t = threadIdx.x; t < kBins; t += kShardThreads) {
      const unsigned c = h_cnt[t];
      if (c != 0u) atomicAdd(&part[t], (unsigned long long)c);
      if (h_sum[t] != 0ull) atomicAdd(&part[kBins + t], h_sum[t]);
      // The last radix pass's counts of each block: the boundary's.
      if (phase == kRadix && shift == 0) hist[g * kBins + t] = c;
    }
  }
  if (g == 0) {
    for (int t = threadIdx.x; t < kPartWidth; t += kShardThreads) next[t] = 0;
    if (threadIdx.x < kState) st_out[threadIdx.x] = st[threadIdx.x];
  }
}

// The calling thread on `dev` for the launch, restored after.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int dev) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != dev) {
      err = cudaSetDevice(dev);
      prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

template <typename T>
T word_ptr(const long long* w, int i) {
  return reinterpret_cast<T>(static_cast<intptr_t>(w[i]));
}

ShardTable shard_table(const long long* w, int group) {
  ShardTable t = {};
  for (int q = 0; q < group; ++q) {
    const long long* s = w + wShards + kShardPtrs * q;
    t.total[q] = word_ptr<const int4*>(s, 0);
    t.used[q] = word_ptr<const int4*>(s, 1);
    t.sched_cap[q] = word_ptr<const float2*>(s, 2);
    t.job_count[q] = word_ptr<const int*>(s, 3);
    t.tg_count[q] = word_ptr<const int*>(s, 4);
    t.bw_avail[q] = word_ptr<const int*>(s, 5);
    t.bw_used[q] = word_ptr<const int*>(s, 6);
    t.eligible[q] = word_ptr<const unsigned char*>(s, 7);
    t.counts_out[q] = word_ptr<int*>(s, 8);
  }
  return t;
}

Small small_inputs(const long long* w) {
  return {word_ptr<const int4*>(w, wAsk), word_ptr<const int*>(w, wBwAsk),
          word_ptr<const int*>(w, wCount),
          word_ptr<const float*>(w, wPenalty)};
}

template <bool kSmem>
cudaError_t launch_solve(const long long* w, int bps, int m) {
  // Once per device and variant (the caller has set w[wDevice] current):
  // the shared memory opt-in and the residency check of each cluster size.
  static std::atomic<int> attr[kMaxDevices];
  if (kSmem) {
    const cudaError_t err = smem_opt_in(attr, solve_kernel<true>,
                                        2 * kSmemRows * (int)sizeof(int));
    if (err != cudaSuccess) return err;
  }
  static std::atomic<int> fits[kMaxCluster + 1][kMaxDevices];
  const int group = (int)w[wGroup];
  const int ncl = group * bps;
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = (unsigned)ncl;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(w[wBatch] * ncl));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem ? 2 * (size_t)m * sizeof(int) : 0;
  cfg.stream = word_ptr<cudaStream_t>(w, wStream);
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  const cudaError_t fit =
      cluster_fits(solve_kernel<kSmem>, fits, cfg, ncl,
                   kSmem ? 2 * kSmemRows * sizeof(int) : 0);
  if (fit != cudaSuccess) return fit;
  return cudaLaunchKernelEx(
      &cfg, solve_kernel<kSmem>, shard_table(w, group), small_inputs(w),
      word_ptr<int*>(w, wCap), word_ptr<unsigned*>(w, wKey),
      word_ptr<int*>(w, wRemaining), (int)w[wRows], ncl, bps, m,
      (int)w[wJobDistinct], (int)w[wTgDistinct]);
}

}  // namespace

// The length of the word table the entries read (the wrapper checks it).
extern "C" int nomad_waterfill_shard_words(void) { return kWords; }

// Route 1: the whole solve, every shard on this device, in one launch.
// Needs column 0, every shard of the solve bound (group == n_shards) and
// group x cluster_size(n_s) <= kMaxCluster blocks an eval; cap and key
// scratch only where a block holds more than kSmemRows rows.
extern "C" int nomad_waterfill_shard_solve(const long long* w) {
  const int group = (int)w[wGroup];
  const int n_s = (int)w[wRows];
  if (w[wBatch] <= 0 || n_s <= 0 || group < 1 || group > kGroupShards ||
      w[wColumn] != 0 || w[wNShards] != group)
    return (int)cudaErrorInvalidValue;
  const int bps = cluster_size(n_s);
  if (group * bps > kMaxCluster) return (int)cudaErrorInvalidValue;
  const int m = (n_s + bps - 1) / bps;
  const bool smem = m <= kSmemRows;
  if (!smem && (w[wCap] == 0 || w[wKey] == 0))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard((int)w[wDevice]);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaError_t err =
      smem ? launch_solve<true>(w, bps, m) : launch_solve<false>(w, bps, m);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Route 2: one pass of this device's shards over their B evals. `comb`:
// the combined partial of the last round ([B, 512] int64; unread by the
// caps pass); `turn`: the pass's index in the solve (it picks the state
// and partial buffers). The pass's partial is parts[turn % 3].
extern "C" int nomad_waterfill_shard_pass(const long long* w,
                                          const void* comb, int phase,
                                          int shift, int turn) {
  const int group = (int)w[wGroup];
  const int n_s = (int)w[wRows];
  if (w[wBatch] <= 0 || n_s <= 0 || group < 1 || group > kGroupShards ||
      w[wNShards] < 1 || w[wNShards] > kPartWidth || w[wColumn] < 0 ||
      w[wColumn] + group > w[wNShards] || phase < kCaps ||
      phase > kCounts || shift < 0 || shift > 24 || turn < 0 ||
      (phase != kCaps && comb == nullptr))
    return (int)cudaErrorInvalidValue;
  const int bps = cluster_size(n_s);
  PassArgs a;
  a.t = shard_table(w, group);
  a.sm = small_inputs(w);
  a.cap = word_ptr<int*>(w, wCap);
  a.key = word_ptr<unsigned*>(w, wKey);
  a.state = word_ptr<long long*>(w, wState);
  a.parts = word_ptr<long long*>(w, wParts);
  a.block_hist = word_ptr<unsigned*>(w, wBlockHist);
  a.remaining_out = word_ptr<int*>(w, wRemaining);
  a.batch = (int)w[wBatch];
  a.n_s = n_s;
  a.group = group;
  a.bps = bps;
  a.m = (n_s + bps - 1) / bps;
  a.column = (int)w[wColumn];
  a.job_distinct = (int)w[wJobDistinct];
  a.tg_distinct = (int)w[wTgDistinct];
  const long long* c = (const long long*)comb;
  DeviceGuard guard((int)w[wDevice]);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const dim3 grid((unsigned)(a.batch * group * bps));
  const cudaStream_t s = word_ptr<cudaStream_t>(w, wStream);
  switch (phase) {
    case kCaps:
      pass_kernel<kCaps><<<grid, kShardThreads, 0, s>>>(a, c, shift, turn);
      break;
    case kLevelFirst:
      pass_kernel<kLevelFirst><<<grid, kShardThreads, 0, s>>>(a, c, shift,
                                                              turn);
      break;
    case kLevel:
      pass_kernel<kLevel><<<grid, kShardThreads, 0, s>>>(a, c, shift, turn);
      break;
    case kKeys:
      pass_kernel<kKeys><<<grid, kShardThreads, 0, s>>>(a, c, shift, turn);
      break;
    case kRadix:
      pass_kernel<kRadix><<<grid, kShardThreads, 0, s>>>(a, c, shift, turn);
      break;
    case kBoundary:
      pass_kernel<kBoundary><<<grid, kShardThreads, 0, s>>>(a, c, shift,
                                                            turn);
      break;
    default:
      pass_kernel<kCounts><<<grid, kShardThreads, 0, s>>>(a, c, shift, turn);
  }
  return (int)cudaGetLastError();
}
