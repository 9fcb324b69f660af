// The closed-form water-fill of one eval by one thread-block cluster: the
// body of the unsharded kernel (waterfill.cu) and of the node-shard
// solve's single launch (waterfill_shard.cu). The two kernels differ only
// in where a block's rows come from: contiguous rows of one [B, N] tensor,
// or a part of one node shard's own tensor. See waterfill.cu for the
// design; every decision is on integers combined across the cluster, so
// how the rows are cut over the blocks cannot change an output.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "device_once.cuh"
#include "waterfill_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemRows = 16384;  // rows a block keeps in shared memory
constexpr int kMaxCluster = 8;    // the portable cluster limit

// Blocks an eval (or a node shard) of n rows is spread over: the next
// power of two of n / kSmemRows, at least 1, at most kMaxCluster
// (ops/waterfill.py shard_blocks mirrors it).
int cluster_size(int n) {
  int ncl = 1;
  while (ncl < kMaxCluster && (long long)ncl * kSmemRows < n) ncl *= 2;
  return ncl;
}

// Rank q's copy of this block's shared variable at p: through distributed
// shared memory in a cluster, directly in a lone block.
template <typename T>
__device__ __forceinline__ T* rank_ptr(cg::cluster_group& cluster, int ncl,
                                       T* p, int q) {
  return ncl > 1 ? cluster.map_shared_rank(p, q) : p;
}

// Warp 0: the cluster's histogram, every rank's partial added up, into
// this block's ccnt / csum. Lane l owns bins [8 l, 8 l + 8).
template <bool kSum>
__device__ __forceinline__ void combine(cg::cluster_group& cluster,
                                        int ncl, unsigned* cnt,
                                        unsigned long long* sum,
                                        unsigned* ccnt,
                                        unsigned long long* csum) {
  const int lane = threadIdx.x & 31;
  unsigned c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int q = 0; q < ncl; ++q) {
    const uint4* rc = reinterpret_cast<const uint4*>(
        rank_ptr(cluster, ncl, cnt, q));
    const uint4 x = rc[2 * lane];
    const uint4 y = rc[2 * lane + 1];
    c[0] += x.x; c[1] += x.y; c[2] += x.z; c[3] += x.w;
    c[4] += y.x; c[5] += y.y; c[6] += y.z; c[7] += y.w;
    if (kSum) {
      const ulonglong2* rs = reinterpret_cast<const ulonglong2*>(
          rank_ptr(cluster, ncl, sum, q));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const ulonglong2 z = rs[4 * lane + k];
        csum[8 * lane + 2 * k] = (q ? csum[8 * lane + 2 * k] : 0ull) + z.x;
        csum[8 * lane + 2 * k + 1] =
            (q ? csum[8 * lane + 2 * k + 1] : 0ull) + z.y;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) ccnt[8 * lane + k] = c[k];
}

// What warp 0 hands its block after a sync point.
struct Decision {
  long long prefix;     // level: P; threshold: the key bits decided so far
  long long base_sum;   // f(level)
  long long t_eff;      // selected: candidates with key > t_eff ...
  long long fill;       // ... plus the first `fill` with key == t (tie)
  long long block_off;  // boundary candidates in lower ranks (tie)
  long long n_selected;
  int done;             // the threshold search has its answer
  int tie;
};

// One block's rows of an eval: each pointer at the block's first row.
struct BlockRows {
  const int4* total;
  const int4* used;
  const float2* sched_cap;
  const int* job_count;
  const int* tg_count;
  const int* bw_avail;
  const int* bw_used;
  const unsigned char* eligible;
  int* counts_out;
  int* remaining_out;  // the eval's slot, written by rank 0
};

// The solve of one eval by the calling block, rank `rank` of `ncl` (the
// eval's cluster; ranks hold consecutive rows in node order): its `rows`
// rows (0 where the eval ends before it), their caps and keys at `cap`
// and `key` (shared memory or device scratch). `m`: rows a block holds at
// most, the same on every rank.
__device__ __forceinline__ void solve_cluster(
    cg::cluster_group& cluster, int ncl, int rank, const BlockRows& r,
    int* cap, unsigned* key, int rows, int m, int4 ask, int bw_ask,
    int count, float penalty, int job_distinct, int tg_distinct) {
  __shared__ __align__(16) unsigned h_cnt[2][kBins];
  __shared__ __align__(16) unsigned long long h_sum[2][kBins];
  __shared__ unsigned c_cnt[kBins];
  __shared__ unsigned long long c_sum[kBins];
  __shared__ unsigned tie_cnt[kTieIters][kWarps];
  __shared__ Divisor divs[5];
  __shared__ Decision dec;

  // The input pointers are taken from r where a pass reads them, so none
  // holds a register across the passes.
  const int a[4] = {ask.x, ask.y, ask.z, ask.w};
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Thread t holds rows t, t + 1024, ...: coalesced, no bank conflict, and
  // every pass touches a thread's own rows, so no pass waits for another
  // thread's writes.
  const int iters = (m + kThreads - 1) / kThreads;

  // Every block's partials complete and visible to the cluster (a lone
  // block needs only its own barrier).
  const auto sync_partials = [&]() {
    if (ncl > 1)
      cluster.sync();
    else
      __syncthreads();
  };

  for (int t = threadIdx.x; t < 2 * kBins; t += kThreads) {
    (&h_cnt[0][0])[t] = 0;
    (&h_sum[0][0])[t] = 0;
  }
  if (threadIdx.x < 5) {
    const int t = threadIdx.x;
    const int d = t == 0 ? ask.x : t == 1 ? ask.y : t == 2 ? ask.z
                : t == 3 ? ask.w : bw_ask;
    divs[t] = make_divisor(max(d, 1));
  }
  __syncthreads();
  int p = 0;  // partial buffer of the current sync point

  // -- 1. capacities, kept on chip; the max cap --------------------------
  int local_max = 0;
  {
    const Divisor dv[5] = {divs[0], divs[1], divs[2], divs[3], divs[4]};
    const int4* __restrict__ total = r.total;
    const int4* __restrict__ used = r.used;
    const int* __restrict__ job_count = r.job_count;
    const int* __restrict__ tg_count = r.tg_count;
    const int* __restrict__ bw_avail = r.bw_avail;
    const int* __restrict__ bw_used = r.bw_used;
    const unsigned char* __restrict__ eligible = r.eligible;
    for (int j = 0; j < iters; ++j) {
      const int i = threadIdx.x + kThreads * j;
      if (i >= rows) break;
      const int4 t = total[i];
      const int4 u = used[i];
      const int av[4] = {t.x - u.x, t.y - u.y, t.z - u.z, t.w - u.w};
      bool nonneg = true;
      int c = kBig;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        nonneg = nonneg && av[d] >= 0;
        if (a[d] > 0) c = min(c, divide(av[d], dv[d]));
      }
      const int bw_free = bw_avail[i] - bw_used[i];
      nonneg = nonneg && bw_free >= 0;
      if (bw_ask > 0) c = min(c, divide(bw_free, dv[4]));
      if (job_distinct) c = min(c, job_count[i] == 0 ? 1 : 0);
      if (tg_distinct) c = min(c, tg_count[i] == 0 ? 1 : 0);
      c = (eligible[i] && nonneg) ? min(max(c, 0), count) : 0;
      cap[i] = c;
      local_max = max(local_max, c);
    }
  }
  local_max = __reduce_max_sync(kFull, local_max);
  if (lane == 0) atomicMax(&h_cnt[p][0], (unsigned)local_max);
  sync_partials();
  if (threadIdx.x < kBins) {
    h_cnt[p ^ 1][threadIdx.x] = 0;
    h_sum[p ^ 1][threadIdx.x] = 0;
  }
  if (warp == 0) {
    const int v =
        lane < ncl ? (int)*rank_ptr(cluster, ncl, &h_cnt[p][0], lane) : 0;
    const int mx = __reduce_max_sync(kFull, v);
    if (lane == 0) {
      dec.prefix = mx;
      dec.base_sum = 0;
    }
  }
  __syncthreads();
  p ^= 1;
  const long long hcap = min((long long)count, dec.prefix);  // H

  // -- 2. level: 8 bits of L a pass, from the top ------------------------
  long long prefix = 0;
  long long sum_below = 0;  // warp 0: sum of the caps below the bins
  long long n_above = 0;    // warp 0: count of the caps above the bins
  const int level_bits = hcap > 0 ? 64 - __clzll(hcap) : 0;
  for (int s = 8 * ((level_bits + 7) / 8 - 1); s >= 0; s -= 8) {
    // The last pass needs no sums: every cap in bin d is prefix + d.
    if (s > 0)
      level_hist<true>(cap, rows, iters, prefix, s, h_cnt[p], h_sum[p]);
    else
      level_hist<false>(cap, rows, iters, prefix, s, h_cnt[p], nullptr);
    sync_partials();
    if (threadIdx.x < kBins) {
      h_cnt[p ^ 1][threadIdx.x] = 0;
      h_sum[p ^ 1][threadIdx.x] = 0;
    }
    if (warp == 0) {
      if (s > 0) {
        combine<true>(cluster, ncl, h_cnt[p], h_sum[p], c_cnt, c_sum);
      } else {
        combine<false>(cluster, ncl, h_cnt[p], nullptr, c_cnt, nullptr);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int d = 8 * lane + k;
          c_sum[d] = (unsigned long long)c_cnt[d] *
                     (unsigned long long)(prefix + d);
        }
      }
      long long lc = 0, ls = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        lc += c_cnt[8 * lane + k];
        ls += (long long)c_sum[8 * lane + k];
      }
      const long long pc = warp_incl_scan(lc);
      const long long ps = warp_incl_scan(ls);
      const long long tot = __shfl_sync(kFull, pc, 31);
      long long below_c = pc - lc;  // caps in the bins under this one
      long long below_s = ps - ls;
      int best = -1;
      long long best_f = 0, best_below = 0, best_above = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = 8 * lane + k;
        const long long lv = prefix + ((long long)d << s);
        const long long ge = n_above + tot - below_c;  // caps >= lv
        const long long f = sum_below + below_s + lv * ge;
        const long long ck = c_cnt[d];
        if (lv <= hcap && f <= count) {
          best = d;
          best_f = f;
          best_below = sum_below + below_s;
          best_above = ge - ck;
        }
        below_c += ck;
        below_s += (long long)c_sum[d];
      }
      const int dstar = __reduce_max_sync(kFull, best);  // edge 0 is valid
      const int src = dstar >> 3;
      sum_below = __shfl_sync(kFull, best_below, src);
      n_above = __shfl_sync(kFull, best_above, src);
      const long long f = __shfl_sync(kFull, best_f, src);
      if (lane == 0) {
        dec.prefix = prefix + ((long long)dstar << s);
        dec.base_sum = f;
      }
    }
    __syncthreads();
    p ^= 1;
    prefix = dec.prefix;
  }
  const int level = (int)prefix;
  const long long remaining = (long long)count - dec.base_sum;

  // -- 3. partial round: keys of the candidates, radix select ------------
  // Selected: key > t_eff, plus (tie) the first `fill` with key == thresh.
  long long t_eff = 0, fill = 0, block_off = 0, n_selected = 0;
  unsigned thresh = 0;
  bool tie = false;
  if (remaining > 0) {
    const int4* __restrict__ used = r.used;
    const float2* __restrict__ sched_cap = r.sched_cap;
    const int* __restrict__ job_count = r.job_count;
    RunHist<false> top(h_cnt[p], nullptr);
    for (int j = 0; j < iters; ++j) {
      const int i = threadIdx.x + kThreads * j;
      unsigned k = 0;
      if (i < rows) {
        // cap > level implies the plain version's fit test: every
        // dimension has room for level + 1 copies (cap is the least
        // quotient), a distinct-hosts cap of 1 means level 0 and no copy
        // yet, and an ineligible or over-committed node has cap 0. So a
        // candidate reads only what its score needs.
        if (cap[i] > level) {
          const int2 u = *reinterpret_cast<const int2*>(&used[i]);
          const float2 sc = sched_cap[i];
          k = monotone_key(bestfit_score(
              u.x + level * a[0] + a[0], u.y + level * a[1] + a[1], sc.x,
              sc.y, penalty, job_count[i] + level));
        }
        key[i] = k;
      }
      top.add(k ? (int)(k >> 24) : -1, 0u);
    }
    top.flush();
    long long k_above = 0;  // warp 0: keys above the bins
    unsigned tprefix = 0;
    for (int s = 24; s >= 0; s -= 8) {
      if (s < 24) {
        RunHist<false> h(h_cnt[p], nullptr);
        for (int j = 0; j < iters; ++j) {
          const int i = threadIdx.x + kThreads * j;
          int bin = -1;
          if (i < rows) {
            const unsigned k = key[i];
            if (k != 0u && (k >> (s + 8)) == (tprefix >> (s + 8)))
              bin = (int)((k >> s) & 0xffu);
          }
          h.add(bin, 0u);
        }
        h.flush();
      }
      sync_partials();
      if (threadIdx.x < kBins) {
        h_cnt[p ^ 1][threadIdx.x] = 0;
        h_sum[p ^ 1][threadIdx.x] = 0;
      }
      if (warp == 0) {
        combine<false>(cluster, ncl, h_cnt[p], nullptr, c_cnt, nullptr);
        long long lc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) lc += c_cnt[8 * lane + k];
        const long long pc = warp_incl_scan(lc);
        const long long tot = __shfl_sync(kFull, pc, 31);
        if (s == 24 && remaining >= tot) {  // every candidate is selected
          if (lane == 0) {
            dec.done = 1;
            dec.tie = 0;
            dec.t_eff = 0;
            dec.fill = 0;
            dec.block_off = 0;
            dec.n_selected = tot;
          }
        } else {
          long long gt = k_above + tot - pc;  // keys above this lane's bins
          int best = -1;
          long long best_gt = 0, best_c = 0;
#pragma unroll
          for (int k = 7; k >= 0; --k) {
            const int d = 8 * lane + k;
            const long long ck = c_cnt[d];
            if (gt < remaining && remaining <= gt + ck) {
              best = d;
              best_gt = gt;
              best_c = ck;
            }
            gt += ck;
          }
          const int dstar = __reduce_max_sync(kFull, best);
          const int src = dstar >> 3;
          k_above = __shfl_sync(kFull, best_gt, src);
          const long long n_at = __shfl_sync(kFull, best_c, src);
          const unsigned tp = tprefix | ((unsigned)dstar << s);
          if (s == 0) {
            // tp is the remaining-th largest key; fill >= 1 take it.
            const long long f = remaining - k_above;
            const unsigned below = (lane < ncl && lane < rank)
                ? *rank_ptr(cluster, ncl, &h_cnt[p][dstar], lane) : 0u;
            const long long boff = __reduce_add_sync(kFull, below);
            if (lane == 0) {
              dec.done = 1;
              dec.tie = f < n_at;
              dec.t_eff = f < n_at ? (long long)tp : (long long)tp - 1;
              dec.fill = f;
              dec.block_off = boff;
              dec.n_selected = remaining;
            }
          } else if (lane == 0) {
            dec.done = 0;
            dec.prefix = tp;
          }
        }
      }
      __syncthreads();
      p ^= 1;
      if (dec.done) break;
      tprefix = (unsigned)dec.prefix;
    }
    t_eff = dec.t_eff;
    tie = dec.tie != 0;
    fill = dec.fill;
    block_off = dec.block_off;
    n_selected = dec.n_selected;
    thresh = (unsigned)t_eff;
  }

  // -- 4. counts: base + selected; the tie fill in node order -------------
  // Node order in a block is (iteration, warp, lane). When the boundary is
  // cut, each warp first counts its boundary rows of each iteration (up to
  // kTieIters iterations at a time); a row is taken when the boundary rows
  // before it, in lower ranks, earlier iterations, lower warps of its
  // iteration and lower lanes, number fewer than `fill`.
  const unsigned lt_mask = (1u << lane) - 1u;
  int* __restrict__ counts_out = r.counts_out;
  long long order = block_off;  // boundary rows before this iteration
  for (int j0 = 0; j0 < iters; j0 += kTieIters) {
    const int j1 = min(iters, j0 + kTieIters);
    if (tie) {
      for (int j = j0; j < j1; ++j) {
        const int i = threadIdx.x + kThreads * j;
        const unsigned bal =
            __ballot_sync(kFull, i < rows && key[i] == thresh);
        if (lane == 0) tie_cnt[j - j0][warp] = __popc(bal);
      }
      __syncthreads();
    }
    for (int j = j0; j < j1; ++j) {
      const int i = threadIdx.x + kThreads * j;
      const bool valid = i < rows;
      const unsigned k = (valid && remaining > 0) ? key[i] : 0u;
      int sel = remaining > 0 && (long long)k > t_eff;
      if (tie) {
        const unsigned v = tie_cnt[j - j0][lane];
        const unsigned lower = __reduce_add_sync(kFull, lane < warp ? v : 0u);
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
  if (rank == 0 && threadIdx.x == 0) {
    *r.remaining_out = (int)(remaining - n_selected);
  }
  if (ncl > 1) cluster.sync();  // peers may still read this block's partials
}

// Whether a cluster of `ncl` blocks of `kernel` with `smem` bytes of
// dynamic shared memory can be resident on the current device, asked once
// per device and cluster size. `fits` is the kernel's own cache, indexed
// by the cluster size, then the device.
template <typename Kernel>
cudaError_t cluster_fits(Kernel kernel,
                         std::atomic<int> (*fits)[kMaxDevices],
                         const cudaLaunchConfig_t& cfg, int ncl,
                         size_t smem) {
  return device_once(fits[ncl], [&] {
    cudaLaunchConfig_t probe = cfg;
    probe.gridDim = dim3((unsigned)ncl);
    probe.dynamicSmemBytes = smem;
    int clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, kernel, &probe);
    if (err != cudaSuccess) return err;
    return clusters > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
  });
}

}  // namespace
