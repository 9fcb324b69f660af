// Closed-form water-fill solve for Hopper: one thread-block cluster per
// eval, the eval's caps and keys held on chip, digit-histogram searches.
//
// Replaces the Pallas TPU kernel nomad_tpu/ops/pallas_solve.py
// (_waterfill_kernel, launched by solve_waterfill_pallas_batched through
// pl.pallas_call at :272) and computes what nomad_tpu/ops/binpack.py
// solve_waterfill computes, decision for decision:
//
//   1. per-node capacity in copies of the ask: min over the 4 resource
//      dims and bandwidth of (total - used) / ask, distinct-hosts clamps,
//      zero where ineligible or over-committed, clipped to count;
//   2. the largest level L in [0, H], H = min(count, max cap), with
//      f(L) = sum(min(cap, L)) <= count; base = min(cap, L);
//   3. the partial round: BestFit v3 score on the post-base usage minus
//      the anti-affinity penalty, the top `remaining` candidates (cap > L)
//      by the order-preserving uint32 image of the score, ties to the
//      lowest node index.
//
// What bounds it on the H100: not bytes. One eval reads about 41 bytes a
// node plus 20 a candidate (0.5 MB at the 8192-row bucket, 0.15 us of HBM
// time). The time goes to one SM's passes over its rows and to the chain
// of block- and cluster-wide decisions that must run one after another.
// The JAX reference takes both searches by bisection, 50 to 70 dependent
// reductions an eval; this kernel has 2 to 10 sync points.
//
// Design:
//
// - Layout. Grid = B x CL blocks of 1024 threads, CL = 1 up to 16384 rows
//   and the next power of two of N / 16384 above, at most 8 (the portable
//   cluster limit): one cluster per eval, block r holding the contiguous
//   rows [r M, r M + M), M = ceil(N / CL). A block's caps and keys live in
//   dynamic shared memory (8 B a row, 128 KB at M = 16384); above 131072
//   rows (M > 16384) in a [B, N] device scratch from the wrapper. Thread t
//   of a block holds its rows t, t + 1024, ...: reads are coalesced, shared
//   memory has no bank conflict, the live rows (a prefix of the bucket)
//   spread over every warp, and every pass touches a thread's own rows, so
//   no pass waits for another thread's writes.
// - Caps. One pass reads each node's inputs once and keeps its cap on
//   chip; the five divisions by the eval's asks are multiplications by
//   per-block magic numbers. The max cap is the first sync point.
// - Level. L's bits are decided from the top, 8 at a time: the caps that
//   share the bits decided so far (prefix P) are binned by their next 8
//   bits into a 256-bin histogram of counts and int64 sums, while warp 0
//   carries the sum of the caps below the bins and the count above them.
//   At the bin edge L = P + d 2^s, f(L) = (sum of caps < L) + L #{cap >=
//   L}; one warp scans the bins and takes the largest edge with f <= count
//   and L <= H. ceil(bits(H) / 8) passes, at most 4 (1 at the headline,
//   where H = 40); the last needs no sums. f at the chosen edge is the base
//   sum.
// - Keys. cap > level implies the fit test, so a candidate reads only its
//   used cpu and memory, job count and schedulable capacity (20 B).
// - Threshold. With 1 <= remaining < #candidates the bisection's threshold
//   is the remaining-th largest candidate key: a radix select, 4 passes of
//   8 bits, MSB first. The first pass is folded into the key pass (it also
//   counts the candidates). remaining <= 0 needs no key at all (the
//   counts are the base); remaining >= #candidates selects every
//   candidate. The last pass gives the count above the threshold and the
//   count at it, so neither needs a pass of its own.
// - Histograms. A thread carries a run (bin, count, sum) in registers and
//   adds it to its block's partial with a shared atomic when the bin
//   changes; a warp adds its lanes' last runs once where they share a bin.
//   No warp-synchronous op runs inside a pass, and identical nodes do not
//   serialise on one atomic.
// - Tie fill. When the boundary is not taken whole, the first `fill`
//   boundary candidates in node order, (rank, iteration, warp, lane), are
//   taken: each warp counts its boundary rows of each iteration by ballot,
//   one block barrier shares the counts, and block r starts after the
//   boundary counts of blocks < r, which the last radix pass already read.
// - Cluster. Each histogram or max is combined through distributed shared
//   memory: each block adds into its own partial, cluster.sync(), then warp
//   0 of every block reads the CL partials, makes the same decision and
//   hands it to its block with one __syncthreads. The partials are double
//   buffered by parity: a buffer is zeroed only after the next cluster
//   barrier, when every block has read it. A last cluster.sync keeps every
//   block resident until the others are done reading its shared memory.
//
// Sync points an eval: 1 (max cap) + ceil(bits(H) / 8) (level) + (if
// remaining > 0) 1 to 4 (radix select) + (if the boundary is cut) 1 block
// barrier per 32 iterations; plus the final cluster barrier when CL > 1.
//
// Arithmetic is IEEE float32 in the operation order of the PyTorch plain
// version (nomad_tpu_torch/ops/waterfill.py): powf is the accurate one (no
// fast math), and multiplies/adds are spelled with _rn intrinsics so the
// compiler cannot contract them into FMAs the plain version does not do.
// Every decision is on integers (int64 sums), so the order in which the
// partials are combined cannot change an output.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kSmemRows = 16384;  // rows a block keeps in shared memory
constexpr int kMaxCluster = 8;    // the portable cluster limit
constexpr int kTieIters = 32;   // iterations a tie-fill chunk counts
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// binpack._monotone_u32: flip all bits of negatives, the sign bit of
// positives. Finite scores never map to 0, so 0 marks "not a candidate".
__device__ __forceinline__ unsigned monotone_key(float s) {
  const unsigned bits = __float_as_uint(s);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

// ops/fit.score_fit for one node, then the anti-affinity penalty.
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

// A thread's adds into its block's partial histogram (counts, and sums
// when kSum). The thread carries a run (bin, count, sum) in registers and
// adds it with a shared atomic when its bin changes; no warp-synchronous op
// runs inside a pass's loop, so the iterations overlap. At the end of the
// pass the warp adds its lanes' last runs once where they share one bin
// (identical nodes), so equal values do not serialise on one atomic.
template <bool kSum>
struct RunHist {
  unsigned* cnt;
  unsigned long long* sum;
  int bin = -1;
  unsigned n = 0;
  unsigned long long s = 0;

  __device__ RunHist(unsigned* c, unsigned long long* su) : cnt(c), sum(su) {}

  // Adds `val` to bin `b`, nothing where b < 0.
  __device__ __forceinline__ void add(int b, unsigned val) {
    if (b < 0) return;
    if (b != bin) {
      if (n) {
        atomicAdd(&cnt[bin], n);
        if (kSum) atomicAdd(&sum[bin], s);
      }
      bin = b;
      n = 0;
      s = 0;
    }
    ++n;
    if (kSum) s += val;
  }

  // Every lane of the warp must call it, once, after its last add.
  __device__ __forceinline__ void flush() {
    const int b = n ? bin : -1;
    const unsigned valid = __ballot_sync(kFull, b >= 0);
    if (valid == 0u) return;
    const int leader = __ffs(valid) - 1;
    const int first = __shfl_sync(kFull, b, leader);
    if (__all_sync(kFull, b < 0 || b == first)) {
      const unsigned tn = __reduce_add_sync(kFull, b < 0 ? 0u : n);
      unsigned long long ts = b < 0 ? 0ull : s;
      if (kSum) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ts += __shfl_xor_sync(kFull, ts, o);
      }
      if ((int)(threadIdx.x & 31) == leader) {
        atomicAdd(&cnt[first], tn);
        if (kSum) atomicAdd(&sum[first], ts);
      }
    } else if (b >= 0) {
      atomicAdd(&cnt[b], n);
      if (kSum) atomicAdd(&sum[b], s);
    }
  }
};

// One level pass's adds: the caps in [prefix, prefix + 256 << s), binned
// by bits [s, s + 8) of cap - prefix.
template <bool kSum>
__device__ __forceinline__ void level_hist(const int* cap, int rows,
                                           int iters, long long prefix, int s,
                                           unsigned* cnt,
                                           unsigned long long* sum) {
  RunHist<kSum> h(cnt, sum);
  for (int j = 0; j < iters; ++j) {
    const int i = threadIdx.x + kThreads * j;
    int bin = -1;
    int c = 0;
    if (i < rows) {
      c = cap[i];
      if (c >= prefix) {
        const long long d = (c - prefix) >> s;
        if (d < kBins) bin = (int)d;
      }
    }
    h.add(bin, (unsigned)c);
  }
  h.flush();
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

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ long long warp_incl_scan(long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// floor(n / d) for 0 <= n < 2^31 and d >= 1 as (n * mul) >> shift, with
// l = ceil(log2 d), shift = 31 + l and mul = ceil(2^shift / d) < 2^32
// (Granlund and Montgomery, "Division by invariant integers using
// multiplication", 1994, theorem 4.2). The cap pass divides every node by
// the same five divisors; a hardware-free integer division costs about 20
// instructions, this one 2.
struct Divisor {
  unsigned mul;
  int shift;
};

__device__ __forceinline__ Divisor make_divisor(int d) {
  const int l = d > 1 ? 32 - __clz(d - 1) : 0;
  const unsigned long long p = 1ull << (31 + l);
  return {(unsigned)((p + (unsigned long long)d - 1) / (unsigned long long)d),
          31 + l};
}

// A negative n gives an arbitrary value: the cap pass zeroes such nodes.
__device__ __forceinline__ int divide(int n, Divisor d) {
  return (int)(((unsigned long long)(unsigned)n * d.mul) >> d.shift);
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

template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
waterfill_kernel(const int4* __restrict__ total, const int4* __restrict__ used,
                 const float2* __restrict__ sched_cap,
                 const int* __restrict__ job_count,
                 const int* __restrict__ tg_count,
                 const int* __restrict__ bw_avail,
                 const int* __restrict__ bw_used,
                 const unsigned char* __restrict__ eligible,
                 const int4* __restrict__ ask_all,
                 const int* __restrict__ bw_ask_all,
                 const int* __restrict__ count_all,
                 const float* __restrict__ penalty_all,
                 int* __restrict__ counts_out, int* __restrict__ remaining_out,
                 int* cap_scratch, unsigned* key_scratch, int n, int m,
                 int ncl, int job_distinct, int tg_distinct) {
  extern __shared__ int smem_rows[];  // kSmem: [m] caps, then [m] keys
  __shared__ __align__(16) unsigned h_cnt[2][kBins];
  __shared__ __align__(16) unsigned long long h_sum[2][kBins];
  __shared__ unsigned c_cnt[kBins];
  __shared__ unsigned long long c_sum[kBins];
  __shared__ unsigned tie_cnt[kTieIters][kWarps];
  __shared__ Divisor divs[5];
  __shared__ Decision dec;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / ncl;
  const int row0 = rank * m;
  const int rows = max(0, min(m, n - row0));  // this block's rows
  const size_t off = (size_t)b * (size_t)n + (size_t)row0;
  total += off;
  used += off;
  sched_cap += off;
  job_count += off;
  tg_count += off;
  bw_avail += off;
  bw_used += off;
  eligible += off;
  counts_out += off;
  int* cap = kSmem ? smem_rows : cap_scratch + off;
  unsigned* key =
      kSmem ? reinterpret_cast<unsigned*>(smem_rows + m) : key_scratch + off;

  const int4 ask = ask_all[b];
  const int bw_ask = bw_ask_all[b];
  const int count = count_all[b];
  const float penalty = penalty_all[b];
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
  const Divisor dv[5] = {divs[0], divs[1], divs[2], divs[3], divs[4]};
  int local_max = 0;
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
    remaining_out[b] = (int)(remaining - n_selected);
  }
  if (ncl > 1) cluster.sync();  // peers may still read this block's partials
}

// The launch: B clusters of `ncl` blocks.
template <bool kSmem>
cudaError_t launch(const cudaLaunchConfig_t& base, const void* total,
                   const void* used, const void* sched_cap,
                   const void* job_count, const void* tg_count,
                   const void* bw_avail, const void* bw_used,
                   const void* eligible, const void* ask, const void* bw_ask,
                   const void* count, const void* penalty, void* counts_out,
                   void* remaining_out, void* cap_scratch, void* key_scratch,
                   int n, int m, int ncl, int job_distinct, int tg_distinct) {
  // Once per process and variant (one card a process): the shared memory
  // opt-in and the check that a cluster of each size can be resident.
  static const cudaError_t attr =
      kSmem ? cudaFuncSetAttribute(waterfill_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   2 * kSmemRows * (int)sizeof(int))
            : cudaSuccess;
  if (attr != cudaSuccess) return attr;
  static std::atomic<int> fits[kMaxCluster + 1];
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = (unsigned)ncl;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = base;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  if (fits[ncl].load() == 0) {
    cudaLaunchConfig_t probe = cfg;
    probe.gridDim = dim3((unsigned)ncl);
    probe.dynamicSmemBytes = kSmem ? 2 * kSmemRows * sizeof(int) : 0;
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &clusters, waterfill_kernel<kSmem>, &probe);
    if (err != cudaSuccess) return err;
    fits[ncl].store(clusters > 0 ? 1 : -1);
  }
  if (fits[ncl].load() < 0) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(
      &cfg, waterfill_kernel<kSmem>, (const int4*)total, (const int4*)used,
      (const float2*)sched_cap, (const int*)job_count, (const int*)tg_count,
      (const int*)bw_avail, (const int*)bw_used,
      (const unsigned char*)eligible, (const int4*)ask, (const int*)bw_ask,
      (const int*)count, (const float*)penalty, (int*)counts_out,
      (int*)remaining_out, (int*)cap_scratch, (unsigned*)key_scratch, n, m,
      ncl, job_distinct, tg_distinct);
}

// Blocks in an eval's cluster: the next power of two of n / kSmemRows, at
// least 1, at most kMaxCluster.
int cluster_size(int n) {
  int ncl = 1;
  while (ncl < kMaxCluster && (long long)ncl * kSmemRows < n) ncl *= 2;
  return ncl;
}

}  // namespace

// Rows one block holds for an eval of n rows (its cluster rank's shard).
extern "C" int nomad_waterfill_block_rows(int n) {
  const int ncl = cluster_size(n);
  return (n + ncl - 1) / ncl;
}

// 1 where an eval of n rows keeps its caps and keys in the cap_scratch and
// key_scratch of nomad_waterfill, not in shared memory.
extern "C" int nomad_waterfill_needs_scratch(int n) {
  return nomad_waterfill_block_rows(n) > kSmemRows;
}

// cap_scratch and key_scratch ([B, N] int32 each) are read only where
// nomad_waterfill_needs_scratch(n); elsewhere they may be null.
extern "C" int nomad_waterfill(
    const void* total, const void* used, const void* sched_cap,
    const void* job_count, const void* tg_count, const void* bw_avail,
    const void* bw_used, const void* eligible, const void* ask,
    const void* bw_ask, const void* count, const void* penalty,
    void* counts_out, void* remaining_out, void* cap_scratch,
    void* key_scratch, int batch, int n, int job_distinct, int tg_distinct,
    void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int ncl = cluster_size(n);
  const int m = nomad_waterfill_block_rows(n);
  const bool smem = !nomad_waterfill_needs_scratch(n);
  if (!smem && (cap_scratch == nullptr || key_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * ncl));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem ? 2 * (size_t)m * sizeof(int) : 0;
  cfg.stream = (cudaStream_t)stream;
  const cudaError_t err =
      smem ? launch<true>(cfg, total, used, sched_cap, job_count, tg_count,
                          bw_avail, bw_used, eligible, ask, bw_ask, count,
                          penalty, counts_out, remaining_out, nullptr,
                          nullptr, n, m, ncl, job_distinct, tg_distinct)
           : launch<false>(cfg, total, used, sched_cap, job_count, tg_count,
                           bw_avail, bw_used, eligible, ask, bw_ask, count,
                           penalty, counts_out, remaining_out, cap_scratch,
                           key_scratch, n, m, ncl, job_distinct, tg_distinct);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
