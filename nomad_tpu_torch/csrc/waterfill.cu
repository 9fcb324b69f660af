// Closed-form water-fill solve, one thread block per eval, for Hopper.
//
// Replaces the Pallas TPU kernel nomad_tpu/ops/pallas_solve.py
// (_waterfill_kernel, launched by solve_waterfill_pallas_batched through
// pl.pallas_call at :272) and computes what nomad_tpu/ops/binpack.py
// solve_waterfill computes, decision for decision:
//
//   1. per-node capacity in copies of the ask: min over the 4 resource
//      dims and bandwidth of (total - used) / ask, distinct-hosts clamps,
//      zero where ineligible or over-committed, clipped to count;
//   2. the largest level L with sum(min(cap, L)) <= count (bisection over
//      [0, min(count, max cap)]); base = min(cap, L);
//   3. the partial round: BestFit v3 score on the post-base usage minus
//      the anti-affinity penalty, the top `remaining` candidates (cap > L)
//      by the order-preserving uint32 image of the score (32-step
//      threshold bisection), ties to the lowest node index.
//
// What bounds it on the H100: not bytes. One eval reads 57 bytes per node
// (about 0.5 MB at the 8192-row bucket, 0.1 us of HBM time at 3.35 TB/s);
// the time goes to the chain of block-wide reductions that must run in
// sequence: one for max cap, up to 31 for the level, up to 32 for the
// threshold, one for the boundary count and the tiled prefix scan. Each
// is a strided pass over the eval's [N] scratch plus two __syncthreads.
//
// Design of this first version: grid = B evals, 1024 threads a block,
// each thread striding over the node axis. A first pass writes every
// node's cap to a [B, N] scratch in device memory (it stays in the 50 MB
// L2); the score pass writes each candidate's key to a second scratch;
// every bisection step is then one strided pass plus one block reduction.
// The Mosaic workarounds of the TPU kernel (byte-split float sums for
// integer reductions, the prefix-cut tie bisection in place of a cumsum)
// are gone: reductions are native integer warp shuffles, and the tie fill
// is a block-wide prefix scan in node order. Left for later: staging the
// eval's nodes in shared memory, several blocks per eval (a cluster), and
// reading shared node tensors once per batched dispatch.
//
// Arithmetic is IEEE float32 in the operation order of the PyTorch plain
// version (nomad_tpu_torch/ops/waterfill.py): powf is the accurate one (no
// fast math), and multiplies/adds are spelled with _rn intrinsics so the
// compiler cannot contract them into FMAs the plain version does not do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  __syncthreads();  // the previous reduction's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < kWarps) ? red[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__device__ __forceinline__ int block_max(int v, long long* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(kFull, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < kWarps) ? (int)red[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(kFull, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return (int)red[0];
}

// Inclusive prefix sum over the block in thread order; *total gets the
// block's sum.
__device__ __forceinline__ int block_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  __syncthreads();
  if (lane == 31) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = (lane < kWarps) ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    ws[lane] = w;
  }
  __syncthreads();
  *total = ws[kWarps - 1];
  return v + (warp > 0 ? ws[warp - 1] : 0);
}

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

__global__ void __launch_bounds__(kThreads)
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
                 int* __restrict__ cap_scratch,
                 unsigned* __restrict__ key_scratch, int n, int job_distinct,
                 int tg_distinct) {
  __shared__ long long red[32];
  __shared__ int ws[32];

  const int b = blockIdx.x;
  const size_t off = (size_t)b * (size_t)n;
  total += off;
  used += off;
  sched_cap += off;
  job_count += off;
  tg_count += off;
  bw_avail += off;
  bw_used += off;
  eligible += off;
  counts_out += off;
  int* cap = cap_scratch + off;
  unsigned* key = key_scratch + off;

  const int4 ask = ask_all[b];
  const int bw_ask = bw_ask_all[b];
  const int count = count_all[b];
  const float penalty = penalty_all[b];
  const int a[4] = {ask.x, ask.y, ask.z, ask.w};

  // -- 1. capacities --------------------------------------------------------
  int local_max = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int4 t = total[i];
    const int4 u = used[i];
    const int av[4] = {t.x - u.x, t.y - u.y, t.z - u.z, t.w - u.w};
    bool nonneg = true;
    int c = kBig;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      nonneg = nonneg && av[d] >= 0;
      // C division truncates where // floors; a negative quotient only
      // arises on an over-committed node, which `nonneg` zeroes below.
      if (a[d] > 0) c = min(c, av[d] / a[d]);
    }
    const int bw_free = bw_avail[i] - bw_used[i];
    nonneg = nonneg && bw_free >= 0;
    if (bw_ask > 0) c = min(c, bw_free / bw_ask);
    if (job_distinct) c = min(c, job_count[i] == 0 ? 1 : 0);
    if (tg_distinct) c = min(c, tg_count[i] == 0 ? 1 : 0);
    c = (eligible[i] && nonneg) ? min(max(c, 0), count) : 0;
    cap[i] = c;
    local_max = max(local_max, c);
  }
  const int max_cap = block_max(local_max, red);

  // -- 2. level: largest L in [0, min(count, max cap)] with
  //       sum(min(cap, L)) <= count ----------------------------------------
  int lo = 0;
  int hi = min(count, max_cap);
  while (lo < hi) {  // lo/hi are block-uniform: every thread iterates
    const int mid = lo + (hi - lo + 1) / 2;
    long long s = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) s += min(cap[i], mid);
    s = block_sum(s, red);
    if (s <= count) lo = mid; else hi = mid - 1;
  }
  const int level = lo;

  // -- 3. partial round: base, fit and score keys of the candidates ---------
  long long base_sum = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = cap[i];
    const int base = min(c, level);
    base_sum += base;
    unsigned k = 0;
    if (c > level) {
      const int4 t = total[i];
      const int4 u = used[i];
      const int ub[4] = {u.x + base * a[0] + a[0], u.y + base * a[1] + a[1],
                         u.z + base * a[2] + a[2], u.w + base * a[3] + a[3]};
      const int jc = job_count[i] + base;
      bool fit = ub[0] <= t.x && ub[1] <= t.y && ub[2] <= t.z &&
                 ub[3] <= t.w &&
                 (bw_used[i] + base * bw_ask + bw_ask) <= bw_avail[i] &&
                 eligible[i];
      if (job_distinct) fit = fit && jc == 0;
      if (tg_distinct) fit = fit && (tg_count[i] + base) == 0;
      if (fit) {
        const float2 sc = sched_cap[i];
        k = monotone_key(bestfit_score(ub[0], ub[1], sc.x, sc.y, penalty, jc));
      }
    }
    key[i] = k;
  }
  base_sum = block_sum(base_sum, red);
  const long long remaining = (long long)count - base_sum;

  // -- 4. the remaining-th largest key: 32-step threshold bisection --------
  unsigned tlo = 0u;
  unsigned thi = 0xFFFFFFFEu;  // all-ones is a NaN image; keeps hi-lo+1 > 0
  for (int it = 0; it < 32 && tlo < thi; ++it) {
    const unsigned mid = tlo + (thi - tlo + 1u) / 2u;
    long long c = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned k = key[i];
      c += (k != 0u && k >= mid);
    }
    c = block_sum(c, red);
    if (c >= remaining) tlo = mid; else thi = mid - 1u;
  }
  const unsigned thresh = tlo;

  long long n_above = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) n_above += key[i] > thresh;
  n_above = block_sum(n_above, red);
  const long long fill = remaining - n_above;

  // -- 5. select: everything above the threshold plus the first `fill`
  //       boundary candidates in node order (the cumsum tie fill) --------
  long long carry = 0;
  long long n_selected = 0;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    const unsigned k = i < n ? key[i] : 0u;
    const int above = k > thresh;
    const int boundary = (k != 0u && k == thresh);
    int tile_total;
    const int incl = block_scan(boundary, ws, &tile_total);
    const int sel = (above || (boundary && carry + incl <= fill)) &&
                    remaining > 0;
    if (i < n) counts_out[i] = min(cap[i], level) + sel;
    n_selected += sel;
    carry += tile_total;
  }
  n_selected = block_sum(n_selected, red);
  if (threadIdx.x == 0) {
    remaining_out[b] = (int)(remaining - n_selected);
  }
}

}  // namespace

extern "C" int nomad_waterfill(
    const void* total, const void* used, const void* sched_cap,
    const void* job_count, const void* tg_count, const void* bw_avail,
    const void* bw_used, const void* eligible, const void* ask,
    const void* bw_ask, const void* count, const void* penalty,
    void* counts_out, void* remaining_out, void* cap_scratch,
    void* key_scratch, int batch, int n, int job_distinct, int tg_distinct,
    void* stream) {
  waterfill_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)total, (const int4*)used, (const float2*)sched_cap,
      (const int*)job_count, (const int*)tg_count, (const int*)bw_avail,
      (const int*)bw_used, (const unsigned char*)eligible, (const int4*)ask,
      (const int*)bw_ask, (const int*)count, (const float*)penalty,
      (int*)counts_out, (int*)remaining_out, (int*)cap_scratch,
      (unsigned*)key_scratch, n, job_distinct, tg_distinct);
  return (int)cudaGetLastError();
}
