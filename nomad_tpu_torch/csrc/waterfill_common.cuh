// Device functions shared by the water-fill kernels: the unsharded one
// (waterfill.cu) and the node-shard passes (waterfill_shard.cu). Both
// must score, key and bin a node bit for bit alike, so they share one
// definition of each.
//
// Arithmetic is IEEE float32 in the operation order of the PyTorch plain
// versions: powf is the accurate one (no fast math), and multiplies/adds
// are spelled with _rn intrinsics so the compiler cannot contract them
// into FMAs the plain versions do not do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
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
// by bits [s, s + 8) of cap - prefix. A block of kT threads; thread t holds
// rows t, t + kT, ...
template <bool kSum, int kT = kThreads>
__device__ __forceinline__ void level_hist(const int* cap, int rows,
                                           int iters, long long prefix, int s,
                                           unsigned* cnt,
                                           unsigned long long* sum) {
  RunHist<kSum> h(cnt, sum);
  for (int j = 0; j < iters; ++j) {
    const int i = threadIdx.x + kT * j;
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

}  // namespace
