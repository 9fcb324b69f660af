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
// What bounds it on the H100: the k block-wide argmax reductions that must
// run in sequence, each after a strided pass over the node axis that
// evaluates two powf per node. Bytes are small: the node tensors (total,
// sched_cap, bw_avail) are shared by every eval of a dispatch and the
// per-eval tensors are read once a step from L2.
//
// Design of this first version: grid = B evals, 1024 threads a block. The
// carried state is one int per node: how many copies this scan has placed
// there so far. used, job_count, tg_count and bw_used are the inputs plus
// that count times the ask, which is exactly the one-hot sums of the scan.
// The inputs are never written. Left for later: staging the per-node
// scores' inputs in shared memory or registers across steps, and a
// cluster of blocks per eval for the 131072-row bucket.
//
// Arithmetic follows ops/waterfill.cu: IEEE float32, accurate powf, _rn
// intrinsics so nothing is contracted into an FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// (score, index) order of jnp.argmax: higher score wins, then lower index.
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(kThreads)
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
              float* __restrict__ score_out, int* __restrict__ placed_scratch,
              int n, int k, int job_distinct, int tg_distinct) {
  __shared__ float red_s[32];
  __shared__ int red_i[32];

  const int b = blockIdx.x;
  const size_t off = (size_t)b * (size_t)n;
  used0 += off;
  job_count0 += off;
  tg_count0 += off;
  bw_used0 += off;
  eligible += off;
  int* placed = placed_scratch + off;
  const unsigned char* active = active_all + (size_t)b * k;

  const int4 ask = ask_all[b];
  const int bw_ask = bw_ask_all[b];
  const float penalty = penalty_all[b];

  for (int i = threadIdx.x; i < n; i += kThreads) placed[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int step = 0; step < k; ++step) {
    float bs = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int p = placed[i];
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
      float s = -INFINITY;
      if (fit) {
        const float2 sc = sched_cap[i];
        s = bestfit_score(up0, up1, sc.x, sc.y, penalty, jc);
      }
      if (better(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_down_sync(kFull, bs, o);
      const int oi = __shfl_down_sync(kFull, bi, o);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = red_s[lane];
      bi = red_i[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float os = __shfl_down_sync(kFull, bs, o);
        const int oi = __shfl_down_sync(kFull, bi, o);
        if (better(os, oi, bs, bi)) {
          bs = os;
          bi = oi;
        }
      }
      if (lane == 0) {
        const bool ok = bs > -INFINITY && active[step] != 0;
        idx_out[(size_t)b * k + step] = bi;
        ok_out[(size_t)b * k + step] = ok ? 1 : 0;
        score_out[(size_t)b * k + step] = bs;
        if (ok) placed[bi] += 1;
      }
    }
    __syncthreads();  // the placement is visible to the next step's pass
  }
}

}  // namespace

extern "C" int nomad_greedy(
    const void* total, const void* sched_cap, const void* bw_avail,
    const void* used0, const void* job_count0, const void* tg_count0,
    const void* bw_used0, const void* eligible, const void* ask,
    const void* bw_ask, const void* active, const void* penalty,
    void* idx_out, void* ok_out, void* score_out, void* placed_scratch,
    int batch, int n, int k, int job_distinct, int tg_distinct,
    void* stream) {
  greedy_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)total, (const float2*)sched_cap, (const int*)bw_avail,
      (const int4*)used0, (const int*)job_count0, (const int*)tg_count0,
      (const int*)bw_used0, (const unsigned char*)eligible, (const int4*)ask,
      (const int*)bw_ask, (const unsigned char*)active,
      (const float*)penalty, (int*)idx_out, (unsigned char*)ok_out,
      (float*)score_out, (int*)placed_scratch, n, k, job_distinct,
      tg_distinct);
  return (int)cudaGetLastError();
}
