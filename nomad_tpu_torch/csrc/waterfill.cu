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
// Design (the body is solve_cluster in waterfill_cluster.cuh, which the
// node-shard solve's single launch in waterfill_shard.cu shares):
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

#include "waterfill_cluster.cuh"

namespace {

// Grid = B clusters of ncl blocks; rank r of eval b's cluster holds the
// rows [r m, r m + m) of its [B, N] tensors.
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
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / ncl;
  const int row0 = rank * m;
  const size_t off = (size_t)b * (size_t)n + (size_t)row0;
  const BlockRows r = {
      total + off, used + off, sched_cap + off, job_count + off,
      tg_count + off, bw_avail + off, bw_used + off, eligible + off,
      counts_out + off, remaining_out + b};
  solve_cluster(
      cluster, ncl, rank, r, kSmem ? smem_rows : cap_scratch + off,
      kSmem ? reinterpret_cast<unsigned*>(smem_rows + m) : key_scratch + off,
      max(0, min(m, n - row0)), m, ask_all[b], bw_ask_all[b], count_all[b],
      penalty_all[b], job_distinct, tg_distinct);
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
  // Once per device and variant: the shared memory opt-in and the check
  // that a cluster of each size can be resident.
  static std::atomic<int> attr[kMaxDevices];
  if (kSmem) {
    const cudaError_t err = smem_opt_in(attr, waterfill_kernel<true>,
                                        2 * kSmemRows * (int)sizeof(int));
    if (err != cudaSuccess) return err;
  }
  static std::atomic<int> fits[kMaxCluster + 1][kMaxDevices];
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = (unsigned)ncl;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = base;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  const cudaError_t fit =
      cluster_fits(waterfill_kernel<kSmem>, fits, cfg, ncl,
                   kSmem ? 2 * kSmemRows * sizeof(int) : 0);
  if (fit != cudaSuccess) return fit;
  return cudaLaunchKernelEx(
      &cfg, waterfill_kernel<kSmem>, (const int4*)total, (const int4*)used,
      (const float2*)sched_cap, (const int*)job_count, (const int*)tg_count,
      (const int*)bw_avail, (const int*)bw_used,
      (const unsigned char*)eligible, (const int4*)ask, (const int*)bw_ask,
      (const int*)count, (const float*)penalty, (int*)counts_out,
      (int*)remaining_out, (int*)cap_scratch, (unsigned*)key_scratch, n, m,
      ncl, job_distinct, tg_distinct);
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
