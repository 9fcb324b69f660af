// Host-side settings made once per device, shared by the port's kernels.
//
// A kernel's dynamic shared memory opt-in (cudaFuncSetAttribute) and the
// check that a cluster of a given size can be resident belong to the
// current device's context, and a solver mesh may put several cards in one
// process (one shard group a card, or eval slices on cuda:0 and cuda:1).
// So each is kept per device, not per process.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;

// Runs `set` (a callable returning cudaError_t) the first time it is asked
// for on the current device and returns its result then and on every later
// call there. `cache` is the caller's own, one slot a device (0: not yet;
// 1: success; else minus the error). Two threads may both run `set` once:
// what it sets is idempotent.
template <typename F>
cudaError_t device_once(std::atomic<int> (&cache)[kMaxDevices], F set) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int v = cache[dev].load();
  if (v == 0) {
    const cudaError_t got = set();
    v = got == cudaSuccess ? 1 : -(int)got;
    cache[dev].store(v);
  }
  return v > 0 ? cudaSuccess : (cudaError_t)(-v);
}

// The dynamic shared memory opt-in of `kernel` up to `bytes` on the current
// device, once per device (`cache` is the kernel's own).
template <typename Kernel>
cudaError_t smem_opt_in(std::atomic<int> (&cache)[kMaxDevices],
                        Kernel kernel, int bytes) {
  return device_once(cache, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  });
}

}  // namespace
