// Native kernels for the host control plane.
//
// Port of nomad_tpu/native/src/nomad_native.cpp, the same three functions
// with the same C interface; nomad_tpu_torch/native/__init__.py builds it
// with the host compiler at first use.
//
// The reference's control plane is compiled Go; the hot host-side loops of
// this framework get the same treatment as a small C++ library loaded via
// ctypes (no pybind dependency). The first consumer is the plan verifier —
// the leader's serialization point (reference: nomad/plan_apply.go:164-277
// evaluatePlan/evaluateNodePlan + nomad/structs/funcs.go:44-87 AllocsFit):
// per-node resource accumulation over every allocation in a plan, then a
// vectorized superset check. At 100k allocations per plan this loop is the
// plans/sec ceiling of the whole cluster.
//
// All buffers are caller-owned contiguous arrays (numpy-compatible):
//   resources are int32 rows of width D (cpu, memory_mb, disk_mb, iops).

#include <cstdint>

extern "C" {

// out[idx[i], :] += vals[i, :] for i in [0, n). idx values must be < n_out.
void nt_scatter_add_i32(const int32_t* idx, const int32_t* vals,
                        int64_t n, int64_t d,
                        int32_t* out, int64_t n_out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t row = idx[i];
        if (row < 0 || row >= n_out) continue;
        int32_t* dst = out + row * d;
        const int32_t* src = vals + i * d;
        for (int64_t j = 0; j < d; ++j) dst[j] += src[j];
    }
}

// Per-row superset check: fit[i] = all(used[i, :] <= total[i, :]).
// exhausted[i] = first failing dimension index, or -1 when fitting.
void nt_fit_check_i32(const int32_t* used, const int32_t* total,
                      int64_t n, int64_t d,
                      uint8_t* fit, int32_t* exhausted) {
    for (int64_t i = 0; i < n; ++i) {
        const int32_t* u = used + i * d;
        const int32_t* t = total + i * d;
        int32_t bad = -1;
        for (int64_t j = 0; j < d; ++j) {
            if (u[j] > t[j]) { bad = (int32_t)j; break; }
        }
        fit[i] = bad < 0 ? 1 : 0;
        exhausted[i] = bad;
    }
}

// Count occurrences of each index: out[idx[i]] += 1 (alloc-per-node counts).
void nt_bincount_i32(const int32_t* idx, int64_t n,
                     int32_t* out, int64_t n_out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t row = idx[i];
        if (row >= 0 && row < n_out) out[row] += 1;
    }
}

}  // extern "C"
