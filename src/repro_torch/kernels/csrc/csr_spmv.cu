// Deterministic float64 CSR sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the two `jax.ops.segment_sum` calls of the PDHG chunk
// `repro.core.lp._pdhg_chunk` (src/repro/core/lp.py:94, the sums at
// :97-101), which XLA runs as one compiled loop on the TPU:
//
//     out[r] = sum over the entries e of row r of vals[e] * x[indices[e]]
//
// The sum of each row is taken left to right in CSR order, starting from
// 0.0, with round-to-nearest multiplies and adds that never contract into
// an FMA (`__dmul_rn`, `__dadd_rn`). The plain torch version
// (`repro_torch.kernels.ref.csr_spmv_ref`, `index_add_` on the CPU) adds
// in the same order, so the two agree bit for bit, run after run: the
// synthesis loop fixes orbits by the order of the LP's fractional values,
// where one ulp of noise can change the fabric. No atomics, no reordering.
//
// Design: one thread per row. Each thread loads a chunk of CHUNK entries
// (indices, values and the gathered x) into registers before it adds them
// in order, so the loads of a chunk are in flight together and only the
// adds form a dependent chain. Bound: the bytes (each of indptr, indices,
// vals and x read once, out written once) at the memory rate; a row far
// longer than the rest (a column of A with 8,256 entries where the median
// has 3, in A^T at the 4x8x8 synthesis LP) leaves one thread adding for
// the whole kernel. Splitting such rows into an ordered two-level sum is
// the next design step.
//
// Plain C entry point, loaded with ctypes (repro_torch/kernels/csr_spmv.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 16;

__global__ void __launch_bounds__(THREADS)
csr_spmv_kernel(const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const double* __restrict__ vals,
                const double* __restrict__ x,
                double* __restrict__ out, int rows) {
    const int row = blockIdx.x * THREADS + threadIdx.x;
    if (row >= rows) return;
    int64_t e = __ldg(indptr + row);
    const int64_t end = __ldg(indptr + row + 1);
    double acc = 0.0;
    for (; e + CHUNK <= end; e += CHUNK) {
        double p[CHUNK];
#pragma unroll
        for (int i = 0; i < CHUNK; ++i)
            p[i] = __dmul_rn(__ldg(vals + e + i),
                             __ldg(x + __ldg(indices + e + i)));
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) acc = __dadd_rn(acc, p[i]);
    }
    for (; e < end; ++e)
        acc = __dadd_rn(acc, __dmul_rn(__ldg(vals + e),
                                       __ldg(x + __ldg(indices + e))));
    out[row] = acc;
}

}  // namespace

// out[r] for r < rows; indptr holds rows + 1 offsets. Launches on
// `stream` and returns the launch's CUDA error code (0 on success).
extern "C" int csr_spmv_f64(const void* indptr, const void* indices,
                            const void* vals, const void* x, void* out,
                            int rows, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rows <= 0) return 0;
    const int blocks = (rows + THREADS - 1) / THREADS;
    csr_spmv_kernel<<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const double*>(vals), static_cast<const double*>(x),
        static_cast<double*>(out), rows);
    return static_cast<int>(cudaGetLastError());
}
