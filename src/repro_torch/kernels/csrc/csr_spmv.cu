// Deterministic float64 CSR sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the two `jax.ops.segment_sum` calls of the PDHG chunk
// `repro.core.lp._pdhg_chunk` (src/repro/core/lp.py:94, the sums at
// :97-101), which XLA runs as one compiled loop on the TPU:
//
//     out[r] = sum over the entries e of row r of vals[e] * x[indices[e]]
//
// The order. A row of at most SEGMENT entries is summed left to right in
// CSR order from 0.0. A longer row is cut into consecutive segments of
// SEGMENT entries (the last one shorter); each segment is summed left to
// right from 0.0, then the segment sums left to right from 0.0. Products
// and adds round to nearest and never contract into an FMA (`__dmul_rn`,
// `__dadd_rn`); no atomics. The plain torch version
// (`repro_torch.kernels.ref.csr_spmv_ref`, `index_add_` on the CPU) sums
// in the same order, so the two agree bit for bit, run after run: the
// synthesis loop fixes orbits by the order of the LP's fractional values,
// where one ulp of noise can change the fabric. SEGMENT is also defined in
// repro_torch/kernels/csr_spmv.py; a test holds the two equal.
//
// Design. A plan made once per CSR on the host (`csr_spmv.plan`) lists the
// rows in grid order by class, and every class sums in the order above, so
// the classes change who adds, never the result. Only long rows have more
// than one segment; a row of any other class is its one segment:
// - long rows (> SEGMENT entries) first, one block each, so they start
//   while the other classes fill the card. A row of at most WARPS / 2
//   segments gives each segment a pair of warps: a producer stages its
//   products round after round into two shared-memory slots, and lane 0
//   of a consumer adds each round in order while the next is staged
//   (named barrier 1 + segment hands the slots over). A longer row gives
//   warp w segments w, w + WARPS, ..., each summed as a warp row is.
//   After a __syncthreads one thread adds the segment sums in order.
// - warp rows (QUARTER_MAX < len <= SEGMENT in the plan), one warp each,
//   warp_rows a block (the plan's choice: about one block an SM), so that
//   they spread over the SMs: a leader's adds share the SM's FP64 pipe
//   with the other leaders there. And
//   quarter-warp rows (SHORT_MAX < len <= QUARTER_MAX), eight lanes each,
//   four rows a warp; both longest first, so that the warps of a block
//   have like work. The lanes of a row gather U products each a
//   round, coalesced, in a three-stage pipeline (indices and values two
//   rounds ahead, the gathered x one round ahead), and stage them in
//   shared memory; the row's leader lane adds them in order (a full round
//   unrolled, its loads hoisted ahead of the adds) while the next rounds'
//   loads fly. A leader's adds are a dependent chain, one lane of a warp
//   instruction: four rows a warp issue a quarter of the instructions per
//   entry that one row a warp does.
// - short rows (len <= SHORT_MAX), one thread each, CHUNK loads in flight
//   at a time, in a pass over all rows in row order (no plan to read).
//
// Bounds. Bytes: row offsets, indices, values and x read once, out written
// once, at the memory rate (`chip_smoke.spmv_bound_ms`). Order: the longest
// dependent chain of adds, min(len, SEGMENT) + ceil(len / SEGMENT) for the
// longest row, times the latency of a dependent DADD (`csr_spmv_probe`:
// 8 cycles on the H100), over the SM clock. At the 4x8x8 synthesis LP, A^T
// has one row of 8,256 entries (the column of lambda) beside rows of at
// most 7, so A^T y is held by its 2,053-add chain (8.3 us at 1.98 GHz); a
// leader's adds take ~13 cycles each, not 8, as ptxas issues each shared
// load about four adds ahead of its use. A x (8,448 rows of 55-578
// entries) is held by its bytes, the gather of x and the fill of its
// rows' dependent loads.
//
// Plain C entry points, loaded with ctypes (repro_torch/kernels/csr_spmv.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define SEGMENT 2048

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int QUARTER = 8;            // lanes a quarter-warp row takes
constexpr int U_WARP = 4;             // entries a lane stages per round,
constexpr int U_QUARTER = 2;          // by lanes a row
constexpr int PAD = 2;                // doubles between a warp's row buffers
constexpr int STAGE = 32 * (U_WARP > U_QUARTER ? U_WARP : U_QUARTER)
    + (32 / QUARTER) * PAD;           // doubles of shared memory a warp has
constexpr int CHUNK = 8;              // a short row's loads in flight
constexpr unsigned FULL = 0xffffffffu;
static_assert(STAGE >= 32 * U_WARP, "a warp's buffer holds a round");
static_assert(SEGMENT % (QUARTER * U_QUARTER) == 0 &&
              SEGMENT % (32 * U_WARP) == 0,
              "a round never straddles two segments");

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
    return a < b ? a : b;
}

// A row of the warp's G-lane group: its round `r` of the n entries at ind,
// val; each lane's indices and values, two rounds ahead.
template <int G, int U>
__device__ __forceinline__ void load_iv(const int32_t* __restrict__ ind,
                                        const double* __restrict__ val,
                                        int r, int n, int sub,
                                        int32_t (&ia)[U], double (&va)[U]) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
        const int k = r + j * G + sub;
        ia[j] = k < n ? __ldg(ind + k) : 0;
        va[j] = k < n ? __ldg(val + k) : 0.0;
    }
}

// The gathered x of round `r`, one round ahead; vb takes over va.
template <int G, int U>
__device__ __forceinline__ void gather(const double* __restrict__ x, int r,
                                       int n, int sub,
                                       const int32_t (&ia)[U],
                                       const double (&va)[U],
                                       double (&vb)[U], double (&xb)[U]) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
        vb[j] = va[j];
        xb[j] = r + j * G + sub < n ? __ldg(x + ia[j]) : 0.0;
    }
}

// Round `r`'s products into the group's `buf`; entries past n stage as
// -0.0, which is exact: s + (-0.0) == s for every s.
template <int G, int U>
__device__ __forceinline__ void stage_round(double* buf, int r, int n,
                                            int sub, const double (&vb)[U],
                                            const double (&xb)[U]) {
#pragma unroll
    for (int j = 0; j < U; ++j)
        buf[j * G + sub] = r + j * G + sub < n
            ? __dmul_rn(vb[j], xb[j]) : -0.0;
}

// acc plus the first m <= R staged values of `buf`, left to right, in
// whole pairs (a value past m is -0.0); a full round unrolled, so that
// its shared loads issue ahead of the adds.
template <int R>
__device__ __forceinline__ double add_round(double acc, const double* buf,
                                            int m) {
    const double2* b2 = reinterpret_cast<const double2*>(buf);
    if (m == R) {
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
            const double2 v = b2[i];
            acc = __dadd_rn(acc, v.x);
            acc = __dadd_rn(acc, v.y);
        }
    } else {
        for (int i = 0; i < (m + 1) / 2; ++i) {
            const double2 v = b2[i];
            acc = __dadd_rn(acc, v.x);
            acc = __dadd_rn(acc, v.y);
        }
    }
    return acc;
}

// Each G-lane group of the warp sums the n <= SEGMENT entries at its ind,
// val (one row, or one segment of a row) left to right from 0.0; the sum
// is its leader's (sub == 0). The warp loops to n_max, the largest n of
// its groups. `buf` is the group's G * U doubles of shared memory. The
// lanes stage G * U products a round, gathered in a three-stage pipeline
// (indices and values two rounds ahead, x one round ahead); the leader
// adds them in order.
template <int G, int U>
__device__ double group_ordered_sum(const int32_t* __restrict__ ind,
                                    const double* __restrict__ val,
                                    const double* __restrict__ x, int n,
                                    int n_max, double* buf, int sub) {
    constexpr int R = G * U;
    int32_t ia[U];
    double va[U], vb[U], xb[U];
    load_iv<G, U>(ind, val, 0, n, sub, ia, va);
    gather<G, U>(x, 0, n, sub, ia, va, vb, xb);
    load_iv<G, U>(ind, val, R, n, sub, ia, va);
    double acc = 0.0;
    for (int r = 0; r < n_max; r += R) {
        __syncwarp();
        stage_round<G, U>(buf, r, n, sub, vb, xb);
        __syncwarp();
        gather<G, U>(x, r + R, n, sub, ia, va, vb, xb);
        load_iv<G, U>(ind, val, r + 2 * R, n, sub, ia, va);
        if (sub == 0 && r < n) acc = add_round<R>(acc, buf, min(R, n - r));
    }
    return acc;
}

// A segment of a long row by a pair of warps, when the row has at most
// WARPS / 2 segments: the producer warp stages round after round of the
// n entries at ind, val into two slots of R_LONG doubles, slot0 and slot1
// (the same pipeline as group_ordered_sum), and lane 0 of the consumer warp
// adds each round in order while the producer stages the next. Named
// barrier `bar` (64 threads) hands the slots over: at its k-th use round
// k is staged and round k - 1 added.
constexpr int R_LONG = 32 * U_WARP;

__device__ __forceinline__ void pair_barrier(int bar) {
    asm volatile("bar.sync %0, 64;" :: "r"(bar) : "memory");
}

__device__ void produce_segment(const int32_t* __restrict__ ind,
                                const double* __restrict__ val,
                                const double* __restrict__ x, int n,
                                double* slot0, double* slot1, int lane,
                                int bar) {
    int32_t ia[U_WARP];
    double va[U_WARP], vb[U_WARP], xb[U_WARP];
    load_iv<32, U_WARP>(ind, val, 0, n, lane, ia, va);
    gather<32, U_WARP>(x, 0, n, lane, ia, va, vb, xb);
    load_iv<32, U_WARP>(ind, val, R_LONG, n, lane, ia, va);
    for (int r = 0, k = 0; r < n; r += R_LONG, ++k) {
        stage_round<32, U_WARP>(k & 1 ? slot1 : slot0, r, n, lane, vb, xb);
        gather<32, U_WARP>(x, r + R_LONG, n, lane, ia, va, vb, xb);
        load_iv<32, U_WARP>(ind, val, r + 2 * R_LONG, n, lane, ia, va);
        pair_barrier(bar);
    }
}

__device__ double consume_segment(int n, const double* slot0,
                                  const double* slot1, int lane, int bar) {
    double acc = 0.0;
    for (int r = 0, k = 0; r < n; r += R_LONG, ++k) {
        pair_barrier(bar);
        if (lane == 0)
            acc = add_round<R_LONG>(acc, k & 1 ? slot1 : slot0,
                                    min(R_LONG, n - r));
        __syncwarp();           // bar.sync is aligned: the warp arrives whole
    }
    return acc;
}

__global__ void __launch_bounds__(THREADS, 2)
csr_spmv_kernel(const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const double* __restrict__ vals,
                const double* __restrict__ x, double* __restrict__ out,
                const int32_t* __restrict__ order, int rows, int n_long,
                int n_warp, int warp_rows, int n_quarter, int short_max) {
    __shared__ __align__(16) double stage[WARPS][STAGE];
    __shared__ double seg_sum[WARPS];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int warp_blocks = (n_warp + warp_rows - 1) / warp_rows;
    constexpr int PER_BLOCK = WARPS * (32 / QUARTER);
    const int quarter_blocks = (n_quarter + PER_BLOCK - 1) / PER_BLOCK;
    int block = blockIdx.x;

    if (block < n_long) {                       // a long row: this block
        const int row = __ldg(order + block);
        const int64_t b = __ldg(indptr + row), e = __ldg(indptr + row + 1);
        const int64_t segs = (e - b + SEGMENT - 1) / SEGMENT;
        double total = 0.0;
        if (segs <= WARPS / 2) {                // a pair of warps a segment
            const int s = warp % (WARPS / 2);
            if (s < segs) {
                const int64_t sb = b + (int64_t)s * SEGMENT;
                const int n = (int)lmin(SEGMENT, e - sb);
                double* slot0 = stage[s];
                double* slot1 = stage[s + WARPS / 2];
                if (warp >= WARPS / 2) {
                    produce_segment(indices + sb, vals + sb, x, n, slot0,
                                    slot1, lane, 1 + s);
                } else {
                    const double v = consume_segment(n, slot0, slot1, lane,
                                                     1 + s);
                    if (lane == 0) seg_sum[s] = v;
                }
            }
            __syncthreads();
            if (threadIdx.x == 0)
                for (int i = 0; i < segs; ++i)
                    total = __dadd_rn(total, seg_sum[i]);
        } else {                                // a warp a segment
            for (int64_t s0 = 0; s0 < segs; s0 += WARPS) {
                const int64_t s = s0 + warp;
                if (s < segs) {
                    const int64_t sb = b + s * SEGMENT;
                    const int n = (int)lmin(SEGMENT, e - sb);
                    const double v = group_ordered_sum<32, U_WARP>(
                        indices + sb, vals + sb, x, n, n, stage[warp], lane);
                    if (lane == 0) seg_sum[warp] = v;
                }
                __syncthreads();
                if (threadIdx.x == 0) {
                    const int n = (int)lmin(WARPS, segs - s0);
                    for (int i = 0; i < n; ++i)
                        total = __dadd_rn(total, seg_sum[i]);
                }
                __syncthreads();
            }
        }
        if (threadIdx.x == 0) out[row] = total;
        return;
    }
    block -= n_long;
    order += n_long;

    if (block < warp_blocks) {                  // a warp row: this warp
        const int i = block * warp_rows + warp;
        if (warp >= warp_rows || i >= n_warp) return;
        const int row = __ldg(order + i);
        const int64_t b = __ldg(indptr + row);
        const int n = (int)(__ldg(indptr + row + 1) - b);
        const double total = group_ordered_sum<32, U_WARP>(
            indices + b, vals + b, x, n, n, stage[warp], lane);
        if (lane == 0) out[row] = total;
        return;
    }
    block -= warp_blocks;
    order += n_warp;

    if (block < quarter_blocks) {               // four rows: this warp
        const int g = lane / QUARTER, sub = lane % QUARTER;
        const int i = (block * WARPS + warp) * (32 / QUARTER) + g;
        if (block * PER_BLOCK + warp * (32 / QUARTER) >= n_quarter) return;
        int row = -1, n = 0;
        int64_t b = 0;
        if (i < n_quarter) {
            row = __ldg(order + i);
            b = __ldg(indptr + row);
            n = (int)(__ldg(indptr + row + 1) - b);
        }
        const double total = group_ordered_sum<QUARTER, U_QUARTER>(
            indices + b, vals + b, x, n, __reduce_max_sync(FULL, n),
            stage[warp] + g * (QUARTER * U_QUARTER + PAD), sub);
        if (sub == 0 && row >= 0) out[row] = total;
        return;
    }
    block -= quarter_blocks;

    // a short row: this thread. The pass covers every row in row order and
    // leaves the rows of more than short_max entries to the classes above.
    const int64_t i = (int64_t)block * THREADS + threadIdx.x;
    if (i >= rows) return;
    const int row = (int)i;
    const int64_t b = __ldg(indptr + row), e = __ldg(indptr + row + 1);
    if (e - b > short_max) return;
    double acc = 0.0;
    for (int64_t k = b; k < e; k += CHUNK) {
        double p[CHUNK];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j)
            p[j] = k + j < e ? __dmul_rn(__ldg(vals + k + j),
                                         __ldg(x + __ldg(indices + k + j)))
                             : -0.0;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j)
            if (k + j < e) acc = __dadd_rn(acc, p[j]);
    }
    out[row] = acc;
}

// One thread a block: a chain of iters * 64 dependent DADDs, timed with
// the SM clock and the global nanosecond timer (their ratio is the SM
// clock's rate during the chain); the timer reads are ordered against the
// chain by taking it as an operand.
__global__ void csr_spmv_probe_kernel(int iters, long long* spans,
                                      double* sink, double a, double b) {
    long long c0, c1, t0, t1;
    asm volatile("mov.u64 %0, %%clock64;\n\tmov.u64 %1, %%globaltimer;"
                 : "=l"(c0), "=l"(t0), "+d"(a) :: "memory");
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < 64; ++k) a = __dadd_rn(a, b);
    }
    asm volatile("mov.u64 %0, %%clock64;\n\tmov.u64 %1, %%globaltimer;"
                 : "=l"(c1), "=l"(t1), "+d"(a) :: "memory");
    spans[2 * blockIdx.x] = c1 - c0;
    spans[2 * blockIdx.x + 1] = t1 - t0;
    sink[blockIdx.x] = a;
}

cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    return err;
}

}  // namespace

// out[r] for r < rows by the plan `order` (n_long long rows, then n_warp
// warp rows, warp_rows of them a block, then n_quarter quarter-warp rows:
// every row of more than short_max entries) and a pass over the rows of at
// most short_max;
// indptr holds rows + 1 offsets. Launches on `stream`, never
// synchronises, and returns the launch's CUDA error code (0 on success).
// Sets the device only when it is not already current, so a launch inside
// a CUDA graph capture makes no device call.
extern "C" int csr_spmv_f64(const void* indptr, const void* indices,
                            const void* vals, const void* x, void* out,
                            const void* order, int rows, int n_long,
                            int n_warp, int warp_rows, int n_quarter,
                            int short_max, int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rows <= 0) return 0;
    constexpr int PER_BLOCK = WARPS * (32 / QUARTER);
    if (warp_rows < 1 || warp_rows > WARPS || short_max > SEGMENT)
        return cudaErrorInvalidValue;
    const int blocks = n_long + (n_warp + warp_rows - 1) / warp_rows
        + (n_quarter + PER_BLOCK - 1) / PER_BLOCK
        + (rows + THREADS - 1) / THREADS;
    csr_spmv_kernel<<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const double*>(vals), static_cast<const double*>(x),
        static_cast<double*>(out), static_cast<const int32_t*>(order), rows,
        n_long, n_warp, warp_rows, n_quarter, short_max);
    return static_cast<int>(cudaGetLastError());
}

// `blocks` one-thread blocks of the DADD latency probe; spans[2 i] and
// spans[2 i + 1] are block i's SM clock and nanosecond spans over
// iters * 64 adds.
extern "C" int csr_spmv_probe(int blocks, int iters, void* spans,
                              void* sink, int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    csr_spmv_probe_kernel<<<blocks, 1, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        iters, static_cast<long long*>(spans), static_cast<double*>(sink),
        1.0, 0x1p-60);
    return static_cast<int>(cudaGetLastError());
}
