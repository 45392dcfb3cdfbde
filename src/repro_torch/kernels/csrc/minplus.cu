// (min, +) matrix product for Hopper (sm_90a), CUDA cores.
//
//   out[i, j] = min(BIG, min_k a[i, k] + b[k, j])      f32, BIG = 1e9
//
// Replaces the Pallas TPU kernel src/repro/kernels/minplus.py:_kernel
// (the same function: its accumulator starts at BIG = 1e9 and takes an
// exact min of f32 sums, so the result is bit-identical whatever the
// order of k). The TPU kernel carries its accumulator in VMEM scratch
// across a sequential K grid axis; Hopper blocks run in parallel and in
// no order, so here the K loop lives inside the block instead.
//
// Design: each block owns one 64x64 output tile (256 threads, a 4x4
// register micro-tile each) and streams 32-deep K slices of A and B
// through shared memory. A is stored transposed (As[k][m], rows padded
// to 68 floats) so both operands are read as float4 broadcasts/rows in
// the inner loop. Ragged edges are filled with +inf, which never wins a
// min. The semiring has no tensor-core path, so the kernel runs on the
// FP32 ALUs.
//
// Bound: operations. M*N*K adds plus M*N*K mins, none of which fuse: at
// 4096^3 that is 1.37e11 instructions, ~4 ms per squaring at one op per
// lane per clock (132 SMs x 128 lanes x ~1.98 GHz), against 0.2 GB of
// operand and result traffic (~0.06 ms at 3.35 TB/s). Later work: hop
// distances are small integers, and Hopper's DPX fused add-min
// (__viaddmin_s32) does the add and the min in one instruction on int32;
// larger micro-tiles would also cut the shared-memory loads per op.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int AS_LD = BM + 4;                   // 16-byte aligned rows
constexpr float BIG = 1e9f;

__global__ void __launch_bounds__(THREADS)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][AS_LD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int t = threadIdx.x;
  const int tx = t % (BN / TN);
  const int ty = t / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = BIG;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: consecutive threads read consecutive k of one row
    for (int l = t; l < BM * BK; l += THREADS) {
      const int r = l / BK, c = l % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : CUDART_INF_F;
    }
    // B tile: consecutive threads read consecutive columns
    for (int l = t; l < BK * BN; l += THREADS) {
      const int r = l / BN, c = l % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : CUDART_INF_F;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fminf(acc[i][j], __fadd_rn(ar[i], br[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// C entry point for ctypes: row-major contiguous f32 a (M, K), b (K, N),
// out (M, N) on `device`; launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int minplus_f32(const float* a, const float* b, float* out,
                           int M, int N, int K, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  minplus_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
