// Blocked GQA flash attention (forward) for Hopper (sm_90a).
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h', j]) v[b, h', j]
//   h' = h / (Hq / Hkv),  scale = 1 / sqrt(hd),  causal: j <= i (top-left)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:24
// (_kernel), and computes what it computes: an online softmax whose
// running max starts at -1e30 and whose running sum starts at 0, masked
// scores -1e30, the output acc / max(l, 1e-30) cast to q's dtype, causal
// tiles wholly above the diagonal skipped. The TPU kernel carries
// (m, l, acc) in VMEM scratch across a sequential kv grid axis and asserts
// Sq % bq == 0; Hopper blocks run in parallel and in no order, so here
// each block owns one q tile of one (batch, head), loops over the kv
// tiles itself, and masks ragged tails (any Sq, Skv) instead. Blocks take
// the longest causal rows first. q, k, v and o are addressed by strides,
// so the model's (B, S, H, hd) layout is read and written in place.
//
// Bound: at the serving shapes (bf16, hd 128, 16/2 heads, causal) the
// function is bound by operations on the bf16 tensor cores -- 4 * hd
// flops per visible (q, k) pair, 1.7e10 at S = 2048 (0.016 ms at 989
// TFLOP/s) against 19 MB of q, k, v, o (0.006 ms at 3.35 TB/s).
//
// Head dims 64, 128, 160 and 256 (the registered archs': 160 stablelm-12b,
// 256 gemma-7b). A tile holds hd rounded up to a multiple of 64 (HDP:
// 160 -> 192) columns, the padding zero: Q.K^T runs over the hd columns,
// P.V over all HDP (at hd 160 a fifth of its products multiply zeros),
// and only the hd columns are stored.
//
// bf16: both products run on the tensor cores with wgmma.
// A block is three warpgroups. Warpgroups 0 and 1 each own 64 q rows of a
// 128-row tile; one thread of warpgroup 2 issues TMA loads -- q once,
// then K and V tiles (128 rows up to hd 128, 64 above: Layout) into a
// two-stage ring in shared memory, with
// full and empty mbarriers for K and for V of each stage -- and gives its
// registers to the consumers (setmaxnreg 40 / 232). A consumer computes
// S = Q.K^T with m64nBKk16 (A = Q and B = K from shared memory, both
// K-major) and keeps the softmax in registers: each row lives in the 4
// lanes of a quad, which reduce the row max by shuffles; masking runs only
// on tiles that the diagonal or the Skv tail crosses; the scale times
// log2(e) is folded into one fma before ex2; l keeps per-lane partial
// sums of the f32 P (reduced once at the end). P is rounded to bf16 and
// fed from registers as wgmma's A operand (the accumulator fragment of S
// is the A fragment of P), and O += P.V reads V from shared memory
// MN-major (transpose bit), in m64n128k16 products (and one m64n64k16 where
// HDP is an odd multiple of 64). The two products overlap the softmax: tile
// t's Q.K_t and tile t-1's P.V_(t-1) are issued together, the softmax of
// tile t runs while P.V_(t-1) is still on the tensor cores, and K_t and
// V_(t-1) go back to the producer as soon as their product completes.
// Tensor maps are 4-d (hd, and B, H, S ordered by stride) with 64-column
// boxes and 128-byte swizzle, the swizzle the wgmma descriptors name.
// cuTensorMapEncodeTiled is looked up with cudaGetDriverEntryPoint, so
// the library needs no -lcuda. Rounding against the TPU kernel:
// products of two bf16 values are exact in f32 (only the accumulation
// order differs), the scale multiplies the product, and P.V takes P in
// bf16 as the JAX model's own attention does; tolerance 2e-2, as the TPU
// kernel's bf16 tests.
//
// f32 keeps the CUDA-core kernel below: its inputs cannot go on the bf16
// tensor cores within the 2e-5 tolerance, and TF32 keeps about three
// digits. 256 threads in a 16 x 16 grid; thread (ty, tx) owns q rows
// ty*4..ty*4+3: their 4 x 4 scores at kv columns tx + 16c of the tile,
// their softmax state (reduced by warp shuffles) and their output columns
// tx*4 + 64c (c < HDP / 64) in registers. q (times scale), then each K
// tile and V tile, are staged in shared memory as f32 with rows padded to
// HDP + 4 floats, so every inner-loop read is a conflict-free float4; P
// goes through shared memory between the two products. Above hd 128 the
// tiles take 115 KB (hd 160) and 147 KB (hd 256), so an SM holds one
// block instead of two.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ---- f32: the CUDA-core kernel -----------------------------------------------
namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TR = 4;         // q rows per thread
constexpr int TC = 4;         // score columns per thread (tx + 16c)
constexpr int PS_LD = BK + 4;
constexpr float NEG_INF = -1e30f;

struct Geometry {
  int Hq, Hkv, Sq, Skv;
  // element strides (batch, head, position) of q, k, v, o; hd is contiguous
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// A tile's columns in shared memory and registers: hd rounded up to a
// multiple of 64 (160 -> 192), the padding zero.
template <int HD>
__host__ __device__ constexpr int padded() { return (HD + 63) / 64 * 64; }

// Rows r0 .. r0+63 of one head (row stride `ss` elements) into `dst` as
// f32 times `mul`, row stride LD; rows at or past `n`, and the padding
// columns HD .. HDP-1, are zero.
template <typename T, int HD, int HDP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int n,
                                          float mul) {
  for (int e = threadIdx.x; e < 64 * HDP; e += THREADS) {
    const int r = e / HDP, d = e % HDP, gr = r0 + r;
    dst[r * LD + d] =
        gr < n && d < HD ? to_f32(src[gr * ss + d]) * mul : 0.f;
  }
}

// Two blocks an SM up to hd 128; above, one (the f32 tiles take 115 KB
// at hd 160 and 147 KB at hd 256 of the SM's 228 KB), with the
// registers a thread that one block leaves.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, HD <= 128 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Geometry g) {
  constexpr int HDP = padded<HD>();
  constexpr int LD = HDP + 4;   // 16-byte rows; float4 reads conflict-free
  constexpr int DC = HDP / 64;  // float4 output column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // BQ x LD: q * scale
  float* KVs = Qs + BQ * LD;    // BK x LD: this tile's K, then its V
  float* Ps = KVs + BK * LD;    // BQ x PS_LD: this tile's probabilities

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / g.Hq, h = blockIdx.y % g.Hq;
  const int hk = h / (g.Hq / g.Hkv);
  const T* kp = k + b * g.k_sb + hk * g.k_sh;
  const T* vp = v + b * g.v_sb + hk * g.v_sh;

  load_tile<T, HD, HDP, LD>(Qs, q + b * g.q_sb + h * g.q_sh, g.q_ss, q0,
                            g.Sq, g.scale);

  float acc[TR][4 * DC], m[TR], l[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, g.Sq) - 1;
  const int kv_end = g.causal ? min(g.Skv, q_last + 1) : g.Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // Qs written; the last tile's V reads are done
    load_tile<T, HD, HDP, LD>(KVs, kp, g.k_ss, k0, g.Skv, 1.f);
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[TR], kv[TC];
#pragma unroll
      for (int r = 0; r < TR; ++r)
        qv[r] = *reinterpret_cast<const float4*>(&Qs[(ty * TR + r) * LD + d]);
#pragma unroll
      for (int c = 0; c < TC; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * c) * LD + d]);
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          float x = s[r][c];
          x = fmaf(qv[r].x, kv[c].x, x);
          x = fmaf(qv[r].y, kv[c].y, x);
          x = fmaf(qv[r].z, kv[c].z, x);
          s[r][c] = fmaf(qv[r].w, kv[c].w, x);
        }
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int qpos = q0 + ty * TR + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int kpos = k0 + tx + 16 * c;
        if (kpos >= g.Skv || (g.causal && qpos < kpos)) s[r][c] = NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        rs += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[r][c] *= corr;
#pragma unroll
      for (int c = 0; c < TC; ++c)
        Ps[(ty * TR + r) * PS_LD + tx + 16 * c] = s[r][c];
    }
    __syncthreads();  // P written; the K reads are done
    load_tile<T, HD, HDP, LD>(KVs, vp, g.v_ss, k0, g.Skv, 1.f);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r)
        pv[r] = *reinterpret_cast<const float4*>(&Ps[(ty * TR + r) * PS_LD + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cg = 0; cg < DC; ++cg) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &KVs[(j + jj) * LD + cg * 64 + tx * 4]);
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            const float p = jj == 0 ? pv[r].x : jj == 1 ? pv[r].y
                          : jj == 2 ? pv[r].z : pv[r].w;
            acc[r][cg * 4 + 0] = fmaf(p, vv.x, acc[r][cg * 4 + 0]);
            acc[r][cg * 4 + 1] = fmaf(p, vv.y, acc[r][cg * 4 + 1]);
            acc[r][cg * 4 + 2] = fmaf(p, vv.z, acc[r][cg * 4 + 2]);
            acc[r][cg * 4 + 3] = fmaf(p, vv.w, acc[r][cg * 4 + 3]);
          }
        }
      }
    }
  }

  T* op = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = q0 + ty * TR + r;
    if (row >= g.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cg = 0; cg < DC; ++cg) {
      if (cg * 64 + tx * 4 >= HD) continue;  // a padding column group
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&op[row * g.o_ss + cg * 64 + tx * 4 + e],
              acc[r][cg * 4 + e] / den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, const Geometry& g, cudaStream_t stream) {
  constexpr int LD = padded<HD>() + 4;
  const size_t smem = sizeof(float) * (BQ * LD + BK * LD + BQ * PS_LD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((g.Sq + BQ - 1) / BQ, B * g.Hq);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), g);
  return cudaGetLastError();
}

// ---- bf16: wgmma on the tensor cores, K/V by TMA ----------------------------
namespace tc {

constexpr int BQ = 128;          // q rows per block, 64 per consumer warpgroup
constexpr int STAGES = 2;        // K/V ring depth
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 384;     // 2 consumer warpgroups + 1 producer
constexpr int ROW = 128;         // bytes per swizzled row: 64 bf16 columns
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Byte offsets from the 1024-aligned base of dynamic shared memory. Every
// tile is [HDP / 64 column chunks][rows][64 bf16], each chunk the layout
// TMA writes with 128-byte swizzle (16-byte unit u of row r at u ^ r % 8).
// HDP is hd padded to a multiple of 64: at hd 160 the third chunk's
// columns 160-191 lie outside the tensor map, and TMA writes them as
// zeros. Up to hd 128 a kv tile is 128 rows; above, 64, so that Q and
// the two-stage ring fit a block's 227 KB (hd 256: 64 + 128 KB, where
// 128-row tiles would take 64 + 256 KB) and the consumers' registers
// (hd 256: 128 of O, 32 of S and 16 of P a thread).
template <int HD>
struct Layout {
  static constexpr int HDP = padded<HD>();
  static constexpr int BK = HD <= 128 ? 128 : 64;  // kv rows per tile
  static constexpr int CHUNKS = HDP / 64;
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;  // one K or V tile
  static constexpr int RING = Q_BYTES;           // stage s: K, then V
  static constexpr int BARS = RING + STAGES * 2 * KV_BYTES;
  // barriers: full Q; full K, full V, empty K, empty V of each stage
  static constexpr int N_BARS = 1 + 4 * STAGES;
  static constexpr int BYTES = BARS + 8 * N_BARS;
  static constexpr int SMEM = 1024 + BYTES;     // + alignment slack
};

struct Geometry {
  int Hq, Hkv, Sq, Skv;
  long long o_sb, o_sh, o_ss;  // element strides of o; hd is contiguous
  int perm_q, perm_k, perm_v;  // tensor-map dim (1..3) of B, H, S: 2 bits each
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Tensor-map coordinate of map dim j (1..3), given where B, H, S went.
__device__ __forceinline__ int pick(int perm, int j, int b, int h, int s) {
  return (perm & 3) == j ? b : ((perm >> 2) & 3) == j ? h : s;
}

// One box (64 columns from `col`, the rows of position `s` on) of
// (b, h) into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int perm,
                                         int b, int h, int s) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col),
         "r"(pick(perm, 1, b, h, s)), "r"(pick(perm, 2, b, h, s)),
         "r"(pick(perm, 3, b, h, s)), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. Byte offsets:
// `lbo` between 64-element chunks of the contiguous dim (MN-major only),
// `sbo` between groups of 8 rows of the strided dim.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// The same for A fragments that an in-flight wgmma still reads: they stay
// live, in their registers, until this point.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D32 D8(0), D8(8), D8(16), D8(24)
#define D64 D32, D8(32), D8(40), D8(48), D8(56)
#define R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
    "%28, %29, %30, %31}"
#define R64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
    "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
    "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
    "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N, f32) = (accumulate ? d : 0) + A (64 x 16) . B (16 x N),
// both bf16 in shared memory, K-major; N = 128 or 64.
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64 : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32 : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 pairs in registers) . B (16 x N),
// B in shared memory MN-major (transpose bit set).
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The scores of one kv tile (raw S = Q.K^T in `sc`) into probabilities
// in place: mask where the diagonal or the Skv tail runs (masked scores
// are -1e30 before scaling), fold the scale into exp2, update the running
// max m (in log2 units) and this lane's part of the row sum l, and return
// the correction c = exp2(m_old - m_new) of each row. Rows r0 (e = 0, 1)
// and r0 + 8 (e = 2, 3) live in the 4 lanes of a quad.
template <int N>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[N], bool masked, int k0, int col0, int qpos0, int qpos1,
    const Geometry& g, float sl2, float& m0, float& m1, float& l0, float& l1,
    float& c0, float& c1) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + col0 + 8 * i + (e & 1);
        if (col >= g.Skv || (g.causal && col > (e < 2 ? qpos0 : qpos1)))
          sc[4 * i + e] = NEG_INF;
      }
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float n0 = fmaxf(m0, mx0 * sl2), n1 = fmaxf(m1, mx1 * sl2);
  c0 = ex2(m0 - n0);
  c1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    sc[4 * i] = ex2(fmaf(sc[4 * i], sl2, -n0));
    sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], sl2, -n0));
    sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], sl2, -n1));
    sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], sl2, -n1));
    rs0 += sc[4 * i] + sc[4 * i + 1];
    rs1 += sc[4 * i + 2] + sc[4 * i + 3];
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
}

// P (f32, the S accumulator's fragment) as bf16 wgmma A fragments, one per
// k16 slice: the accumulator fragment of columns 16k.. is the A fragment.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&p)[N],
                                           uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    pa[i / 2][2 * (i % 2)] = pack_bf16(p[4 * i], p[4 * i + 1]);
    pa[i / 2][2 * (i % 2) + 1] = pack_bf16(p[4 * i + 2], p[4 * i + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float c0, float c1) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    acc[4 * i] *= c0;
    acc[4 * i + 1] *= c0;
    acc[4 * i + 2] *= c1;
    acc[4 * i + 3] *= c1;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, Geometry g) {
  using L = Layout<HD>;
  constexpr int HDP = L::HDP, BK = L::BK, CHUNKS = L::CHUNKS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // barriers, 8 bytes each: full Q; then per stage s full K, full V,
  // empty K, empty V at + 8 s
  const uint32_t full_q = base + L::BARS;
  const uint32_t full_k = full_q + 8, full_v = full_k + 8 * STAGES,
                 empty_k = full_v + 8 * STAGES,
                 empty_v = empty_k + 8 * STAGES;
  const uint32_t ring = base + L::RING;  // stage s: K at ring + s * 2 tiles
  const int tid = threadIdx.x;
  const int b = blockIdx.x / g.Hq, h = blockIdx.x % g.Hq;
  const int hk = h / (g.Hq / g.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int q_last = min(q0 + BQ, g.Sq) - 1;
  const int kv_end = g.causal ? min(g.Skv, q_last + 1) : g.Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMER_WARPS);
      mbar_init(empty_v + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 2 * 128) {
      mbar_expect_tx(full_q, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
        tma_load(base + c * BQ * ROW, &tq, full_q, 64 * c, g.perm_q, b, h,
                 q0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;
        const uint32_t kt = ring + s * 2 * L::KV_BYTES;
        mbar_wait(empty_k + 8 * s, free_parity);
        mbar_expect_tx(full_k + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
          tma_load(kt + c * BK * ROW, &tk, full_k + 8 * s, 64 * c, g.perm_k,
                   b, hk, t * BK);
        mbar_wait(empty_v + 8 * s, free_parity);
        mbar_expect_tx(full_v + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
          tma_load(kt + L::KV_BYTES + c * BK * ROW, &tv, full_v + 8 * s,
                   64 * c, g.perm_v, b, hk, t * BK);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    // Tile t's S = Q.K_t runs on the tensor cores while tile t-1's
    // O += P.V_(t-1) is queued behind it; the softmax of tile t overlaps
    // that product, and P_t replaces P_(t-1) once it has completed.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid / 128, lane = tid % 32;
    const int r0 = wg * 64 + (tid / 32) % 4 * 16 + lane / 4;  // and r0 + 8
    const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
    const int col0 = 2 * (lane % 4);  // first column of this lane
    const int wg_first = q0 + wg * 64;
    const uint32_t qa = base + wg * 64 * ROW;
    const float sl2 = g.scale * LOG2E;
    auto masked = [&](int k0) {
      return k0 + BK > g.Skv || (g.causal && k0 + BK - 1 > wg_first);
    };
    // S = Q . K^T from the K tile at `kt`, over the hd columns only (the
    // padding is zero in both)
    auto qk = [&](float (&sc)[BK / 2], uint32_t kt) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss(sc, desc(qa + kk / 4 * BQ * ROW + kk % 4 * 32, 16, 8 * ROW),
               desc(kt + kk / 4 * BK * ROW + kk % 4 * 32, 16, 8 * ROW),
               kk > 0);
      wgmma_commit();
    };
    // O += P . V from the V tile at `vt` (MN-major), over all HDP columns
    // in products of 128 columns (accumulator fragment 64 c .. of columns
    // 128 c ..) and, where HDP is an odd multiple of 64, one of 64
    auto pv = [&](float (&acc)[HDP / 2], const uint32_t (&pa)[BK / 16][4],
                  uint32_t vt) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t vk = vt + kk * 16 * ROW;
#pragma unroll
        for (int c = 0; c < HDP / 128; ++c)
          mma_rs(*reinterpret_cast<float(*)[64]>(&acc[64 * c]), pa[kk],
                 desc(vk + 2 * c * BK * ROW, BK * ROW, 8 * ROW));
        if constexpr (HDP % 128 != 0)
          mma_rs(*reinterpret_cast<float(*)[32]>(&acc[HDP / 2 - 32]), pa[kk],
                 desc(vk + (CHUNKS - 1) * BK * ROW, BK * ROW, 8 * ROW));
      }
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);  // this warp is done with the tile
    };

    float acc[HDP / 2];  // O: m64 x HDP fragment
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float sc[BK / 2];  // S, then P, of one tile: m64 x BK fragment
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    uint32_t pa[BK / 16][4];
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, c0, c1;

    mbar_wait(full_q, 0);
    mbar_wait(full_k, 0);
    fence_regs(sc);
    wgmma_fence();
    qk(sc, ring);
    wgmma_wait<0>();
    fence_regs(sc);
    release(empty_k);
    softmax_tile(sc, masked(0), 0, col0, qpos0, qpos1, g, sl2, m0, m1, l0, l1,
                 c0, c1);
    to_a_frags(sc, pa);

    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % STAGES, sp = (t - 1) % STAGES;
      const uint32_t kt = ring + s * 2 * L::KV_BYTES;
      const uint32_t vt = ring + sp * 2 * L::KV_BYTES + L::KV_BYTES;
      rescale(acc, c0, c1);
      mbar_wait(full_k + 8 * s, (t / STAGES) & 1);
      mbar_wait(full_v + 8 * sp, ((t - 1) / STAGES) & 1);
      fence_regs(acc);
      fence_regs(sc);
      wgmma_fence();
      qk(sc, kt);
      pv(acc, pa, vt);
      wgmma_wait<1>();  // S done, P.V may still run
      fence_regs(sc);
      release(empty_k + 8 * s);
      softmax_tile(sc, masked(t * BK), t * BK, col0, qpos0, qpos1, g, sl2,
                   m0, m1, l0, l1, c0, c1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(empty_v + 8 * sp);
      to_a_frags(sc, pa);
    }
    const int sl = (n_tiles - 1) % STAGES;
    rescale(acc, c0, c1);
    mbar_wait(full_v + 8 * sl, ((n_tiles - 1) / STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
    pv(acc, pa, ring + sl * 2 * L::KV_BYTES + L::KV_BYTES);
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: o = acc / max(l, 1e-30), rows below Sq and the hd
    // columns only
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* op = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {  // fragment i: columns 8 i ..
      const int col = 8 * i + col0;
      if (qpos0 < g.Sq)
        *reinterpret_cast<__nv_bfloat162*>(&op[qpos0 * g.o_ss + col]) =
            __floats2bfloat162_rn(acc[4 * i] / d0, acc[4 * i + 1] / d0);
      if (qpos1 < g.Sq)
        *reinterpret_cast<__nv_bfloat162*>(&op[qpos1 * g.o_ss + col]) =
            __floats2bfloat162_rn(acc[4 * i + 2] / d1, acc[4 * i + 3] / d1);
    }
  }
}

#undef D8
#undef D32
#undef D64
#undef R32
#undef R64

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so that the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d tensor map of one bf16 tensor (B, H, S, hd) with element strides
// (sb, sh, ss) and hd contiguous: dim 0 is hd, dims 1..3 are B, H, S in
// order of byte stride (a dim of extent 1 takes the tensor's span, a
// valid stride that it never steps). Boxes are 64 columns by `rows`
// positions. `perm` gets the map dim of B, H, S, 2 bits each.
CUresult encode_map(CUtensorMap* map, const void* ptr, int hd, int B, int H,
                    int S, long long sb, long long sh, long long ss,
                    int rows, int* perm) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const long long ext[3] = {B, H, S};
  long long stride[3] = {2 * sb, 2 * sh, 2 * ss};
  const long long span =
      ((2 * (hd + (B - 1) * sb + (H - 1) * sh + (S - 1) * ss) + 15) / 16) * 16;
  for (int i = 0; i < 3; ++i)
    if (ext[i] == 1) stride[i] = span;
  int order[3] = {0, 1, 2};  // stable sort of B, H, S by stride
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int x = order[j];
      order[j] = order[j - 1];
      order[j - 1] = x;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  *perm = 0;
  for (int j = 0; j < 3; ++j) {
    dims[j + 1] = static_cast<cuuint64_t>(ext[order[j]]);
    strides[j] = static_cast<cuuint64_t>(stride[order[j]]);
    if (order[j] == 2) box[j + 1] = rows;
    *perm |= (j + 1) << (2 * order[j]);
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int MAX_DEVICES = 64;  // devices whose opt-in is remembered

// Returns a CUDA error (0 = launched), or minus the CUresult of a failed
// tensor-map encode. The maps span the hd columns; a box past them (hd
// 160's third chunk) is filled with zeros and still counts its full bytes
// toward the barrier's transaction.
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, const long long* st, float scale,
           int causal, int device, cudaStream_t stream) {
  Geometry g{Hq, Hkv, Sq, Skv, st[9], st[10], st[11], 0, 0, 0, scale, causal};
  CUtensorMap tq, tk, tv;
  constexpr int BK = Layout<HD>::BK;
  CUresult res = encode_map(&tq, q, HD, B, Hq, Sq, st[0], st[1], st[2], BQ,
                            &g.perm_q);
  if (res == CUDA_SUCCESS)
    res = encode_map(&tk, k, HD, B, Hkv, Skv, st[3], st[4], st[5], BK,
                     &g.perm_k);
  if (res == CUDA_SUCCESS)
    res = encode_map(&tv, v, HD, B, Hkv, Skv, st[6], st[7], st[8], BK,
                     &g.perm_v);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const int smem = Layout<HD>::SMEM;
  // The shared-memory opt-in is per device: made at the first launch on
  // each one, not on every call.
  static bool opted_in[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_fwd_wgmma<HD><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// C entry point for ctypes. q (B, Hq, Sq, hd), k and v (B, Hkv, Skv, hd)
// and o (the shape of q) on `device`, all float32 (bf16 == 0) or all
// bfloat16 (bf16 == 1), addressed by `strides`: 12 element strides,
// (batch, head, position) of q, k, v, o in that order, hd contiguous.
// hd is 64, 128, 160 or 256 and Hq % Hkv == 0; for bf16, q, k and v
// start on 16 bytes and their strides are multiples of 8 elements (the
// wrapper checks). Launches on `stream` and returns the CUDA error (0 =
// launched), or minus the CUresult of a failed tensor-map encode.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bf16, int hd,
                                   int B, int Hq, int Hkv, int Sq, int Skv,
                                   const long long* strides, float scale,
                                   int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (hd) {
      case 64: return tc::launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides,
                                     scale, causal, device, s);
      case 128: return tc::launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                       strides, scale, causal, device, s);
      case 160: return tc::launch<160>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                       strides, scale, causal, device, s);
      case 256: return tc::launch<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                       strides, scale, causal, device, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Geometry g{Hq, Hkv, Sq, Skv,
                   strides[0], strides[1], strides[2],
                   strides[3], strides[4], strides[5],
                   strides[6], strides[7], strides[8],
                   strides[9], strides[10], strides[11],
                   scale, causal};
  switch (hd) {
    case 64: err = launch<float, 64>(q, k, v, o, B, g, s); break;
    case 128: err = launch<float, 128>(q, k, v, o, B, g, s); break;
    case 160: err = launch<float, 160>(q, k, v, o, B, g, s); break;
    case 256: err = launch<float, 256>(q, k, v, o, B, g, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
