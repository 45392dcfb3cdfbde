// Blocked GQA flash attention (forward) for Hopper (sm_90a), CUDA cores.
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h', j]) v[b, h', j]
//   h' = h / (Hq / Hkv),  scale = 1 / sqrt(hd),  causal: j <= i (top-left)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _kernel, and computes what it computes: scores in f32 from q (cast to
// f32, times scale) and k (cast to f32); an online softmax whose running
// max starts at -1e30 and whose running sum starts at 0; P.V in f32; the
// output acc / max(l, 1e-30) cast to q's dtype. Masked scores are -1e30,
// as in the TPU kernel, and causal tiles wholly above the diagonal are
// skipped. The TPU kernel carries (m, l, acc) in VMEM scratch across a
// sequential kv grid axis and asserts Sq % bq == 0; Hopper blocks run in
// parallel and in no order, so here each block owns one 64-row q tile of
// one (batch, head), loops over the kv tiles itself, and masks ragged
// tails (any Sq, Skv) instead.
//
// Design: 256 threads in a 16 x 16 grid. Thread (ty, tx) owns q rows
// ty*4..ty*4+3: their 4 x 4 scores at kv columns tx + 16c of the tile,
// their softmax state (m, l; the same in all 16 threads of a row, which
// reduce by warp shuffles), and their output columns tx*4.. (+64 for
// hd = 128) in registers. q (times scale), then each K tile and V tile,
// are staged in shared memory as f32 with rows padded to hd + 4 floats,
// so every inner-loop read is a conflict-free float4; P goes through
// shared memory between the two products. The rows of q and the tiles of
// K/V/o are addressed by strides, so the model's (B, S, H, hd) layout is
// read and written in place. Blocks take the longest causal rows first.
//
// Bound: for the serving shapes (bf16, hd 128, causal) the function is
// bound by operations -- 4 * hd flops per visible (q, k) pair, ~1.7e10 at
// S = 2048, 0.016 ms on the tensor cores -- against ~19 MB of q, k, v, o
// (0.006 ms at 3.35 TB/s). This first kernel runs its two products in
// f32 on the CUDA cores (67 TFLOP/s peak, so 0.26 ms at best at S = 2048)
// and is the simple, exact-to-tolerance version; wgmma with bf16 operands
// fed by TMA is the redesign that can approach the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows r0 .. r0+63 of one head (row stride `ss` elements) into `dst` as
// f32 times `mul`, row stride LD; rows at or past `n` are zero.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int n,
                                          float mul) {
  for (int e = threadIdx.x; e < 64 * HD; e += THREADS) {
    const int r = e / HD, d = e % HD, gr = r0 + r;
    dst[r * LD + d] = gr < n ? to_f32(src[gr * ss + d]) * mul : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Geometry g) {
  constexpr int LD = HD + 4;   // 16-byte rows; float4 reads conflict-free
  constexpr int DC = HD / 64;  // float4 output column groups per thread
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

  load_tile<T, HD, LD>(Qs, q + b * g.q_sb + h * g.q_sh, g.q_ss, q0, g.Sq,
                       g.scale);

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
    load_tile<T, HD, LD>(KVs, kp, g.k_ss, k0, g.Skv, 1.f);
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
    load_tile<T, HD, LD>(KVs, vp, g.v_ss, k0, g.Skv, 1.f);
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
    for (int cg = 0; cg < DC; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&op[row * g.o_ss + cg * 64 + tx * 4 + e],
              acc[r][cg * 4 + e] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, const Geometry& g, cudaStream_t stream) {
  constexpr int LD = HD + 4;
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

}  // namespace

// C entry point for ctypes. q (B, Hq, Sq, hd), k and v (B, Hkv, Skv, hd)
// and o (the shape of q) on `device`, all float32 (bf16 == 0) or all
// bfloat16 (bf16 == 1), addressed by `strides`: 12 element strides,
// (batch, head, position) of q, k, v, o in that order, hd contiguous.
// hd is 64 or 128 and Hq % Hkv == 0 (the wrapper checks). Launches on
// `stream` and returns the CUDA error (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bf16, int hd,
                                   int B, int Hq, int Hkv, int Sq, int Skv,
                                   const long long* strides, float scale,
                                   int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g{Hq, Hkv, Sq, Skv,
                   strides[0], strides[1], strides[2],
                   strides[3], strides[4], strides[5],
                   strides[6], strides[7], strides[8],
                   strides[9], strides[10], strides[11],
                   scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && hd == 64) err = launch<__nv_bfloat16, 64>(q, k, v, o, B, g, s);
  else if (bf16 && hd == 128) err = launch<__nv_bfloat16, 128>(q, k, v, o, B, g, s);
  else if (!bf16 && hd == 64) err = launch<float, 64>(q, k, v, o, B, g, s);
  else if (!bf16 && hd == 128) err = launch<float, 128>(q, k, v, o, B, g, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
