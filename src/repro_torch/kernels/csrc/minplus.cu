// (min, +) matrix product for Hopper (sm_90a), CUDA cores, two element
// paths from one kernel template:
//
//   f32 (minplus_f32):   out[i, j] = min(1e9, min_k a[i, k] + b[k, j])
//   hop (minplus_hops):  out[i, j] = min(INF, min_k a[i, k] + b[k, j]),
//                        int16 hop counts, INF = 16383 means "no path"
//
// Replaces the Pallas TPU kernel src/repro/kernels/minplus.py:_kernel
// (the f32 path is the same function: its accumulator starts at 1e9 and
// takes an exact min of f32 sums, so the result is bit-identical whatever
// the order of k). The hop path is the same function on hop matrices,
// whose values stay in {0, ..., n-1} and {1e9}: f32 sums below 2^24 are
// exact and everything at or above 1e9 is capped to 1e9, so mapping
// INF <-> 1e9 gives the same bits. It holds two output cells in each
// 32-bit word and does one DPX instruction (__viaddmin_s16x2, VIADDMNMX)
// for two (i, j, k) triples, where the f32 path needs an FADD and an
// FMNMX for one. INF + INF = 32766 cannot overflow int16.
//
// Bound: operations. M*N*K triples, none reaching the tensor cores (the
// semiring has no MMA). minplus_probe below measured, per SM per clock on
// an H100 SXM: FADD 122, FMNMX 63, VIADDMNMX 62.4 in s32 and in s16x2.
// The f32 path (one FADD and one FMNMX per triple) is held to ~63 triples
// per SM per clock by FMNMX: ~4.2 ms at 4096^3 (132 SMs, 1.98 GHz). The
// hop path does two triples per VIADDMNMX, ~125 per SM per clock: 2.1 ms
// at 4096^3, a quarter of the f32 path's instructions. Operand and result
// traffic is 0.2 GB (f32) / 0.1 GB (hop) at 4096^3, ~0.06 ms.
//
// Design (one template, P = element path, T = tile shape):
// - Each block owns a BM x BW-word output tile; each thread an 8 x 8-word
//   (or 4 x 8 in the small tile) register micro-tile, rows and words split
//   in two halves BM/2 and BW/2 apart so the shared-memory reads of a
//   quarter warp are 128 contiguous bytes (no bank conflicts).
// - 16-deep K slices stream through a two-stage shared-memory ring: B rows
//   by 16-byte cp.async, A through registers (16-byte global loads issued
//   before this slice's compute, stored after it), transposed to As[k][i]
//   and, on the hop path, broadcast into both halves of a word. Lanes of
//   a warp write consecutive i, so the transposing stores are
//   conflict-free. One __syncthreads per slice.
// - A grid sized to the card: a large shape takes 128 x 128-word tiles
//   (256 threads); a shape with fewer such tiles than SMs takes 64 x
//   64-word tiles and splits K over a thread block cluster of up to 8
//   blocks (the portable cluster size), which reduce their partial tiles
//   through distributed shared memory with an exact min (no atomics, no
//   second pass). That fills the 132 SMs of an H100 SXM at 512^3 (256
//   hop / 512 f32 blocks) but not at 256^3: the hop path has 8 tiles
//   there, so 64 blocks (the f32 path 128). 16-block clusters, which
//   would give the hop path 128, measured no faster at 256^3.
// - Ragged edges and unaligned rows take element-wise loads and stores,
//   padded with +inf (f32) or INF (hop), which never win a min.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 16;                 // K slice per ring stage
constexpr int16_t HOP_INF = 16383;     // "no path" on the hop path
constexpr int MAX_SPLITS = 8;          // portable cluster size

// ---- element paths --------------------------------------------------------

struct F32Path {
  using Elem = float;
  static constexpr int CELLS = 1;  // output cells per 32-bit word
  static __device__ __forceinline__ Elem pad() { return CUDART_INF_F; }
  static __device__ __forceinline__ uint32_t start() {
    return __float_as_uint(1e9f);
  }
  static __device__ __forceinline__ uint32_t a_word(Elem x) {
    return __float_as_uint(x);
  }
  static __device__ __forceinline__ uint32_t pack(const Elem* c) {
    return __float_as_uint(c[0]);
  }
  static __device__ __forceinline__ Elem cell(uint32_t w, int) {
    return __uint_as_float(w);
  }
  static __device__ __forceinline__ uint32_t step(uint32_t a, uint32_t b,
                                                  uint32_t acc) {
    return __float_as_uint(fminf(__uint_as_float(acc),
                                 __fadd_rn(__uint_as_float(a),
                                           __uint_as_float(b))));
  }
  static __device__ __forceinline__ uint32_t min2(uint32_t x, uint32_t y) {
    return __float_as_uint(fminf(__uint_as_float(x), __uint_as_float(y)));
  }
};

struct HopPath {
  using Elem = int16_t;
  static constexpr int CELLS = 2;
  static __device__ __forceinline__ Elem pad() { return HOP_INF; }
  static __device__ __forceinline__ uint32_t start() {
    return 0x00010001u * static_cast<uint32_t>(HOP_INF);
  }
  // a[i, k] broadcast into both halves: one add-min serves columns j, j+1
  static __device__ __forceinline__ uint32_t a_word(Elem x) {
    return 0x00010001u * static_cast<uint16_t>(x);
  }
  static __device__ __forceinline__ uint32_t pack(const Elem* c) {
    return static_cast<uint16_t>(c[0]) |
           (static_cast<uint32_t>(static_cast<uint16_t>(c[1])) << 16);
  }
  static __device__ __forceinline__ Elem cell(uint32_t w, int c) {
    return static_cast<Elem>(static_cast<uint16_t>(w >> (16 * c)));
  }
  static __device__ __forceinline__ uint32_t step(uint32_t a, uint32_t b,
                                                  uint32_t acc) {
    return __viaddmin_s16x2(a, b, acc);  // per half: min(a + b, acc)
  }
  static __device__ __forceinline__ uint32_t min2(uint32_t x, uint32_t y) {
    return __vmins2(x, y);
  }
};

// ---- tile shapes ----------------------------------------------------------

template <int BM_, int BW_, int TM_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_;          // output rows per block
  static constexpr int BW = BW_;          // output words per block
  static constexpr int TM = TM_;          // rows per thread (words: 8)
  static constexpr int TX = BW / 8;       // threads across the words
  static constexpr int THREADS = (BM / TM) * TX;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int SMEM_WORDS = 2 * BK * (BM + BW);
  // a split block parks its partial tile in the ring for the cluster
  static constexpr bool CAN_SPLIT = BM * BW <= SMEM_WORDS;
};
using Big = Tile<128, 128, 8, 2>;    // 256 threads
using Small = Tile<64, 64, 4, 4>;    // 128 threads, K split by a cluster
static_assert(Small::CAN_SPLIT, "the small tile reduces through the ring");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void lds(const uint32_t* p, uint32_t* r) {
  if constexpr (N == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
    static_assert(N == 2, "two or four words");
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r[0] = v.x; r[1] = v.y;
  }
}

// Four result words of row gm from word gw on: one 16-byte store when the
// row is aligned and whole, else cell by cell inside (M, N).
template <class P>
__device__ __forceinline__ void store_words(typename P::Elem* out, int gm,
                                            int gw, const uint32_t* w,
                                            int M, int N, bool vec) {
  if (gm >= M) return;
  const int gc = gw * P::CELLS;
  typename P::Elem* row = out + static_cast<size_t>(gm) * N;
  if (vec && gc + 4 * P::CELLS <= N) {
    *reinterpret_cast<uint4*>(row + gc) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < P::CELLS; ++c) {
      const int col = gc + q * P::CELLS + c;
      if (col < N) row[col] = P::cell(w[q], c);
    }
}

template <class P, class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
minplus_kernel(const typename P::Elem* __restrict__ a,
               const typename P::Elem* __restrict__ b,
               typename P::Elem* __restrict__ out, int M, int N, int K,
               int tiles_w, int splits, int k_split, bool vec_a, bool vec_b,
               bool vec_out) {
  using Elem = typename P::Elem;
  constexpr int BM = T::BM, BW = T::BW, TM = T::TM, TX = T::TX;
  constexpr int THREADS = T::THREADS;
  constexpr int VA = 16 / sizeof(Elem);          // A elements per 16 bytes
  constexpr int VB = 4 * P::CELLS;               // B cells per 16 bytes
  constexpr int A_PER = BM * BK / VA / THREADS;  // A chunks per thread
  constexpr int B_PER = BK * BW / 4 / THREADS;   // B chunks per thread
  static_assert(A_PER * VA * THREADS == BM * BK, "A chunks tile the slice");
  static_assert(B_PER * 4 * THREADS == BK * BW, "B chunks tile the slice");

  __shared__ __align__(16) uint32_t smem[T::SMEM_WORDS];
  auto As = reinterpret_cast<uint32_t(*)[BK][BM]>(smem);           // [2]
  auto Bs = reinterpret_cast<uint32_t(*)[BK][BW]>(smem + 2 * BK * BM);

  const int t = threadIdx.x;
  const int tx = t % TX;
  const int ty = t / TX;
  const int tile = blockIdx.x / splits;
  const int rank = blockIdx.x % splits;      // block rank in its cluster
  const int m0 = (tile / tiles_w) * BM;
  const int w0 = (tile % tiles_w) * BW;
  const int kb = rank * k_split;
  const int ke = min(K, kb + k_split);
  const int steps = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  // B slice at k0 into ring stage st: 16-byte cp.async where whole and
  // aligned, else padded element-wise stores
  auto load_b = [&](int st, int k0) {
#pragma unroll
    for (int r = 0; r < B_PER; ++r) {
      const int q = t + r * THREADS;
      const int row = q / (BW / 4), cw = q % (BW / 4);
      const int gk = k0 + row, gc = (w0 + cw * 4) * P::CELLS;
      uint32_t* dst = &Bs[st][row][cw * 4];
      const Elem* src = b + static_cast<size_t>(gk) * N + gc;
      if (vec_b && gk < K && gc + VB <= N) {
        cp_async16(dst, src);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          Elem c[P::CELLS];
#pragma unroll
          for (int y = 0; y < P::CELLS; ++y) {
            const int col = gc + x * P::CELLS + y;
            c[y] = (gk < K && col < N) ? src[x * P::CELLS + y] : P::pad();
          }
          w[x] = P::pack(c);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };
  // A slice at k0 into registers: 16 bytes of one row per chunk
  uint4 astage[A_PER];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const int q = t + r * THREADS;
      const int i = q % BM, c = q / BM;
      const int gm = m0 + i, gk = k0 + c * VA;
      const Elem* src = a + static_cast<size_t>(gm) * K + gk;
      if (vec_a && gm < M && gk + VA <= K) {
        astage[r] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        __align__(16) Elem e[VA];
#pragma unroll
        for (int x = 0; x < VA; ++x)
          e[x] = (gm < M && gk + x < K) ? src[x] : P::pad();
        astage[r] = *reinterpret_cast<const uint4*>(e);
      }
    }
  };
  // ... and from registers into stage st, transposed (As[k][i])
  auto store_a = [&](int st) {
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const int q = t + r * THREADS;
      const int i = q % BM, c = q / BM;
      const Elem* e = reinterpret_cast<const Elem*>(&astage[r]);
#pragma unroll
      for (int x = 0; x < VA; ++x) As[st][c * VA + x][i] = P::a_word(e[x]);
    }
  };

  uint32_t acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = P::start();

  if (steps > 0) {
    load_b(0, kb);
    cp_async_commit();
    load_a(kb);
    store_a(0);
  }
  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    cp_async_wait_all();
    __syncthreads();  // slice s is in; every thread is done with s - 1
    const bool more = s + 1 < steps;
    if (more) {
      load_b(st ^ 1, kb + (s + 1) * BK);
      cp_async_commit();
      load_a(kb + (s + 1) * BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t af[TM], bf[8];
      lds<TM / 2>(&As[st][kk][ty * (TM / 2)], af);
      lds<TM / 2>(&As[st][kk][BM / 2 + ty * (TM / 2)], af + TM / 2);
      lds<4>(&Bs[st][kk][tx * 4], bf);
      lds<4>(&Bs[st][kk][BW / 2 + tx * 4], bf + 4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = P::step(af[i], bf[j], acc[i][j]);
    }
    if (more) store_a(st ^ 1);
  }

  auto row_of = [&](int i) {
    return i < TM / 2 ? ty * (TM / 2) + i : BM / 2 + ty * (TM / 2) + i - TM / 2;
  };
  if constexpr (T::CAN_SPLIT) {
    if (splits > 1) {
      // park the partial tile in the ring, then each block of the cluster
      // takes BM / splits rows, min over every block's tile
      cg::cluster_group cluster = cg::this_cluster();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint4*>(&smem[row_of(i) * BW + h * BW / 2 + tx * 4]) =
              make_uint4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                         acc[i][4 * h + 3]);
      cluster.sync();
      const int rows = BM / splits;
      for (int q = t; q < rows * BW / 4; q += THREADS) {
        const int row = rank * rows + q / (BW / 4), cw = q % (BW / 4);
        uint4* mine = reinterpret_cast<uint4*>(&smem[row * BW + cw * 4]);
        uint4 v = *mine;
        for (int s = 0; s < splits; ++s) {
          if (s == rank) continue;
          const uint4 u = *cluster.map_shared_rank(mine, s);
          v.x = P::min2(v.x, u.x); v.y = P::min2(v.y, u.y);
          v.z = P::min2(v.z, u.z); v.w = P::min2(v.w, u.w);
        }
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        store_words<P>(out, m0 + row, w0 + cw * 4, w, M, N, vec_out);
      }
      cluster.sync();  // no block leaves while another reads its tile
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t w[4] = {acc[i][4 * h], acc[i][4 * h + 1],
                             acc[i][4 * h + 2], acc[i][4 * h + 3]};
      store_words<P>(out, m0 + row_of(i), w0 + h * BW / 2 + tx * 4, w, M, N,
                     vec_out);
    }
}

// ---- launch ---------------------------------------------------------------

struct Plan {
  int big, tiles_w;
  long long tiles;
  int splits, k_split;
};

template <class P>
Plan plan_for(int M, int N, int K, int sms) {
  const int nw = (N + P::CELLS - 1) / P::CELLS;
  const long long big = 1LL * ((M + Big::BM - 1) / Big::BM) *
                        ((nw + Big::BW - 1) / Big::BW);
  if (big >= sms) return {1, (nw + Big::BW - 1) / Big::BW, big, 1, K};
  const int tiles_w = (nw + Small::BW - 1) / Small::BW;
  const long long tiles = 1LL * ((M + Small::BM - 1) / Small::BM) * tiles_w;
  int splits = 1;
  while (splits < MAX_SPLITS && tiles * splits < 2 * sms &&
         K >= 2 * splits * BK)
    splits *= 2;
  const int per = (K + splits - 1) / splits;
  return {0, tiles_w, tiles, splits, (per + BK - 1) / BK * BK};
}

template <class P, class T>
cudaError_t launch_tile(const typename P::Elem* a, const typename P::Elem* b,
                        typename P::Elem* out, int M, int N, int K,
                        const Plan& p, cudaStream_t stream) {
  constexpr int VA = 16 / sizeof(typename P::Elem);
  constexpr int VB = 4 * P::CELLS;
  auto aligned = [](const void* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  const bool vec_a = K % VA == 0 && aligned(a);
  const bool vec_b = N % VB == 0 && aligned(b);
  const bool vec_out = N % VB == 0 && aligned(out);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.tiles * p.splits));
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, minplus_kernel<P, T>, a, b, out, M, N, K,
                            p.tiles_w, p.splits, p.k_split, vec_a, vec_b,
                            vec_out);
}

template <class P>
int launch(const typename P::Elem* a, const typename P::Elem* b,
           typename P::Elem* out, int M, int N, int K, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan_for<P>(M, N, K, sms);
  if (p.tiles * p.splits >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = p.big ? launch_tile<P, Big>(a, b, out, M, N, K, p, s)
              : launch_tile<P, Small>(a, b, out, M, N, K, p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- instruction probe ----------------------------------------------------
// Independent chains of one instruction per thread, timed with the SM's
// clock: issue rates per SM per clock of the candidate inner-loop forms.

constexpr int PROBE_THREADS = 256;
constexpr int PROBE_CHAINS = 8;
constexpr int PROBE_UNROLL = 4;

template <int OP>
__device__ __forceinline__ uint32_t probe_op(uint32_t x, uint32_t y,
                                             uint32_t z) {
  if constexpr (OP == 0) {         // FADD
    return __float_as_uint(__fadd_rn(__uint_as_float(x), __uint_as_float(y)));
  } else if constexpr (OP == 1) {  // FMNMX
    return __float_as_uint(fminf(__uint_as_float(x), __uint_as_float(y)));
  } else if constexpr (OP == 2) {  // VIADDMNMX, s32
    return static_cast<uint32_t>(__viaddmin_s32(
        static_cast<int>(y), static_cast<int>(z), static_cast<int>(x)));
  } else if constexpr (OP == 3) {  // VIADDMNMX, s16x2
    return __viaddmin_s16x2(y, z, x);
  } else {                         // FADD + FMNMX, the f32 path's pair
    return __float_as_uint(fminf(
        __fadd_rn(__uint_as_float(x), __uint_as_float(y)), __uint_as_float(z)));
  }
}

template <int OP>
__global__ void __launch_bounds__(PROBE_THREADS)
minplus_probe_kernel(int iters, uint32_t seed, unsigned long long* clocks,
                     uint32_t* sink) {
  uint32_t x[PROBE_CHAINS];
  const uint32_t y = seed ^ (threadIdx.x * 0x9e3779b9u);
  const uint32_t z = (seed >> 3) + threadIdx.x;
#pragma unroll
  for (int c = 0; c < PROBE_CHAINS; ++c) x[c] = seed + 977u * c + threadIdx.x;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < PROBE_UNROLL; ++u)
#pragma unroll
      for (int c = 0; c < PROBE_CHAINS; ++c) {
        x[c] = probe_op<OP>(x[c], y, z);
        asm volatile("" : "+r"(x[c]));  // keep every step
      }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t fold = 0;
#pragma unroll
  for (int c = 0; c < PROBE_CHAINS; ++c) fold ^= x[c];
  sink[blockIdx.x * PROBE_THREADS + threadIdx.x] = fold;
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    clocks[3 * blockIdx.x] = sm;
    clocks[3 * blockIdx.x + 1] = static_cast<unsigned long long>(t0);
    clocks[3 * blockIdx.x + 2] = static_cast<unsigned long long>(t1);
  }
}

}  // namespace

// C entry points for ctypes. Row-major contiguous a (M, K), b (K, N) and
// out (M, N) on `device`; each launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int minplus_f32(const float* a, const float* b, float* out,
                           int M, int N, int K, int device, void* stream) {
  return launch<F32Path>(a, b, out, M, N, K, device, stream);
}

// int16 hop counts in [0, 16383]; 16383 is "no path"
extern "C" int minplus_hops(const int16_t* a, const int16_t* b, int16_t* out,
                            int M, int N, int K, int device, void* stream) {
  return launch<HopPath>(a, b, out, M, N, K, device, stream);
}

// The launch plan for a shape: {path (0 f32, 1 hop), M, N, K} in, {big
// tile, tiles, K splits, blocks} out; returns a CUDA error code.
extern "C" int minplus_plan(int path, int M, int N, int K, int device,
                            int* plan) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = path ? plan_for<HopPath>(M, N, K, sms)
                      : plan_for<F32Path>(M, N, K, sms);
  plan[0] = p.big;
  plan[1] = static_cast<int>(p.tiles);
  plan[2] = p.splits;
  plan[3] = static_cast<int>(p.tiles * p.splits);
  return 0;
}

// Instruction probe: `op` 0 FADD, 1 FMNMX, 2 VIADDMNMX s32, 3 VIADDMNMX
// s16x2, 4 FADD then FMNMX (the f32 pair); `blocks` x 256 threads of
// `iters` x 32 instructions each. clocks (3 per block): SM id, start and
// end of the block's SM clock. Returns a CUDA error code.
extern "C" int minplus_probe(int op, int blocks, int iters,
                             unsigned long long* clocks, uint32_t* sink,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t seed = 12345u;
  switch (op) {
    case 0: minplus_probe_kernel<0><<<blocks, PROBE_THREADS, 0, s>>>(iters, seed, clocks, sink); break;
    case 1: minplus_probe_kernel<1><<<blocks, PROBE_THREADS, 0, s>>>(iters, seed, clocks, sink); break;
    case 2: minplus_probe_kernel<2><<<blocks, PROBE_THREADS, 0, s>>>(iters, seed, clocks, sink); break;
    case 3: minplus_probe_kernel<3><<<blocks, PROBE_THREADS, 0, s>>>(iters, seed, clocks, sink); break;
    case 4: minplus_probe_kernel<4><<<blocks, PROBE_THREADS, 0, s>>>(iters, seed, clocks, sink); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
