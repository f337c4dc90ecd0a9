// x @ packed int4 weights with grouped scales, for Hopper.
//
// Replaces: qwen3_tts_tpu/kernels/int4_matmul.py matmul_int4 (the Pallas
// TPU kernel).  Contract: x [M, K] bf16; q4 [N, K/2] uint8, the port's
// output-major packing (ops/quant.py pack_int4: output column n's K values
// contiguous, each 4-byte word holding K rows 8m..8m+3 in its low nibbles
// and 8m+4..8m+7 in its high nibbles, two's complement); s [N, K/G] f32
// group scales (G input rows per group) -> y [M, N] f32 = x @ w with
// w[k, n] = bf16(bf16(q[k, n]) * bf16(s[n, k / G])), the JAX kernel's
// dequantization (`_kernel`: both factors in bf16, a bf16 product), summed
// in f32.  Two kernels, chosen by the wrapper (kernels/int4_matmul.py
// `plan`, which holds the crossover in M):
//
// int4_mm_kernel, small M (decode).  What bounds it: bytes.  At M = 1 it
// must read K * N / 2 bytes of weights and K * N / G * 4 of scales once
// (2048 x 12288: 12.6 MB + 0.8 MB, ~4 us at 3.35 TB/s) for 2 * K * N
// flops.  The weights are read once per block of NB rows, as 16-byte
// vectors along each output column (32 K values per lane, one group scale
// per lane), and dequantized in registers: no weight is written back to
// memory in bf16 (the JAX package's own reason for the kernel).  A block
// of 8 warps owns 8 output columns, one per warp; its NB rows of x (NB =
// 1, 2 or 4: M rounded up; M <= 4) sit in shared memory (NB * K * 2
// bytes: 64 KB at K = 8192), each lane multiplies its 32 dequantized
// weights into NB f32 sums, and the warp adds its lanes by a butterfly.
// More rows would re-read the weights per row tile: from 4 rows on the
// tile kernel is about as fast or faster (kernels/int4_matmul.py
// TILE_MIN_M), and the wrapper sends it M >= 4.
//
// int4_tile_kernel, from M = 4 (prefill sizes).  What bounds it: the
// operations, 2 * M * K * N (6.4 GFLOP at M = 128, 2048 x 12288: 6.5 us
// on the bf16 tensor cores, 96 us at the CUDA cores' f32 peak).  So it
// runs on the tensor cores, mma.sync.m16n8k16 bf16 -> f32: the B fragment
// of a 16 x 8 weight tile is built in registers straight from the packed
// bytes, which wgmma (B from shared memory only) would first need written
// out as a bf16 tile; mma.sync also takes the 32-row tiles of M = 32.  A
// CTA of 8 warps (2 along M, 4 along N) owns a BM x 64 output tile, BM =
// 32 * MI (MI = 1, 2, 4 m16 tiles per warp), and walks K in 64-row steps
// through a 4-stage cp.async ring in shared memory: per stage the x tile
// [BM, 64] bf16 (rows padded to 72 values, so ldmatrix reads without bank
// conflicts), the packed weights [64 columns, 32 bytes] and their scales
// (G % 32 == 0: one group per column and 32-row half; a half past K is
// zero-filled).  Each lane dequantizes the values that the mma B layout
// gives it (column lane / 4, K rows 2t, 2t + 1, 2t + 8, 2t + 9 of a
// 16-row slice, t = lane % 4), which are two bytes of one packed word
// each: a byte permute, a shift and a mask give the two nibbles as bf16
// (0x4300 | n ^ 8 = 136 + q), then two bf16x2 fmas, (136 + q) - 136 exact
// and q * bf16(s) rounded once: the same bits as int4_mm_kernel's wf[].
// Every weight is read once per BM rows (once at M <= 128) and never
// stored in bf16.  Enough CTAs for 132 SMs: where the (M, N) tiles are
// fewer, the wrapper splits K into S ranges; each split writes its f32
// partial tile to a workspace and int4_splitk_sum adds the S partials in
// split order, so the result does not depend on the order the CTAs ran
// in.  Ragged M and the edge N tile are zero-filled on load and masked on
// store.  3-6 stages differ by under 5 % (scripts/torch_int4_sweep.py,
// one H100, CUDA graphs).

#include <algorithm>

#include "cp_async.cuh"
#include "w4a8.cuh"

namespace {

using qtts::bf16r;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <int NB>
__global__ void __launch_bounds__(THREADS)
int4_mm_kernel(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ q4, const float* __restrict__ s,
               float* __restrict__ y, int M, int N, int K, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xs = reinterpret_cast<uint4*>(smem);     // [NB, K] bf16
  const int row_vecs = K / 8;                     // 16-byte vectors per row
  for (int i = threadIdx.x; i < NB * row_vecs; i += THREADS) {
    const int b = i / row_vecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);         // rows past M: zeros
    if (b < M)
      v = reinterpret_cast<const uint4*>(x + (size_t)b * K)
          [i - b * row_vecs];
    xs[i] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;  // warp-uniform; no barrier follows
  const uint8_t* wrow = q4 + (size_t)n * (K / 2);
  const float* srow = s + (size_t)n * (K / G);
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int k0 = lane * 32; k0 < K; k0 += 32 * 32) {
    const uint4 wv = *reinterpret_cast<const uint4*>(wrow + k0 / 2);
    const float sc = bf16r(srow[k0 / G]);          // JAX: s in bf16
    const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
    float wf[32];                                  // K rows k0 .. k0 + 31
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = (uint32_t)qtts::sext4(ww[i] & 0x0F0F0F0Fu);
      const uint32_t hi = (uint32_t)qtts::sext4((ww[i] >> 4) & 0x0F0F0F0Fu);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // bf16(q) * bf16(s): exact in f32, then rounded to bf16
        wf[8 * i + j] = bf16r((float)(signed char)(lo >> (8 * j)) * sc);
        wf[8 * i + 4 + j] = bf16r((float)(signed char)(hi >> (8 * j)) * sc);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint4* xv = xs + (size_t)b * row_vecs + k0 / 8;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint4 xa = xv[v];
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&xa);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h2[j]);
          acc[b] = fmaf(f.x, wf[8 * v + 2 * j], acc[b]);
          acc[b] = fmaf(f.y, wf[8 * v + 2 * j + 1], acc[b]);
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], o);
  }
  if (lane != 0) return;
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < M) y[(size_t)b * N + n] = acc[b];
}

template <int NB>
cudaError_t launch(const __nv_bfloat16* x, const uint8_t* q4, const float* s,
                   float* y, int M, int N, int K, int G, cudaStream_t st) {
  const size_t smem = (size_t)NB * K * sizeof(__nv_bfloat16);
  cudaError_t e = qtts::allow_smem(int4_mm_kernel<NB>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + WARPS - 1) / WARPS);
  int4_mm_kernel<NB><<<grid, THREADS, smem, st>>>(x, q4, s, y, M, N, K, G);
  return cudaGetLastError();
}

// ------------------------------------------------ tensor-core tile kernel
namespace tile {

constexpr int BN = 64;         // output columns per CTA
constexpr int BK = 64;         // K rows per pipeline stage: two 32-row halves
constexpr int STAGES = 4;
constexpr int WARPS_M = 2;     // warps along M; 4 along N, 16 columns each
constexpr int XPITCH = BK + 8; // bf16 per staged x row (144 bytes)

template <int MI>
struct Smem {
  __nv_bfloat16 x[STAGES][WARPS_M * 16 * MI][XPITCH];
  uint2 q[STAGES][BN][4];      // each column's 32 packed bytes, 8 per slice
  float s[STAGES][2][BN];      // each column's group scale per half
};

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The two weights of packed word w that mma's B layout gives lane t (t =
// lane % 4): bytes 2 (t & 1) and 2 (t & 1) + 1, nibble t >> 1 of each (K
// rows 2t and 2t + 1 of the word's 8 when the word's first row is 0 of a
// 16-row slice, 2t + 8 and 2t + 9 for the slice's second word), as bf16x2
// bf16(q * sc), the lower K row in the low half.
__device__ __forceinline__ uint32_t dequant_pair(uint32_t w, int t,
                                                 uint32_t sc2) {
  uint32_t v = __byte_perm(w, 0u, (t & 1) ? 0x4342u : 0x4140u);
  v = (v >> (4 * (t >> 1))) & 0x000F000Fu;
  v = (v ^ 0x00080008u) | 0x43004300u;           // bf16 136 + q, exact
  v = bf16x2_fma(v, 0x3F803F80u, 0xC308C308u);   // * 1 - 136: q, exact
  return bf16x2_fma(v, sc2, 0x80008000u);        // q * s + -0: one rounding
}

// Stage the K rows [k0, k0 + 64): a half past K (K % 64 == 32) is
// zero-filled, so it adds nothing.
template <int MI>
__device__ __forceinline__ void load_stage(
    Smem<MI>& sm, int st, const __nv_bfloat16* __restrict__ x,
    const uint8_t* __restrict__ q4, const float* __restrict__ s, int M,
    int N, int K, int G, int m0, int n0, int k0) {
  constexpr int BM = WARPS_M * 16 * MI;
  const int tid = threadIdx.x;
  for (int i = tid; i < BM * (BK / 8); i += THREADS) {
    const int r = i / (BK / 8), c = i % (BK / 8);
    const bool ok = m0 + r < M && k0 + c * 8 < K;
    const __nv_bfloat16* src = ok ? x + (size_t)(m0 + r) * K + k0 + c * 8 : x;
    qtts::cp_async16(&sm.x[st][r][c * 8], src, ok ? 16 : 0);
  }
  const int j = tid % BN, h = (tid / BN) % 2;     // column, 32-row half
  const bool ok = n0 + j < N && k0 + 32 * h < K;
  if (tid < 2 * BN) {
    const uint8_t* src =
        ok ? q4 + (size_t)(n0 + j) * (K / 2) + (k0 + 32 * h) / 2 : q4;
    qtts::cp_async16(&sm.q[st][j][2 * h], src, ok ? 16 : 0);
  } else if (tid < 4 * BN) {
    const float* src =
        ok ? s + (size_t)(n0 + j) * (K / G) + (k0 + 32 * h) / G : s;
    qtts::cp_async4(&sm.s[st][h][j], src, ok ? 4 : 0);
  }
}

// grid (ceil(N / BN), ceil(M / BM), splits).  splits == 1: y [M, N];
// else split z writes its partial tile to ws[z] ([splits, M, N] f32).
template <int MI>
__global__ void __launch_bounds__(THREADS)
int4_tile_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ q4, const float* __restrict__ s,
                 float* __restrict__ y, float* __restrict__ ws, int M, int N,
                 int K, int G) {
  constexpr int BM = WARPS_M * 16 * MI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MI>& sm = *reinterpret_cast<Smem<MI>*>(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int splits = gridDim.z, z = blockIdx.z;
  const int steps = (K + BK - 1) / BK;
  const int kb = (int)((long long)z * steps / splits);
  const int nk = (int)((long long)(z + 1) * steps / splits) - kb;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / 4, wn = warp % 4;
  const int grp = lane >> 2, t = lane & 3;
  float acc[MI][2][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nk)
      load_stage<MI>(sm, p, x, q4, s, M, N, K, G, m0, n0, (kb + p) * BK);
    qtts::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    qtts::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed; stage i - 1 is read by no warp
    if (i + STAGES - 1 < nk)
      load_stage<MI>(sm, (i + STAGES - 1) % STAGES, x, q4, s, M, N, K, G,
                     m0, n0, (kb + i + STAGES - 1) * BK);
    qtts::cp_async_commit();
    const int st = i % STAGES;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t b[2][2];  // this 16-row slice of each n8 tile
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 16 + j * 8 + grp;
        const uint2 w = sm.q[st][col][ks];
        const uint32_t sbits = (uint32_t)__bfloat16_as_ushort(
            __float2bfloat16_rn(sm.s[st][ks / 2][col]));
        const uint32_t sc2 = sbits | (sbits << 16);
        b[j][0] = dequant_pair(w.x, t, sc2);
        b[j][1] = dequant_pair(w.y, t, sc2);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t a0, a1, a2, a3;
        const uint32_t addr = qtts::smem_addr(
            &sm.x[st][wm * 16 * MI + mi * 16 + (lane & 15)]
                 [ks * 16 + (lane >> 4) * 8]);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
            : "r"(addr));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(acc[mi][j][0]), "+f"(acc[mi][j][1]),
                "+f"(acc[mi][j][2]), "+f"(acc[mi][j][3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[j][0]),
                "r"(b[j][1]));
        }
      }
    }
  }
  qtts::cp_async_wait<0>();

  float* out = splits == 1 ? y : ws + (size_t)z * M * N;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = m0 + wm * 16 * MI + mi * 16 + grp;
      const int col = n0 + wn * 16 + j * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rr = row + (r >> 1) * 8, cc = col + (r & 1);
        if (rr < M && cc < N) out[(size_t)rr * N + cc] = acc[mi][j][r];
      }
    }
  }
}

// y = the splits' partial tiles added in split order (deterministic)
__global__ void __launch_bounds__(THREADS)
int4_splitk_sum(const float* __restrict__ ws, float* __restrict__ y,
                int splits, size_t count) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < count;
       i += (size_t)gridDim.x * THREADS) {
    float v = ws[i];
    for (int z = 1; z < splits; ++z) v += ws[(size_t)z * count + i];
    y[i] = v;
  }
}

template <int MI>
cudaError_t launch(const __nv_bfloat16* x, const uint8_t* q4, const float* s,
                   float* y, float* ws, int M, int N, int K, int G,
                   int splits, cudaStream_t st) {
  constexpr int BM = WARPS_M * 16 * MI;
  const size_t smem = sizeof(Smem<MI>);
  cudaError_t e = qtts::allow_smem(int4_tile_kernel<MI>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int4_tile_kernel<MI><<<grid, THREADS, smem, st>>>(x, q4, s, y, ws, M, N,
                                                    K, G);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t count = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((count + THREADS - 1) / THREADS,
                                           4 * 132);
  int4_splitk_sum<<<blocks, THREADS, 0, st>>>(ws, y, splits, count);
  return cudaGetLastError();
}

}  // namespace tile

}  // namespace

extern "C" int qtts_int4_matmul(const void* x, const void* q4,
                                const float* s, float* y, int M, int N, int K,
                                int G, void* stream) {
  // whole 32-row lane slices inside one group; x rows in shared memory;
  // at most 4 rows (one row tile of the NB = 4 instance)
  if (M <= 0 || M > 4 || N <= 0 || K <= 0 || K % 32 != 0 || G <= 0 ||
      G % 32 != 0 || K % G != 0 || K > 8192)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(q4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 1) return (int)launch<1>(xb, qb, s, y, M, N, K, G, st);
  if (M == 2) return (int)launch<2>(xb, qb, s, y, M, N, K, G, st);
  return (int)launch<4>(xb, qb, s, y, M, N, K, G, st);
}

// The tile kernel at MI m16 tiles per warp (1, 2 or 4: BM = 32, 64, 128)
// with K split into `splits` ranges of its 64-row steps; ws: [splits, M,
// N] f32 when splits > 1 (else unused).  The wrapper's plan picks MI and
// splits.
extern "C" int qtts_int4_matmul_tile(const void* x, const void* q4,
                                     const float* s, float* y, float* ws,
                                     int M, int N, int K, int G, int mi,
                                     int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G % 32 != 0 || K % G != 0 ||
      splits < 1 || splits > (K + tile::BK - 1) / tile::BK ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(q4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mi) {
    case 1:
      return (int)tile::launch<1>(xb, qb, s, y, ws, M, N, K, G, splits, st);
    case 2:
      return (int)tile::launch<2>(xb, qb, s, y, ws, M, N, K, G, splits, st);
    case 4:
      return (int)tile::launch<4>(xb, qb, s, y, ws, M, N, K, G, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
