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
// in f32.
//
// What bounds it on the card: bytes at decode sizes.  At M = 1 the kernel
// must read K * N / 2 bytes of weights and K * N / G * 4 of scales once
// (2048 x 12288: 12.6 MB + 0.8 MB, ~4 us at 3.35 TB/s) for 2 * K * N
// flops; at M = 128 the flops (6.4 G at 2048 x 12288) would bound it on
// the tensor cores (~7 us), which this simple kernel does not use.
//
// What the design does about it: the weights are read once per block of
// NB rows, as 16-byte vectors along each output column (32 K values per
// lane, one group scale per lane), and dequantized in registers: no weight
// is written back to memory in bf16 (the JAX package's own reason for the
// kernel).  A block of 8 warps owns 8 output columns, one per warp; its NB
// rows of x (NB = M for M <= 4, else 8) sit in shared memory (NB * K * 2
// bytes: 96 KB at K = 6144), each lane multiplies its 32 dequantized
// weights into NB f32 sums, and the warp adds its lanes by a butterfly.
// grid.y runs over the M / NB row tiles, so at prefill sizes (M = 32-128)
// the tiles re-read the weights, mostly from L2.  Tensor-core MMA on
// dequantized tiles is what a faster version does at prefill sizes.

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
  const int m0 = blockIdx.y * NB;
  const int row_vecs = K / 8;                     // 16-byte vectors per row
  for (int i = threadIdx.x; i < NB * row_vecs; i += THREADS) {
    const int b = i / row_vecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);         // rows past M: zeros
    if (m0 + b < M)
      v = reinterpret_cast<const uint4*>(x + (size_t)(m0 + b) * K)
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
    if (m0 + b < M) y[(size_t)(m0 + b) * N + n] = acc[b];
}

template <int NB>
cudaError_t launch(const __nv_bfloat16* x, const uint8_t* q4, const float* s,
                   float* y, int M, int N, int K, int G, cudaStream_t st) {
  const size_t smem = (size_t)NB * K * sizeof(__nv_bfloat16);
  cudaError_t e = qtts::allow_smem(int4_mm_kernel<NB>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + WARPS - 1) / WARPS, (M + NB - 1) / NB);
  int4_mm_kernel<NB><<<grid, THREADS, smem, st>>>(x, q4, s, y, M, N, K, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qtts_int4_matmul(const void* x, const void* q4,
                                const float* s, float* y, int M, int N, int K,
                                int G, void* stream) {
  // whole 32-row lane slices inside one group; x rows in shared memory
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || G <= 0 || G % 32 != 0 ||
      K % G != 0 || K > 8192)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(q4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 1) return (int)launch<1>(xb, qb, s, y, M, N, K, G, st);
  if (M == 2) return (int)launch<2>(xb, qb, s, y, M, N, K, G, st);
  if (M <= 4) return (int)launch<4>(xb, qb, s, y, M, N, K, G, st);
  return (int)launch<8>(xb, qb, s, y, M, N, K, G, st);
}
