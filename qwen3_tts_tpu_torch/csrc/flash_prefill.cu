// Multi-token (prefill) causal GQA attention over a stacked KV cache, for
// Hopper.
//
// Replaces: qwen3_tts_tpu/kernels/flash_prefill.py flash_gqa_prefill_stacked
// (the Pallas TPU kernel).  Same contract: q [B, S, H, Dh] bf16, k/v
// [L, B, Hkv, C, Dh] bf16 with the S new rows already written, lengths [B]
// and start [B] int32, one layer index, a static window <= C of readable
// slots; output [B, S, H, Dh] bf16.  Slot c is visible to the query at
// absolute slot a = start + i iff c <= a, c < window and (c < length or
// c >= prompt_cap or c == a): ops.attention.history_mask.
//
// What bounds it on the card: at the prompt buckets of the preset-voice
// path (S = 32..128) each block reads the live K/V prefix once per query
// tile, 2 * window * Dh * 2 bytes, and does ~4 * ROWS flops per byte
// loaded, so launch latency and the K/V bytes bound it; at S in the
// thousands the S^2 dot products dominate.  This first version computes
// the dots with plain FMA on the CUDA cores, which is far below the
// tensor-core rate: mma.sync / wgmma with TMA loads is later work.
//
// What the design does about it: one block per (query tile, kv-head,
// lane).  A tile is ROWS = 128 rows of (position, head-in-group): 128 / G
// positions times the G query heads that share one kv head, so each K/V
// tile loaded into shared memory serves all of them.  K/V tiles of KT
// slots stream from the cache of layer `layer`; tiles that lie wholly
// past the tile's causal bound (start + last position) are never read.
// Scores are kept only in shared memory; the softmax is online in f32;
// p is rounded to bf16 for the P.V product (accumulated in f32), as in the
// TPU kernel; masked slots give p = 0 exactly.  The ragged last query
// tile and the ragged last K/V tile are masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 128;  // query rows per block: positions x group heads
constexpr int KT = 64;     // cache slots per K/V tile
constexpr int NT = 256;    // threads per block: 16 x 16
constexpr int PAD = 8;     // bf16 padding per shared row (bank spread)
constexpr float NEG = -1e30f;

template <int DH>
struct Smem {
  __nv_bfloat16 q[ROWS][DH + PAD];
  __nv_bfloat16 k[KT][DH + PAD];
  __nv_bfloat16 v[KT][DH + PAD];
  float p[ROWS][KT + 1];
  float m[ROWS];
  float l[ROWS];
  float alpha[ROWS];
};

template <int DH>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     const int* __restrict__ lengths,
                     const int* __restrict__ start, int layer, int B, int S,
                     int H, int Hkv, int C, int prompt_cap, int window,
                     float scale) {
  constexpr int VEC = DH / 8;   // 16-byte vectors per row
  constexpr int RI = ROWS / 16; // rows per thread
  constexpr int CJ = KT / 16;   // score columns per thread
  constexpr int DJ = DH / 16;   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int G = H / Hkv;
  const int QT = ROWS / G;  // positions per tile
  const int pos0 = tile * QT;
  const int n_pos = min(QT, S - pos0);
  const int n_rows = n_pos * G;
  const int length = lengths[b];
  const int st = start[b];
  // causal bound: the tile's last query sits at slot st + pos0 + n_pos - 1
  const int kv_end = min(window, st + pos0 + n_pos);

  // row r of the tile is (position pos0 + r / G, head kvh * G + r % G)
  auto row_off = [&](int r) -> size_t {
    return ((size_t)(b * S + pos0 + r / G) * H + kvh * G + r % G) * DH;
  };

  for (int i = tid; i < ROWS * VEC; i += NT) {
    const int r = i / VEC, c8 = i % VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) val = reinterpret_cast<const uint4*>(q + row_off(r))[c8];
    *reinterpret_cast<uint4*>(&sm.q[r][c8 * 8]) = val;
  }
  for (int r = tid; r < ROWS; r += NT) {
    sm.m[r] = NEG;
    sm.l[r] = 0.f;
  }

  const size_t head = ((size_t)layer * B + b) * Hkv + kvh;
  const __nv_bfloat16* kp = k + head * (size_t)C * DH;
  const __nv_bfloat16* vp = v + head * (size_t)C * DH;

  float o[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;

  for (int kt0 = 0; kt0 < kv_end; kt0 += KT) {
    __syncthreads();  // previous tile's k/v/p reads are done
    for (int i = tid; i < KT * VEC; i += NT) {
      const int rr = i / VEC, c8 = i % VEC, c = kt0 + rr;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (c < kv_end) {
        kv = reinterpret_cast<const uint4*>(kp + (size_t)c * DH)[c8];
        vv = reinterpret_cast<const uint4*>(vp + (size_t)c * DH)[c8];
      }
      *reinterpret_cast<uint4*>(&sm.k[rr][c8 * 8]) = kv;
      *reinterpret_cast<uint4*>(&sm.v[rr][c8 * 8]) = vv;
    }
    __syncthreads();

    // ---- scores for rows ty + 16 i, slots kt0 + tx + 16 j
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 2) {
      float2 qf[RI], kf[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qf[i] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&sm.q[ty + 16 * i][d]));
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        kf[j] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&sm.k[tx + 16 * j][d]));
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          s[i][j] += qf[i].x * kf[j].x + qf[i].y * kf[j].y;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qa = st + pos0 + r / G;  // absolute slot of this query
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = kt0 + tx + 16 * j;
        const bool ok = c < kv_end && c <= qa &&
                        (c < length || c >= prompt_cap || c == qa);
        sm.p[r][tx + 16 * j] = ok ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // ---- online softmax: two threads per row, 32 slots each
    {
      const int r = tid >> 1, half = tid & 1;
      float mx = -INFINITY;
#pragma unroll 8
      for (int c = half * 32; c < half * 32 + 32; ++c) mx = fmaxf(mx, sm.p[r][c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll 8
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        const float sc = sm.p[r][c];
        const float pv = sc == -INFINITY ? 0.f : expf(sc - m_new);
        sum += pv;
        sm.p[r][c] = __bfloat162float(__float2bfloat16(pv));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        const float a = expf(m_old - m_new);
        sm.alpha[r] = a;
        sm.l[r] = sm.l[r] * a + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    // ---- P.V for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float a = sm.alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= a;
    }
    const int n_kk = min(KT, kv_end - kt0);
#pragma unroll 2
    for (int kk = 0; kk < n_kk; ++kk) {
      float pr[RI], vr[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pr[i] = sm.p[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vr[j] = __bfloat162float(sm.v[kk][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] += pr[i] * vr[j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r < n_rows) {
      const float l = fmaxf(sm.l[r], 1e-30f);
      __nv_bfloat16* orow = out + row_off(r);
#pragma unroll
      for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = __float2bfloat16(o[i][j] / l);
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* lengths, const int* start, int layer, int B, int S,
           int H, int Hkv, int C, int prompt_cap, int window, float scale,
           cudaStream_t st) {
  const int smem = (int)sizeof(Smem<DH>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int qt = ROWS / (H / Hkv);
  const dim3 grid((S + qt - 1) / qt, Hkv, B);
  flash_prefill_kernel<DH><<<grid, NT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lengths, start, layer, B, S, H, Hkv, C, prompt_cap, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qtts_flash_prefill(const void* q, const void* k, const void* v,
                                  void* out, const int* lengths,
                                  const int* start, int layer, int B, int S,
                                  int H, int Hkv, int C, int head_dim,
                                  int prompt_cap, int window, float scale,
                                  void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || ROWS % (H / Hkv) != 0 || B <= 0 ||
      S <= 0 || window <= 0 || window > C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, out, lengths, start, layer, B, S, H, Hkv, C,
                        prompt_cap, window, scale, st);
    case 128:
      return launch<128>(q, k, v, out, lengths, start, layer, B, S, H, Hkv, C,
                         prompt_cap, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
