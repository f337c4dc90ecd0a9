// Single-token GQA decode attention over one layer's KV cache, for Hopper.
//
// Replaces: qwen3_tts_tpu/kernels/flash_decode.py flash_gqa_decode (the
// one-layer Pallas TPU kernel) and, through it, flash_gqa_decode_stacked
// (the stacked one), whose wrapper (kernels/flash_decode.py) passes layer
// l's view of a stacked cache [L, B, Hkv, C, Dh], a pointer offset.
// Contract: q [B, H, Dh] bf16, k/v [B, Hkv, C, Dh] bf16, lengths [B] and
// write_idx [B] int32 (the current token already written at write_idx);
// output [B, H, Dh] bf16.  Slot c is visible iff c <= write_idx and
// (c < length or c >= prompt_cap or c == write_idx), which is
// ops.attention.history_mask for one query row.
//
// What bounds it on the card: bytes read.  A step reads the live prefix
// [0, write_idx] of one layer's K and V once: 2 * (write_idx + 1) * Dh * 2
// bytes per (lane, kv-head), and does ~4 flops per byte, far below the
// ~295 flops/byte where bf16 tensor cores would become the limit.
//
// What the design does about it: the trip count follows the live prefix,
// not the capacity C, so no dead slot is read.  One block per
// (kv-head, lane); the G = H / Hkv query heads of the group share every
// K/V row the block loads.  Thread t scores slot t of each Dh-slot tile
// (the row read as 16-byte vectors), the block takes the tile's max, and
// then thread t owns output column t for the P.V sum, whose V-row reads
// are coalesced across the block.  Softmax is online in f32; masked slots
// get p = 0 exactly.  Only B * Hkv blocks run (8 at b = 1), which leaves
// most SMs idle: splitting the prefix across blocks (flash-decoding) is
// later work.  The tile loop is qtts::attend_tiles (common.cuh), shared
// with the talker-step and predictor-frame kernels.

#include "common.cuh"

namespace {

using qtts::MAX_G;
using qtts::NEG;

template <int DH>
__global__ void __launch_bounds__(DH)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out,
                    const int* __restrict__ lengths,
                    const int* __restrict__ write_idx,
                    int H, int Hkv, int C, int prompt_cap, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int G = H / Hkv;

  __shared__ float q_s[MAX_G][DH];
  __shared__ float p_s[MAX_G][DH];
  __shared__ float red_s[MAX_G][DH / 32];

  const int length = lengths[b];
  const int cursor = write_idx[b];
  const int end = min(cursor + 1, C);  // live prefix [0, cursor]

  const size_t head = (size_t)b * Hkv + kvh;
  const __nv_bfloat16* kp = k + head * (size_t)C * DH;
  const __nv_bfloat16* vp = v + head * (size_t)C * DH;

#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G)
      q_s[g][t] = __bfloat162float(q[((size_t)b * H + kvh * G + g) * DH + t]) * scale;
  __syncthreads();

  float m[MAX_G], l[MAX_G], acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  qtts::attend_tiles<DH>(q_s, G, kp, vp, end, length, cursor, prompt_cap,
                         1.0f, p_s, red_s, m, l, acc);

#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G)
      out[((size_t)b * H + kvh * G + g) * DH + t] =
          __float2bfloat16(acc[g] / fmaxf(l[g], 1e-30f));
}

}  // namespace

extern "C" int qtts_flash_decode(const void* q, const void* k, const void* v,
                                 void* out, const int* lengths,
                                 const int* write_idx, int B,
                                 int H, int Hkv, int C, int head_dim,
                                 int prompt_cap, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_G || B <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  switch (head_dim) {
    case 64:
      flash_decode_kernel<64><<<grid, 64, 0, st>>>(
          qb, kb, vb, ob, lengths, write_idx, H, Hkv, C,
          prompt_cap, scale);
      break;
    case 128:
      flash_decode_kernel<128><<<grid, 128, 0, st>>>(
          qb, kb, vb, ob, lengths, write_idx, H, Hkv, C,
          prompt_cap, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
