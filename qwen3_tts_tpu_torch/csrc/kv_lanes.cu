// Per-lane KV cache kernels of continuous batching, for Hopper.
//
// Replaces three Pallas TPU kernels of qwen3_tts_tpu/kernels/flash_decode.py:
//
//   flash_gqa_decode_append  decode attention over slots [0, write_idx[b])
//                            of one layer of the stacked cache, plus the
//                            current token from registers, plus the
//                            current token's k/v row written IN PLACE at
//                            (layer, b, kv head, write_idx[b]);
//   inject_prompt_lanes      copy R compact prefilled lanes [L, R, Hkv, S,
//                            Dh] into slots [0, S) of big-cache lanes
//                            lanes[r], in place;
//   append_kv_lanes          one k/v row per (layer, lane, kv head) at
//                            starts[b], in place.
//
// Caches are bf16 [L, B, Hkv, C, Dh].  The TPU kernels write through an
// aligned 8-row read-modify-write window because a bf16 HBM DMA cannot
// address one row; a CUDA store can, so every kernel here writes exactly
// the rows it owns and nothing else.
//
// What bounds them on the card: bytes.
// - decode_append reads the visible prefix of one layer's K and V once
//   (2 * write_idx * Dh * 2 bytes per lane and kv head) and does ~4 flops
//   per byte.  Design: flash_decode.cu's one block per (kv head, lane),
//   whose G query heads share each K/V row (common.cuh attend_tiles); the
//   prefix loop stops at write_idx, so the slot being written is never
//   read and the write needs no ordering against the reads; the current
//   token joins the online softmax last, as one more column.
// - inject_lanes moves 2 * L * R * Hkv * S * Dh * 2 bytes (read once,
//   written once).  Design: one block per (kv head, layer, refill row), 16
//   bytes per thread per step, consecutive threads on consecutive
//   addresses; each block's source and destination are contiguous runs of
//   S * Dh values.  Duplicate lanes (allowed only with identical data)
//   make two blocks store the same bytes, which is harmless.
// - append_lanes moves 2 * L * B * Hkv * Dh * 2 bytes of rows in and the
//   same out, scattered one 256-byte row per (layer, lane, kv head).
//   Design: one block per (layer, lane); its threads cover the lane's Hkv
//   k rows and Hkv v rows in 16-byte vectors.
// A cursor outside [0, C), or a lane outside [0, B), writes nothing.

#include "common.cuh"

namespace {

using qtts::MAX_G;
using qtts::NEG;

template <int DH>
__global__ void __launch_bounds__(DH)
decode_append_kernel(const __nv_bfloat16* __restrict__ q,
                     __nv_bfloat16* k, __nv_bfloat16* v,
                     const __nv_bfloat16* __restrict__ k_new,
                     const __nv_bfloat16* __restrict__ v_new,
                     __nv_bfloat16* __restrict__ out,
                     const int* __restrict__ lengths,
                     const int* __restrict__ write_idx, int layer, int B,
                     int H, int Hkv, int C, int prompt_cap, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int G = H / Hkv;

  __shared__ float q_s[MAX_G][DH];
  __shared__ float p_s[MAX_G][DH];
  __shared__ float red_s[MAX_G][DH / 32];
  __shared__ float red[DH / 32];

  const int length = lengths[b];
  const int cursor = write_idx[b];
  const size_t head = ((size_t)layer * B + b) * Hkv + kvh;
  __nv_bfloat16* kp = k + head * (size_t)C * DH;
  __nv_bfloat16* vp = v + head * (size_t)C * DH;
  const __nv_bfloat16 kn = k_new[((size_t)b * Hkv + kvh) * DH + t];
  const __nv_bfloat16 vn = v_new[((size_t)b * Hkv + kvh) * DH + t];
  // the prefix loop below reads slots < cursor only
  if (cursor >= 0 && cursor < C) {
    kp[(size_t)cursor * DH + t] = kn;
    vp[(size_t)cursor * DH + t] = vn;
  }

#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G)
      q_s[g][t] =
          __bfloat162float(q[((size_t)b * H + kvh * G + g) * DH + t]) * scale;
  __syncthreads();

  float m[MAX_G], l[MAX_G], acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  // visible prefix: slots c < cursor with c < length or c >= prompt_cap
  qtts::attend_tiles<DH>(q_s, G, kp, vp, max(0, min(cursor, C)), length,
                         cursor, prompt_cap, 1.0f, p_s, red_s, m, l, acc);
  // the current token, always visible, folded in last
  qtts::attend_current<DH>(q_s, G, __bfloat162float(kn), __bfloat162float(vn),
                           m, l, acc, red, out + ((size_t)b * H + kvh * G) * DH);
}

// k/v_small [L, R, Hkv, S, Dh] -> k/v_big [L, B, Hkv, C, Dh] slots [0, S)
// of lane lanes[r]; grid (Hkv, L, R).
__global__ void __launch_bounds__(256)
inject_lanes_kernel(uint4* k_big, uint4* v_big,
                    const uint4* __restrict__ k_small,
                    const uint4* __restrict__ v_small,
                    const int* __restrict__ lanes, int R, int B, int Hkv,
                    int C, int S, int DH) {
  const int kvh = blockIdx.x;
  const int layer = blockIdx.y;
  const int r = blockIdx.z;
  const int lane = lanes[r];
  if (lane < 0 || lane >= B) return;
  const size_t run = (size_t)S * DH / 8;          // 16-byte vectors
  const size_t src = (((size_t)layer * R + r) * Hkv + kvh) * run;
  const size_t dst = (((size_t)layer * B + lane) * Hkv + kvh) *
                     ((size_t)C * DH / 8);
  for (size_t i = threadIdx.x; i < run; i += blockDim.x) {
    k_big[dst + i] = k_small[src + i];
    v_big[dst + i] = v_small[src + i];
  }
}

// k/v_tok [L, B, Hkv, Dh] -> k/v_big [L, B, Hkv, C, Dh] slot starts[b];
// grid (L, B).
__global__ void __launch_bounds__(128)
append_lanes_kernel(uint4* k_big, uint4* v_big,
                    const uint4* __restrict__ k_tok,
                    const uint4* __restrict__ v_tok,
                    const int* __restrict__ starts, int B, int Hkv, int C,
                    int DH) {
  const int layer = blockIdx.x;
  const int b = blockIdx.y;
  const int start = starts[b];
  if (start < 0 || start >= C) return;
  const int row = DH / 8;                         // 16-byte vectors a row
  for (int i = threadIdx.x; i < 2 * Hkv * row; i += blockDim.x) {
    const bool is_v = i >= Hkv * row;
    const int j = is_v ? i - Hkv * row : i;
    const int kvh = j / row, c = j % row;
    const size_t head = ((size_t)layer * B + b) * Hkv + kvh;
    const uint4 val = (is_v ? v_tok : k_tok)[head * row + c];
    (is_v ? v_big : k_big)[(head * C + start) * row + c] = val;
  }
}

}  // namespace

extern "C" int qtts_decode_append(const void* q, void* k, void* v,
                                  const void* k_new, const void* v_new,
                                  void* out, const int* lengths,
                                  const int* write_idx, int layer, int B,
                                  int H, int Hkv, int C, int head_dim,
                                  int prompt_cap, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_G || B <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const auto* qb = static_cast<const bf*>(q);
  auto* kb = static_cast<bf*>(k);
  auto* vb = static_cast<bf*>(v);
  const auto* knb = static_cast<const bf*>(k_new);
  const auto* vnb = static_cast<const bf*>(v_new);
  auto* ob = static_cast<bf*>(out);
  switch (head_dim) {
    case 64:
      decode_append_kernel<64><<<grid, 64, 0, st>>>(
          qb, kb, vb, knb, vnb, ob, lengths, write_idx, layer, B, H, Hkv, C,
          prompt_cap, scale);
      break;
    case 128:
      decode_append_kernel<128><<<grid, 128, 0, st>>>(
          qb, kb, vb, knb, vnb, ob, lengths, write_idx, layer, B, H, Hkv, C,
          prompt_cap, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int qtts_inject_lanes(void* k_big, void* v_big,
                                 const void* k_small, const void* v_small,
                                 const int* lanes, int L, int R, int B,
                                 int Hkv, int C, int S, int head_dim,
                                 void* stream) {
  if (L <= 0 || R <= 0 || B <= 0 || Hkv <= 0 || S <= 0 || S > C ||
      head_dim % 8 != 0 || R > 65535)
    return (int)cudaErrorInvalidValue;
  inject_lanes_kernel<<<dim3(Hkv, L, R), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_big), static_cast<uint4*>(v_big),
      static_cast<const uint4*>(k_small), static_cast<const uint4*>(v_small),
      lanes, R, B, Hkv, C, S, head_dim);
  return (int)cudaGetLastError();
}

extern "C" int qtts_append_lanes(void* k_big, void* v_big, const void* k_tok,
                                 const void* v_tok, const int* starts, int L,
                                 int B, int Hkv, int C, int head_dim,
                                 void* stream) {
  if (L <= 0 || B <= 0 || Hkv <= 0 || C <= 0 || head_dim % 8 != 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  append_lanes_kernel<<<dim3(L, B), 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_big), static_cast<uint4*>(v_big),
      static_cast<const uint4*>(k_tok), static_cast<const uint4*>(v_tok),
      starts, B, Hkv, C, head_dim);
  return (int)cudaGetLastError();
}
