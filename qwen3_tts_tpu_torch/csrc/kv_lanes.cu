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
//   per byte.  Design: the talker step's split-prefix attention
//   (split_attn.cuh split_item), one warp per item (lane b, kv head, split
//   s of the lane's prefix [0, min(write_idx[b], C)) in 64-slot splits),
//   4 warps a block.  The grid covers B * Hkv * ceil(C / 64) items, split
//   fastest, so the host never reads write_idx: a warp whose split lies
//   past its lane's ns_b = max(1, ceil(min(write_idx[b], C) / 64)) exits,
//   and at short cursors the live items sit one a block, spread over the
//   SMs.  A warp scores 4 slots at a time, 8 lanes a slot on 16-byte loads;
//   the last of an item's splits to arrive combines them in split order and
//   sets the arrival counter back to 0.  That warp writes the token's row
//   at write_idx[b] (no split reads that slot, so the write needs no
//   ordering against the reads) and merges the current token last, from
//   registers; the output row is the only bf16 rounding.
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

#include "split_attn.cuh"

namespace {

using bf16 = __nv_bfloat16;
using qtts::SPLIT;

constexpr int DA_WARPS = 4;       // warps (items) a decode_append block
// k rows of 8 passes (32 slots) and v rows of 16 slots in flight a warp:
// one item is a chain of dependent loads (the talker step keeps 4 and 8)
constexpr int APPEND_SB = 8, APPEND_PB = 16;

// One warp per item (b, kv head, split); grid ceil(B * Hkv * nsmax /
// DA_WARPS), item = blockIdx.x * DA_WARPS + warp, split fastest.
template <int DH, int CG>
__global__ void __launch_bounds__(DA_WARPS * 32)
decode_append_kernel(const bf16* __restrict__ q, bf16* k, bf16* v,
                     const bf16* __restrict__ k_new,
                     const bf16* __restrict__ v_new, bf16* __restrict__ out,
                     const int* __restrict__ lengths,
                     const int* __restrict__ write_idx, qtts::SplitParts sp,
                     int layer, int B, int H, int Hkv, int C, int prompt_cap,
                     float scale) {
  using W = qtts::SplitWarp<CG, DH>;
  constexpr int NC = DH / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x * DA_WARPS + warp;
  const int s = item % sp.nsmax, bh = item / sp.nsmax;
  if (bh >= B * Hkv) return;
  const int b = bh / Hkv, kvh = bh % Hkv;
  // a lane's first split always runs: its loads below go out beside the
  // cursor's; a later split first learns whether its lane reaches it
  int cursor = 0;
  if (s > 0) {
    cursor = write_idx[b];
    if (s >= max(1, (max(0, min(cursor, C)) + SPLIT - 1) / SPLIT)) return;
  }
  const int G = H / Hkv;
  W& w = reinterpret_cast<W*>(smem)[warp];
  // the item's query heads times the score scale, the token's k and v rows
#pragma unroll
  for (int g = 0; g < CG; ++g) {
    if (g >= G) continue;
    const bf16* qr = q + ((size_t)b * H + kvh * G + g) * DH;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      w.q[g][lane + 32 * i] =
          __fmul_rn(qtts::bf2f(qr[lane + 32 * i]), scale);
  }
  const size_t row = ((size_t)b * Hkv + kvh) * DH;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    w.k[lane + 32 * i] = qtts::bf2f(k_new[row + lane + 32 * i]);
    w.v[lane + 32 * i] = qtts::bf2f(v_new[row + lane + 32 * i]);
  }
  if (s == 0) cursor = write_idx[b];
  const int length = lengths[b];
  const int end = max(0, min(cursor, C));
  const int ns = max(1, (end + SPLIT - 1) / SPLIT);
  __syncwarp();
  const size_t head = ((size_t)layer * B + b) * Hkv + kvh;
  bf16* kp = k + head * C * DH;
  bf16* vp = v + head * C * DH;
  const bool in = cursor >= 0 && cursor < C;
  float o[CG][NC];
  if (!qtts::split_item<APPEND_SB, APPEND_PB>(
          w, G, kp, vp, end, length, prompt_cap, s, ns, bh, sp,
          in ? kp + (size_t)cursor * DH : nullptr,
          in ? vp + (size_t)cursor * DH : nullptr, o))
    return;
#pragma unroll
  for (int g = 0; g < CG; ++g) {
    if (g >= G) continue;
    bf16* orow = out + ((size_t)b * H + kvh * G + g) * DH + NC * lane;
#pragma unroll
    for (int i = 0; i < NC; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(orow + i) =
          __floats2bfloat162_rn(o[g][i], o[g][i + 1]);
  }
}

template <int DH, int CG>
cudaError_t launch_append(const bf16* q, bf16* k, bf16* v, const bf16* kn,
                          const bf16* vn, bf16* out, const int* lengths,
                          const int* write_idx, const qtts::SplitParts& sp,
                          int layer, int B, int H, int Hkv, int C,
                          int prompt_cap, float scale, cudaStream_t st) {
  auto kernel = decode_append_kernel<DH, CG>;
  const size_t smem = DA_WARPS * sizeof(qtts::SplitWarp<CG, DH>);
  cudaError_t e = qtts::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const long long items = (long long)B * Hkv * sp.nsmax;
  kernel<<<(unsigned)((items + DA_WARPS - 1) / DA_WARPS), DA_WARPS * 32,
           smem, st>>>(q, k, v, kn, vn, out, lengths, write_idx, sp, layer,
                       B, H, Hkv, C, prompt_cap, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_append_g(int G, const bf16* q, bf16* k, bf16* v,
                            const bf16* kn, const bf16* vn, bf16* out,
                            const int* lengths, const int* write_idx,
                            const qtts::SplitParts& sp, int layer, int B,
                            int H, int Hkv, int C, int prompt_cap,
                            float scale, cudaStream_t st) {
#define QTTS_APPEND(CG)                                                      \
  return launch_append<DH, CG>(q, k, v, kn, vn, out, lengths, write_idx, sp, \
                               layer, B, H, Hkv, C, prompt_cap, scale, st)
  if (G <= 1) QTTS_APPEND(1);
  if (G <= 2) QTTS_APPEND(2);
  if (G <= 4) QTTS_APPEND(4);
  QTTS_APPEND(8);
#undef QTTS_APPEND
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

// part: [B * Hkv * ceil(C / 64) * G * (head_dim + 2)] f32 (null, with
// part_floats 0, when C <= 64: one split, no partials); arrive: [B * Hkv]
// uint32, 0 between launches.  The sizes given are checked.
extern "C" int qtts_decode_append(const void* q, void* k, void* v,
                                  const void* k_new, const void* v_new,
                                  void* out, const int* lengths,
                                  const int* write_idx, void* part,
                                  long long part_floats, void* arrive,
                                  int arrive_n, int layer, int B, int H,
                                  int Hkv, int C, int head_dim,
                                  int prompt_cap, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > qtts::MAX_G || B <= 0 || C <= 0 ||
      (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int nsmax = (C + SPLIT - 1) / SPLIT;
  const long long n_rows = (long long)B * Hkv * nsmax * G;
  if (arrive == nullptr || arrive_n < B * Hkv ||
      (nsmax > 1 && (part == nullptr || part_floats < n_rows * (head_dim + 2))))
    return (int)cudaErrorInvalidValue;
  float* pa = static_cast<float*>(part);
  const qtts::SplitParts sp{pa, pa == nullptr ? nullptr
                                              : pa + n_rows * head_dim,
                            static_cast<unsigned*>(arrive), nsmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const bf16*>(q);
  auto* kb = static_cast<bf16*>(k);
  auto* vb = static_cast<bf16*>(v);
  const auto* knb = static_cast<const bf16*>(k_new);
  const auto* vnb = static_cast<const bf16*>(v_new);
  auto* ob = static_cast<bf16*>(out);
  return (int)(head_dim == 64
                   ? launch_append_g<64>(G, qb, kb, vb, knb, vnb, ob, lengths,
                                         write_idx, sp, layer, B, H, Hkv, C,
                                         prompt_cap, scale, st)
                   : launch_append_g<128>(G, qb, kb, vb, knb, vnb, ob,
                                          lengths, write_idx, sp, layer, B, H,
                                          Hkv, C, prompt_cap, scale, st));
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
