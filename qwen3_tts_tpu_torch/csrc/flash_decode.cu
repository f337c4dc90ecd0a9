// Single-token GQA decode attention over one layer's KV cache, for Hopper,
// as split-prefix decoding (flash-decoding).
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
// ~295 flops/byte where bf16 tensor cores would become the limit.  At
// decode sizes (one layer: 16-512 KB) the latency of the chain load ->
// scores -> softmax -> P.V sets the time, not the bytes.
//
// What the design does about it.  The live prefix [0, end), end =
// min(write_idx + 1, C), is cut into chunks of SPLIT slots, and one CTA of
// 8 warps takes the G = H / Hkv query heads of one (lane, kv head) over
// one chunk, so B * Hkv * ceil(end / SPLIT) CTAs share the card (128 at
// B = 1 and cursor 1023, where the earlier kernel ran 8 blocks walking 8
// tiles each).  The grid is sized by the capacity (the host does not know
// write_idx); a CTA past its lane's prefix returns at once.  A CTA starts
// cp.async copies of its K and V chunk rows (two groups: the scores need
// only K), then each warp scores two slots at a time: a K row of Dh bf16
// is read as 16-byte vectors by Dh / 8 lanes, dotted with the lane's 8
// dims of every query head (q in registers, once for all G heads) and
// summed by warp shuffles.  Warp g then takes head g's softmax over the
// whole chunk (its max, p = exp(s - max), masked slots p = 0 exactly, l =
// sum p), and for P.V the threads split the chunk's slots into groups,
// each thread two output columns of its group; the groups' sums are added
// in group order through shared memory, once per CTA.  One chunk (cursor
// < SPLIT): that CTA writes the output.  More: each chunk writes its f32
// (max, l, acc) to a workspace (the wrapper's torch.empty), and
// flash_decode_combine rescales and adds the chunks in chunk order, so
// the result does not depend on the order the CTAs ran in.  SPLIT = 64:
// one slot pair per lane in the softmax, and 16 chunks per head at
// C = 1024.  Softmax in f32; the output is the only bf16 rounding.

#include "common.cuh"
#include "cp_async.cuh"

namespace {

using qtts::MAX_G;
using qtts::NEG;

constexpr int SPLIT = 64;         // slots per chunk (one CTA)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(WARPS == MAX_G, "one warp per query head in the softmax");
static_assert(SPLIT == 64, "two slots per lane in the softmax");

template <int DH>
struct Smem {
  static constexpr int GROUPS = THREADS / (DH / 2);   // P.V slot groups
  __nv_bfloat16 k[SPLIT][DH];
  __nv_bfloat16 v[SPLIT][DH];
  float p[MAX_G][SPLIT];          // scores, then p
  float m[MAX_G];
  float l[MAX_G];
  float red[GROUPS][MAX_G][DH];   // each slot group's P.V sums
};

__device__ __forceinline__ int n_chunks(int end) {
  return max(1, (end + SPLIT - 1) / SPLIT);
}

// grid (Hkv, B, ceil(C / SPLIT)).  ws_acc [B * Hkv, NS, G, DH] and ws_ml
// [B * Hkv, NS, G, 2] (NS = gridDim.z) take the chunks' partials when the
// lane's prefix spans more than one chunk.
template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_decode_split(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                   const int* __restrict__ lengths,
                   const int* __restrict__ write_idx, int H, int Hkv, int C,
                   int prompt_cap, float scale) {
  constexpr int LPS = DH / 8;           // lanes per K row, 16 bytes each
  constexpr int SPW = 32 / LPS;         // slots per warp and pass
  constexpr int GROUPS = Smem<DH>::GROUPS;
  constexpr int SPG = SPLIT / GROUPS;   // slots per P.V group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);

  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int G = H / Hkv;
  const int cursor = write_idx[b], length = lengths[b];
  const int end = min(cursor + 1, C);
  const int chunks = n_chunks(end);
  if (z >= chunks) return;              // past this lane's prefix
  const int c0 = z * SPLIT;
  const int n = max(0, min(SPLIT, end - c0));
  const size_t head = (size_t)b * Hkv + kvh;
  const __nv_bfloat16* kp = k + (head * C + c0) * DH;
  const __nv_bfloat16* vp = v + (head * C + c0) * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < n * (DH / 8); i += THREADS)
    qtts::cp_async16(&sm.k[0][0] + i * 8, kp + (size_t)i * 8, 16);
  qtts::cp_async_commit();
  for (int i = tid; i < n * (DH / 8); i += THREADS)
    qtts::cp_async16(&sm.v[0][0] + i * 8, vp + (size_t)i * 8, 16);
  qtts::cp_async_commit();

  // this lane's 8 dims of every query head of the group, times the scale
  const int sub = lane / LPS, part = lane % LPS;
  float qr[MAX_G][8];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * H + kvh * G + g) * DH + part * 8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        qr[g][2 * j] = f.x * scale;
        qr[g][2 * j + 1] = f.y * scale;
      }
    }
  }
  qtts::cp_async_wait<1>();
  __syncthreads();                      // K landed

  // ---- scores: slot j of the chunk by the LPS lanes `sub` of warp j's
#pragma unroll
  for (int j0 = 0; j0 < SPLIT; j0 += WARPS * SPW) {
    const int j = j0 + warp * SPW + sub;
    float sc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) sc[g] = 0.f;
    if (j < n) {
      const uint4 u = *reinterpret_cast<const uint4*>(&sm.k[j][part * 8]);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      float kf[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        kf[2 * i] = f.x;
        kf[2 * i + 1] = f.y;
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
#pragma unroll
          for (int i = 0; i < 8; ++i) sc[g] = fmaf(qr[g][i], kf[i], sc[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
#pragma unroll
      for (int o = LPS / 2; o > 0; o >>= 1)
        sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], o);
    }
    if (part == 0) {
      const int c = c0 + j;
      const bool valid =
          j < n && (c < length || c >= prompt_cap || c == cursor);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) sm.p[g][j] = valid ? sc[g] : NEG;
    }
  }
  __syncthreads();

  // ---- softmax over the chunk: warp g takes head g
  if (warp < G) {
    const float sa = sm.p[warp][lane], sb = sm.p[warp][lane + 32];
    float mx = fmaxf(sa, sb);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float pa = sa > NEG ? expf(sa - mx) : 0.f;   // masked: exactly 0
    const float pb = sb > NEG ? expf(sb - mx) : 0.f;
    float l = pa + pb;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    sm.p[warp][lane] = pa;
    sm.p[warp][lane + 32] = pb;
    if (lane == 0) {
      sm.m[warp] = mx;
      sm.l[warp] = l;
    }
  }
  qtts::cp_async_wait<0>();
  __syncthreads();                      // V landed, p written

  // ---- P.V: thread (group grp, columns 2 pr, 2 pr + 1) over its slots
  const int pr = tid % (DH / 2), grp = tid / (DH / 2);
  float acc[MAX_G][2];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g][0] = acc[g][1] = 0.f;
  const int jb = grp * SPG, je = min(jb + SPG, n);
  for (int j = jb; j < je; ++j) {
    const float2 vv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&sm.v[j][2 * pr]));
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const float p = sm.p[g][j];
        acc[g][0] = fmaf(p, vv.x, acc[g][0]);
        acc[g][1] = fmaf(p, vv.y, acc[g][1]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G)
      *reinterpret_cast<float2*>(&sm.red[grp][g][2 * pr]) =
          make_float2(acc[g][0], acc[g][1]);
  __syncthreads();

  const size_t part_base = (head * gridDim.z + z) * G;
  for (int e = tid; e < G * DH; e += THREADS) {
    const int g = e / DH, d = e % DH;
    float a = sm.red[0][g][d];
#pragma unroll
    for (int r = 1; r < GROUPS; ++r) a += sm.red[r][g][d];
    if (chunks == 1)
      out[((size_t)b * H + kvh * G + g) * DH + d] =
          __float2bfloat16(a / fmaxf(sm.l[g], 1e-30f));
    else
      ws_acc[(part_base + g) * DH + d] = a;
  }
  if (chunks > 1 && tid < G) {
    ws_ml[(part_base + tid) * 2] = sm.m[tid];
    ws_ml[(part_base + tid) * 2 + 1] = sm.l[tid];
  }
}

// grid (Hkv, B), G * DH threads, thread (g, t) for head g's column t:
// where a lane's prefix spans several chunks, the heads' outputs from the
// chunks' (max, l, acc), in chunk order (the loads of the chunks are
// independent, unrolled so that they are in flight together).
template <int DH>
__global__ void __launch_bounds__(MAX_G * DH)
flash_decode_combine(const float* __restrict__ ws_acc,
                     const float* __restrict__ ws_ml,
                     __nv_bfloat16* __restrict__ out,
                     const int* __restrict__ write_idx, int H, int Hkv,
                     int C, int ns) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x / DH, t = threadIdx.x % DH;
  const int G = H / Hkv;
  const int chunks = n_chunks(min(write_idx[b] + 1, C));
  if (chunks == 1) return;              // the chunk wrote the output
  const size_t base = ((size_t)b * Hkv + kvh) * ns * G + g;
  float mx = NEG;
#pragma unroll 8
  for (int z = 0; z < chunks; ++z)
    mx = fmaxf(mx, ws_ml[(base + (size_t)z * G) * 2]);
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int z = 0; z < chunks; ++z) {
    const size_t i = base + (size_t)z * G;
    const float w = expf(ws_ml[i * 2] - mx);
    l = fmaf(ws_ml[i * 2 + 1], w, l);
    a = fmaf(ws_acc[i * DH + t], w, a);
  }
  out[((size_t)b * H + kvh * G + g) * DH + t] =
      __float2bfloat16(a / fmaxf(l, 1e-30f));
}

template <int DH>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, float* ws,
                   const int* lengths, const int* write_idx, int B, int H,
                   int Hkv, int C, int prompt_cap, float scale,
                   cudaStream_t st) {
  const int ns = (C + SPLIT - 1) / SPLIT;
  const int G = H / Hkv;
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)B * Hkv * ns * G * DH;
  const size_t smem = sizeof(Smem<DH>);
  cudaError_t e = qtts::allow_smem(flash_decode_split<DH>, smem);
  if (e != cudaSuccess) return e;
  flash_decode_split<DH><<<dim3(Hkv, B, ns), THREADS, smem, st>>>(
      q, k, v, out, ws_acc, ws_ml, lengths, write_idx, H, Hkv, C,
      prompt_cap, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || ns == 1) return e;
  flash_decode_combine<DH><<<dim3(Hkv, B), G * DH, 0, st>>>(
      ws_acc, ws_ml, out, write_idx, H, Hkv, C, ns);
  return cudaGetLastError();
}

}  // namespace

// ws: f32 workspace of B * Hkv * ceil(C / 64) * (H / Hkv) * (head_dim + 2)
// values (kernels/flash_decode.py decode_workspace), unused when C <= 64.
extern "C" int qtts_flash_decode(const void* q, const void* k, const void* v,
                                 void* out, float* ws, const int* lengths,
                                 const int* write_idx, int B, int H, int Hkv,
                                 int C, int head_dim, int prompt_cap,
                                 float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_G || B <= 0 || C <= 0 ||
      (C > SPLIT && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  switch (head_dim) {
    case 64:
      return (int)launch<64>(qb, kb, vb, ob, ws, lengths, write_idx, B, H,
                             Hkv, C, prompt_cap, scale, st);
    case 128:
      return (int)launch<128>(qb, kb, vb, ob, ws, lengths, write_idx, B, H,
                              Hkv, C, prompt_cap, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
