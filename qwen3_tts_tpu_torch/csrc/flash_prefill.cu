// Multi-token (prefill) causal GQA attention over a stacked KV cache, for
// Hopper, on the tensor cores (FlashAttention-2 style, mma.sync).
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
// path (S = 32..128, window = S) the bytes are tiny (q, one layer's live
// K/V prefix and the output: ~0.6 MB at S = 128) and the time is launch
// and latency: how many SMs the grid keeps busy and how short each CTA's
// load -> scores -> softmax -> P.V chain is.  At S = 1024 the S^2 / 2 dot
// products (~1.1 GFLOP over ~12 MB) make it the bf16 tensor cores'
// (989 TFLOP/s: ~1.1 us against ~3.6 us of bytes; both far below what a
// CTA chain costs).
//
// What the design does about it.  A row is (position, head in group): row
// r of a (lane, kv head) is position r / G of head kvh * G + r % G, so each
// K/V tile loaded into shared memory serves all G query heads that share
// it.  Each warp owns 16 rows (one m16 tile) and keeps its Q fragments in
// registers for the whole loop (ldmatrix from a staged Q tile).  A CTA of
// NW warps (NW * 16 rows) walks the K/V tiles of KT = 64 slots, double
// buffered in shared memory with cp.async (the next tile's copy overlaps
// this tile's products; rows past the causal bound are zero-filled, never
// read).  Per tile and warp: S = Q.K^T as mma.sync.m16n8k16 bf16 -> f32
// (K's B fragments by ldmatrix from the [slot][dim] tile), the mask and
// scale on the f32 accumulators, the online softmax in registers (a row's
// max and sum over the fragment's quad by shuffles), p rounded to bf16 as
// the A operand of the P.V mma.sync (as the TPU kernel and the CUDA-core
// kernel before this one rounded it; l sums the unrounded f32 p; a masked
// slot gives p = 0 exactly), and V's B fragments by ldmatrix.trans.  Tiles
// wholly past the CTA's causal bound are never loaded, a warp skips the
// products of a tile wholly past its own rows' bound, and the ragged last
// query tile and K/V tile are masked.  The grid is (query tiles, kv heads,
// lanes), the longest causal tiles first; the launcher takes the largest
// NW in {4, 2, 1} whose grid still covers every SM (B = 1: S = 32 -> 32
// CTAs and S = 128 -> 128 CTAs of one warp, S = 1024 -> 256 CTAs of four),
// where the CUDA-core kernel before ran 16 CTAs at S = 128.  wgmma and TMA
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WR = 16;       // query rows per warp: one m16 tile
constexpr int KT = 64;       // cache slots per K/V tile
constexpr int PAD = 8;       // bf16 padding per shared row: ldmatrix rows
                             // 16 bytes apart in bank groups
constexpr float NEG = -1e30f;

template <int DH, int NW>
struct Smem {
  bf16 q[NW * WR][DH + PAD];
  bf16 k[2][KT][DH + PAD];
  bf16 v[2][KT][DH + PAD];
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(qtts::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(qtts::smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 inputs, f32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// grid (query tiles, Hkv, B), NW warps.  Fragment layout (mma.sync
// m16n8k16): lane = 4 * gr + t; a C/D tile's thread holds rows gr and
// gr + 8, columns 2t and 2t + 1.
template <int DH, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_prefill_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  const int* __restrict__ lengths,
                  const int* __restrict__ start, int layer, int B, int S,
                  int H, int Hkv, int C, int prompt_cap, int window,
                  float scale) {
  constexpr int NT = NW * 32;
  constexpr int BM = NW * WR;          // rows per CTA
  constexpr int VEC = DH / 8;          // 16-byte vectors per row
  constexpr int KC = DH / 16;          // k16 chunks of q.k
  constexpr int SN = KT / 8;           // n8 score tiles per K/V tile
  constexpr int ON = DH / 8;           // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH, NW>& sm = *reinterpret_cast<Smem<DH, NW>*>(smem_raw);

  const int tile = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int G = H / Hkv;
  const int n_rows = S * G;
  const int r0 = tile * BM;
  const int length = lengths[b];
  const int st = start[b];
  // causal bound of the CTA: its last row's query sits at slot st + pos
  const int kv_end = min(window, st + (min(r0 + BM, n_rows) - 1) / G + 1);
  const int wr0 = r0 + warp * WR;                 // the warp's first row
  const int w_end =
      wr0 < n_rows ? min(window, st + (min(wr0 + WR, n_rows) - 1) / G + 1)
                   : 0;
  const size_t head = ((size_t)layer * B + b) * Hkv + kvh;
  const bf16* kp = k + head * (size_t)C * DH;
  const bf16* vp = v + head * (size_t)C * DH;

  // the Q tile (rows past n_rows zero-filled) and K/V tile 0: one group
  for (int i = tid; i < BM * VEC; i += NT) {
    const int r = i / VEC, c8 = i % VEC, row = r0 + r;
    const bool ok = row < n_rows;
    const int rr = ok ? row : 0;
    qtts::cp_async16(&sm.q[r][c8 * 8],
                     q + ((size_t)(b * S + rr / G) * H + kvh * G + rr % G) *
                                 DH + c8 * 8,
                     ok ? 16 : 0);
  }
  auto load_kv = [&](int buf, int kt0) {
    for (int i = tid; i < KT * VEC; i += NT) {
      const int rr = i / VEC, c8 = i % VEC, c = kt0 + rr;
      const bool ok = c < kv_end;
      const size_t off = (size_t)(ok ? c : 0) * DH + c8 * 8;
      qtts::cp_async16(&sm.k[buf][rr][c8 * 8], kp + off, ok ? 16 : 0);
      qtts::cp_async16(&sm.v[buf][rr][c8 * 8], vp + off, ok ? 16 : 0);
    }
  };
  load_kv(0, 0);
  qtts::cp_async_commit();

  uint32_t qa[KC][4];                  // the warp's Q fragments
  float o[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  // absolute query slots of the thread's two rows
  int qabs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qabs[h] = st + (wr0 + gr + 8 * h) / G;

  const int n_tiles = (kv_end + KT - 1) / KT;
  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = it * KT;
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, kt0 + KT);
    qtts::cp_async_commit();           // possibly empty: keeps the count
    qtts::cp_async_wait<1>();          // tile it (and Q) landed
    __syncthreads();
    const int buf = it & 1;
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(qa[kc], &sm.q[warp * WR + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
    }
    if (kt0 < w_end) {
      // ---- S = Q.K^T: per n8 tile j and k16 chunk pair
      float s[SN][4];
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; kc += 2) {
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          uint32_t kb[4];
          ldsm_x4(kb, &sm.k[buf][j * 8 + (lane & 7)][kc * 16 + (lane >> 3) * 8]);
          mma16816(s[j], qa[kc], kb[0], kb[1]);
          mma16816(s[j], qa[kc + 1], kb[2], kb[3]);
        }
      }
      // ---- mask, scale, online softmax (rows gr and gr + 8)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int c = kt0 + j * 8 + 2 * t4 + (e & 1);
          const int qs = qabs[h];
          const bool ok = c < kv_end && c <= qs &&
                          (c < length || c >= prompt_cap || c == qs);
          s[j][e] = ok ? s[j][e] * scale : -INFINITY;
          mx[h] = fmaxf(mx[h], s[j][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[h]);
          sum[h] += p;
          s[j][e] = p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
      }
#pragma unroll
      for (int j = 0; j < ON; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // ---- O += P.V: p (bf16) as the A operand, k16 chunk jj = score
      // tiles 2jj and 2jj + 1
#pragma unroll
      for (int jj = 0; jj < KT / 16; ++jj) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * jj][0], s[2 * jj][1]);
        pa[1] = pack_bf16(s[2 * jj][2], s[2 * jj][3]);
        pa[2] = pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]);
        pa[3] = pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3]);
#pragma unroll
        for (int dd = 0; dd < ON; dd += 2) {
          uint32_t vb[4];
          ldsm_x4_t(vb, &sm.v[buf][jj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                               [dd * 8 + (lane >> 4) * 8]);
          mma16816(o[dd], pa, vb[0], vb[1]);
          mma16816(o[dd + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                   // buffer `buf` is refilled next+1
  }
  qtts::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + gr + 8 * h;
    if (row >= n_rows) continue;
    const float inv_l = 1.f / fmaxf(l[h], 1e-30f);
    bf16* orow =
        out + ((size_t)(b * S + row / G) * H + kvh * G + row % G) * DH;
#pragma unroll
    for (int j = 0; j < ON; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[j][2 * h] * inv_l, o[j][2 * h + 1] * inv_l);
  }
}

template <int DH, int NW>
int launch_nw(const void* q, const void* k, const void* v, void* out,
              const int* lengths, const int* start, int layer, int B, int S,
              int H, int Hkv, int C, int prompt_cap, int window, float scale,
              cudaStream_t st) {
  const int smem = (int)sizeof(Smem<DH, NW>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_mma<DH, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = S * (H / Hkv);
  const dim3 grid((rows + NW * WR - 1) / (NW * WR), Hkv, B);
  flash_prefill_mma<DH, NW><<<grid, NW * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lengths, start,
      layer, B, S, H, Hkv, C, prompt_cap, window, scale);
  return (int)cudaGetLastError();
}

// The warps per CTA: the largest NW in {4, 2, 1} whose grid covers the
// card's `sms` SMs (more rows per CTA share each K/V tile; fewer keep more
// SMs busy).
int pick_warps(int B, int S, int H, int Hkv, int sms) {
  const long rows = (long)S * (H / Hkv);
  for (int nw = 4; nw > 1; nw /= 2)
    if ((rows + nw * WR - 1) / (nw * WR) * Hkv * B >= sms) return nw;
  return 1;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* lengths, const int* start, int layer, int B, int S,
           int H, int Hkv, int C, int prompt_cap, int window, float scale,
           int nw, cudaStream_t st) {
  switch (nw) {
    case 4:
      return launch_nw<DH, 4>(q, k, v, out, lengths, start, layer, B, S, H,
                              Hkv, C, prompt_cap, window, scale, st);
    case 2:
      return launch_nw<DH, 2>(q, k, v, out, lengths, start, layer, B, S, H,
                              Hkv, C, prompt_cap, window, scale, st);
    default:
      return launch_nw<DH, 1>(q, k, v, out, lengths, start, layer, B, S, H,
                              Hkv, C, prompt_cap, window, scale, st);
  }
}

}  // namespace

// info (host), when not null, gets the launch: {CTAs, warps per CTA}.
extern "C" int qtts_flash_prefill(const void* q, const void* k, const void* v,
                                  void* out, const int* lengths,
                                  const int* start, int layer, int B, int S,
                                  int H, int Hkv, int C, int head_dim,
                                  int prompt_cap, int window, float scale,
                                  int* info, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B <= 0 || S <= 0 || window <= 0 ||
      window > C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int nw = pick_warps(B, S, H, Hkv, sms);
  if (info != nullptr) {
    const long rows = (long)S * (H / Hkv);
    info[0] = (int)((rows + nw * WR - 1) / (nw * WR) * Hkv * B);
    info[1] = nw;
  }
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, out, lengths, start, layer, B, S, H, Hkv, C,
                        prompt_cap, window, scale, nw, st);
    case 128:
      return launch<128>(q, k, v, out, lengths, start, layer, B, S, H, Hkv, C,
                         prompt_cap, window, scale, nw, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
