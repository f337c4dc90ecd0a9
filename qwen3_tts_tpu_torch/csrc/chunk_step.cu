// Whole decode frames of one chunk in ONE cooperative launch, for Hopper.
//
// Replaces: qwen3_tts_tpu/kernels/chunk_step.py gen_chunk_fused (the Pallas
// TPU kernel) at its batches: 1 lane, 8 or 16 lanes at F <= 8 frames, 24 or
// 32 lanes at F <= 4 (the JAX gate), with its in-kernel sampler
// `_sample_inkernel`.
// Contract (kernels/chunk_step.py): F <= 8 frames; each frame samples
// code_0 of every lane from the carried codec logits (greedy, or the
// threshold sampler with the caller's uniform u[f, b]), projects the f32
// hidden 2048 -> 1024, runs the predictor's 16 tokens (w4a8 weights, f32
// group scales, 16-slot KV, window argmax, next input ctab_pred[t][code_t]),
// sums the feedback (16 codec-table rows + tts_pad), runs the 28-layer w4a8
// talker step writing the frame's k/v row IN PLACE at slot write_idx + f
// (one cursor for every lane: write_idx[0]; the prompt lengths are per
// lane), and applies the final norm (kept as the f32 hidden) and the int8
// codec head over rows [0, 2160) for the next frame's logits.  It rounds to
// bf16 where the Pallas kernel and kernels/chunk_step.gen_chunk_plain do,
// but its f32 sums run in its own order: the talker's cache prefix goes in
// SPLIT = 64-slot splits combined in split order (the plain version and the
// JAX kernel: 512-slot tiles), the heads' dots on the tensor cores, the
// projection and the feedback in the lanes' order below; chip_smoke.py
// holds the talker layer by layer to the plain layer in these orders
// (chunk_step.KERNEL_ORDERS) and the rest of the frame to
// gen_chunk_plain(orders=FRAME_ORDERS).  Every lane of a batched launch
// computes exactly what the one-lane launch computes on that lane's inputs
// (bit for bit; chip_smoke.py checks it): no sum mixes lanes, and no order
// depends on B or on the grid.  The JAX kernel's batched loop scores q.k
// and p.v in bf16, a TPU matrix-unit artefact that is not carried over, nor
// is its bf16 proj_w at b >= 24.
//
// What bounds it on the card.  Bytes, as a floor: per frame at full width
// the talker's 0.70 GB of int4 weights and 22 MB of bf16 scales (0.216 ms
// at 3.35 TB/s), the predictor's 37.7 MB of int4 and 2.4 MB of f32 scales,
// read once if the 50 MB L2 keeps them over the 16 tokens (0.012 ms) or 16
// times if not (0.19 ms), and 31 MB of lm-head windows (0.009 ms):
// 0.24-0.42 ms a frame, 0.98-1.7 ms a 4-frame chunk at one lane.  In fact
// latency: a frame is 542 phases behind grid barriers, and each phase is a
// chain of dependent round trips to L2 or device memory (the barrier, the
// input rows, the weights, the epilogue), each ~1 us, which at one lane
// weighs more than the phase's bytes (PERF.md §5-§6).
//
// Two kernels, chosen by B in the C entry: one lane runs the one-lane
// kernel (namespace one, below; why there), 8-32 lanes the body described
// here.
//
// Design.  A persistent grid (one block per SM: 8 warps up to 8 lanes, 16
// from 16 lanes, by measurement; launched with cudaLaunchCooperativeKernel,
// which refuses rather than run a grid that could deadlock) runs each
// frame as a fixed sequence of phases separated by grid barriers
// (gemv_stream.cuh):
//   sample+project  block b < B samples code_0 of lane b (the arithmetic of
//                   ops.sampling.sample_threshold, on 256 threads); every
//                   block projects its columns of h1024 = hidden . proj_w^T
//                   + proj_b (f32, a warp per lane, lane l summing k = 4 l +
//                   128 j by fma, then the butterfly) for every lane;
//   predictor       per token t and layer: qkv (the block that completes a
//                   kv head's qkv columns then runs its attention for every
//                   lane, a warp per (lane, kv head): q/k norm and rope,
//                   slot t's k/v row, scores over slots <= t, softmax, P.V,
//                   the context and its lane's max |ctx| by atomicMax), wo
//                   + residual, gate_up + SwiGLU (raising the lane's max
//                   |ff|), down + residual; after token t >= 1 the final
//                   norm and the 2048-row int8 window, each block writing
//                   its rows' best (value, lowest index) per lane; the next
//                   phase reduces those in every block (a warp per lane);
//   feedback        code_15 as above, then x = bf16(sum of 16 rows + pad);
//   talker          per layer: qkv; split-prefix attention over the whole
//                   grid (split_attn.cuh: items (lane, kv head, 64-slot
//                   split), a last-arriver combine in split order, the
//                   lane's max |ctx| by atomicMax); wo; gate_up; down;
//   codec head      final norm -> hidden (f32), int8 head -> logits.
// 1 + 16 x 6 x 4 + 15 + 1 + 28 x 5 + 1 = 542 barriers a frame at full
// width, at every B.
//
// The GEMV phases (w4a8; the heads int8 x bf16) have ONE body for B = 8-32:
// the lanes are the M rows of gemv_stream.cuh's mma.sync tiles (m16n8k32
// s8; the heads m16n8k16 bf16), in ceil(B / 16) row tiles, so each weight
// byte is read once for every lane; each w4a8 group's int32 dot is exact
// and the groups are summed in f32 in the JAX order, with each tile's K
// range split over idle warps (the exact dots kept in shared memory).
// Each GEMV input is normed and quantized once per phase for every lane at
// once: a warp per lane holds the row in registers and takes its sum of
// squares in quantize_rows' 256-thread order (KERNEL_ORDERS "rms", so the
// plain layer needs no other order), its max |h| and its int8 row with no
// block barrier; ctx and ff take their scale from the max |x| that their
// producers raised, and are quantized as they are staged.
//
// The weight ring (weight_ring.cuh).  Each block owns a contiguous range of
// every phase's 8-column output tiles (gemv_stream.cuh tile_range), so its
// weights and group scales are one byte range per matrix.  As soon as a
// block has read its weights of phase p it issues the Tensor Memory
// Accelerator's bulk copies of its share of the next phase that has
// weights, then arrives at the grid barrier: the weights stream into
// shared memory while the grid synchronises, and after the barrier a
// phase's chain is only the input rows, their norm and quantization, the
// dots from shared memory and the epilogue.  The ring holds one fill, the
// largest phase's share (the talker's gate_up: 104 KB a block at 132
// blocks); the staged rows (and the K split's dots, and the attention
// scratch) share a second region; the wrapper's plan (kernels/chunk_step.py
// `plan`) sizes both, and the rows a pass, and refuses a plan that does not
// fit.
//
// Data that other blocks wrote during the launch is read with ld.global.cg
// (L2; L1 is not coherent across SMs); weights arrive by the bulk copies.
//
// Code layout.  The GEMVs' staging and tiles, the heads' tiles, the sampler,
// the projection and the ring fill are out of line, one copy each, called
// with the shared-memory copy of the arguments (and the phase's Mat and In
// there too: a by-value struct would go to the stack); the phases called
// once a layer (attention, feedback, the token rows) are inline and read
// the kernel parameter.  Everything inlined spilled 3.7 KB a thread and was
// slower (PERF.md §6).
//
// What the measurement showed (an H100, block 0's `marks`): the weights
// land before the phase needs them, but the tiles' first pass over them is
// slow: at one lane the talker's qkv tiles take 15 kcycles, a second pass
// over the same ring 1.2 with the code warm either way, and cp.async in
// place of the bulk copies changes nothing.  Not explained yet (no
// stall-reason profiler was at hand); it is why the body is faster than
// the row tiles of 8 lanes it replaced, slower than the one-lane kernel at
// one lane (so B = 1 keeps that kernel), and slower than the step schedule
// (four frames of talker_step_fused + predict_frame_fused) at every B
// measured, 8-32, so the engine's default routes only B = 1 here
// (runtime/generate.CHUNK_BATCHES).

#include <algorithm>
#include <climits>

#include "gemv_stream.cuh"
#include "split_attn.cuh"
#include "weight_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;
using qtts::bf16r;
using qtts::bf2f;
using qtts::ld_bf;
using qtts::pv_slots;
using qtts::score_slots;
using qtts::warp_sum;

constexpr int N_TOKENS = 16;
constexpr int WINDOW = 2048;       // predictor lm-head rows per codebook
constexpr int MAX_FRAMES = 8;
constexpr int MAX_K = 8192;        // widest GEMV input
constexpr int MAX_D = 2048;        // widest normed row (a warp's registers)
constexpr int MAX_V = 4096;        // sampler columns
constexpr int TDH = 128;           // talker head_dim
constexpr int PDH = 64;            // predictor head_dim
constexpr int MAX_B = 32;
constexpr int CG = 2;              // query heads per kv head (both models)
constexpr int SPLIT = qtts::SPLIT; // talker prefix slots per work item
constexpr int GROUP = qtts::W4_GROUP;
constexpr int SAMPLER_THREADS = 256;
constexpr int MAX_WARPS = 16;
constexpr int MAX_PKV = 32;        // predictor kv heads
constexpr int SMALL_BYTES = 6144;  // kernels/chunk_step.SMALL_BYTES
constexpr int N_PTRS = 69, N_INTS = 36, N_FLTS = 7;

enum { EPI_STORE = 0, EPI_RESID = 1, EPI_SWIGLU = 2 };
// the weighted phases, in the order of kernels/chunk_step.PLAN_KINDS
enum { K_PROJ, K_PQKV, K_PWO, K_PGU, K_PDN, K_PHEAD, K_TQKV, K_TWO, K_TGU,
       K_TDN, K_CHEAD, N_KINDS };

struct Args {
  // inputs
  const float *logits, *hidden, *cos, *sin, *u;
  const int *lengths, *write_idx;
  // talker (talker_step.prep_layer_weights)
  const float *t_ln1, *t_ln2, *t_qn, *t_kn;
  const uint8_t* t_wqkv_q; const bf16* t_wqkv_s;
  const uint8_t* t_wo_q;   const bf16* t_wo_s;
  const uint8_t* t_gu_q;   const bf16* t_gu_s;
  const uint8_t* t_dn_q;   const bf16* t_dn_s;
  bf16 *cache_k, *cache_v;
  // extras (chunk_step.prep_chunk_extras)
  const float* tfn; const int8_t* chead_q; const float* chead_s;
  const float *proj_w, *proj_b, *tts_pad;
  const void* ctab_fb; const bf16* ctab_pred;
  const float* pfn; const int8_t* phead_q; const float* phead_s;
  const float *pcos, *psin;
  // predictor (chunk_step.prep_predictor_w4)
  const float *p_ln1, *p_ln2, *p_qn, *p_kn;
  const uint8_t* p_wqkv_q; const float* p_wqkv_s;
  const uint8_t* p_wo_q;   const float* p_wo_s;
  const uint8_t* p_gu_q;   const float* p_gu_s;
  const uint8_t* p_dn_q;   const float* p_dn_s;
  // outputs
  int* codes; float *logits_out, *hidden_out, *taps;
  bf16* xtaps;                     // optional: [B, F, L + 1, D]
  // scratch
  bf16 *x, *qkv, *ctx, *ff, *px, *pqkv, *pff, *pk, *pv;
  float* part;                     // talker splits: acc [B*Hkv, NS, CG, Dh]
                                   //   then (max, sum) [B*Hkv, NS, CG, 2]
  unsigned* arrive;                // [B * Hkv] splits done, 0 between phases
  unsigned* amax;                  // [F, 32 LP + 2 L, B] max |ctx|, |ff|
                                   //   (f32 bits), zeroed at launch
  unsigned* parrive;               // [PHkv] predictor qkv tiles done
  float* best_v; int* best_i;      // [B, blocks] head bests
  unsigned* barrier;               // [arrivals, check-outs], 0 at launch
  long long* trace;                // optional: phase clocks of block 0
  long long* marks;                // optional: [phases, 4] of block 0: ring
                                   //   landed, warp 0's tiles done, work
                                   //   done, barrier reached
  // sizes
  int F, L, D, H, Hkv, t_dh, FF, C, prompt_cap, LP, DP, PH, PHkv, p_dh, PFF,
      R_fb, R_pd, V, fb_bf16, slots, B;
  float t_eps, p_eps, temperature, top_k, top_p, t_scale, p_scale;
  // the plan (kernels/chunk_step.plan): blocks, warps a block, the ring's
  // and the row region's bytes, rows a pass per weighted phase
  int blocks, warps, ring_bytes, region_bytes;
  int rows[N_KINDS];
};

// ================================================================ one lane
// B = 1 runs this kernel, not the body further down, by measurement: on an
// H100 80GB HBM3 at 700 W one 4-frame chunk at start 32 takes 17.56-17.57
// ms here and 29.90-29.94 ms in the body (scripts/torch_step_bench.py,
// both in one run; PERF.md §6).  Its GEMVs run on the CUDA cores, a warp a
// weight row (w4a8.cuh w4a8_warp_row), the rows spread grid-stride over
// two 8-warp blocks an SM, each block norming and quantizing the input row
// itself after each barrier (quantize_rows); the predictor's attention
// runs in every wo block (pred_attn_wo); the talker's is split over the
// grid as in the body.  The talker layers sum in chunk_step.KERNEL_ORDERS,
// as the body's do; the heads sum a row on one warp (i8_row_dot), the
// body's on the tensor cores, so a lane of the body is not bit-equal to
// this kernel.  The weight ring is not used here (untried).
namespace one {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_D = 4096;        // widest row a block stages
constexpr long long BARRIER_TIMEOUT = 1LL << 34;   // SM cycles, ~8 s

// Per-warp scratch of the talker's split attention (talker_attn).
struct TalkWarp {
  float q[CG][TDH];                // normed, roped q heads times the scale
  float s[CG][SPLIT];              // a split's scores, then its p
  float k[TDH];                    // the frame's k row (bf16 values)
  float v[TDH];                    // and its v row
};

struct GemvSmem {
  int8_t xq[MAX_K];
  int gd[WARPS * 2 * (MAX_K / qtts::W4_GROUP)];
  uint16_t xs_raw[MAX_K];          // the (normed) input row, bf16 bits
  float sx[1];
};
struct RowSmem {
  float h[MAX_D];
  __align__(16) uint16_t xb_raw[MAX_D];   // bf16 bits (see xb())
  float bv[WARPS];
  int bi[WARPS];
};
// Floats of the predictor attention's shared scratch for ni (lane, kv
// head) items (pred_ctx_block): q [ni, CG, PDH], k [ni, PDH], v [ni, PDH],
// scores then p [ni, CG, N_TOKENS], sums [ni, CG].
__host__ __device__ inline size_t pred_attn_floats(int ni) {
  return (size_t)ni * (CG * PDH + 2 * PDH + CG * N_TOKENS + CG);
}

union Smem {
  GemvSmem g;
  RowSmem r;
  TalkWarp tw[WARPS];
};

__device__ __forceinline__ bf16* xb(Smem& sm) {
  return reinterpret_cast<bf16*>(sm.r.xb_raw);
}

// ------------------------------------------------------------- the barrier
// bar[0] is a monotonic arrival counter: barrier n of the launch completes
// when it reaches n * gridDim.x.  Arrival with release and polling with
// acquire semantics at GPU scope, as cooperative_groups' grid sync does;
// the block barriers around them order the other threads' accesses.  A
// block that waits for ~8 s traps (the launch then fails with an error)
// instead of hanging the card.  With `trace`, block 0 stores its SM clock
// as it leaves barrier n into trace[n] (trace[0]: at the kernel's start).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target,
                                          long long* trace) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned v;
    asm volatile("atom.add.release.gpu.u32 %0,[%1],%2;"
                 : "=r"(v) : "l"(bar), "r"(1u) : "memory");
    const long long t0 = clock64();
    do {
      asm volatile("ld.acquire.gpu.u32 %0,[%1];"
                   : "=r"(v) : "l"(bar) : "memory");
      if (clock64() - t0 > BARRIER_TIMEOUT) __trap();
    } while (v < target);
    if (trace != nullptr && blockIdx.x == 0)
      trace[target / gridDim.x] = clock64();
  }
  __syncthreads();
}

// After the last barrier each block checks out on bar[1]; the last one to
// do so sets both words back to 0 for the next launch.  By then every
// block has left its last poll of bar[0], so nothing reads it any more.
__device__ __forceinline__ void grid_exit(unsigned* bar) {
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.add.acq_rel.gpu.u32 %0,[%1],%2;"
                 : "=r"(old) : "l"(bar + 1), "r"(1u) : "memory");
    if (old == gridDim.x - 1) {
      bar[0] = 0u;
      bar[1] = 0u;
    }
  }
}

// ------------------------------------------------------------- reductions
__device__ __forceinline__ int block_min_int(int v, int* ired) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) ired[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = ired[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) s = min(s, ired[w]);
  return s;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// ---------------------------------------------------------------- sampler
// One block: code from logits lg [V] (V <= MAX_V) and uniform u, the same
// arithmetic as ops.sampling.sample_threshold (f32 bisections: 24 for the
// top-k threshold, 24 for the nucleus threshold, 12 on the column index
// for the inverse CDF).  Every thread returns the code.
template <bool CG>
__device__ int sample_block(const float* lg, int V, float u, float temp,
                            float top_k, float top_p, float* red,
                            int* ired) {
  constexpr int PER = MAX_V / THREADS;
  const int tid = threadIdx.x;
  float v[PER];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = tid + i * THREADS;
    v[i] = k < V ? (CG ? __ldcg(lg + k) : lg[k]) : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  m = qtts::block_max<THREADS>(m, red);
  if (temp <= 0.f) {
    int best = V;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = tid + i * THREADS;
      if (k < V && v[i] >= m) best = min(best, k);
    }
    return block_min_int(best, ired);
  }
  float lo = -1e5f, hi = m;
  for (int it = 0; it < 24; ++it) {
    const float mid = 0.5f * (lo + hi);
    float cnt = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) cnt += v[i] >= mid ? 1.f : 0.f;
    const bool ge = qtts::block_sum<THREADS>(cnt, red) >= top_k;
    lo = ge ? mid : lo;
    hi = ge ? hi : mid;
  }
  const float temp_c = fmaxf(temp, 1e-6f);
  float p[PER];
  bool keep[PER];
  float z = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = tid + i * THREADS;
    keep[i] = k < V && (v[i] >= lo || top_k <= 0.f);
    p[i] = keep[i] ? expf(__fdiv_rn(v[i] - m, temp_c)) : 0.f;
    z += p[i];
  }
  z = qtts::block_sum<THREADS>(z, red);
  float pmax = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    p[i] = __fdiv_rn(p[i], z);
    pmax = fmaxf(pmax, p[i]);
  }
  float plo = 0.f, phi = qtts::block_max<THREADS>(pmax, red);
  for (int it = 0; it < 24; ++it) {
    const float q = 0.5f * (plo + phi);
    float mass = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) mass += p[i] > q ? p[i] : 0.f;
    const bool ge = qtts::block_sum<THREADS>(mass, red) >= top_p;
    plo = ge ? q : plo;
    phi = ge ? phi : q;
  }
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    p[i] = keep[i] && p[i] > plo ? p[i] : 0.f;
    tot += p[i];
  }
  const float target = u * qtts::block_sum<THREADS>(tot, red);
  int ilo = 0, ihi = V - 1;
  for (int it = 0; it < 12; ++it) {                 // 2^12 >= MAX_V
    const int imid = (ilo + ihi) / 2;
    float pref = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      pref += tid + i * THREADS <= imid ? p[i] : 0.f;
    const bool gt = qtts::block_sum<THREADS>(pref, red) > target;
    ihi = gt ? imid : ihi;
    ilo = gt ? ilo : imid + 1;
  }
  return ihi;
}

// ------------------------------------------------------------ row helpers
// 1 / sqrt(mean(x^2) + eps) over a bf16 row written during the launch.
__device__ __forceinline__ float rms_inv(const bf16* x, int K, float eps,
                                         float* red) {
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const float v = ld_bf<true>(x + k);
    ss += v * v;
  }
  ss = qtts::block_sum<THREADS>(ss, red);
  return 1.0f / sqrtf(ss / (float)K + eps);
}

// A full warp's dot of int8 row w [K] with bf16 xs [K] (shared), in f32;
// every lane gets the sum.  K % 16 == 0.
__device__ __forceinline__ float i8_row_dot(const int8_t* __restrict__ w,
                                            const bf16* xs, int K) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
    const uint4 wv = *reinterpret_cast<const uint4*>(w + k0);
    const int8_t* w8 = reinterpret_cast<const int8_t*>(&wv);
    const uint4* xv = reinterpret_cast<const uint4*>(xs + k0);
    const uint4 xa = xv[0], xb = xv[1];
    const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&xa);
    const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&xb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f0 = __bfloat1622float2(h0[j]);
      const float2 f1 = __bfloat1622float2(h1[j]);
      acc = fmaf(f0.x, (float)w8[2 * j], acc);
      acc = fmaf(f0.y, (float)w8[2 * j + 1], acc);
      acc = fmaf(f1.x, (float)w8[8 + 2 * j], acc);
      acc = fmaf(f1.y, (float)w8[8 + 2 * j + 1], acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// (value, lowest index) over the blocks' scratch entries; every thread
// gets the index.
__device__ int grid_argmax(const Args& a, float* red, int* ired) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS) {
    const float v = __ldcg(a.best_v + i);
    const int k = __ldcg(a.best_i + i);
    if (better(v, k, bv, bi)) {
      bv = v;
      bi = k;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = bv;
    ired[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  float v = red[0];
  int k = ired[0];
  for (int w = 1; w < WARPS; ++w)
    if (better(red[w], ired[w], v, k)) {
      v = red[w];
      k = ired[w];
    }
  return k;
}

// ------------------------------------------------------------------ phases
// dst[n] for n < N (grid-stride over output columns, one warp each): the
// w4a8 product of the (normed) input row with column n (and n + N for the
// SwiGLU pair), then the epilogue; the talker_step.cu GEMV body.  in ==
// nullptr: the input row is already staged in xs_raw (not normed).
template <int R, bool RMS, int EPI, typename S>
__device__ void gemv(const bf16* in, const float* norm_w, float eps, int K,
                     const uint8_t* wq, const S* ws, int N, bf16* dst,
                     Smem& sm, float* red) {
  if (in == nullptr)
    qtts::quantize_staged<THREADS>(K, reinterpret_cast<bf16*>(sm.g.xs_raw),
                                   sm.g.xq, sm.g.sx, red);
  else
    qtts::quantize_rows<1, RMS, THREADS, true>(
        in, norm_w, K, eps, reinterpret_cast<bf16*>(sm.g.xs_raw), sm.g.xq,
        sm.g.sx, red);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* gw = sm.g.gd + warp * R * (K / qtts::W4_GROUP);
  for (int row = blockIdx.x * WARPS + warp; row < N;
       row += gridDim.x * WARPS) {
    float y[R];
    qtts::w4a8_warp_row<1, R>(sm.g.xq, sm.g.sx, K, wq, ws, N, row, gw, y);
    if (lane == 0) {
      bf16* o = dst + row;
      if (EPI == EPI_STORE) {
        *o = __float2bfloat16_rn(y[0]);
      } else if (EPI == EPI_RESID) {
        *o = __float2bfloat16_rn(__fadd_rn(ld_bf<true>(o), y[0]));
      } else {
        const float gate = y[0];
        const float act = bf16r(__fdiv_rn(gate, 1.0f + expf(-gate)));
        *o = __float2bfloat16_rn(__fmul_rn(act, y[R - 1]));
      }
    }
    __syncwarp();                  // gw is rewritten by the next column
  }
}

// Block 0: code_0 of frame f.  Every block: px = bf16(hid . proj_w^T + b).
__device__ void sample_project(const Args& a, int f, Smem& sm, float* red,
                               int* ired) {
  const float* lg = f == 0 ? a.logits : a.logits_out;
  const float* hid = f == 0 ? a.hidden : a.hidden_out;
  if (blockIdx.x == 0) {
    const int c0 = sample_block<true>(lg, a.V, a.u[f], a.temperature,
                                      a.top_k, a.top_p, red, ired);
    if (threadIdx.x == 0) a.codes[f * N_TOKENS] = c0;
  }
  for (int k = threadIdx.x; k < a.D; k += THREADS) sm.r.h[k] = __ldcg(hid + k);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * WARPS + warp; row < a.DP;
       row += gridDim.x * WARPS) {
    const float* w = a.proj_w + (size_t)row * a.D;
    float acc = 0.f;
    for (int k = lane * 4; k < a.D; k += 32 * 4) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k);
      acc = fmaf(sm.r.h[k], wv.x, acc);
      acc = fmaf(sm.r.h[k + 1], wv.y, acc);
      acc = fmaf(sm.r.h[k + 2], wv.z, acc);
      acc = fmaf(sm.r.h[k + 3], wv.w, acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0)
      a.px[row] = __float2bfloat16_rn(__fadd_rn(acc, a.proj_b[row]));
  }
}

// ------------------------------------------------------------- attention

// The predictor's attention of token tok, layer l, for lanes lane0 ..
// lane0 + NB - 1, on the whole block: the G <= CG query heads' context
// (bf16) of each (lane, kv head) item into the lane's row of xs (stride
// PH * PDH) at the c-major positions of wo's input (position c * PHkv +
// kvh for head kvh * G + c); with `write`, token tok's k/v rows into slot
// tok of pk/pv (one block per lane writes; every block keeps its own copy
// in the scratch ps, pred_attn_floats(NB * PHkv) floats, and reads only
// slots < tok, written in earlier phases).  Four steps, each a loop of
// independent pieces over the block's threads, a barrier between them:
// 1. q/k norms and rope, one warp per item (norm_rope_heads_g's
//    arithmetic; lane holds dims lane and lane + 32, rotate_half's pairs;
//    the loads of the warp's items first);
// 2. scores, one thread per (item, slot): q . k by fma in dim order, times
//    the scale (slots > tok masked);
// 3. softmax, one thread per (item, head): max, p = exp(s - max), the sum
//    of p in slot order;
// 4. P.V, one thread per (item, DC columns): fma over the slots in order.
// Each item's arithmetic is the same whatever NB, so a batched launch's
// lanes equal the one-lane launch's.
template <int NB>
__device__ void pred_ctx_block(const Args& a, int lane0, int tok, int l,
                               bool write, float* ps, bf16* xs) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.PH / a.PHkv;
  const int NI = NB * a.PHkv;
  const int pnqkv = (a.PH + 2 * a.PHkv) * PDH, pdq = a.PH * PDH;
  float* qs = ps;                                   // [NI, CG, PDH]
  float* ks = qs + (size_t)NI * CG * PDH;           // [NI, PDH]
  float* vs = ks + (size_t)NI * PDH;                // [NI, PDH]
  float* ss = vs + (size_t)NI * PDH;                // [NI, CG, N_TOKENS]
  float* sums = ss + (size_t)NI * CG * N_TOKENS;    // [NI, CG]
  const float* cs = a.pcos + (size_t)tok * PDH;
  const float* sn = a.psin + (size_t)tok * PDH;
  auto kv_head = [&](int it) {                      // item it = b * PHkv + kvh
    return (((size_t)(lane0 + it / a.PHkv) * a.LP + l) * a.PHkv +
            it % a.PHkv) * N_TOKENS * PDH;
  };
  // ---- 1. norms and rope: IG items of the warp at a time, their rows
  // loaded first
  constexpr int IG = NB < 4 ? NB : 4;
  for (int it0 = warp; it0 < NI; it0 += IG * WARPS) {
    float raw[IG][CG + 1][2], rv[IG][2];
#pragma unroll
    for (int r = 0; r < IG; ++r) {
      const int it = it0 + r * WARPS;
      if (it < NI) {
        const int kvh = it % a.PHkv;
        const bf16* row = a.pqkv + (size_t)(lane0 + it / a.PHkv) * pnqkv;
#pragma unroll
        for (int h = 0; h <= CG; ++h) {          // q heads h < G; k at CG
          const bool live = h == CG || h < G;
          const bf16* src =
              row + (size_t)(h == CG ? a.PH + kvh : kvh * G + h) * PDH;
          raw[r][h][0] = live ? ld_bf<true>(src + lane) : 0.f;
          raw[r][h][1] = live ? ld_bf<true>(src + lane + 32) : 0.f;
        }
        const bf16* vsrc = row + (size_t)(a.PH + a.PHkv + kvh) * PDH;
        rv[r][0] = ld_bf<true>(vsrc + lane);
        rv[r][1] = ld_bf<true>(vsrc + lane + 32);
      }
    }
#pragma unroll
    for (int r = 0; r < IG; ++r) {
      const int it = it0 + r * WARPS;
      if (it >= NI) continue;
#pragma unroll
      for (int h = 0; h <= CG; ++h) {
        const float r0 = raw[r][h][0], r1 = raw[r][h][1];
        const float sq = __fadd_rn(warp_sum(__fmul_rn(r0, r0)),
                                   warp_sum(__fmul_rn(r1, r1)));
        const float inv = 1.0f / sqrtf(sq / (float)PDH + a.p_eps);
        const float* nw = (h == CG ? a.p_kn : a.p_qn) + (size_t)l * PDH;
        const float x0 = bf16r(__fmul_rn(__fmul_rn(r0, inv), nw[lane]));
        const float x1 = bf16r(__fmul_rn(__fmul_rn(r1, inv), nw[lane + 32]));
        float* dst = h == CG ? ks + (size_t)it * PDH
                             : qs + ((size_t)it * CG + h) * PDH;
        dst[lane] = bf16r(__fadd_rn(__fmul_rn(x0, cs[lane]),
                                    __fmul_rn(-x1, sn[lane])));
        dst[lane + 32] = bf16r(__fadd_rn(__fmul_rn(x1, cs[lane + 32]),
                                         __fmul_rn(x0, sn[lane + 32])));
      }
      vs[(size_t)it * PDH + lane] = rv[r][0];
      vs[(size_t)it * PDH + lane + 32] = rv[r][1];
      if (write) {
        __syncwarp();
        bf16* kr = a.pk + kv_head(it) + (size_t)tok * PDH;
        bf16* vr = a.pv + kv_head(it) + (size_t)tok * PDH;
        kr[lane] = __float2bfloat16_rn(ks[(size_t)it * PDH + lane]);
        kr[lane + 32] = __float2bfloat16_rn(ks[(size_t)it * PDH + lane + 32]);
        vr[lane] = __float2bfloat16_rn(rv[r][0]);
        vr[lane + 32] = __float2bfloat16_rn(rv[r][1]);
      }
    }
  }
  __syncthreads();
  // ---- 2. scores (the next pair's k row loaded during this pair's dots)
  auto load_k = [&](int pr, uint4 (&u)[PDH / 8]) {
    const int it = pr / N_TOKENS, j = pr % N_TOKENS;
    const bool g_ = pr < NI * N_TOKENS && j < tok;
    const bf16* kr = a.pk + (g_ ? kv_head(it) + (size_t)j * PDH : 0);
#pragma unroll
    for (int i = 0; i < PDH / 8; ++i)
      u[i] = g_ ? qtts::ld_16<true>(kr + i * 8) : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 un[PDH / 8];
  load_k(tid, un);
  for (int pr = tid; pr < NI * N_TOKENS; pr += THREADS) {
    const int it = pr / N_TOKENS, j = pr % N_TOKENS;
    uint4 u[PDH / 8];
#pragma unroll
    for (int i = 0; i < PDH / 8; ++i) u[i] = un[i];
    load_k(pr + THREADS, un);
    float* srow = ss + (size_t)it * CG * N_TOKENS + j;   // head g: g * 16
    if (j > tok) {
#pragma unroll
      for (int g = 0; g < CG; ++g) srow[g * N_TOKENS] = qtts::NEG;
      continue;
    }
    const float* qi = qs + (size_t)it * CG * PDH;
    const float* ki = ks + (size_t)it * PDH;
    float acc[CG];
#pragma unroll
    for (int g = 0; g < CG; ++g) acc[g] = 0.f;
#pragma unroll
    for (int i = 0; i < PDH / 8; ++i) {
      float kf[8];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f2 = __bfloat1622float2(h2[e]);
        kf[2 * e] = j < tok ? f2.x : ki[i * 8 + 2 * e];
        kf[2 * e + 1] = j < tok ? f2.y : ki[i * 8 + 2 * e + 1];
      }
#pragma unroll
      for (int g = 0; g < CG; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[g] = fmaf(qi[g * PDH + i * 8 + e], kf[e], acc[g]);
    }
#pragma unroll
    for (int g = 0; g < CG; ++g)
      srow[g * N_TOKENS] = __fmul_rn(acc[g], a.p_scale);
  }
  __syncthreads();
  // ---- 3. softmax
  for (int rw = tid; rw < NI * CG; rw += THREADS) {
    if (rw % CG >= G) continue;
    float* srow = ss + (size_t)rw * N_TOKENS;
    float mx = qtts::NEG;
    for (int j = 0; j <= tok; ++j) mx = fmaxf(mx, srow[j]);
    float sum = 0.f;
    for (int j = 0; j <= tok; ++j) {
      const float p = expf(srow[j] - mx);
      srow[j] = p;
      sum += p;
    }
    sums[rw] = sum;
  }
  __syncthreads();
  // ---- 4. P.V: DC columns a thread, the v rows of JB slots loaded first
  constexpr int DC = NB == 1 ? 4 : 8;
  constexpr int JB = NB == 1 ? N_TOKENS : 8;
  constexpr int NCH = PDH / DC;
  for (int o = tid; o < NI * NCH; o += THREADS) {
    const int it = o / NCH, d0 = (o % NCH) * DC;
    const bf16* vb = a.pv + kv_head(it) + d0;
    const float* vi = vs + (size_t)it * PDH + d0;
    const float* pi = ss + (size_t)it * CG * N_TOKENS;
    float acc[CG][DC];
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int e = 0; e < DC; ++e) acc[g][e] = 0.f;
    for (int j0 = 0; j0 <= tok; j0 += JB) {
      uint2 u[JB][DC / 4];
#pragma unroll
      for (int q = 0; q < JB; ++q)
#pragma unroll
        for (int c = 0; c < DC / 4; ++c)
          u[q][c] = j0 + q < tok
                        ? __ldcg(reinterpret_cast<const uint2*>(
                              vb + (size_t)(j0 + q) * PDH + 4 * c))
                        : make_uint2(0u, 0u);
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const int j = j0 + q;
        if (j > tok) break;
        float vf[DC];
#pragma unroll
        for (int c = 0; c < DC / 4; ++c) {
          const __nv_bfloat162* h2 =
              reinterpret_cast<const __nv_bfloat162*>(&u[q][c]);
          const float2 va = __bfloat1622float2(h2[0]);
          const float2 vb2 = __bfloat1622float2(h2[1]);
          vf[4 * c] = j < tok ? va.x : vi[4 * c];
          vf[4 * c + 1] = j < tok ? va.y : vi[4 * c + 1];
          vf[4 * c + 2] = j < tok ? vb2.x : vi[4 * c + 2];
          vf[4 * c + 3] = j < tok ? vb2.y : vi[4 * c + 3];
        }
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const float p = pi[g * N_TOKENS + j];
#pragma unroll
          for (int e = 0; e < DC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    const int bl = it / a.PHkv, kvh = it % a.PHkv;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (g >= G) break;
      const float den = fmaxf(sums[(size_t)it * CG + g], 1e-30f);
      bf16* c = xs + (size_t)bl * pdq + ((size_t)g * a.PHkv + kvh) * PDH + d0;
#pragma unroll
      for (int e = 0; e < DC; ++e) c[e] = __float2bfloat16_rn(acc[g][e] / den);
    }
  }
  __syncthreads();
}

// The talker's q heads and k head of (lane b, kv head kvh) at frame f,
// layer l, on one warp: norm_rope_heads_g's arithmetic (its sums of
// squares in the same order: lane holds dims lane + 32 i, each set's
// butterfly, then the sets in order), q times the score scale, into w.q;
// the k row (roped) and the v row into w.k and w.v.
__device__ void talker_qk_warp(const Args& a, int b, int kvh, int f, int l,
                               TalkWarp& w) {
  qtts::qk_warp(a.qkv + (size_t)b * (a.H + 2 * a.Hkv) * TDH, a.H, a.Hkv, kvh,
                a.H / a.Hkv, a.t_qn + (size_t)l * TDH, a.t_kn + (size_t)l * TDH,
                a.cos + ((size_t)f * a.B + b) * TDH,
                a.sin + ((size_t)f * a.B + b) * TDH, a.t_eps, a.t_scale, w);
}


// Talker attention of frame f, layer l, split over the whole grid: items
// (lane b, kv head, split s of the cache prefix [0, start)), one warp
// each, items spread over the blocks first.  Per split: its scores
// (score_slots; slot c visible iff c < length or c >= prompt_cap), its
// max m, p = exp(s - m) (masked: 0 exactly), l = the 32 lanes' butterfly
// of p[lane] + p[lane + 32], acc = P.V in slot order by fma (lane: columns
// 4 lane .. 4 lane + 3).  With more than one split each writes (acc, m, l)
// to a.part; the warp that finishes last (a.arrive) combines them in split
// order: M = max m_s, acc = sum_s acc_s exp(m_s - M) by fma, l likewise.
// That warp then writes the frame's k/v row at slot start + f and merges
// the chunk's own slots start .. start + f (always visible) as one last
// online-softmax step, the JAX order.  Context out in head order.
__device__ void talker_attn(const Args& a, int f, int l, int start,
                            TalkWarp* tw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  TalkWarp& w = tw[warp];
  const int G = a.H / a.Hkv;
  const int dq = a.H * TDH;
  const int end = min(start, a.C);             // the cache prefix
  const int ns = max(1, (end + SPLIT - 1) / SPLIT);
  const int nsmax = (a.C + SPLIT - 1) / SPLIT;
  const size_t n_heads = (size_t)a.B * a.Hkv * nsmax * CG;
  float* part_acc = a.part;
  float* part_ml = a.part + n_heads * TDH;
  const int n_items = a.B * a.Hkv * ns;
  for (int it = blockIdx.x + warp * gridDim.x; it < n_items;
       it += gridDim.x * WARPS) {
    const int s = it % ns, bh = it / ns;
    const int b = bh / a.Hkv, kvh = bh % a.Hkv;
    const int length = a.lengths[b];
    const size_t head = ((size_t)l * a.B + b) * a.Hkv + kvh;
    bf16* kp = a.cache_k + head * a.C * TDH;
    bf16* vp = a.cache_v + head * a.C * TDH;
    talker_qk_warp(a, b, kvh, f, l, w);
    // ---- split s: slots [c0, c0 + n)
    const int c0 = s * SPLIT;
    const int n = max(0, min(SPLIT, end - c0));
    const int pc = a.prompt_cap;
    score_slots(
        w, G, n, [&](int j) { return kp + (size_t)(c0 + j) * TDH; },
        [](int) { return false; },
        [&](int j) { return c0 + j < length || c0 + j >= pc; });
    float m[CG], ls[CG], acc[CG][4];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float sa = lane < n ? w.s[g][lane] : qtts::NEG;
      const float sb = lane + 32 < n ? w.s[g][lane + 32] : qtts::NEG;
      float mx = fmaxf(sa, sb);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float pa = sa > qtts::NEG ? expf(sa - mx) : 0.f;
      const float pb = sb > qtts::NEG ? expf(sb - mx) : 0.f;
      m[g] = mx;
      ls[g] = warp_sum(__fadd_rn(pa, pb));
      __syncwarp();
      if (g < G) {
        w.s[g][lane] = pa;
        w.s[g][lane + 32] = pb;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
    }
    __syncwarp();
    pv_slots(w, n, [&](int j) { return vp + (size_t)(c0 + j) * TDH; },
             [](int) { return false; }, acc);
    if (ns > 1) {
      // ---- this split's partials out; the last of the item's splits
      // combines them
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        if (g >= G) continue;
        const size_t r = ((size_t)bh * nsmax + s) * CG + g;
        *reinterpret_cast<float4*>(part_acc + r * TDH + 4 * lane) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        if (lane == 0) {
          part_ml[r * 2] = m[g];
          part_ml[r * 2 + 1] = ls[g];
        }
      }
      __threadfence();
      __syncwarp();
      unsigned old = 0;
      if (lane == 0) old = atomicAdd(a.arrive + bh, 1u);
      old = __shfl_sync(0xffffffffu, old, 0);
      if (old != (unsigned)ns - 1) continue;
      __threadfence();
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        if (g >= G) continue;
        const size_t r0 = (size_t)bh * nsmax * CG + g;
        float mm = qtts::NEG;
#pragma unroll 4
        for (int z = 0; z < ns; ++z)
          mm = fmaxf(mm, __ldcg(part_ml + (r0 + (size_t)z * CG) * 2));
        float l_ = 0.f, ac[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int z = 0; z < ns; ++z) {
          const size_t r = r0 + (size_t)z * CG;
          const float wz = expf(__ldcg(part_ml + r * 2) - mm);
          l_ = fmaf(__ldcg(part_ml + r * 2 + 1), wz, l_);
          const float4 pz = __ldcg(
              reinterpret_cast<const float4*>(part_acc + r * TDH + 4 * lane));
          ac[0] = fmaf(pz.x, wz, ac[0]);
          ac[1] = fmaf(pz.y, wz, ac[1]);
          ac[2] = fmaf(pz.z, wz, ac[2]);
          ac[3] = fmaf(pz.w, wz, ac[3]);
        }
        m[g] = mm;
        ls[g] = l_;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = ac[i];
      }
      if (lane == 0) a.arrive[bh] = 0u;          // for the next layer
    }
    // ---- the merging warp: slot start + f written once, then the chunk's
    // frames 0..f at slots start .. start + f as one merge
    const int slot = start + f;
    if (slot < a.C) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kp[(size_t)slot * TDH + lane + 32 * i] =
            __float2bfloat16_rn(w.k[lane + 32 * i]);
        vp[(size_t)slot * TDH + lane + 32 * i] =
            __float2bfloat16_rn(w.v[lane + 32 * i]);
      }
    }
    const int n_loc = min(f + 1, a.C - start);
    auto own = [&](int j) { return j == f; };
    score_slots(
        w, G, n_loc, [&](int j) { return kp + (size_t)(start + j) * TDH; },
        own, [](int) { return true; });
    // rescale the prefix by exp(m - mx), then p = exp(s - mx) of each own
    // slot into w.s for pv_slots
    float lsum[CG];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      float mx = m[g];
      for (int j = 0; j < n_loc; ++j) mx = fmaxf(mx, w.s[g][j]);
      const float alpha = expf(m[g] - mx);
      lsum[g] = __fmul_rn(ls[g], alpha);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = __fmul_rn(acc[g][i], alpha);
      __syncwarp();
      float pj = 0.f;
      for (int j = 0; j < n_loc; ++j) {
        const float p = expf(w.s[g][j] - mx);
        lsum[g] = __fadd_rn(lsum[g], p);
        if (lane == j) pj = p;
      }
      __syncwarp();
      if (lane < n_loc) w.s[g][lane] = pj;
    }
    __syncwarp();
    pv_slots(w, n_loc, [&](int j) { return vp + (size_t)(start + j) * TDH; },
             own, acc);
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (g >= G) continue;
      float* ac = acc[g];
      const float den = fmaxf(lsum[g], 1e-30f);
      __nv_bfloat162 o2[2];
      o2[0] = __floats2bfloat162_rn(ac[0] / den, ac[1] / den);
      o2[1] = __floats2bfloat162_rn(ac[2] / den, ac[3] / den);
      *reinterpret_cast<uint2*>(a.ctx + (size_t)b * dq +
                                ((size_t)kvh * G + g) * TDH + 4 * lane) =
          *reinterpret_cast<const uint2*>(o2);
    }
    __syncwarp();                  // w is rewritten by the warp's next item
  }
}

// The predictor's attention and wo phase of token tok, layer l (one lane):
// a block with wo rows stages the context in xs_raw (pred_ctx_block, its
// scratch after the staged row; block 0 writes the k/v rows) and runs the
// wo GEMV on it.
__device__ void pred_attn_wo(const Args& a, int tok, int l, Smem& sm,
                             float* red) {
  const int pdq = a.PH * PDH;
  if ((int)blockIdx.x * WARPS >= a.DP) return;   // no wo rows here
  bf16* xs = reinterpret_cast<bf16*>(sm.g.xs_raw);
  pred_ctx_block<1>(a, 0, tok, l, blockIdx.x == 0,
                    reinterpret_cast<float*>(sm.g.xs_raw + pdq), xs);
  gemv<1, false, EPI_RESID, float>(
      nullptr, nullptr, a.p_eps, pdq,
      a.p_wo_q + (size_t)l * a.DP * (pdq / 2),
      a.p_wo_s + (size_t)l * a.DP * (pdq / qtts::W4_GROUP), a.DP, a.px, sm,
      red);
}

// Window tok - 1 of the predictor's lm-head: logits into taps, each
// block's best (value, lowest row) into the scratch.
__device__ void pred_head(const Args& a, int f, int tok, Smem& sm,
                          float* red) {
  const float inv = rms_inv(a.px, a.DP, a.p_eps, red);
  for (int k = threadIdx.x; k < a.DP; k += THREADS)
    xb(sm)[k] = __float2bfloat16_rn(
        __fmul_rn(__fmul_rn(ld_bf<true>(a.px + k), inv), a.pfn[k]));
  __syncthreads();
  const int win = tok - 1;
  const int8_t* W = a.phead_q + (size_t)win * WINDOW * a.DP;
  const float* S = a.phead_s + (size_t)win * WINDOW;
  float* out = a.taps == nullptr
                   ? nullptr
                   : a.taps + ((size_t)f * (N_TOKENS - 1) + win) * WINDOW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int row = blockIdx.x * WARPS + warp; row < WINDOW;
       row += gridDim.x * WARPS) {
    const float lg = __fmul_rn(i8_row_dot(W + (size_t)row * a.DP, xb(sm),
                                          a.DP), S[row]);
    if (lane == 0 && out != nullptr) out[row] = lg;
    if (lg > bv) {                  // rows rise: the first max is kept
      bv = lg;
      bi = row;
    }
  }
  if (lane == 0) {
    sm.r.bv[warp] = bv;
    sm.r.bi[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w)
      if (better(sm.r.bv[w], sm.r.bi[w], bv, bi)) {
        bv = sm.r.bv[w];
        bi = sm.r.bi[w];
      }
    a.best_v[blockIdx.x] = bv;
    a.best_i[blockIdx.x] = bi;
  }
}

// The talker's residual entering layer `slot` of frame f (slot L: the last
// layer's output) into xtaps [1, F, L + 1, D], for the checks that hold
// the kernel layer by layer; called in a phase that only reads x.
__device__ void tap_x(const Args& a, int f, int slot) {
  if (a.xtaps == nullptr) return;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < a.D;
       i += gridDim.x * THREADS)
    a.xtaps[((size_t)f * (a.L + 1) + slot) * a.D + i] =
        __float2bfloat16_rn(ld_bf<true>(a.x + i));
}

// x = bf16(sum_q ctab_fb[q][code_q] (f32, q in order) + tts_pad).
__device__ void feedback(const Args& a, int f, int code15) {
  int code[N_TOKENS];
#pragma unroll
  for (int q = 0; q < N_TOKENS; ++q) {
    const int c = q < N_TOKENS - 1 ? __ldcg(a.codes + f * N_TOKENS + q)
                                   : code15;
    code[q] = min(max(c, 0), a.R_fb - 1);
  }
  for (int k = blockIdx.x * THREADS + threadIdx.x; k < a.D;
       k += gridDim.x * THREADS) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < N_TOKENS; ++q) {
      const size_t i = ((size_t)q * a.R_fb + code[q]) * a.D + k;
      s = __fadd_rn(s, a.fb_bf16 ? bf2f(static_cast<const bf16*>(a.ctab_fb)[i])
                                 : static_cast<const float*>(a.ctab_fb)[i]);
    }
    a.x[k] = __float2bfloat16_rn(__fadd_rn(s, a.tts_pad[k]));
  }
}

// hidden = RMSNorm(x, tfn) in f32 (block 0 writes it out); logits[n] =
// (bf16(hidden) . chead_q[n]) * chead_s[n] for n < V.
__device__ void codec_head(const Args& a, Smem& sm, float* red) {
  const float inv = rms_inv(a.x, a.D, a.t_eps, red);
  for (int k = threadIdx.x; k < a.D; k += THREADS) {
    const float h = __fmul_rn(__fmul_rn(ld_bf<true>(a.x + k), inv), a.tfn[k]);
    xb(sm)[k] = __float2bfloat16_rn(h);
    if (blockIdx.x == 0) a.hidden_out[k] = h;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * WARPS + warp; row < a.V;
       row += gridDim.x * WARPS) {
    const float acc = i8_row_dot(a.chead_q + (size_t)row * a.D, xb(sm), a.D);
    if (lane == 0) a.logits_out[row] = __fmul_rn(acc, a.chead_s[row]);
  }
}

__global__ void __launch_bounds__(THREADS, 2) chunk_kernel(const Args a) {
  __shared__ __align__(16) Smem sm;
  __shared__ float red[WARPS];
  __shared__ int ired[WARPS];
  unsigned target = 0;             // bar[0] at the next barrier
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.trace[0] = clock64();
  const int start = a.write_idx[0];
  const int GRP = qtts::W4_GROUP;
  // predictor and talker matrix sizes
  const int pnqkv = (a.PH + 2 * a.PHkv) * PDH;
  const int nqkv = (a.H + 2 * a.Hkv) * TDH, dq = a.H * TDH;
  const int DP = a.DP, D = a.D;

  for (int f = 0; f < a.F; ++f) {
    sample_project(a, f, sm, red, ired);
    grid_sync(a.barrier, target, a.trace);

    // ---- predictor: 16 tokens x LP layers
    for (int tok = 0; tok < N_TOKENS; ++tok) {
      for (int l = 0; l < a.LP; ++l) {
        const bf16* in = a.px;
        if (l == 0 && tok >= 1) {
          // the input of token tok: ctab_pred[tok - 1][code_{tok - 1}]
          const int prev = tok - 1;
          int code = prev == 0 ? __ldcg(a.codes + f * N_TOKENS)
                               : grid_argmax(a, red, ired);
          if (prev >= 1 && blockIdx.x == 0 && threadIdx.x == 0)
            a.codes[f * N_TOKENS + prev] = code;
          code = min(max(code, 0), a.R_pd - 1);
          in = a.ctab_pred + ((size_t)prev * a.R_pd + code) * DP;
          if (blockIdx.x == 0)
            for (int k = threadIdx.x; k < DP; k += THREADS) a.px[k] = in[k];
        }
        gemv<1, true, EPI_STORE, float>(
            in, a.p_ln1 + (size_t)l * DP, a.p_eps, DP,
            a.p_wqkv_q + (size_t)l * pnqkv * (DP / 2),
            a.p_wqkv_s + (size_t)l * pnqkv * (DP / GRP), pnqkv, a.pqkv, sm,
            red);
        grid_sync(a.barrier, target, a.trace);
        pred_attn_wo(a, tok, l, sm, red);
        grid_sync(a.barrier, target, a.trace);
        gemv<2, true, EPI_SWIGLU, float>(
            a.px, a.p_ln2 + (size_t)l * DP, a.p_eps, DP,
            a.p_gu_q + (size_t)l * 2 * a.PFF * (DP / 2),
            a.p_gu_s + (size_t)l * 2 * a.PFF * (DP / GRP), a.PFF, a.pff, sm,
            red);
        grid_sync(a.barrier, target, a.trace);
        gemv<1, false, EPI_RESID, float>(
            a.pff, nullptr, a.p_eps, a.PFF,
            a.p_dn_q + (size_t)l * DP * (a.PFF / 2),
            a.p_dn_s + (size_t)l * DP * (a.PFF / GRP), DP, a.px, sm, red);
        grid_sync(a.barrier, target, a.trace);
      }
      if (tok >= 1) {
        pred_head(a, f, tok, sm, red);
        grid_sync(a.barrier, target, a.trace);
      }
    }

    // ---- feedback (code_15 is the last window's argmax)
    const int code15 = grid_argmax(a, red, ired);
    if (blockIdx.x == 0 && threadIdx.x == 0)
      a.codes[f * N_TOKENS + N_TOKENS - 1] = code15;
    feedback(a, f, code15);
    grid_sync(a.barrier, target, a.trace);

    // ---- talker step
    for (int l = 0; l < a.L; ++l) {
      tap_x(a, f, l);
      gemv<1, true, EPI_STORE, bf16>(
          a.x, a.t_ln1 + (size_t)l * D, a.t_eps, D,
          a.t_wqkv_q + (size_t)l * nqkv * (D / 2),
          a.t_wqkv_s + (size_t)l * nqkv * (D / GRP), nqkv, a.qkv, sm, red);
      grid_sync(a.barrier, target, a.trace);
      talker_attn(a, f, l, start, sm.tw);
      grid_sync(a.barrier, target, a.trace);
      gemv<1, false, EPI_RESID, bf16>(
          a.ctx, nullptr, a.t_eps, dq, a.t_wo_q + (size_t)l * D * (dq / 2),
          a.t_wo_s + (size_t)l * D * (dq / GRP), D, a.x, sm, red);
      grid_sync(a.barrier, target, a.trace);
      gemv<2, true, EPI_SWIGLU, bf16>(
          a.x, a.t_ln2 + (size_t)l * D, a.t_eps, D,
          a.t_gu_q + (size_t)l * 2 * a.FF * (D / 2),
          a.t_gu_s + (size_t)l * 2 * a.FF * (D / GRP), a.FF, a.ff, sm, red);
      grid_sync(a.barrier, target, a.trace);
      gemv<1, false, EPI_RESID, bf16>(
          a.ff, nullptr, a.t_eps, a.FF,
          a.t_dn_q + (size_t)l * D * (a.FF / 2),
          a.t_dn_s + (size_t)l * D * (a.FF / GRP), D, a.x, sm, red);
      grid_sync(a.barrier, target, a.trace);
    }
    tap_x(a, f, a.L);
    codec_head(a, sm, red);
    grid_sync(a.barrier, target, a.trace);
  }
  grid_exit(a.barrier);
}

// As many 8-warp blocks as are resident (two an SM: 29 KB of static
// shared memory, 128 registers a thread), up to the argmax scratch's
// `slots`; info gets (blocks, warps a block).
cudaError_t launch(const Args& a, int* info, cudaStream_t st) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chunk_kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  per_sm = std::min(per_sm, a.slots / sms);
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  info[0] = per_sm * sms;
  info[1] = WARPS;
  void* params[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel((const void*)chunk_kernel,
                                  dim3(per_sm * sms), dim3(THREADS), params,
                                  0, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace one

// Per-warp scratch of the talker's split attention (talker_attn).
using TalkWarp = qtts::SplitWarp<CG>;
// Per-warp scratch of the predictor's attention (pred_attend): the k/v
// rows of the 16 slots (rows padded: no bank conflicts), the q heads, p.
struct PredWarp {
  bf16 k[N_TOKENS][PDH + 8];
  bf16 v[N_TOKENS][PDH + 8];
  float q[CG][PDH];
  float p[CG][N_TOKENS];
};
static_assert(sizeof(TalkWarp) == 2560, "kernels/chunk_step.TALK_WARP_BYTES");
static_assert(sizeof(PredWarp) == 5248, "kernels/chunk_step.PRED_WARP_BYTES");

// Small per-block state, after the row region.
struct Small {
  uint64_t bar;                    // the ring's mbarrier
  float sx[MAX_B];                 // the staged rows' scales
  float red[MAX_WARPS];
  int ired[MAX_WARPS];
  int code[MAX_B];                 // the lanes' last codes
  int row[MAX_B];                  // and their (clamped) table rows
  float bv[MAX_WARPS][MAX_B];      // the head's best (value, row) per warp
  int bi[MAX_WARPS][MAX_B];        //   and staged row
  int last[MAX_PKV];               // kv heads whose attention this block runs
  int n_last;
  Args args;                       // the launch's arguments, for the
                                   //   out-of-line bodies (below)
  // the current GEMV phase's matrix and input (Mat, In), for the same:
  // in shared memory, not on their stack
  alignas(8) unsigned char mat[64];
  alignas(8) unsigned char in[64];
};
static_assert(sizeof(Small) <= SMALL_BYTES, "kernels/chunk_step.SMALL_BYTES");

// ------------------------------------------------------------ reductions
// Max / min over a group of NT threads on barrier BAR (0: the whole
// block); `red` holds NT / 32 entries.
template <int NT, int BAR>
__device__ __forceinline__ float group_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  qtts::group_sync<NT>(BAR);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  qtts::group_sync<NT>(BAR);
  float s = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) s = fmaxf(s, red[w]);
  return s;
}

template <int NT, int BAR>
__device__ __forceinline__ int group_min_int(int v, int* ired) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  qtts::group_sync<NT>(BAR);
  if ((threadIdx.x & 31) == 0) ired[threadIdx.x >> 5] = v;
  qtts::group_sync<NT>(BAR);
  int s = ired[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) s = min(s, ired[w]);
  return s;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// ---------------------------------------------------------------- sampler
// The first 256 threads of the block (barrier BAR): code from logits lg
// [V] (V <= MAX_V) and uniform u, the same arithmetic as
// ops.sampling.sample_threshold (f32 bisections: 24 for the top-k
// threshold, 24 for the nucleus threshold, 12 on the column index for the
// inverse CDF).  Each of those threads returns the code.
template <bool LDCG, int BAR>
__device__ __forceinline__ int sample_block(const float* lg, int V, float u, float temp,
                            float top_k, float top_p, float* red,
                            int* ired) {
  constexpr int NT = SAMPLER_THREADS;
  constexpr int PER = MAX_V / NT;
  const int tid = threadIdx.x;
  auto bsum = [&](float v) { return qtts::group_sum<NT>(v, red, tid, BAR); };
  float v[PER];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = tid + i * NT;
    v[i] = k < V ? (LDCG ? __ldcg(lg + k) : lg[k]) : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  m = group_max<NT, BAR>(m, red);
  if (temp <= 0.f) {
    int best = V;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = tid + i * NT;
      if (k < V && v[i] >= m) best = min(best, k);
    }
    return group_min_int<NT, BAR>(best, ired);
  }
  float lo = -1e5f, hi = m;
  for (int it = 0; it < 24; ++it) {
    const float mid = 0.5f * (lo + hi);
    float cnt = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) cnt += v[i] >= mid ? 1.f : 0.f;
    const bool ge = bsum(cnt) >= top_k;
    lo = ge ? mid : lo;
    hi = ge ? hi : mid;
  }
  const float temp_c = fmaxf(temp, 1e-6f);
  float p[PER];
  bool keep[PER];
  float z = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = tid + i * NT;
    keep[i] = k < V && (v[i] >= lo || top_k <= 0.f);
    p[i] = keep[i] ? expf(__fdiv_rn(v[i] - m, temp_c)) : 0.f;
    z += p[i];
  }
  z = bsum(z);
  float pmax = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    p[i] = __fdiv_rn(p[i], z);
    pmax = fmaxf(pmax, p[i]);
  }
  float plo = 0.f, phi = group_max<NT, BAR>(pmax, red);
  for (int it = 0; it < 24; ++it) {
    const float q = 0.5f * (plo + phi);
    float mass = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) mass += p[i] > q ? p[i] : 0.f;
    const bool ge = bsum(mass) >= top_p;
    plo = ge ? q : plo;
    phi = ge ? phi : q;
  }
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    p[i] = keep[i] && p[i] > plo ? p[i] : 0.f;
    tot += p[i];
  }
  const float target = u * bsum(tot);
  int ilo = 0, ihi = V - 1;
  for (int it = 0; it < 12; ++it) {                 // 2^12 >= MAX_V
    const int imid = (ilo + ihi) / 2;
    float pref = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) pref += tid + i * NT <= imid ? p[i] : 0.f;
    const bool gt = bsum(pref) > target;
    ihi = gt ? imid : ihi;
    ilo = gt ? ilo : imid + 1;
  }
  return ihi;
}

// ---------------------------------------------------------------- the plan
// One weighted phase's matrix (layer l, or window l of the predictor's
// head): column c of half r (R = 2: gate, then up N columns further) at q
// + (r N + c) qcol bytes, its scales at s + (r N + c) scol bytes; `stride`
// its columns' spacing in the ring (weight_ring.cuh).
struct Mat {
  const unsigned char* q;
  const unsigned char* s;
  int N, K, R, qcol, scol, stride;
};

template <typename T>
__host__ __device__ __forceinline__ const unsigned char* bytes(const T* p) {
  return reinterpret_cast<const unsigned char*>(p);
}

__host__ __device__ __forceinline__ Mat mat_of(const Args& a, int kind,
                                                 int l) {
  const int pnqkv = (a.PH + 2 * a.PHkv) * PDH, pdq = a.PH * PDH;
  const int nqkv = (a.H + 2 * a.Hkv) * TDH, dq = a.H * TDH;
  Mat m;
  int ss = 4;                                  // bytes a scale
  const unsigned char *q = nullptr, *s = nullptr;
  switch (kind) {
    case K_PROJ:
      m.N = a.DP; m.K = a.D; m.R = 1;
      m.q = bytes(a.proj_w); m.s = nullptr;
      m.qcol = 4 * a.D; m.scol = 0; m.stride = m.qcol;
      return m;
    case K_PHEAD:
    case K_CHEAD: {
      const bool ph = kind == K_PHEAD;
      m.N = ph ? WINDOW : a.V; m.K = ph ? a.DP : a.D; m.R = 1;
      m.q = ph ? bytes(a.phead_q + (size_t)l * WINDOW * a.DP)
               : bytes(a.chead_q);
      m.s = ph ? bytes(a.phead_s + (size_t)l * WINDOW) : bytes(a.chead_s);
      m.qcol = m.K; m.scol = 4; m.stride = m.K + 64;
      return m;
    }
    case K_PQKV: m.N = pnqkv; m.K = a.DP; m.R = 1;
      q = a.p_wqkv_q; s = bytes(a.p_wqkv_s); break;
    case K_PWO: m.N = a.DP; m.K = pdq; m.R = 1;
      q = a.p_wo_q; s = bytes(a.p_wo_s); break;
    case K_PGU: m.N = a.PFF; m.K = a.DP; m.R = 2;
      q = a.p_gu_q; s = bytes(a.p_gu_s); break;
    case K_PDN: m.N = a.DP; m.K = a.PFF; m.R = 1;
      q = a.p_dn_q; s = bytes(a.p_dn_s); break;
    case K_TQKV: m.N = nqkv; m.K = a.D; m.R = 1;
      q = a.t_wqkv_q; s = bytes(a.t_wqkv_s); ss = 2; break;
    case K_TWO: m.N = a.D; m.K = dq; m.R = 1;
      q = a.t_wo_q; s = bytes(a.t_wo_s); ss = 2; break;
    case K_TGU: m.N = a.FF; m.K = a.D; m.R = 2;
      q = a.t_gu_q; s = bytes(a.t_gu_s); ss = 2; break;
    default: m.N = a.D; m.K = a.FF; m.R = 1;
      q = a.t_dn_q; s = bytes(a.t_dn_s); ss = 2; break;
  }
  m.qcol = m.K / 2;
  m.scol = (m.K / GROUP) * ss;
  m.stride = m.qcol + 64;
  const size_t cols = (size_t)l * m.R * m.N;   // the layer's first column
  m.q = q + cols * m.qcol;
  m.s = s + cols * m.scol;
  return m;
}

// Issue the block's share of phase `kind` (layer or window l) into the
// ring; every thread, after every thread has read the previous fill.
__device__ __noinline__ bool fill(const Args& a, unsigned char* ring,
                                  uint64_t* bar, int kind, int l) {
  const Mat m = mat_of(a, kind, l);
  int t0, t1;
  qtts::tile_range(m.N / 8, t0, t1);
  __syncthreads();
  return qtts::ring_fill(ring, bar, m.q, m.qcol, m.stride, m.s, m.scol, m.R,
                         (size_t)m.N, 8 * t0, 8 * (t1 - t0));
}

// The block's state: its shared memory, the ring's parity and whether a
// fill is in flight, the grid barrier's next target (registers: only the
// kernel's inline code holds it).
struct Blk {
  const Args& a;
  unsigned char* ring;
  unsigned char* region;
  Small& sm;
  uint32_t parity;
  bool armed;
  unsigned target;
  long long* marks;

  // Issue the block's share of phase `kind` (layer or window l) into the
  // ring, after every thread has read the previous fill.
  __device__ __forceinline__ void mark(int i) {
    if (marks != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
      marks[4 * (target / gridDim.x) + i] = clock64();
  }
  __device__ __forceinline__ void issue(int kind, int l) {
    mark(2);
    armed = fill(a, ring, &sm.bar, kind, l);
  }
  __device__ __forceinline__ void wait() {
    if (!armed) return;
    qtts::ring_wait(&sm.bar, parity);
    parity ^= 1u;
    armed = false;
    mark(0);
  }
  __device__ __forceinline__ void sync() {
    mark(3);
    qtts::grid_sync(a.barrier, target, a.trace);
  }
};

// ------------------------------------------------------------ row staging
// rintf(__fdiv_rn(x, s)) as int8 bits, from r = 1 / s: x * r is within ~2
// ulp of the quotient, so only near a half-integer (where the quotient's
// own rounding decides) the division runs, out of line (the staging loops
// stay small).
__device__ __noinline__ float quotient(float x, float s) {
  return __fdiv_rn(x, s);
}
__device__ __forceinline__ uint32_t quant8(float x, float s, float r) {
  float q = __fmul_rn(x, r);
  if (fabsf(q - rintf(q)) > 0.4995f) q = quotient(x, s);
  return (uint32_t)(uint8_t)(int8_t)rintf(q);
}

// A GEMV input: lane b's row at base + (row ? row[b] : b) * stride (bf16,
// written during the launch: ld.global.cg).  norm != nullptr: RMS-normed
// with those weights; else scaled by the lane's max |x| in amax.
struct In {
  const bf16* base;
  int stride;
  const int* row;
  const float* norm;
  const unsigned* amax;
};
static_assert(sizeof(Mat) <= sizeof(Small::mat) &&
                  sizeof(In) <= sizeof(Small::in),
              "Small holds a phase's Mat and In");

// Rows [r0, r0 + nr) normed, a warp per row: lane l holds chunks l + 32 i
// (8 values each) of the K <= MAX_D values, which are the values of
// quantize_rows' threads t = 8 l + e (k = t + 256 i), so the sum of
// squares runs in that order: each t's partial in i order, the butterfly of
// each 32 t (xor 16 and 8 across lanes, 4, 2, 1 within one), the eight
// sums in order; then h = bf16((x inv) w) and its max |h|.  OUT_I8: int8
// rows (lda bytes apart) with their scales in sm.sx; else bf16 rows and,
// with `hid`, the f32 (x inv) w of each row into hid.
template <int WARPS, bool OUT_I8>
__device__ __noinline__ void stage_norm(const In& in, int K, float eps,
                                        int r0, int nr, unsigned char* A,
                                        int lda, Small& sm, float* hid,
                                        int hid_stride) {
  constexpr int NC = MAX_D / 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nc = K / 256;
  for (int row = warp; row < nr; row += WARPS) {
    const int b = r0 + row;
    const bf16* x =
        in.base + (size_t)(in.row != nullptr ? in.row[b] : b) * in.stride;
    uint4 u[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (i < nc) u[i] = qtts::ld_16<true>(x + 8 * (lane + 32 * i));
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i >= nc) break;
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        p[2 * j] += f.x * f.x;
        p[2 * j + 1] += f.y * f.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] += __shfl_xor_sync(0xffffffffu, p[e], 2);
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] += __shfl_xor_sync(0xffffffffu, p[e], 1);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      float q[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) q[e] = p[e] + p[e ^ o];
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = q[e];
    }
    float ss = __shfl_sync(0xffffffffu, p[0], 0);
#pragma unroll
    for (int w = 1; w < 8; ++w) ss += __shfl_sync(0xffffffffu, p[0], 4 * w);
    const float inv = 1.0f / sqrtf(ss / (float)K + eps);
    // h = bf16((x inv) w), kept packed in u (the f32 value, unrounded, to
    // hid), and its max |h|
    float am = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i >= nc) break;
      const int k0 = 8 * (lane + 32 * i);
      const float4 w0 = *reinterpret_cast<const float4*>(in.norm + k0);
      const float4 w1 = *reinterpret_cast<const float4*>(in.norm + k0 + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u[i]);
      float hf[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        hf[2 * j] = __fmul_rn(__fmul_rn(f.x, inv), wv[2 * j]);
        hf[2 * j + 1] = __fmul_rn(__fmul_rn(f.y, inv), wv[2 * j + 1]);
        h2[j] = __floats2bfloat162_rn(hf[2 * j], hf[2 * j + 1]);
        const float2 r = __bfloat1622float2(h2[j]);
        am = fmaxf(am, fmaxf(fabsf(r.x), fabsf(r.y)));
      }
      if (!OUT_I8 && hid != nullptr) {
        float* o = hid + (size_t)b * hid_stride + k0;
        *reinterpret_cast<float4*>(o) = make_float4(hf[0], hf[1], hf[2], hf[3]);
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(hf[4], hf[5], hf[6], hf[7]);
      }
    }
    if (OUT_I8) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
      const float sx = __fmul_rn(fmaxf(am, 1e-8f), qtts::INV127);
      const float rs = __fdiv_rn(1.0f, sx);
      if (lane == 0) sm.sx[row] = sx;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (i >= nc) break;
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&u[i]);
        uint32_t w2[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 r = __bfloat1622float2(h2[j]);
          w2[j >> 1] |= (quant8(r.x, sx, rs) | quant8(r.y, sx, rs) << 8)
                        << (16 * (j & 1));
        }
        *reinterpret_cast<uint2*>(A + (size_t)row * lda +
                                  8 * (lane + 32 * i)) =
            make_uint2(w2[0], w2[1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (i >= nc) break;
        *reinterpret_cast<uint4*>(A + (size_t)row * lda +
                                  16 * (lane + 32 * i)) = u[i];
      }
    }
  }
  __syncthreads();
}

// Rows [r0, r0 + nr) of an unnormed input (ctx, ff), quantized as they are
// staged with sx = max(amax, 1e-8) * f32(1/127) (quantize_rows' numbers).
template <int WARPS>
__device__ __noinline__ void stage_amax(const In& in, int K, int r0, int nr,
                                        unsigned char* A, int lda,
                                        Small& sm) {
  constexpr int THREADS = WARPS * 32;
  const int tid = threadIdx.x;
  if (tid < nr)
    sm.sx[tid] = __fmul_rn(fmaxf(__uint_as_float(__ldcg(in.amax + r0 + tid)),
                                 1e-8f), qtts::INV127);
  __syncthreads();
  constexpr int UQ = 4;            // 16-byte loads of a thread in flight
  const int per = K / 8, total = nr * per;
  for (int i0 = tid; i0 < total; i0 += UQ * THREADS) {
    uint4 u[UQ];
#pragma unroll
    for (int q = 0; q < UQ; ++q) {
      const int i = i0 + q * THREADS;
      u[q] = i < total ? qtts::ld_16<true>(in.base + (size_t)(r0 + i / per) *
                                                         in.stride +
                                           8 * (i % per))
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < UQ; ++q) {
      const int i = i0 + q * THREADS;
      if (i >= total) break;
      const int row = i / per, c = i % per;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[q]);
      const float s = sm.sx[row], rs = __fdiv_rn(1.0f, s);
      uint32_t w2[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        w2[j >> 1] |= (quant8(f.x, s, rs) | quant8(f.y, s, rs) << 8)
                      << (16 * (j & 1));
      }
      *reinterpret_cast<uint2*>(A + (size_t)row * lda + 8 * c) =
          make_uint2(w2[0], w2[1]);
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------------ GEMVs
// The w4a8 tiles [t0, t1) of matrix m on the staged rows [r0, r0 + nr),
// the block's weights in the ring (tile t's column c of half r at ring + (r
// nc + 8 (t - t0) + c) stride, nc = 8 (t1 - t0)).  With fewer tiles than
// warps (MT = 1, `dots` given) each tile's K range is split over ks warps,
// each group's exact int32 dot kept in `dots`, and the tile's first warp
// adds them in the JAX order (the bits of the unsplit sum).  Epilogue:
// STORE out[b, n]; RESID out[b, n] += y (out: the residual, D wide);
// SWIGLU out[b, n] = silu(gate) up, and each warp's max |ff| of a staged
// row into sm.bv[warp][row].
template <int WARPS, int MT, int R, typename S>
__device__ __noinline__ void mma_tiles(const Mat& m, int epi, int t0, int t1,
                                       int r0, int nr,
                                       const unsigned char* A, int lda,
                                       int* dots, const unsigned char* ring,
                                       bf16* out, int out_stride, Small& sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int K = m.K, ng = K / GROUP;
  const int nt = t1 - t0, nc = 8 * nt;
  const int span = K / (2 * GROUP);
  const int ks = (MT == 1 && dots != nullptr) ? qtts::k_split(nt, WARPS, span)
                                              : 1;
  const int units = ks > 1 ? nt * ks : nt;
  const unsigned char* scales = ring + (size_t)R * nc * m.stride;
  float rmax[MT][2];               // SwiGLU: the thread's rows' max |ff|
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) rmax[mt][0] = rmax[mt][1] = 0.f;
  for (int u = warp; u < (ks > 1 ? WARPS : units); u += WARPS) {
    const bool live = u < units;
    const int lt = ks > 1 ? u / ks : u, part = ks > 1 ? u % ks : 0;
    const int n0 = 8 * (t0 + lt);
    const uint8_t* wcol[R];
    const S* scol[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wcol[r] = ring + ((size_t)r * nc + 8 * lt) * m.stride;
      scol[r] = reinterpret_cast<const S*>(scales + (size_t)r * nc * m.scol) +
                (size_t)8 * lt * ng;
    }
    float res[MT][4];
    if (epi == EPI_RESID && live && part == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + g + 8 * (e >> 1);
          res[mt][e] = row < nr ? ld_bf<true>(out + (size_t)(r0 + row) *
                                                        out_stride +
                                              n0 + 2 * t + (e & 1))
                                : 0.f;
        }
    }
    const int p0 = part * span / ks, p1 = (part + 1) * span / ks;
    int* tdots = ks > 1 ? dots + (size_t)lt * R * ng * 128 : nullptr;
    float y[R][MT][4];
    if (live)
      qtts::w4a8_cols<MT, R, S, true>(A, lda, nr, wcol, m.stride, scol, K, p0,
                                      p1, y, tdots);
    if (ks > 1) {
      __syncthreads();                  // every share of every tile
      if (!live || part != 0) continue;
      float acc1[R][1][4];
      qtts::w4a8_sum_dots_cols<R, S, true>(tdots, scol, K, acc1);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[r][0][e] = acc1[r][0][e];
    }
    if (!live) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + 8 * (e >> 1);
        if (row >= nr) continue;
        const float sx = sm.sx[row];
        float v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = bf16r(__fmul_rn(y[r][mt][e], sx));
        bf16* o = out + (size_t)(r0 + row) * out_stride + n0 + 2 * t + (e & 1);
        if (epi == EPI_STORE) {
          *o = __float2bfloat16_rn(v[0]);
        } else if (epi == EPI_RESID) {
          *o = __float2bfloat16_rn(__fadd_rn(res[mt][e], v[0]));
        } else {
          const float act = bf16r(__fdiv_rn(v[0], 1.0f + expf(-v[0])));
          const bf16 z = __float2bfloat16_rn(__fmul_rn(act, v[R - 1]));
          *o = z;
          rmax[mt][e >> 1] = fmaxf(rmax[mt][e >> 1], fabsf(bf2f(z)));
        }
      }
  }
  if (epi != EPI_SWIGLU) return;
  // a row's 4 lanes, then the warp's max into sm.bv[warp][row] (the
  // caller takes the warps' max after the block's barrier)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rmax[mt][h];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) sm.bv[warp][16 * mt + g + 8 * h] = v;
    }
}

// One w4a8 GEMV phase (matrix `kind`, layer l) for every lane: rows in
// passes of a.rows[kind] (staged normed or by amax), the ring waited for
// after the first pass's staging, the tiles, the epilogue; SWIGLU raises
// the lanes' max |ff| in amax_out.
template <int WARPS, int R, typename S>
__device__ __forceinline__ void gemv(Blk& k, int kind, int l, int epi,
                                  const In& in, float eps, bf16* out,
                                  int out_stride, unsigned* amax_out) {
  const Args& a = k.a;
  const Mat m = mat_of(a, kind, l);
  int t0, t1;
  qtts::tile_range(m.N / 8, t0, t1);
  if (t0 >= t1) return;
  const int lda = m.K + 16, rp = a.rows[kind];
  unsigned char* A = k.region;
  const size_t used = ((size_t)rp * lda + 15) / 16 * 16;
  const size_t need = (size_t)(t1 - t0) * R * (m.K / GROUP) * 128 * 4;
  int* dots = used + need <= (size_t)a.region_bytes
                  ? reinterpret_cast<int*>(A + used)
                  : nullptr;
  Mat& ms = *reinterpret_cast<Mat*>(k.sm.mat);
  In& ins = *reinterpret_cast<In*>(k.sm.in);
  if (threadIdx.x == 0) {
    ms = m;
    ins = in;
  }
  __syncthreads();
  for (int r0 = 0; r0 < a.B; r0 += rp) {
    const int nr = min(rp, a.B - r0);
    if (in.norm != nullptr)
      stage_norm<WARPS, true>(ins, m.K, eps, r0, nr, A, lda, k.sm, nullptr,
                              0);
    else
      stage_amax<WARPS>(ins, m.K, r0, nr, A, lda, k.sm);
    k.wait();
    if (nr > 16)
      mma_tiles<WARPS, 2, R, S>(ms, epi, t0, t1, r0, nr, A, lda, nullptr,
                                k.ring, out, out_stride, k.sm);
    else
      mma_tiles<WARPS, 1, R, S>(ms, epi, t0, t1, r0, nr, A, lda, dots,
                                k.ring, out, out_stride, k.sm);
    if (r0 == 0) k.mark(1);
    __syncthreads();                   // A is restaged by the next pass
    if (epi == EPI_SWIGLU && threadIdx.x < nr) {
      float v = k.sm.bv[0][threadIdx.x];
      for (int w = 1; w < WARPS; ++w) v = fmaxf(v, k.sm.bv[w][threadIdx.x]);
      atomicMax(amax_out + r0 + threadIdx.x, __float_as_uint(v));
    }
    if (epi == EPI_SWIGLU) __syncthreads();   // sm.bv: the next pass's
  }
}

// ------------------------------------------------------------------ heads
// The int8 head `kind` (window l of the predictor's, or the codec head) for
// every lane: the rows RMS-normed (norm, eps) and staged as bf16, the
// block's tiles on the tensor cores (one warp a tile, the whole K: no
// order that depends on the grid), logit = dot * row scale.  The codec
// head writes logits_out and (block 0) the f32 hidden; the predictor's
// writes its taps and each staged row's best (value, lowest index) over
// the block's columns into the best scratch (neutral where it has none).
template <int WARPS, int MT>
__device__ __noinline__ void head_tiles(const Args& a, const Mat& m, int kind,
                                        int f, int win, int t0, int t1,
                                        int r0, int nr,
                                        const unsigned char* A, int lda,
                                        const unsigned char* ring,
                                        Small& sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nc = 8 * (t1 - t0);
  const float* sc = reinterpret_cast<const float*>(ring + (size_t)nc * m.stride);
  float bv[MT][2];
  int bi[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bv[mt][h] = -INFINITY;
      bi[mt][h] = INT_MAX;
    }
  for (int tile = t0 + warp; tile < t1; tile += WARPS) {
    const int lc = 8 * (tile - t0);
    const int8_t* wcol[1] = {
        reinterpret_cast<const int8_t*>(ring + (size_t)lc * m.stride)};
    float acc[1][MT][4];
    qtts::i8bf_cols<MT, 1, true>(A, lda, nr, wcol, m.stride, 0, m.K / 64,
                                 acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + 8 * (e >> 1);
        if (row >= nr) continue;
        const int b = r0 + row, n = 8 * tile + 2 * t + (e & 1);
        const float v = __fmul_rn(acc[0][mt][e], sc[lc + 2 * t + (e & 1)]);
        if (kind == K_CHEAD) {
          a.logits_out[(size_t)b * a.V + n] = v;
          continue;
        }
        if (a.taps != nullptr)
          a.taps[(((size_t)b * a.F + f) * (N_TOKENS - 1) + win) * WINDOW + n] =
              v;
        if (better(v, n, bv[mt][e >> 1], bi[mt][e >> 1])) {
          bv[mt][e >> 1] = v;
          bi[mt][e >> 1] = n;
        }
      }
  }
  if (kind == K_CHEAD) return;
  // the rows' bests over the block's columns: a row's 4 lanes, the warps in
  // order
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = bv[mt][h];
      int i = bi[mt][h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i, o);
        if (better(ov, oi, v, i)) {
          v = ov;
          i = oi;
        }
      }
      if (t == 0 && 16 * mt + g + 8 * h < MAX_B) {
        sm.bv[warp][16 * mt + g + 8 * h] = v;
        sm.bi[warp][16 * mt + g + 8 * h] = i;
      }
    }
  __syncthreads();
  if (threadIdx.x < nr) {
    const int row = threadIdx.x;
    float v = sm.bv[0][row];
    int i = sm.bi[0][row];
    for (int w = 1; w < WARPS; ++w)
      if (better(sm.bv[w][row], sm.bi[w][row], v, i)) {
        v = sm.bv[w][row];
        i = sm.bi[w][row];
      }
    const size_t slot = (size_t)(r0 + row) * gridDim.x + blockIdx.x;
    a.best_v[slot] = v;
    a.best_i[slot] = i;
  }
}

template <int WARPS>
__device__ __forceinline__ void head(Blk& k, int kind, int f, int win) {
  const Args& a = k.a;
  const Mat m = mat_of(a, kind, win);
  int t0, t1;
  qtts::tile_range(m.N / 8, t0, t1);
  const bool codec = kind == K_CHEAD;
  Mat& ms = *reinterpret_cast<Mat*>(k.sm.mat);
  In& in = *reinterpret_cast<In*>(k.sm.in);
  if (threadIdx.x == 0) {
    ms = m;
    in = In{codec ? a.x : a.px, m.K, nullptr, codec ? a.tfn : a.pfn,
            nullptr};
  }
  __syncthreads();
  const float eps = codec ? a.t_eps : a.p_eps;
  const int lda = 2 * m.K + 16, rp = a.rows[kind];
  if (t0 >= t1) {
    // no columns here: the f32 hidden (block 0), a neutral best per lane
    if (codec && blockIdx.x == 0)
      for (int r0 = 0; r0 < a.B; r0 += rp)
        stage_norm<WARPS, false>(in, m.K, eps, r0, min(rp, a.B - r0),
                                 k.region, lda, k.sm, a.hidden_out, a.D);
    if (!codec)
      for (int b = threadIdx.x; b < a.B; b += WARPS * 32) {
        a.best_v[(size_t)b * gridDim.x + blockIdx.x] = -INFINITY;
        a.best_i[(size_t)b * gridDim.x + blockIdx.x] = INT_MAX;
      }
    return;
  }
  for (int r0 = 0; r0 < a.B; r0 += rp) {
    const int nr = min(rp, a.B - r0);
    stage_norm<WARPS, false>(in, m.K, eps, r0, nr, k.region, lda, k.sm,
                             codec && blockIdx.x == 0 ? a.hidden_out : nullptr,
                             a.D);
    k.wait();
    if (nr > 16)
      head_tiles<WARPS, 2>(a, ms, kind, f, win, t0, t1, r0, nr, k.region,
                           lda, k.ring, k.sm);
    else
      head_tiles<WARPS, 1>(a, ms, kind, f, win, t0, t1, r0, nr, k.region,
                           lda, k.ring, k.sm);
    __syncthreads();                   // the rows are restaged next pass
  }
}

// --------------------------------------------------------- sample, project
// Block b < B samples code_0 of lane b from the carried logits (its first
// 256 threads).
template <int WARPS>
__device__ __noinline__ void sample_lane(const Args& a, int f, Small& sm) {
  const int b = blockIdx.x;
  constexpr int BAR = WARPS * 32 == SAMPLER_THREADS ? 0 : 1;
  if (threadIdx.x >= SAMPLER_THREADS) return;
  const float* lg = f == 0 ? a.logits : a.logits_out;
  const int c0 = sample_block<true, BAR>(
      lg + (size_t)b * a.V, a.V, a.u[f * a.B + b], a.temperature, a.top_k,
      a.top_p, sm.red, sm.ired);
  if (threadIdx.x == 0) a.codes[((size_t)b * a.F + f) * N_TOKENS] = c0;
}

// x[i] for a lane's own i < 8, without indexing registers by a variable.
__device__ __forceinline__ float pick8(const float (&x)[8], int i) {
  float r = x[0];
#pragma unroll
  for (int c = 1; c < 8; ++c)
    if (c == i) r = x[c];
  return r;
}

// Columns [c0, c0 + nc) of px = bf16(hid . proj_w^T + proj_b) for every
// lane, the columns' f32 weights in the ring, a warp per lane holding the
// f32 row.
template <int WARPS>
__device__ __noinline__ void project(const Args& a, int f, int c0, int nc,
                                     const float* w0) {
  const float* hid = f == 0 ? a.hidden : a.hidden_out;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int NJ = MAX_D / 128;
  const int nj = a.D / 128;
  for (int b = warp; b < a.B; b += WARPS) {
    float4 h[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nj)
        h[j] = __ldcg(reinterpret_cast<const float4*>(
            hid + (size_t)b * a.D + 4 * lane + 128 * j));
    for (int cb = 0; cb < nc; cb += 8) {         // 8 columns' sums at once
      float acc[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= nj) break;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 wv = *reinterpret_cast<const float4*>(
              w0 + (size_t)(cb + c) * a.D + 4 * lane + 128 * j);
          acc[c] = fmaf(h[j].x, wv.x, acc[c]);
          acc[c] = fmaf(h[j].y, wv.y, acc[c]);
          acc[c] = fmaf(h[j].z, wv.z, acc[c]);
          acc[c] = fmaf(h[j].w, wv.w, acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
      }
      if (lane < 8)
        a.px[(size_t)b * a.DP + c0 + cb + lane] = __float2bfloat16_rn(
            __fadd_rn(pick8(acc, lane), a.proj_b[c0 + cb + lane]));
    }
  }
}

template <int WARPS>
__device__ __forceinline__ void sample_project(Blk& k, int f) {
  if ((int)blockIdx.x < k.a.B) sample_lane<WARPS>(k.a, f, k.sm);
  const Mat m = mat_of(k.a, K_PROJ, 0);
  int t0, t1;
  qtts::tile_range(m.N / 8, t0, t1);
  if (t0 >= t1) return;
  k.wait();
  project<WARPS>(k.a, f, 8 * t0, 8 * (t1 - t0),
                 reinterpret_cast<const float*>(k.ring));
}

// sm.code[b] = lane b's code from the head phase's per-block bests (value,
// lowest index), a warp per lane.
template <int WARPS>
__device__ __forceinline__ void lane_codes(const Args& a, Small& sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = warp; b < a.B; b += WARPS) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = lane; i < (int)gridDim.x; i += 32) {
      const float v = __ldcg(a.best_v + (size_t)b * gridDim.x + i);
      const int c = __ldcg(a.best_i + (size_t)b * gridDim.x + i);
      if (better(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) sm.code[b] = bi;
  }
  __syncthreads();
}

// The input rows of token tok >= 1, layer 0: ctab_pred[tok - 1][code] of
// every lane (code_0 from the sampler, later codes from the last window's
// argmax, which block 0 also writes out); block b % blocks copies lane b's
// row into px for the residual adds.
template <int WARPS>
__device__ __forceinline__ In token_rows(const Args& a, int f, int tok, Small& sm) {
  const int prev = tok - 1;
  if (prev == 0) {
    for (int b = threadIdx.x; b < a.B; b += WARPS * 32)
      sm.code[b] = __ldcg(a.codes + ((size_t)b * a.F + f) * N_TOKENS);
    __syncthreads();
  } else {
    lane_codes<WARPS>(a, sm);
  }
  for (int b = threadIdx.x; b < a.B; b += WARPS * 32) {
    const int c = sm.code[b];
    if (prev >= 1 && blockIdx.x == 0)
      a.codes[((size_t)b * a.F + f) * N_TOKENS + prev] = c;
    sm.row[b] = min(max(c, 0), a.R_pd - 1);
  }
  __syncthreads();
  const bf16* base = a.ctab_pred + (size_t)prev * a.R_pd * a.DP;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x)
    for (int i = threadIdx.x; i < a.DP / 8; i += WARPS * 32)
      reinterpret_cast<uint4*>(a.px + (size_t)b * a.DP)[i] =
          reinterpret_cast<const uint4*>(base + (size_t)sm.row[b] * a.DP)[i];
  return In{base, a.DP, sm.row, a.p_ln1, nullptr};
}

// ------------------------------------------------------------- attention
// The predictor's attention of token tok, layer l, lane b, kv head kvh on
// one warp, with `w` its shared scratch: the k/v rows of slots < tok are
// copied there in one batch (cp.async) while the warp computes the q/k
// RMSNorm and rope at position tok (lane holding dims lane, lane + 32) and
// writes slot tok; then scores (q . k by fma in dim order) * scale, one
// (head, slot) per lane; max, p = exp(s - max), their sum and P.V in slot
// order (by fma) per head.  The context goes to ctx in the c-major order of
// wo's input (q head kvh * G + c at position c * PHkv + kvh); returns the
// item's max |ctx|.
__device__ __forceinline__ float pred_attend(const Args& a, int tok, int l, int b, int kvh,
                             PredWarp& w) {
  constexpr int DL = PDH / 32;
  const int lane = threadIdx.x & 31;
  const int G = a.PH / a.PHkv;
  const int pnqkv = (a.PH + 2 * a.PHkv) * PDH, pdq = a.PH * PDH;
  const bf16* row = a.pqkv + (size_t)b * pnqkv;
  const float* cs = a.pcos + (size_t)tok * PDH;
  const float* sn = a.psin + (size_t)tok * PDH;
  const size_t head =
      (((size_t)b * a.LP + l) * a.PHkv + kvh) * N_TOKENS * PDH;
  bf16* kp = a.pk + head;
  bf16* vp = a.pv + head;
  for (int c = lane; c < tok * PDH / 8; c += 32) {
    const int j = c / (PDH / 8), o = 8 * (c % (PDH / 8));
    qtts::cp_async16(&w.k[j][o], kp + (size_t)j * PDH + o, 16);
    qtts::cp_async16(&w.v[j][o], vp + (size_t)j * PDH + o, 16);
  }
  qtts::cp_async_commit();
  // every head's row loaded first: q heads g < G, the k head, the v head
  float raw[CG + 2][DL];
#pragma unroll
  for (int h = 0; h < CG + 2; ++h) {
    const int col = h < G ? kvh * G + h
                  : h == CG ? a.PH + kvh
                  : h == CG + 1 ? a.PH + a.PHkv + kvh : -1;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      raw[h][i] = col >= 0 ? ld_bf<true>(row + (size_t)col * PDH + lane +
                                         32 * i)
                           : 0.f;
  }
  auto norm_rope = [&](const float (&x0)[DL], const float* nw,
                       float (&o)[DL]) {
    float x[DL];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      x[i] = x0[i];
      ss = __fadd_rn(ss, warp_sum(__fmul_rn(x[i], x[i])));
    }
    const float inv = 1.0f / sqrtf(ss / (float)PDH + a.p_eps);
#pragma unroll
    for (int i = 0; i < DL; ++i)
      x[i] = bf16r(__fmul_rn(__fmul_rn(x[i], inv), nw[lane + 32 * i]));
#pragma unroll
    for (int i = 0; i < DL; ++i) {      // dim d < PDH / 2 pairs with d + PDH / 2
      const int d = lane + 32 * i;
      const float rot = i < DL / 2 ? -x[i + DL / 2] : x[i - DL / 2];
      o[i] = bf16r(__fadd_rn(__fmul_rn(x[i], cs[d]), __fmul_rn(rot, sn[d])));
    }
  };
#pragma unroll
  for (int g = 0; g < CG; ++g) {
    if (g >= G) break;
    float q[DL];
    norm_rope(raw[g], a.p_qn + (size_t)l * PDH, q);
#pragma unroll
    for (int i = 0; i < DL; ++i) w.q[g][lane + 32 * i] = q[i];
  }
  float kr[DL];
  norm_rope(raw[CG], a.p_kn + (size_t)l * PDH, kr);
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = lane + 32 * i;
    const bf16 kb = __float2bfloat16_rn(kr[i]);
    const bf16 vb = __float2bfloat16_rn(raw[CG + 1][i]);
    kp[(size_t)tok * PDH + d] = kb;
    vp[(size_t)tok * PDH + d] = vb;
    w.k[tok][d] = kb;
    w.v[tok][d] = vb;
  }
  qtts::cp_async_wait<0>();
  __syncwarp();
  const int ns = tok + 1;
  for (int pi = lane; pi < G * ns; pi += 32) {
    const int g = pi / ns, j = pi % ns;
    const float* q = w.q[g];
    const bf16* krow = w.k[j];
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < PDH; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(krow + i);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f2 = __bfloat1622float2(h2[e]);
        d = fmaf(q[i + 2 * e], f2.x, d);
        d = fmaf(q[i + 2 * e + 1], f2.y, d);
      }
    }
    w.p[g][j] = __fmul_rn(d, a.p_scale);
  }
  __syncwarp();
  float amx = 0.f;
  for (int g = 0; g < G; ++g) {
    const float* sg = w.p[g];
    float mx = qtts::NEG;
    for (int j = 0; j < ns; ++j) mx = fmaxf(mx, sg[j]);
    float den = 0.f, acc[DL];
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] = 0.f;
    for (int j = 0; j < ns; ++j) {
      const float p = expf(sg[j] - mx);
      den += p;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        acc[i] = fmaf(p, bf2f(w.v[j][lane + 32 * i]), acc[i]);
    }
    den = fmaxf(den, 1e-30f);
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const bf16 c = __float2bfloat16_rn(acc[i] / den);
      a.ctx[(size_t)b * pdq + ((size_t)g * a.PHkv + kvh) * PDH + lane +
            32 * i] = c;
      amx = fmaxf(amx, fabsf(bf2f(c)));
    }
  }
  __syncwarp();                    // the scratch is rewritten by the next item
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amx = fmaxf(amx, __shfl_xor_sync(0xffffffffu, amx, o));
  return amx;
}

// After the predictor's qkv tiles [t0, t1) of token tok, layer l: the
// block counts its tiles per kv head (a.parrive); for each kv head whose
// last tile it wrote it runs that head's attention for every lane, a warp
// per (lane, head), raising each lane's max |ctx| in amax.
template <int WARPS>
__device__ __forceinline__ void pred_attn_tail(const Args& a, Small& sm,
                                            unsigned char* region, int tok,
                                            int l, int t0, int t1,
                                            unsigned* amax) {
  const int G = a.PH / a.PHkv, pdq = a.PH * PDH;
  __threadfence();                  // this block's qkv columns, then count
  __syncthreads();
  if (threadIdx.x == 0) {
    sm.n_last = 0;
    const int per_head = (G + 2) * PDH / 8;
    auto head_of = [&](int n) {
      return n < pdq ? n / PDH / G
             : n < pdq + a.PHkv * PDH ? (n - pdq) / PDH
                                      : (n - pdq - a.PHkv * PDH) / PDH;
    };
    int tile = t0;
    while (tile < t1) {
      const int kvh = head_of(8 * tile);
      int cnt = 0;
      while (tile < t1 && head_of(8 * tile) == kvh) {
        ++cnt;
        ++tile;
      }
      const unsigned old = atomicAdd(a.parrive + kvh, (unsigned)cnt);
      if (old + cnt == (unsigned)per_head) {
        a.parrive[kvh] = 0u;           // for the next phase
        sm.last[sm.n_last++] = kvh;
      }
    }
    __threadfence();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  PredWarp* pw = reinterpret_cast<PredWarp*>(region);
  for (int it = warp; it < sm.n_last * a.B; it += WARPS) {
    const int kvh = sm.last[it / a.B], b = it % a.B;
    const float amx = pred_attend(a, tok, l, b, kvh, pw[warp]);
    if ((threadIdx.x & 31) == 0) atomicMax(amax + b, __float_as_uint(amx));
  }
}

// The talker's q heads and k head of (lane b, kv head kvh) at frame f,
// layer l, on one warp (split_attn.cuh qk_warp).
__device__ __forceinline__ void talker_qk_warp(const Args& a, int b, int kvh, int f, int l,
                               TalkWarp& w) {
  qtts::qk_warp(a.qkv + (size_t)b * (a.H + 2 * a.Hkv) * TDH, a.H, a.Hkv, kvh,
                a.H / a.Hkv, a.t_qn + (size_t)l * TDH, a.t_kn + (size_t)l * TDH,
                a.cos + ((size_t)f * a.B + b) * TDH,
                a.sin + ((size_t)f * a.B + b) * TDH, a.t_eps, a.t_scale, w);
}

// Talker attention of frame f, layer l, split over the whole grid: items
// (lane b, kv head, split s of the cache prefix [0, start)), one warp
// each, items spread over the blocks first.  Per split: its scores
// (score_slots; slot c visible iff c < length or c >= prompt_cap), its
// max m, p = exp(s - m) (masked: 0 exactly), l = the 32 lanes' butterfly
// of p[lane] + p[lane + 32], acc = P.V in slot order by fma (lane: columns
// 4 lane .. 4 lane + 3).  With more than one split each writes (acc, m, l)
// to a.part; the warp that finishes last (a.arrive) combines them in split
// order: M = max m_s, acc = sum_s acc_s exp(m_s - M) by fma, l likewise.
// That warp then writes the frame's k/v row at slot start + f, merges the
// chunk's own slots start .. start + f (always visible) as one last
// online-softmax step (the JAX order), writes the context in head order and
// raises the lane's max |ctx| in amax.
template <int WARPS>
__device__ __forceinline__ void talker_attn(const Args& a, int f, int l, int start,
                            TalkWarp* tw, unsigned* amax) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  TalkWarp& w = tw[warp];
  const int G = a.H / a.Hkv;
  const int dq = a.H * TDH;
  const int end = min(start, a.C);             // the cache prefix
  const int ns = max(1, (end + SPLIT - 1) / SPLIT);
  const int nsmax = (a.C + SPLIT - 1) / SPLIT;
  const size_t n_heads = (size_t)a.B * a.Hkv * nsmax * CG;
  float* part_acc = a.part;
  float* part_ml = a.part + n_heads * TDH;
  const int n_items = a.B * a.Hkv * ns;
  for (int it = blockIdx.x + warp * gridDim.x; it < n_items;
       it += gridDim.x * WARPS) {
    const int s = it % ns, bh = it / ns;
    const int b = bh / a.Hkv, kvh = bh % a.Hkv;
    const int length = a.lengths[b];
    const size_t head = ((size_t)l * a.B + b) * a.Hkv + kvh;
    bf16* kp = a.cache_k + head * a.C * TDH;
    bf16* vp = a.cache_v + head * a.C * TDH;
    talker_qk_warp(a, b, kvh, f, l, w);
    // ---- split s: slots [c0, c0 + n)
    const int c0 = s * SPLIT;
    const int n = max(0, min(SPLIT, end - c0));
    const int pc = a.prompt_cap;
    score_slots(
        w, G, n, [&](int j) { return kp + (size_t)(c0 + j) * TDH; },
        [](int) { return false; },
        [&](int j) { return c0 + j < length || c0 + j >= pc; });
    float m[CG], ls[CG], acc[CG][4];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float sa = lane < n ? w.s[g][lane] : qtts::NEG;
      const float sb = lane + 32 < n ? w.s[g][lane + 32] : qtts::NEG;
      float mx = fmaxf(sa, sb);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float pa = sa > qtts::NEG ? expf(sa - mx) : 0.f;
      const float pb = sb > qtts::NEG ? expf(sb - mx) : 0.f;
      m[g] = mx;
      ls[g] = warp_sum(__fadd_rn(pa, pb));
      __syncwarp();
      if (g < G) {
        w.s[g][lane] = pa;
        w.s[g][lane + 32] = pb;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
    }
    __syncwarp();
    pv_slots(w, n, [&](int j) { return vp + (size_t)(c0 + j) * TDH; },
             [](int) { return false; }, acc);
    if (ns > 1) {
      // ---- this split's partials out; the last of the item's splits
      // combines them
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        if (g >= G) continue;
        const size_t r = ((size_t)bh * nsmax + s) * CG + g;
        *reinterpret_cast<float4*>(part_acc + r * TDH + 4 * lane) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        if (lane == 0) {
          part_ml[r * 2] = m[g];
          part_ml[r * 2 + 1] = ls[g];
        }
      }
      __threadfence();
      __syncwarp();
      unsigned old = 0;
      if (lane == 0) old = atomicAdd(a.arrive + bh, 1u);
      old = __shfl_sync(0xffffffffu, old, 0);
      if (old != (unsigned)ns - 1) continue;
      __threadfence();
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        if (g >= G) continue;
        const size_t r0 = (size_t)bh * nsmax * CG + g;
        float mm = qtts::NEG;
#pragma unroll 4
        for (int z = 0; z < ns; ++z)
          mm = fmaxf(mm, __ldcg(part_ml + (r0 + (size_t)z * CG) * 2));
        float l_ = 0.f, ac[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int z = 0; z < ns; ++z) {
          const size_t r = r0 + (size_t)z * CG;
          const float wz = expf(__ldcg(part_ml + r * 2) - mm);
          l_ = fmaf(__ldcg(part_ml + r * 2 + 1), wz, l_);
          const float4 pz = __ldcg(
              reinterpret_cast<const float4*>(part_acc + r * TDH + 4 * lane));
          ac[0] = fmaf(pz.x, wz, ac[0]);
          ac[1] = fmaf(pz.y, wz, ac[1]);
          ac[2] = fmaf(pz.z, wz, ac[2]);
          ac[3] = fmaf(pz.w, wz, ac[3]);
        }
        m[g] = mm;
        ls[g] = l_;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = ac[i];
      }
      if (lane == 0) a.arrive[bh] = 0u;          // for the next layer
    }
    // ---- the merging warp: slot start + f written once, then the chunk's
    // frames 0..f at slots start .. start + f as one merge
    const int slot = start + f;
    if (slot < a.C) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kp[(size_t)slot * TDH + lane + 32 * i] =
            __float2bfloat16_rn(w.k[lane + 32 * i]);
        vp[(size_t)slot * TDH + lane + 32 * i] =
            __float2bfloat16_rn(w.v[lane + 32 * i]);
      }
    }
    const int n_loc = min(f + 1, a.C - start);
    auto own = [&](int j) { return j == f; };
    score_slots(
        w, G, n_loc, [&](int j) { return kp + (size_t)(start + j) * TDH; },
        own, [](int) { return true; });
    // rescale the prefix by exp(m - mx), then p = exp(s - mx) of each own
    // slot into w.s for pv_slots
    float lsum[CG];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      float mx = m[g];
      for (int j = 0; j < n_loc; ++j) mx = fmaxf(mx, w.s[g][j]);
      const float alpha = expf(m[g] - mx);
      lsum[g] = __fmul_rn(ls[g], alpha);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = __fmul_rn(acc[g][i], alpha);
      __syncwarp();
      float pj = 0.f;
      for (int j = 0; j < n_loc; ++j) {
        const float p = expf(w.s[g][j] - mx);
        lsum[g] = __fadd_rn(lsum[g], p);
        if (lane == j) pj = p;
      }
      __syncwarp();
      if (lane < n_loc) w.s[g][lane] = pj;
    }
    __syncwarp();
    pv_slots(w, n_loc, [&](int j) { return vp + (size_t)(start + j) * TDH; },
             own, acc);
    float amx = 0.f;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (g >= G) continue;
      float* ac = acc[g];
      const float den = fmaxf(lsum[g], 1e-30f);
      __nv_bfloat162 o2[2];
      o2[0] = __floats2bfloat162_rn(ac[0] / den, ac[1] / den);
      o2[1] = __floats2bfloat162_rn(ac[2] / den, ac[3] / den);
      *reinterpret_cast<uint2*>(a.ctx + (size_t)b * dq +
                                ((size_t)kvh * G + g) * TDH + 4 * lane) =
          *reinterpret_cast<const uint2*>(o2);
      amx = fmaxf(amx, fmaxf(fmaxf(fabsf(__low2float(o2[0])),
                                   fabsf(__high2float(o2[0]))),
                             fmaxf(fabsf(__low2float(o2[1])),
                                   fabsf(__high2float(o2[1])))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amx = fmaxf(amx, __shfl_xor_sync(0xffffffffu, amx, o));
    if (lane == 0) atomicMax(amax + b, __float_as_uint(amx));
    __syncwarp();                  // w is rewritten by the warp's next item
  }
}

// ------------------------------------------------------- feedback, taps
// x[b] = bf16(sum_q ctab_fb[q][code_q] (f32, q in order) + tts_pad) for
// every lane; code_15 is the last window's argmax (block 0 writes it).
template <int WARPS>
__device__ __forceinline__ void feedback(const Args& a, int f, Small& sm) {
  lane_codes<WARPS>(a, sm);
  constexpr int THREADS = WARPS * 32;
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b < a.B; b += THREADS)
      a.codes[((size_t)b * a.F + f) * N_TOKENS + N_TOKENS - 1] = sm.code[b];
  const int n = a.B * a.D;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const int b = i / a.D, k = i % a.D;
    const int* cr = a.codes + ((size_t)b * a.F + f) * N_TOKENS;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < N_TOKENS; ++q) {
      const int c0 = q < N_TOKENS - 1 ? __ldcg(cr + q) : sm.code[b];
      const size_t j = ((size_t)q * a.R_fb + min(max(c0, 0), a.R_fb - 1)) *
                           a.D + k;
      s = __fadd_rn(s, a.fb_bf16 ? bf2f(static_cast<const bf16*>(a.ctab_fb)[j])
                                 : static_cast<const float*>(a.ctab_fb)[j]);
    }
    a.x[i] = __float2bfloat16_rn(__fadd_rn(s, a.tts_pad[k]));
  }
}

// xtaps[lane, f, slot] = x of every lane (the talker's residual entering
// layer `slot`, or the last layer's output at slot L), when asked for: x
// is only read in the phase that calls this.
template <int WARPS>
__device__ __forceinline__ void tap_x(const Args& a, int f, int slot) {
  if (a.xtaps == nullptr) return;
  constexpr int THREADS = WARPS * 32;
  const int n = a.B * a.D;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const int b = i / a.D, k = i % a.D;
    a.xtaps[(((size_t)b * a.F + f) * (a.L + 1) + slot) * a.D + k] =
        __float2bfloat16_rn(ld_bf<true>(a.x + i));
  }
}

// The max |x| slots of the unnormed GEMV inputs: the predictor's context
// and ff of (frame, token, layer), the talker's of (frame, layer).
__device__ __forceinline__ unsigned* amax_p(const Args& a, int f, int tok,
                                            int l, int which) {
  return a.amax + ((size_t)((f * N_TOKENS + tok) * a.LP + l) * 2 + which) *
                      a.B;
}
__device__ __forceinline__ unsigned* amax_t(const Args& a, int f, int l,
                                            int which) {
  return a.amax + ((size_t)a.F * N_TOKENS * a.LP * 2 +
                   (size_t)(f * a.L + l) * 2 + which) * a.B;
}

// ------------------------------------------------------------------ kernel
template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
    chunk_kernel(const Args args) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int THREADS = WARPS * 32;
  Small& sm =
      *reinterpret_cast<Small*>(smem + args.ring_bytes + args.region_bytes);
  if (args.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    args.trace[0] = clock64();
  if (threadIdx.x == 0) {
    sm.args = args;
    qtts::ring_init(&sm.bar);
  }
  __syncthreads();
  // The phases inlined here read the parameter itself (the constant bank);
  // the out-of-line bodies (the GEMVs' staging and tiles, the heads' tiles,
  // the sampler, the projection, the ring fill: one copy each, so the
  // frame's code stays small) get the shared copy, since handing them the
  // parameter's address would put a copy of it in every thread's local
  // memory.
  const Args& a = args;
  Blk k{sm.args, smem, smem + a.ring_bytes, sm, 0u, false, 0u, a.marks};
  {  // the max |x| slots, first raised after the first barrier
    const size_t n = (size_t)a.F * (2 * N_TOKENS * a.LP + 2 * a.L) * a.B;
    for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += (size_t)gridDim.x * THREADS)
      a.amax[i] = 0u;
  }
  const int start = a.write_idx[0];
  const int pdq = a.PH * PDH, dq = a.H * TDH;
  const int pnqkv = (a.PH + 2 * a.PHkv) * PDH, nqkv = (a.H + 2 * a.Hkv) * TDH;
  k.issue(K_PROJ, 0);

  for (int f = 0; f < a.F; ++f) {
    sample_project<WARPS>(k, f);
    k.issue(K_PQKV, 0);
    k.sync();

    // ---- predictor: 16 tokens x LP layers
    for (int tok = 0; tok < N_TOKENS; ++tok) {
      for (int l = 0; l < a.LP; ++l) {
        In in{a.px, a.DP, nullptr, a.p_ln1 + (size_t)l * a.DP, nullptr};
        if (l == 0 && tok >= 1) in = token_rows<WARPS>(a, f, tok, sm);
        gemv<WARPS, 1, float>(k, K_PQKV, l, EPI_STORE, in, a.p_eps, a.pqkv,
                              pnqkv, nullptr);
        k.issue(K_PWO, l);
        {
          int t0, t1;
          qtts::tile_range(pnqkv / 8, t0, t1);
          pred_attn_tail<WARPS>(a, sm, k.region, tok, l, t0, t1,
                                amax_p(a, f, tok, l, 0));
        }
        k.sync();
        gemv<WARPS, 1, float>(
            k, K_PWO, l, EPI_RESID,
            In{a.ctx, pdq, nullptr, nullptr, amax_p(a, f, tok, l, 0)},
            a.p_eps, a.px, a.DP, nullptr);
        k.issue(K_PGU, l);
        k.sync();
        gemv<WARPS, 2, float>(
            k, K_PGU, l, EPI_SWIGLU,
            In{a.px, a.DP, nullptr, a.p_ln2 + (size_t)l * a.DP, nullptr},
            a.p_eps, a.pff, a.PFF, amax_p(a, f, tok, l, 1));
        k.issue(K_PDN, l);
        k.sync();
        gemv<WARPS, 1, float>(
            k, K_PDN, l, EPI_RESID,
            In{a.pff, a.PFF, nullptr, nullptr, amax_p(a, f, tok, l, 1)},
            a.p_eps, a.px, a.DP, nullptr);
        if (l + 1 < a.LP)
          k.issue(K_PQKV, l + 1);
        else if (tok >= 1)
          k.issue(K_PHEAD, tok - 1);
        else
          k.issue(K_PQKV, 0);
        k.sync();
      }
      if (tok >= 1) {
        head<WARPS>(k, K_PHEAD, f, tok - 1);
        k.issue(tok + 1 < N_TOKENS ? K_PQKV : K_TQKV, 0);
        k.sync();
      }
    }

    // ---- feedback (code_15 is the last window's argmax)
    feedback<WARPS>(a, f, sm);
    k.sync();

    // ---- talker step
    for (int l = 0; l < a.L; ++l) {
      tap_x<WARPS>(a, f, l);
      gemv<WARPS, 1, bf16>(
          k, K_TQKV, l, EPI_STORE,
          In{a.x, a.D, nullptr, a.t_ln1 + (size_t)l * a.D, nullptr}, a.t_eps,
          a.qkv, nqkv, nullptr);
      k.issue(K_TWO, l);
      k.sync();
      talker_attn<WARPS>(a, f, l, start,
                         reinterpret_cast<TalkWarp*>(k.region),
                         amax_t(a, f, l, 0));
      k.sync();
      gemv<WARPS, 1, bf16>(
          k, K_TWO, l, EPI_RESID,
          In{a.ctx, dq, nullptr, nullptr, amax_t(a, f, l, 0)}, a.t_eps, a.x,
          a.D, nullptr);
      k.issue(K_TGU, l);
      k.sync();
      gemv<WARPS, 2, bf16>(
          k, K_TGU, l, EPI_SWIGLU,
          In{a.x, a.D, nullptr, a.t_ln2 + (size_t)l * a.D, nullptr}, a.t_eps,
          a.ff, a.FF, amax_t(a, f, l, 1));
      k.issue(K_TDN, l);
      k.sync();
      gemv<WARPS, 1, bf16>(
          k, K_TDN, l, EPI_RESID,
          In{a.ff, a.FF, nullptr, nullptr, amax_t(a, f, l, 1)}, a.t_eps, a.x,
          a.D, nullptr);
      k.issue(l + 1 < a.L ? K_TQKV : K_CHEAD, l + 1 < a.L ? l + 1 : 0);
      k.sync();
    }
    tap_x<WARPS>(a, f, a.L);
    head<WARPS>(k, K_CHEAD, f, 0);
    if (f + 1 < a.F) k.issue(K_PROJ, 0);
    k.sync();
  }
  qtts::grid_exit(a.barrier);
}

// One block per row: the sampler alone (sample_block), for the tests.
__global__ void __launch_bounds__(SAMPLER_THREADS)
sample_kernel(const float* __restrict__ logits, const float* __restrict__ u,
              int* __restrict__ out, int V, float temp, float top_k,
              float top_p) {
  __shared__ float red[SAMPLER_THREADS / 32];
  __shared__ int ired[SAMPLER_THREADS / 32];
  const int c = sample_block<false, 0>(logits + (size_t)blockIdx.x * V, V,
                                       u[blockIdx.x], temp, top_k, top_p, red,
                                       ired);
  if (threadIdx.x == 0) out[blockIdx.x] = c;
}

template <int WARPS>
cudaError_t launch(const Args& a, size_t smem, int* info, cudaStream_t st) {
  auto kernel = chunk_kernel<WARPS>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  e = qtts::allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      WARPS * 32, smem);
  if (e != cudaSuccess) return e;
  // the plan's grid must be resident at once (every lane needs a block for
  // its sampler); the argmax scratch holds `slots` blocks
  if (a.blocks > per_sm * sms || a.blocks > a.slots || a.blocks < a.B)
    return cudaErrorCooperativeLaunchTooLarge;
  info[0] = a.blocks;
  info[1] = a.warps;
  void* params[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(a.blocks),
                                  dim3(WARPS * 32), params, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// ptrs / ints / flts in the order of kernels/chunk_step.gen_chunk_fused;
// info (host) gets the grid: blocks, blocks per SM.
extern "C" int qtts_chunk_step(void* const* ptrs, int n_ptrs,
                               const int* ints, int n_ints,
                               const float* flts, int n_flts, int* info,
                               void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS || n_flts != N_FLTS)
    return (int)cudaErrorInvalidValue;
  Args a;
  int i = 0;
  auto P = [&]() { return ptrs[i++]; };
  a.logits = (const float*)P(); a.hidden = (const float*)P();
  a.cos = (const float*)P(); a.sin = (const float*)P();
  a.u = (const float*)P(); a.lengths = (const int*)P();
  a.write_idx = (const int*)P();
  a.t_ln1 = (const float*)P(); a.t_ln2 = (const float*)P();
  a.t_qn = (const float*)P(); a.t_kn = (const float*)P();
  a.t_wqkv_q = (const uint8_t*)P(); a.t_wqkv_s = (const bf16*)P();
  a.t_wo_q = (const uint8_t*)P(); a.t_wo_s = (const bf16*)P();
  a.t_gu_q = (const uint8_t*)P(); a.t_gu_s = (const bf16*)P();
  a.t_dn_q = (const uint8_t*)P(); a.t_dn_s = (const bf16*)P();
  a.cache_k = (bf16*)P(); a.cache_v = (bf16*)P();
  a.tfn = (const float*)P(); a.chead_q = (const int8_t*)P();
  a.chead_s = (const float*)P(); a.proj_w = (const float*)P();
  a.proj_b = (const float*)P(); a.tts_pad = (const float*)P();
  a.ctab_fb = P(); a.ctab_pred = (const bf16*)P();
  a.pfn = (const float*)P(); a.phead_q = (const int8_t*)P();
  a.phead_s = (const float*)P(); a.pcos = (const float*)P();
  a.psin = (const float*)P();
  a.p_ln1 = (const float*)P(); a.p_ln2 = (const float*)P();
  a.p_qn = (const float*)P(); a.p_kn = (const float*)P();
  a.p_wqkv_q = (const uint8_t*)P(); a.p_wqkv_s = (const float*)P();
  a.p_wo_q = (const uint8_t*)P(); a.p_wo_s = (const float*)P();
  a.p_gu_q = (const uint8_t*)P(); a.p_gu_s = (const float*)P();
  a.p_dn_q = (const uint8_t*)P(); a.p_dn_s = (const float*)P();
  a.codes = (int*)P(); a.logits_out = (float*)P();
  a.hidden_out = (float*)P(); a.taps = (float*)P();
  a.xtaps = (bf16*)P();
  a.x = (bf16*)P(); a.qkv = (bf16*)P(); a.ctx = (bf16*)P();
  a.ff = (bf16*)P(); a.px = (bf16*)P(); a.pqkv = (bf16*)P();
  a.pff = (bf16*)P(); a.pk = (bf16*)P(); a.pv = (bf16*)P();
  a.part = (float*)P(); a.arrive = (unsigned*)P();
  a.amax = (unsigned*)P(); a.parrive = (unsigned*)P();
  a.best_v = (float*)P(); a.best_i = (int*)P();
  a.barrier = (unsigned*)P(); a.trace = (long long*)P();
  a.marks = (long long*)P();
  int j = 0;
  a.F = ints[j++]; a.L = ints[j++]; a.D = ints[j++]; a.H = ints[j++];
  a.Hkv = ints[j++]; a.t_dh = ints[j++]; a.FF = ints[j++]; a.C = ints[j++];
  a.prompt_cap = ints[j++]; a.LP = ints[j++]; a.DP = ints[j++];
  a.PH = ints[j++]; a.PHkv = ints[j++]; a.p_dh = ints[j++];
  a.PFF = ints[j++]; a.R_fb = ints[j++]; a.R_pd = ints[j++];
  a.V = ints[j++]; a.fb_bf16 = ints[j++]; a.slots = ints[j++];
  a.B = ints[j++];
  a.blocks = ints[j++]; a.warps = ints[j++]; a.ring_bytes = ints[j++];
  a.region_bytes = ints[j++];
  for (int k = 0; k < N_KINDS; ++k) a.rows[k] = ints[j++];
  a.t_eps = flts[0]; a.p_eps = flts[1]; a.temperature = flts[2];
  a.top_k = flts[3]; a.top_p = flts[4]; a.t_scale = flts[5];
  a.p_scale = flts[6];

  const int g2 = 2 * GROUP;
  // the JAX gate: 1 lane, 8 or 16 at F <= 8, 24 or 32 at F <= 4
  const bool batch_ok =
      a.B == 1 || (a.B % 8 == 0 && a.B <= MAX_B && (a.B <= 16 || a.F <= 4));
  bool ok =
      batch_ok && a.F >= 1 && a.F <= MAX_FRAMES && a.L >= 1 && a.LP >= 1 &&
      a.t_dh == TDH && a.p_dh == PDH && a.Hkv > 0 && a.H % a.Hkv == 0 &&
      a.H / a.Hkv <= CG && a.PHkv > 0 && a.PHkv <= MAX_PKV &&
      a.PH % a.PHkv == 0 && a.PH / a.PHkv <= CG && a.D % g2 == 0 &&
      a.D <= MAX_D && a.DP % g2 == 0 && a.DP <= MAX_D && a.FF % g2 == 0 &&
      a.FF <= MAX_K && a.PFF % g2 == 0 && a.PFF <= MAX_K &&
      (a.H * TDH) % g2 == 0 && a.H * TDH <= MAX_K && (a.PH * PDH) % g2 == 0 &&
      a.PH * PDH <= MAX_K && a.C > 0 && a.V > 0 && a.V <= MAX_V &&
      a.V % 8 == 0 && a.R_fb > 0 && a.R_pd > 0 && a.slots >= 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B == 1) {
    // one lane (namespace one): the predictor attention's scratch after
    // the staged row; the plan's entries are not read
    ok = ok && 4 * one::pred_attn_floats(a.PHkv) <=
                   (size_t)2 * (MAX_K - a.PH * PDH);
    return ok ? (int)one::launch(a, info, st) : (int)cudaErrorInvalidValue;
  }
  ok = ok && a.blocks >= a.B && (a.warps == 8 || a.warps == 16) &&
       a.ring_bytes > 0 && a.ring_bytes % 16 == 0 &&
       a.region_bytes % 16 == 0 &&
       a.region_bytes >= a.warps * (int)std::max(sizeof(TalkWarp),
                                                 sizeof(PredWarp));
  // The plan (kernels/chunk_step.plan) against this kernel's own layout:
  // each phase's largest block share (tile_range) of columns at their ring
  // spacing with their scales (mat_of, weight_ring.cuh) within the ring,
  // and a pass's staged rows (gemv: K + 16 bytes a row; head: 2 K + 16)
  // within the row region.  A plan short anywhere is refused: the copies
  // and the staging would run past their region.
  for (int k = 0; ok && k < N_KINDS; ++k) {
    const Mat m = mat_of(a, k, 0);
    const long long nc = 8LL * ((m.N / 8 + a.blocks - 1) / a.blocks);
    ok = m.N % 8 == 0 &&
         (long long)m.R * nc * (m.stride + m.scol) <= a.ring_bytes;
    if (k == K_PROJ) continue;         // its rows stay in registers
    const bool head = k == K_PHEAD || k == K_CHEAD;
    const long long lda = head ? 2LL * m.K + 16 : m.K + 16;
    ok = ok && a.rows[k] >= 1 && a.rows[k] <= MAX_B &&
         (a.rows[k] >= a.B || a.rows[k] % 8 == 0) &&
         a.rows[k] * lda <= a.region_bytes;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.ring_bytes + a.region_bytes + SMALL_BYTES;
  const cudaError_t e = a.warps == 16 ? launch<16>(a, smem, info, st)
                                      : launch<8>(a, smem, info, st);
  return (int)e;
}

extern "C" int qtts_sample_threshold(const float* logits, const float* u,
                                     int* out, int B, int V, float temp,
                                     float top_k, float top_p,
                                     void* stream) {
  if (B < 1 || V < 1 || V > MAX_V) return (int)cudaErrorInvalidValue;
  sample_kernel<<<B, SAMPLER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, u, out, V, temp, top_k, top_p);
  return (int)cudaGetLastError();
}
