// The GEMV core of the persistent kernels (talker_step.cu,
// predictor_frame.cu, chunk_step.cu): a grid barrier, and one warp's n8
// output tile on the tensor cores (mma.sync) for up to 32 batch rows staged
// in shared memory, its weights read from device memory or (SH, chunk_step.cu's
// weight ring) from shared memory.
//
// Layout.  Weights are output-major (output column n's K values
// contiguous), so a block that owns the output tiles [t0, t1) of a phase
// reads one contiguous byte range per matrix.  A warp owns n8 tiles (8
// output columns; with R = 2 also the 8 columns N further on: the SwiGLU
// gate and up pair) and computes them for MT m16 row tiles of the staged
// rows at once, so every lane of the batch shares one read of each weight
// byte; a tile's K range can be split over warps (k_split).
//
// The mma operand permutation.  In mma.m16n8k32 (s8) thread (g = lane / 4,
// t = lane % 4) holds A rows g, g + 8 and B column g at the logical k
// 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3 of each 32-deep step (m16n8k16
// bf16: 2t, 2t + 1 and 8 + 2t, 8 + 2t + 1).  A dot product sums over k in
// any order, so each thread's logical k may stand for any physical k as
// long as A and B use the same map.  Here thread t takes one 16-byte run
// of its column's weights per k block and the same run of each row's
// activations: the int4 weights' packed words (ops/quant.py pack_int4:
// word m holds k 8m .. 8m + 3 in its low nibbles and 8m + 4 .. 8m + 7 in
// its high ones) go to the B registers unpacked in place, and A needs no
// shuffle either.  The products are exact integers (s8) or exact in f32
// (bf16 x int8), so the only order that matters is the one the callers
// keep: the w4a8 group sums in f32 in the JAX order (group i, then group
// nb + i), each group's int32 dot exact.
#pragma once

#include "cp_async.cuh"
#include "w4a8.cuh"

namespace qtts {

constexpr long long GRID_TIMEOUT = 1LL << 34;   // SM cycles, ~8 s

// Grid barrier of a cooperative launch (chunk_step.cu's design): bar[0]
// counts arrivals, barrier n completes when it reaches n * gridDim.x
// (release / acquire at GPU scope); a block that waits ~8 s traps rather
// than hang the card.
// With `trace`, block 0 stores its SM clock as it leaves barrier n into
// trace[n].
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target,
                                          long long* trace = nullptr) {
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
      if (clock64() - t0 > GRID_TIMEOUT) __trap();
    } while (v < target);
    if (trace != nullptr && blockIdx.x == 0)
      trace[target / gridDim.x] = clock64();
  }
  __syncthreads();
}

// After the last barrier: the last block to check out on bar[1] sets both
// words back to 0 for the next launch.
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

// The block's share [t0, t1) of nt tiles: contiguous, as even as can be.
__device__ __forceinline__ void tile_range(int nt, int& t0, int& t1) {
  t0 = (int)((long long)blockIdx.x * nt / gridDim.x);
  t1 = (int)((long long)(blockIdx.x + 1) * nt / gridDim.x);
}

// Warps per tile (a power of two) when a block's nt tiles leave warps of
// its `warps` idle: each takes a share of the tile's K range.
__device__ __forceinline__ int k_split(int nt, int warps, int max_split) {
  int ks = 1;
  while (2 * ks * nt <= warps && 2 * ks <= max_split) ks *= 2;
  return ks;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ld_w(const void* p) {   // weights: read-only
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The tile functions' weight and scale loads: read-only device memory, or
// (SH) shared memory, where chunk_step.cu stages a block's weights
// (weight_ring.cuh).
template <bool SH>
__device__ __forceinline__ uint4 ld_wv(const void* p) {
  if constexpr (SH) return *reinterpret_cast<const uint4*>(p);
  return ld_w(p);
}
template <bool SH, typename S>
__device__ __forceinline__ float ld_scale(const S* p) {
  if constexpr (SH) return scale_f32(*p);
  return scale_f32(__ldg(p));
}

// Staged rows: row r of the tile's m16 tile mt, 32 bytes at byte offset
// `off` (zeros past nrows).
__device__ __forceinline__ void ld_rows(const unsigned char* A, int lda,
                                        int nrows, int row, int off,
                                        uint4& lo, uint4& hi) {
  if (row < nrows) {
    const uint4* p = reinterpret_cast<const uint4*>(A + (size_t)row * lda + off);
    lo = p[0];
    hi = p[1];
  } else {
    lo = hi = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// ---------------------------------------------------------------- w4a8
// acc[r][mt][e] for the tile's column n0 + r N + 2t + (e & 1) and row
// 16 mt + g + 8 (e >> 1): sum over groups in the JAX order of
// f32(int32 group dot) * scale (w4a8.cuh w4a8_warp_row's arithmetic,
// without its final * sx), over the group pairs (i, nb + i), i in [i0, i1).
// With `dots`, the int32 dots go there instead ([R][ng][4][32]: one
// int per (r, group, e, lane)) and acc is not touched; w4a8_sum_dots then
// adds them in the same order, so a tile split over warps by pair range
// gives the same bits.  A: int8 rows, stride lda bytes (lda % 128 == 16:
// conflict-free); wq uint8 [*, K / 2]; ws [*, K / 128] (bf16 or f32).
// D group pairs' weight loads stay in flight (a rotation of registers).
// w4a8_cols is the same product with the tile's columns given by address:
// column n0 + c of half r at wcol[r] + c * wstride bytes, its scales at
// scol[r] + c * ng; SH: both in shared memory.
template <int MT, int R, typename S, bool SH = false>
__device__ __forceinline__ void w4a8_cols(const unsigned char* A, int lda,
                                          int nrows,
                                          const uint8_t* const (&wcol)[R],
                                          int wstride,
                                          const S* const (&scol)[R], int K,
                                          int i0, int i1,
                                          float (&acc)[R][MT][4],
                                          int* dots = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ng = K / W4_GROUP, nb = ng / 2;
  if (dots == nullptr) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][mt][e] = 0.f;
  }
  const uint8_t* wc[R];
  const S* sc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wc[r] = wcol[r] + (size_t)g * wstride + 16 * t;
    sc[r] = scol[r] + (size_t)(2 * t) * ng;
  }
  // a pair's weights and (without dots) its scales of columns 2t, 2t + 1
  auto load = [&](uint4 (&w)[R][2], float (&sv)[R][2][2], int i) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool in = i < i1;
        w[r][h] = in ? ld_wv<SH>(wc[r] + (size_t)(i + h * nb) * 64)
                     : make_uint4(0u, 0u, 0u, 0u);
        if (dots == nullptr) {
          sv[r][h][0] = in ? ld_scale<SH>(sc[r] + i + h * nb) : 0.f;
          sv[r][h][1] = in ? ld_scale<SH>(sc[r] + ng + i + h * nb) : 0.f;
        }
      }
  };
  // pairs of loads in flight (one from shared memory: its latency is short)
  constexpr int D = SH ? 1 : R == 1 ? 4 : 2;
  uint4 wr[D][R][2];
  float sr[D][R][2][2];
#pragma unroll
  for (int q = 0; q < D; ++q) load(wr[q], sr[q], i0 + q);
  for (int ib = i0; ib < i1; ib += D)
#pragma unroll
  for (int q = 0; q < D; ++q) {
    const int i = ib + q;
    if (i >= i1) break;
    uint4 (&wcur)[R][2] = wr[q];
    float (&scur)[R][2][2] = sr[q];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = i + h * nb;
      int d[R][MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint4 x0, x1, y0, y1;               // rows g and g + 8, 32 bytes each
        ld_rows(A, lda, nrows, 16 * mt + g, gi * W4_GROUP + 32 * t, x0, x1);
        ld_rows(A, lda, nrows, 16 * mt + g + 8, gi * W4_GROUP + 32 * t, y0,
                y1);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[r][mt][e] = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // bytes 8c .. 8c + 7 of the thread's 32: k 8(4t + c) + 0..7
          const uint4& xr = c < 2 ? x0 : x1;
          const uint4& yr = c < 2 ? y0 : y1;
          const uint32_t a[4] = {word(xr, 2 * (c & 1)), word(yr, 2 * (c & 1)),
                                 word(xr, 2 * (c & 1) + 1),
                                 word(yr, 2 * (c & 1) + 1)};
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const uint32_t wv = word(wcur[r][h], c);
            mma_s8(d[r][mt], a, (uint32_t)sext4(wv & 0x0F0F0F0Fu),
                   (uint32_t)sext4((wv >> 4) & 0x0F0F0F0Fu));
          }
        }
      }
      if (dots != nullptr) {               // MT == 1 here
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dots[((r * ng + gi) * 4 + e) * 32 + lane] = d[r][0][e];
        continue;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float s0 = scur[r][h][0], s1 = scur[r][h][1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][mt][e] = __fadd_rn(
                acc[r][mt][e],
                __fmul_rn((float)d[r][mt][e], (e & 1) ? s1 : s0));
      }
    }
    load(wcur, scur, i + D);
  }
}

template <int MT, int R, typename S>
__device__ __forceinline__ void w4a8_tile(const unsigned char* A, int lda,
                                          int nrows, const uint8_t* wq,
                                          const S* ws, int N, int K, int n0,
                                          int i0, int i1,
                                          float (&acc)[R][MT][4],
                                          int* dots = nullptr) {
  const int ng = K / W4_GROUP;
  const uint8_t* wcol[R];
  const S* scol[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wcol[r] = wq + (size_t)(n0 + r * N) * (K / 2);
    scol[r] = ws + (size_t)(n0 + r * N) * ng;
  }
  w4a8_cols<MT, R, S, false>(A, lda, nrows, wcol, K / 2, scol, K, i0, i1,
                             acc, dots);
}

// w4a8_tile's f32 group sum (MT = 1) from the int32 dots its K-split
// warps left in `dots`, in the JAX order; the scales of column n0 of half r
// at scol[r] (SH: in shared memory).
template <int R, typename S, bool SH = false>
__device__ __forceinline__ void w4a8_sum_dots_cols(
    const int* dots, const S* const (&scol)[R], int K, float (&acc)[R][1][4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int ng = K / W4_GROUP, nb = ng / 2;
  constexpr int U = 8;                     // pairs whose scales load at once
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const S* sc = scol[r] + (size_t)(2 * t) * ng;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][0][e] = 0.f;
    for (int i0 = 0; i0 < nb; i0 += U) {
      float sv[U][2][2];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool in = i0 + u < nb;
          sv[u][h][0] = in ? ld_scale<SH>(sc + i0 + u + h * nb) : 0.f;
          sv[u][h][1] = in ? ld_scale<SH>(sc + ng + i0 + u + h * nb) : 0.f;
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u >= nb) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gi = i0 + u + h * nb;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][0][e] = __fadd_rn(
                acc[r][0][e],
                __fmul_rn((float)dots[((r * ng + gi) * 4 + e) * 32 + lane],
                          sv[u][h][e & 1]));
        }
      }
    }
  }
}

template <int R, typename S>
__device__ __forceinline__ void w4a8_sum_dots(const int* dots, const S* ws,
                                              int N, int K, int n0,
                                              float (&acc)[R][1][4]) {
  const S* scol[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    scol[r] = ws + (size_t)(n0 + r * N) * (K / W4_GROUP);
  w4a8_sum_dots_cols<R, S, false>(dots, scol, K, acc);
}

// ---------------------------------------------------------------- w8a8
// acc[r][mt][e]: the exact int32 dot of int8 rows (stride lda, lda % 128
// == 64) with int8 weights wq [*, K] over the 64-deep blocks [k0, k1) of
// K, same (row, column) map as w4a8_tile (integer partial dots of a K
// split add up exactly in any order).  D blocks' weight loads stay in
// flight.
template <int MT, int R>
__device__ __forceinline__ void w8a8_tile(const unsigned char* A, int lda,
                                          int nrows, const int8_t* wq, int N,
                                          int K, int n0, int k0, int k1,
                                          int (&acc)[R][MT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][mt][e] = 0;
  const int8_t* wc[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    wc[r] = wq + (size_t)(n0 + r * N + g) * K + 16 * t;
  auto load = [&](uint4 (&w)[R], int kb) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      w[r] = kb < k1 ? ld_w(wc[r] + (size_t)kb * 64)
                     : make_uint4(0u, 0u, 0u, 0u);
  };
  constexpr int D = R == 1 ? 4 : 2;         // blocks of loads in flight
  uint4 wr[D][R];
#pragma unroll
  for (int d = 0; d < D; ++d) load(wr[d], k0 + d);
  for (int kbb = k0; kbb < k1; kbb += D)
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int kb = kbb + d;
    if (kb >= k1) break;
    uint4 (&wcur)[R] = wr[d];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int ra = 16 * mt + g, rb = ra + 8;
      const int off = kb * 64 + 16 * t;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      const uint4 x = ra < nrows ? *reinterpret_cast<const uint4*>(
                                       A + (size_t)ra * lda + off) : z;
      const uint4 y = rb < nrows ? *reinterpret_cast<const uint4*>(
                                       A + (size_t)rb * lda + off) : z;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t a[4] = {word(x, 2 * c), word(y, 2 * c),
                               word(x, 2 * c + 1), word(y, 2 * c + 1)};
#pragma unroll
        for (int r = 0; r < R; ++r)
          mma_s8(acc[r][mt], a, word(wcur[r], 2 * c),
                 word(wcur[r], 2 * c + 1));
      }
    }
    load(wcur, kb + D);
  }
}

// ------------------------------------------------ int8 weights, bf16 rows
// acc[r][mt][e]: the f32 dot of bf16 rows (stride lda bytes, lda % 128 ==
// 16) with int8 weights wq [*, K] (each turned into bf16 in registers:
// exact), same (row, column) map, products exact in f32, summed by the
// tensor cores over the 64-deep blocks [k0, k1) of K (D blocks' weight
// loads in flight).
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, int j) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(
      (float)(int8_t)(w >> (16 * j)), (float)(int8_t)(w >> (16 * j + 8)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// i8bf_cols: the tile's column n0 + c of half r at wcol[r] + c * wstride
// bytes (SH: in shared memory).
template <int MT, int R, bool SH = false>
__device__ __forceinline__ void i8bf_cols(const unsigned char* A, int lda,
                                          int nrows,
                                          const int8_t* const (&wcol)[R],
                                          int wstride, int k0, int k1,
                                          float (&acc)[R][MT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][mt][e] = 0.f;
  const int8_t* wc[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    wc[r] = wcol[r] + (size_t)g * wstride + 16 * t;
  auto load = [&](uint4 (&w)[R], int kb) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      w[r] = kb < k1 ? ld_wv<SH>(wc[r] + (size_t)kb * 64)
                     : make_uint4(0u, 0u, 0u, 0u);
  };
  constexpr int D = SH ? 1 : R == 1 ? 4 : 2;   // blocks of loads in flight
  uint4 wr[D][R];
#pragma unroll
  for (int d = 0; d < D; ++d) load(wr[d], k0 + d);
  for (int kbb = k0; kbb < k1; kbb += D)
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int kb = kbb + d;
    if (kb >= k1) break;
    uint4 (&wcur)[R] = wr[d];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // 16 bf16 of rows g and g + 8 at k 64 kb + 16 t
      uint4 x0, x1, y0, y1;
      const int off = (kb * 64 + 16 * t) * 2;
      ld_rows(A, lda, nrows, 16 * mt + g, off, x0, x1);
      ld_rows(A, lda, nrows, 16 * mt + g + 8, off, y0, y1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // k 16 t + 4c .. 4c + 3: bf16 words 2c, 2c + 1 of the 8
        const uint4& xr = c < 2 ? x0 : x1;
        const uint4& yr = c < 2 ? y0 : y1;
        const uint32_t a[4] = {word(xr, 2 * (c & 1)), word(yr, 2 * (c & 1)),
                               word(xr, 2 * (c & 1) + 1),
                               word(yr, 2 * (c & 1) + 1)};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t wv = word(wcur[r], c);
          mma_bf16(acc[r][mt], a, i8x2_bf16(wv, 0), i8x2_bf16(wv, 1));
        }
      }
    }
    load(wcur, kb + D);
  }
}

template <int MT, int R>
__device__ __forceinline__ void i8bf_tile(const unsigned char* A, int lda,
                                          int nrows, const int8_t* wq, int N,
                                          int K, int n0, int k0, int k1,
                                          float (&acc)[R][MT][4]) {
  const int8_t* wcol[R];
#pragma unroll
  for (int r = 0; r < R; ++r) wcol[r] = wq + (size_t)(n0 + r * N) * K;
  i8bf_cols<MT, R, false>(A, lda, nrows, wcol, K, k0, k1, acc);
}

}  // namespace qtts
