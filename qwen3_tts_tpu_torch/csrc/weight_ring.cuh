// A block's share of its next GEMV phase's weights, copied from device
// memory into shared memory while the block waits at a grid barrier
// (chunk_step.cu).  Hopper's Tensor Memory Accelerator does the copy: one
// 1-D bulk copy (cp.async.bulk, global -> shared) per byte range, each
// completing on one mbarrier in shared memory that counts the bytes; the
// block's threads spend no registers on the copy and the phase after the
// barrier only waits for the barrier's phase to flip.
//
// Layout of a fill (ring_fill): a matrix's output columns are stored
// column-major in device memory (column c's qcol bytes contiguous), so a
// block's contiguous column range [c0, c0 + nc) is one byte range per half
// of the SwiGLU pair.  Columns land `stride` bytes apart in the ring:
// stride = qcol + 64 (qcol a multiple of 128) puts the two columns that a
// quarter warp of gemv_stream.cuh's tile loads reads at once in different
// halves of the 32 banks, at the price of one copy per column; stride ==
// qcol keeps the range in one copy.  The scales (scol bytes a column,
// contiguous) follow the weights, one copy per half.
//
// Use: ring_init once; after the last read of a fill (a __syncthreads),
// ring_fill issues the next one and returns whether it copies anything;
// ring_wait(parity) before the first read of it, parity = the count of
// fills waited for so far, mod 2.
#pragma once

#include <stdint.h>

#include "cp_async.cuh"

namespace qtts {

constexpr long long RING_TIMEOUT = 1LL << 34;   // SM cycles, ~8 s

// One thread: the barrier expects one arrival (ring_fill's) per phase.
__device__ __forceinline__ void ring_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every thread: wait until the fill of this parity has landed; a wait of
// ~8 s traps (the launch fails) rather than hang the card.
__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > RING_TIMEOUT) __trap();
  }
}

// Bytes of a fill of R halves of nc columns (ring_fill's layout).
__host__ __device__ inline size_t ring_bytes(int R, int nc, int stride,
                                             int scol) {
  return (size_t)R * nc * stride + (size_t)R * nc * scol;
}

// Issue the block's copies of columns [c0, c0 + nc) of each half r < R
// (half r's columns start at column r * half_cols of q and s): weights at
// ring + (r * nc + c) * stride, scales (scol bytes a column, none when
// scol == 0) at ring + R * nc * stride + r * nc * scol.  Called by every
// thread of the block after a __syncthreads that ends the reads of the
// previous fill; the lanes of the block's last warp issue one copy each
// (warp 0 runs the grid barrier's release, which must not wait behind
// them), its last lane arms the barrier with the total.  Returns false when
// there is nothing to copy (nc == 0: no wait follows).  Sizes and
// addresses are multiples of 16.
__device__ __forceinline__ bool ring_fill(unsigned char* ring, uint64_t* bar,
                                          const unsigned char* q, int qcol,
                                          int stride,
                                          const unsigned char* s, int scol,
                                          int R, size_t half_cols, int c0,
                                          int nc) {
  if (nc <= 0) return false;
  if (threadIdx.x < blockDim.x - 32) return true;
  const bool dense = stride == qcol;
  const int wcopies = dense ? R : R * nc;
  const int copies = wcopies + (scol > 0 ? R : 0);
  if (threadIdx.x == blockDim.x - 1)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"((uint32_t)ring_bytes(R, nc, qcol, scol))
        : "memory");
  for (int i = threadIdx.x & 31; i < copies; i += 32) {
    // the generic-proxy reads of the previous fill before these writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (i < wcopies) {
      const int r = dense ? i : i / nc, c = dense ? 0 : i % nc;
      const size_t col = r * half_cols + c0 + c;
      bulk_copy(ring + ((size_t)r * nc + c) * stride, q + col * qcol,
                dense ? (uint32_t)nc * qcol : (uint32_t)qcol, bar);
    } else {
      const int r = i - wcopies;
      bulk_copy(ring + (size_t)R * nc * stride + (size_t)r * nc * scol,
                s + (r * half_cols + c0) * scol, (uint32_t)nc * scol, bar);
    }
  }
  return true;
}

}  // namespace qtts
