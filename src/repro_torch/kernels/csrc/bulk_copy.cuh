// Bulk asynchronous copies from device memory into shared memory, and the
// mbarriers that report their completion, and bulk stores back (sm_90).
// Shared by box_scan.cu, box_scan_seg.cu and l2dist.cu; build.py hashes
// this header into every library's key.
//
// A ring stage is filled by one thread: `copy_span` moves a contiguous span
// of 4-byte words with one cp.async.bulk for its 16-byte-aligned middle
// (the instruction needs 16-byte-aligned addresses and sizes) and plain
// loads and stores for the head and tail words around it (fewer than four
// each). So any row width D and any 4-byte-aligned start take the same
// route: a span of rows whose byte length D * 4 is not a multiple of 16
// (D = 17, 130, 400) or whose start is not 16-byte aligned still goes by
// one bulk copy, plus at most six scalar words.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// after every mbar_init, before any thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` more of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// cp.async.bulk: `bytes` (a multiple of 16) from 16-byte-aligned global src
// to 16-byte-aligned shared dst, completing on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"((uint64_t)src), "r"(bytes), "r"(bar)
      : "memory");
}

// The offset in bytes (0, 4, 8 or 12) at which copy_span places a span
// starting at src inside its 16-byte-aligned stage.
__device__ __forceinline__ uint32_t span_head(const void* src) {
  return (uint32_t)((uintptr_t)src & 15);
}

// Copies the 4-byte words [src, src + bytes) into the stage at `stage`
// (16-byte aligned, generic pointer), starting span_head(src) bytes into
// it, and makes the one arrival that completes the stage's full barrier
// `bar` once the bulk part has landed. The scalar words are stored before
// that arrival, whose release the consumers' wait acquires. Called by one
// thread.
__device__ __forceinline__ void copy_span(uint8_t* stage, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  const uintptr_t a = (uintptr_t)src, b = a + bytes;
  uint8_t* dst = stage + (a & 15);
  uintptr_t ma = (a + 15) & ~(uintptr_t)15, mb = b & ~(uintptr_t)15;
  if (mb <= ma) ma = mb = b;             // no aligned middle: all scalar
  for (uintptr_t p = a; p < ma; p += 4)
    *reinterpret_cast<float*>(dst + (p - a)) =
        *reinterpret_cast<const float*>(p);
  for (uintptr_t p = mb; p < b; p += 4)
    *reinterpret_cast<float*>(dst + (p - a)) =
        *reinterpret_cast<const float*>(p);
  mbar_expect_tx(bar, (uint32_t)(mb - ma));
  if (mb > ma)
    bulk_load(smem_u32(dst + (ma - a)), reinterpret_cast<const void*>(ma),
              (uint32_t)(mb - ma), bar);
}

// cp.async.bulk store: `bytes` (a multiple of 16) from 16-byte-aligned
// shared src to 16-byte-aligned global dst, in the thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          (uint64_t)dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of the thread's committed bulk groups still read
// their shared-memory source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until all of the thread's committed bulk groups are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// makes this thread's plain shared-memory stores visible to the bulk
// copies (the async proxy) that a later barrier lets another thread issue
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The store half of copy_span: writes the 4-byte words [dst, dst + bytes)
// of global memory from the stage at `stage` (16-byte aligned), which
// holds them from span_head(dst) bytes in: the 16-byte-aligned middle by
// one cp.async.bulk store, the head and tail words (fewer than four each)
// by plain stores, then commits the bulk group. Called by one thread,
// after the stage's writers have run fence_async_shared and a barrier.
__device__ __forceinline__ void store_span(void* dst, const uint8_t* stage,
                                           uint32_t bytes) {
  const uintptr_t a = (uintptr_t)dst, b = a + bytes;
  const uint8_t* src = stage + (a & 15);
  uintptr_t ma = (a + 15) & ~(uintptr_t)15, mb = b & ~(uintptr_t)15;
  if (mb <= ma) ma = mb = b;             // no aligned middle: all scalar
  for (uintptr_t p = a; p < ma; p += 4)
    *reinterpret_cast<float*>(p) =
        *reinterpret_cast<const float*>(src + (p - a));
  for (uintptr_t p = mb; p < b; p += 4)
    *reinterpret_cast<float*>(p) =
        *reinterpret_cast<const float*>(src + (p - a));
  if (mb > ma)
    bulk_store(reinterpret_cast<void*>(ma), smem_u32(src + (ma - a)),
               (uint32_t)(mb - ma));
  bulk_commit();
}

}  // namespace bulk

// the card's SM count (host)
static inline int bulk_sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}
