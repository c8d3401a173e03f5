// zone_prune for Hopper (sm_90a): the index PRUNE stage.
//
// Replaces: src/repro/kernels/zone_prune.py::zone_prune_pallas
// (body _zone_prune_kernel). For zones zlo/zhi [NZ, D] and boxes
// blo/bhi [B, D] (f32, row-major), zone z overlaps box b iff on EVERY dim
//     zhi[z, d] > blo[b, d]  &&  zlo[z, d] <= bhi[b, d]
// (half-open boxes (lo, hi]: a zone whose max equals the box lo cannot
// hold a match). Comparisons are written exactly as in the Pallas body and
// never as a subtraction, so +-inf padding and NaN behave identically
// (any comparison with NaN is false -> no overlap).
//
// Bound on the H100: the launch. On the engine's main path NZ = n / block
// (1024 at n = 2^20), D = 6 and B <= a few hundred boxes: the kernel reads
// NZ*D*8 + B*D*8 bytes (~50 KB, ~15 ns at 3.35 TB/s) and does at most
// NZ*B*D*2 compares (~6 M at B = 512, ~0.2 us at 33.5 T f32 lane-ops/s), far
// below the few microseconds one launch costs.
//
// Design: one thread per zone. The zone's 2*D bounds live in registers for
// D <= 8 (the path's d' = 6); boxes are staged through shared memory in
// chunks that every thread of the block reads by broadcast (all threads
// test the same box at the same time, so no bank conflicts). Two outputs
// from one kernel:
//   * hit  [NZ] uint8 — any(overlap) per zone; the engine path only needs
//     this (ops.fused_query uses mask.any(1) and its sum), so with
//     mask == nullptr a zone stops at its first overlapping box and a
//     block stops loading chunks once all its zones have a hit;
//   * mask [NZ, B] uint8 (optional) — the full overlap matrix, the
//     Pallas kernel's own output, kept for the kernel tests.
// torch.bool is one byte holding 0 or 1, so both outputs are written into
// bool tensors directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int DR>
__global__ void zone_prune_kernel(const float* __restrict__ zlo,
                                  const float* __restrict__ zhi,
                                  const float* __restrict__ blo,
                                  const float* __restrict__ bhi,
                                  int nz, int nb, int d, int box_chunk,
                                  uint8_t* __restrict__ mask,
                                  uint8_t* __restrict__ hit) {
  extern __shared__ float smem[];
  float* s_lo = smem;                       // [box_chunk, d]
  float* s_hi = smem + (size_t)box_chunk * d;
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = z < nz;
  float rlo[DR > 0 ? DR : 1], rhi[DR > 0 ? DR : 1];
  if (DR > 0 && live) {
#pragma unroll
    for (int k = 0; k < (DR > 0 ? DR : 1); ++k) {
      if (k < d) {
        rlo[k] = zlo[(size_t)z * d + k];
        rhi[k] = zhi[(size_t)z * d + k];
      }
    }
  }
  bool found = false;
  for (int b0 = 0; b0 < nb; b0 += box_chunk) {
    // hit-only mode: stop once every zone of this block has a hit
    if (mask == nullptr && __syncthreads_and(found || !live)) break;
    const int bn = min(box_chunk, nb - b0);
    __syncthreads();
    for (int t = threadIdx.x; t < bn * d; t += blockDim.x) {
      s_lo[t] = blo[(size_t)b0 * d + t];
      s_hi[t] = bhi[(size_t)b0 * d + t];
    }
    __syncthreads();
    if (!live || (found && mask == nullptr)) continue;
    for (int bb = 0; bb < bn; ++bb) {
      bool ov = true;
      if (DR > 0) {
#pragma unroll
        for (int k = 0; k < (DR > 0 ? DR : 1); ++k) {
          if (k < d) {
            ov = ov && (rhi[k] > s_lo[bb * d + k]) &&
                 (rlo[k] <= s_hi[bb * d + k]);
          }
        }
      } else {
        for (int k = 0; k < d && ov; ++k) {
          ov = (zhi[(size_t)z * d + k] > s_lo[bb * d + k]) &&
               (zlo[(size_t)z * d + k] <= s_hi[bb * d + k]);
        }
      }
      if (mask != nullptr) {
        mask[(size_t)z * nb + b0 + bb] = ov ? 1 : 0;
      } else if (ov) {
        found = true;
        break;
      }
      found = found || ov;
    }
  }
  if (live) hit[z] = found ? 1 : 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Launches on
// `stream` and never synchronises. mask may be null (hit-only mode).
extern "C" int zone_prune_launch(const float* zlo, const float* zhi,
                                 const float* blo, const float* bhi,
                                 int nz, int nb, int d,
                                 uint8_t* mask, uint8_t* hit,
                                 void* stream) {
  if (nz <= 0) return (int)cudaGetLastError();
  // boxes staged in chunks of at most 32 KB of shared memory
  int box_chunk = 32768 / (2 * (d > 0 ? d : 1) * (int)sizeof(float));
  if (box_chunk > 256) box_chunk = 256;
  if (box_chunk < 1) box_chunk = 1;
  const size_t smem = (size_t)box_chunk * 2 * d * sizeof(float);
  const dim3 grid((nz + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 8) {
    zone_prune_kernel<8><<<grid, kThreads, smem, s>>>(
        zlo, zhi, blo, bhi, nz, nb, d, box_chunk, mask, hit);
  } else {
    zone_prune_kernel<0><<<grid, kThreads, smem, s>>>(
        zlo, zhi, blo, bhi, nz, nb, d, box_chunk, mask, hit);
  }
  return (int)cudaGetLastError();
}
