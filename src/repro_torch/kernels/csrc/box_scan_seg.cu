// box_scan_seg for Hopper (sm_90a): the index REFINE stage, segmented by
// query.
//
// Replaces: src/repro/kernels/box_scan.py::box_scan_seg_pallas (body
// _box_scan_seg_kernel). For rows x [N, D], boxes lo/hi [B, D] and the
// box->query ownership map onehot [B, Q] (all f32, row-major):
//     out[i, q] = sum_b onehot[b, q] * [lo[b] < x[i] <= hi[b] on every dim]
// as int32. The TPU reduces the [TN, B] membership mask with an f32 0/1
// matmul on the MXU; here each thread adds the ownership row of every box
// that contains its row into f32 accumulators, in box order, and casts to
// int32 at the end — the same f32 sums of the same 0/1 terms, exact below
// 2^24 boxes per query. Comparisons are never rewritten as subtractions
// and no fast-math is used, so +inf row padding, impossible (+inf, -inf)
// box padding and NaN give exactly the plain version's answer.
//
// Rows are gathered in place: instead of a gathered [C*block, D] copy,
// row i is read from the Morton-ordered index rows3 [NB, block, D] as
// rows3[cand[i / block], i % block], and rows whose slot i / block is
// >= *n_hit (a device scalar: the zone prune's survivor count) are written
// as zeros without being tested — ops.fused_query's "slots >= n_hit
// zeroed" contract, with no host round trip and no wasted compares on the
// capacity padding. A flat x [N, D] is the case rows3 = x[None], cand =
// [0], n_hit = 1, block = N.
//
// Bound on the H100: the compares. At the main path's shapes (C*block =
// 64K..256K rows, d' = 6, B = 64..512 boxes, Q = 8) the kernel reads
// C*block*D*4 bytes and writes C*block*Q*4 bytes (a few MB, ~2-3 us at
// 3.35 TB/s) but tests C*block*B*D*2 compares in the worst case
// (~0.2-1.6 G, 6-48 us at 33.5 T f32 lane-ops/s); the early exit at a row's first
// failing dim cuts the real count well below that.
//
// Design: one thread per row, the row's D values in registers (D <= 8),
// boxes and the ownership columns of up to 8 queries staged in shared
// memory in chunks (all threads read the same box at once: broadcast, no
// bank conflicts). Each thread owns its output row, so there are no
// atomics. Q > 8 runs the box loop once per group of 8 queries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQC = 8;  // queries accumulated in registers per pass

template <int DR>
__global__ void box_scan_seg_kernel(const float* __restrict__ x,
                                    const int32_t* __restrict__ cand,
                                    const int32_t* __restrict__ n_hit,
                                    int block,
                                    const float* __restrict__ lo,
                                    const float* __restrict__ hi,
                                    const float* __restrict__ onehot,
                                    int n, int nb, int d, int nq,
                                    int box_chunk,
                                    int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_lo = smem;                                   // [box_chunk, d]
  float* s_hi = s_lo + (size_t)box_chunk * d;           // [box_chunk, d]
  float* s_oh = s_hi + (size_t)box_chunk * d;           // [box_chunk, kQC]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = i < n;
  const float* row = x;
  if (live) {
    const int slot = i / block;
    live = slot < *n_hit;
    row = x + ((size_t)cand[slot] * block + (i % block)) * d;
  }
  if (i < n && !live) {
    for (int q = 0; q < nq; ++q) out[(size_t)i * nq + q] = 0;
  }
  // a block whose rows all lie past n_hit has nothing to test
  if (!__syncthreads_or(live)) return;

  float xr[DR > 0 ? DR : 1];
  if (DR > 0 && live) {
#pragma unroll
    for (int k = 0; k < (DR > 0 ? DR : 1); ++k) {
      if (k < d) xr[k] = row[k];
    }
  }
  for (int q0 = 0; q0 < nq; q0 += kQC) {
    const int qn = min(kQC, nq - q0);
    float acc[kQC];
#pragma unroll
    for (int qq = 0; qq < kQC; ++qq) acc[qq] = 0.f;
    for (int b0 = 0; b0 < nb; b0 += box_chunk) {
      const int bn = min(box_chunk, nb - b0);
      __syncthreads();
      for (int t = threadIdx.x; t < bn * d; t += blockDim.x) {
        s_lo[t] = lo[(size_t)b0 * d + t];
        s_hi[t] = hi[(size_t)b0 * d + t];
      }
      for (int t = threadIdx.x; t < bn * kQC; t += blockDim.x) {
        const int bb = t / kQC, qq = t % kQC;
        s_oh[t] = qq < qn ? onehot[(size_t)(b0 + bb) * nq + q0 + qq] : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      for (int bb = 0; bb < bn; ++bb) {
        bool in = true;
        if (DR > 0) {
#pragma unroll
          for (int k = 0; k < (DR > 0 ? DR : 1); ++k) {
            if (k < d) {
              in = in && (xr[k] > s_lo[bb * d + k]) &&
                   (xr[k] <= s_hi[bb * d + k]);
            }
          }
        } else {
          for (int k = 0; k < d && in; ++k) {
            const float v = row[k];
            in = (v > s_lo[bb * d + k]) && (v <= s_hi[bb * d + k]);
          }
        }
        if (in) {
#pragma unroll
          for (int qq = 0; qq < kQC; ++qq) acc[qq] += s_oh[bb * kQC + qq];
        }
      }
    }
    if (live) {
      for (int qq = 0; qq < qn; ++qq) {
        out[(size_t)i * nq + q0 + qq] = (int32_t)acc[qq];
      }
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Launches on
// `stream` and never synchronises. x is rows3 [NB, block, d], cand [C]
// block ids, n_hit a device scalar, n = C * block.
extern "C" int box_scan_seg_launch(const float* x, const int32_t* cand,
                                   const int32_t* n_hit, int block,
                                   const float* lo, const float* hi,
                                   const float* onehot, int n, int nb, int d,
                                   int nq, int32_t* out, void* stream) {
  if (n <= 0 || nq <= 0) return (int)cudaGetLastError();
  const int per_box = (2 * (d > 0 ? d : 1) + kQC) * (int)sizeof(float);
  int box_chunk = 32768 / per_box;
  if (box_chunk > 256) box_chunk = 256;
  if (box_chunk < 1) box_chunk = 1;
  const size_t smem = (size_t)box_chunk * per_box;
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 8) {
    box_scan_seg_kernel<8><<<grid, kThreads, smem, s>>>(
        x, cand, n_hit, block, lo, hi, onehot, n, nb, d, nq, box_chunk, out);
  } else {
    box_scan_seg_kernel<0><<<grid, kThreads, smem, s>>>(
        x, cand, n_hit, block, lo, hi, onehot, n, nb, d, nq, box_chunk, out);
  }
  return (int)cudaGetLastError();
}
