// box_scan for Hopper (sm_90a): box-membership counts over a full scan.
//
// Replaces: src/repro/kernels/box_scan.py::box_scan_pallas (body
// _box_scan_kernel). For rows x [N, D] and boxes lo/hi [B, D] (all f32,
// row-major):
//     out[i] = number of boxes b with lo[b, k] < x[i, k] <= hi[b, k]
//              on EVERY dim k
// as int32. It serves two callers: full_scan, the dtree/rforest scan over
// the whole [n, 384] feature matrix with full-width tree boxes, and
// query_index (the engine's use_fused=False oracle) over the surviving
// blocks' rows at d' = 6. Comparisons are written exactly as in the Pallas
// body and never as a subtraction, and no fast-math is used, so the
// (-inf, +inf) bounds of unconstrained tree dims, +inf row padding and
// NaN rows (inside no box) give exactly the plain version's answer.
//
// Bound on the H100: the bytes are N*D*4 read plus N*4 written (1.61 GB
// at the full scan's 1,048,576 x 384, 0.48 ms at 3.35 TB/s); the compares
// are at most N*B*D*2 (51.5 G at B = 64, 1.54 ms at 33.5 T f32 lane
// instructions/s). So with more than ~20 full-width boxes the worst case
// is bound by the compares. A row leaves a box at its first failing group
// of dims, which cuts the real count well below that.
//
// Design: a group of G lanes owns R rows. For D > 8, G = 32 (one warp):
// lane j holds dims j, j+32, ... of its R = 4 rows in registers (12 values
// each up to D = 384), so x is read from device memory once and every box
// bound loaded from shared memory is used for R rows. After each group of
// 32 dims the warp votes (__all_sync per row) and leaves the box once no
// row can still be inside. For D <= 8 (d' = 6), G = 1: one thread per
// row, the row in registers, all threads reading the same box at once
// (shared-memory broadcast). Boxes are staged as (lo, hi) float2 pairs in
// shared memory in chunks of up to 192 KB (100 full-width boxes are 307 KB
// and do not fit at once); the grid is persistent (as many blocks as fit
// on the card) and walks the rows once per chunk, so with one chunk, the
// usual case, each block stages the boxes once. Each row's count is owned
// by one lane, so there are no atomics. D > 384 runs the warp groups
// reading x from device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemBudget = 192 * 1024;   // boxes staged per chunk

template <int G>
__device__ __forceinline__ bool group_all(bool p) {
  if constexpr (G == 1) {
    return p;
  } else {
    return __all_sync(0xffffffffu, p);
  }
}

// G lanes per row group (1 or 32); each lane holds V values (dims lane,
// lane + G, ...) of each of the group's R rows; V == 0 reads x from
// device memory instead.
template <int G, int V, int R>
__global__ void __launch_bounds__(kThreads)
box_scan_kernel(const float* __restrict__ x, const float* __restrict__ lo,
                const float* __restrict__ hi, long long n, int d, int nb,
                int box_chunk, int32_t* __restrict__ out) {
  extern __shared__ float2 s_box[];                    // [box_chunk, d]
  const int lane = threadIdx.x % G;
  const long long group =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const long long n_groups = (long long)gridDim.x * blockDim.x / G;
  const int nv = (d + G - 1) / G;                      // values per lane
  for (int b0 = 0; b0 < nb; b0 += box_chunk) {
    const int bn = min(box_chunk, nb - b0);
    __syncthreads();
    for (int t = threadIdx.x; t < bn * d; t += blockDim.x) {
      s_box[t] = make_float2(lo[(size_t)b0 * d + t], hi[(size_t)b0 * d + t]);
    }
    __syncthreads();
    for (long long r0 = group * R; r0 < n; r0 += n_groups * R) {
      bool live[R];
      float xr[R][V > 0 ? V : 1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        live[r] = r0 + r < n;
        if constexpr (V > 0) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const int c = k * G + lane;
            xr[r][k] = (live[r] && k < nv && c < d)
                           ? x[(r0 + r) * d + c] : 0.f;
          }
        }
      }
      int cnt[R];
#pragma unroll
      for (int r = 0; r < R; ++r) cnt[r] = 0;
      for (int bb = 0; bb < bn; ++bb) {
        const float2* bx = s_box + (size_t)bb * d;
        bool in[R];
#pragma unroll
        for (int r = 0; r < R; ++r) in[r] = live[r];
        if constexpr (V > 0) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if (k >= nv) break;
            const int c = k * G + lane;
            if (c < d) {
              const float2 b = bx[c];
#pragma unroll
              for (int r = 0; r < R; ++r) {
                in[r] = in[r] && (xr[r][k] > b.x) && (xr[r][k] <= b.y);
              }
            }
            bool any = false;
#pragma unroll
            for (int r = 0; r < R; ++r) any |= group_all<G>(in[r]);
            if (!any) break;
          }
        } else {
          for (int c0 = 0; c0 < d; c0 += G) {
            const int c = c0 + lane;
            if (c < d) {
              const float2 b = bx[c];
#pragma unroll
              for (int r = 0; r < R; ++r) {
                if (in[r]) {
                  const float v = x[(r0 + r) * d + c];
                  in[r] = (v > b.x) && (v <= b.y);
                }
              }
            }
            bool any = false;
#pragma unroll
            for (int r = 0; r < R; ++r) any |= group_all<G>(in[r]);
            if (!any) break;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (group_all<G>(in[r])) ++cnt[r];
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (live[r]) {
            const long long i = r0 + r;
            out[i] = (b0 == 0 ? 0 : out[i]) + cnt[r];
          }
        }
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int G, int V, int R>
int launch(const float* x, const float* lo, const float* hi, long long n,
           int d, int nb, int32_t* out, cudaStream_t s) {
  auto kernel = box_scan_kernel<G, V, R>;
  const int per_box = (d > 0 ? d : 1) * (int)sizeof(float2);
  int box_chunk = kSmemBudget / per_box;
  if (box_chunk > nb) box_chunk = nb;
  if (box_chunk < 1) box_chunk = 1;
  const size_t smem = (size_t)box_chunk * per_box;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  const long long groups = (n + R - 1) / R;
  long long blocks = (groups * G + kThreads - 1) / kThreads;
  const long long resident = (long long)sm_count() * per_sm;
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(x, lo, hi, n, d, nb,
                                                  box_chunk, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the first CUDA error of the launch (0 on success). Launches on
// `stream` and never synchronises. The caller handles nb == 0 (all
// counts 0) without a launch.
extern "C" int box_scan_launch(const float* x, const float* lo,
                               const float* hi, long long n, int d, int nb,
                               int32_t* out, void* stream) {
  if (n <= 0 || nb <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 8) return launch<1, 8, 1>(x, lo, hi, n, d, nb, out, s);
  if (d <= 32 * 12) return launch<32, 12, 4>(x, lo, hi, n, d, nb, out, s);
  return launch<32, 0, 1>(x, lo, hi, n, d, nb, out, s);
}
