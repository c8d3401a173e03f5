// l2dist for Hopper (sm_90a): the squared-L2 distance matrix of the kNN
// model.
//
// Replaces: src/repro/kernels/l2dist.py::l2dist_pallas (body
// _l2dist_kernel). For rows x [N, D] and queries q [Q, D] (f32,
// row-major):
//     out[i, j] = sum over k = 0 .. D-1, in that order, of (x[i,k] - q[j,k])^2
// as f32. The TPU kernel expands |x|^2 - 2 x.q + |q|^2 to put the cross
// term on the MXU. Here the sum is direct: at the kNN path's d' = 6 a
// matrix product gains nothing, the expansion can go negative through
// cancellation, and TF32 would miss the kernel tolerance. Every step is
// spelled with a round-to-nearest intrinsic (__fsub_rn, __fmul_rn,
// __fadd_rn), which nvcc never contracts into an FMA, so the result is
// bitwise the plain version's (kernels/ref.py l2dist_ref: the same ops in
// the same order, each a separate correctly rounded f32 op).
//
// Bound on the H100: the bytes. The kNN path (N = n rows of subset 0,
// D = 6, Q = number of positives) reads N*D*4 bytes and writes N*Q*4:
// 88 MB at 1,048,576 rows and Q = 15, 0.026 ms at 3.35 TB/s, against
// N*Q*D*3 = 283 M f32 operations (0.0085 ms at 33.5 T f32 lane
// instructions/s: none of them is an FMA).
//
// Design: one thread per output element (i, j), consecutive threads on
// consecutive j, so the [N, Q] output is written fully coalesced and the
// rows a warp needs (a few, at Q = 15) are read once into L1 and shared.
// The queries are staged in shared memory transposed, [D, Q], a chunk of
// dims at a time: lanes with consecutive j read consecutive words (no bank
// conflicts), lanes with the same j read the same word (broadcast). Each
// thread's sum stays in a register across the chunks, so the dims are
// still summed in ascending order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemFloats = 12 * 1024;   // 48 KB of staged queries

__global__ void __launch_bounds__(kThreads)
l2dist_kernel(const float* __restrict__ x, const float* __restrict__ q,
              long long n, int d, int nq, int dim_chunk,
              float* __restrict__ out) {
  extern __shared__ float s_qt[];                    // [dim_chunk, nq]
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = e < n * nq;
  const long long i = live ? e / nq : 0;
  const int j = live ? (int)(e % nq) : 0;
  float acc = 0.f;
  for (int k0 = 0; k0 < d; k0 += dim_chunk) {
    const int kn = min(dim_chunk, d - k0);
    __syncthreads();
    for (int t = threadIdx.x; t < kn * nq; t += blockDim.x) {
      const int kk = t / nq, jj = t % nq;
      s_qt[t] = q[(size_t)jj * d + k0 + kk];
    }
    __syncthreads();
    if (live) {
      const float* xr = x + i * d + k0;
      for (int kk = 0; kk < kn; ++kk) {
        const float t = __fsub_rn(xr[kk], s_qt[kk * nq + j]);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
    }
  }
  if (live) out[e] = acc;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Launches on
// `stream` and never synchronises. Needs nq <= kSmemFloats (one staged
// dim of every query); the wrapper checks it.
extern "C" int l2dist_launch(const float* x, const float* q, long long n,
                             int d, int nq, float* out, void* stream) {
  if (n <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (nq > kSmemFloats) return (int)cudaErrorInvalidValue;
  int dim_chunk = kSmemFloats / nq;
  if (dim_chunk > d) dim_chunk = d;
  if (dim_chunk < 1) dim_chunk = 1;
  const size_t smem = (size_t)dim_chunk * nq * sizeof(float);
  const long long blocks = (n * nq + kThreads - 1) / kThreads;
  l2dist_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, q, n, d, nq, dim_chunk, out);
  return (int)cudaGetLastError();
}
