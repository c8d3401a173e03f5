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
// NaN rule (x86's, which l2dist_ref spells out so that the CPU and the
// card give the same bits): an op with a NaN operand returns its first
// NaN operand, quieted (bit 22 set); an invalid op on numbers returns
// 0xFFC00000, a NaN with its sign bit set. Of the three ops only
// sub(x, q) can be invalid (inf - inf of equal signs): t * t and acc +
// t * t are never invalid, as acc >= +0. So a NaN distance takes its bits
// from the first dim whose step x - q is NaN: x's NaN if x is one, else
// q's, else 0xFFC00000; every later add returns acc, its first NaN
// operand. The hardware returns 0x7FFFFFFF for any NaN result, so each
// output is a select around the intrinsics' sum: the sum where it is a
// number, else first_nan's bits (a scan of the dims, run only for NaN
// outputs). All six cases of tests/test_torch_kernels.py's NaN matrix
// (inf - inf, -inf - -inf, NaN in x, NaN in q, NaN in both with opposite
// signs, a NaN after an earlier inf - inf) match bit for bit. The sign is
// what the ranking reads (ops.knn_topk): a -NaN ranks first, a +NaN last.
//
// Bound on the H100: the bytes. The kNN path (N = n rows of subset 0,
// D = 6, Q = number of positives) reads N*D*4 bytes and writes N*Q*4:
// 88 MB at 1,048,576 rows and Q = 15, 0.026 ms at 3.35 TB/s, against
// N*Q*D*3 = 283 M f32 operations (0.0085 ms at 33.5 T f32 lane
// instructions/s: none of them is an FMA). Store-bound: 63 of the 88 MB
// are the output.
//
// Design, D and Q up to 32 (64 with half-size tiles): the tiled route.
// - A persistent grid walks tiles of TN = 128 rows; the grid is sized so
//   that every CTA takes the same number of tiles (within one).
// - A row tile is one contiguous span of TN*D*4 bytes, brought into
//   shared memory by one cp.async.bulk (bulk_copy.cuh copy_span: its
//   16-byte-aligned middle, plus at most six edge words by plain loads),
//   completing on an mbarrier. The tiles are double-buffered: tile i+1's
//   copy is issued before tile i is computed.
// - The queries are staged once per CTA, transposed [D, QP] (QP = Q
//   rounded up to 16, zero padded), and read as 16-byte broadcast loads.
// - One thread computes its row against a group of 16 queries in
//   registers: no division or modulo per output element.
// - The [TN, Q] output tile is one contiguous span of the output. It is
//   staged in shared memory (double-buffered) and written by one
//   cp.async.bulk store (store_span), so tile i's store drains while tile
//   i+1 is copied in and computed. Rows write at a stride of Q words,
//   free of bank conflicts for odd Q (the path's 15); for even Q they
//   would conflict gcd(Q, 32)-way (Q = 16 took 1.4x Q = 15's time), so
//   even Q writes a tile padded to a stride of Q + 1 and the CTA copies
//   it into the output stage, consecutive lanes on consecutive words.
// Larger D or Q keep the D-chunked route (the earlier kernel, one thread
// per output element, the queries staged a chunk of dims at a time),
// with the same NaN rule: `knn_full` over all 384 features, and the
// 65,536 x 384 x 8 synthetic case.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr uint32_t kDefaultNaN = 0xFFC00000u;   // x86's invalid-op NaN
constexpr uint32_t kQuietBit = 0x00400000u;

// The bits of a NaN distance by the NaN rule: the first dim whose step
// x - q is NaN. xr[k] is the row's dim k, qr[k * qs] the query's.
__device__ __noinline__ float first_nan(const float* xr, const float* qr,
                                        int qs, int d) {
  for (int k = 0; k < d; ++k) {
    const float a = xr[k], b = qr[(size_t)k * qs];
    if (isnan(a)) return __uint_as_float(__float_as_uint(a) | kQuietBit);
    if (isnan(b)) return __uint_as_float(__float_as_uint(b) | kQuietBit);
    if (isinf(a) && a == b) break;
  }
  return __uint_as_float(kDefaultNaN);
}

// ---------------------------------------------------------------------
// The tiled route
// ---------------------------------------------------------------------

constexpr int kTileThreads = 128;
constexpr int kTileRows = 128;            // TN at most; one row a thread
constexpr int kQG = 16;                   // queries a thread holds
constexpr int kStageBytes = 16 * 1024;    // bytes of rows / outputs a tile
constexpr int kQBytes = 16 * 1024;        // staged queries

__host__ __device__ constexpr int round16(long long b) {
  return (int)((b + 15) / 16 * 16);
}

// shared memory: two mbarriers (16 bytes), the queries [D, QP], two row
// stages, two output stages and, for even Q, one padded output tile (rows
// at a stride of Q + 1 words); + 16 in each stage because a span that is
// not 16-byte aligned starts up to 12 bytes into it
struct TileLayout {
  int q_off, x_off, x_bytes, o_off, o_bytes, p_off, ps, total;
  __host__ __device__ TileLayout(int tn, int d, int nq, int qp) {
    q_off = 16;
    x_off = q_off + round16((long long)d * qp * 4);
    x_bytes = round16((long long)tn * d * 4 + 16);
    o_off = x_off + 2 * x_bytes;
    o_bytes = round16((long long)tn * nq * 4 + 16);
    p_off = o_off + 2 * o_bytes;
    ps = nq & 1 ? nq : nq + 1;
    total = p_off + (nq & 1 ? 0 : round16((long long)tn * ps * 4));
  }
};

__global__ void __launch_bounds__(kTileThreads)
l2dist_tiled_kernel(const float* __restrict__ x, const float* __restrict__ q,
                    long long n, int d, int nq, int qp, int tn,
                    long long ntiles, float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const TileLayout L(tn, d, nq, qp);
  const int tid = threadIdx.x;
  float* qt = reinterpret_cast<float*>(smem + L.q_off);
  const uint32_t bar0 = bulk::smem_u32(smem), bar1 = bar0 + 8;
  if (tid == 0) {
    bulk::mbar_init(bar0, 1);
    bulk::mbar_init(bar1, 1);
    bulk::mbar_init_fence();
  }
  for (int t = tid; t < d * qp; t += blockDim.x) {
    const int k = t / qp, j = t - k * qp;
    qt[t] = j < nq ? q[(size_t)j * d + k] : 0.f;
  }
  __syncthreads();
  auto copy_in = [&](long long tile, int s) {
    const long long r0 = tile * tn;
    const long long rows = min((long long)tn, n - r0);
    bulk::copy_span(smem + L.x_off + s * L.x_bytes, x + r0 * d,
                    (uint32_t)(rows * d * 4), s ? bar1 : bar0);
  };
  if (tid == 0 && blockIdx.x < ntiles) copy_in(blockIdx.x, 0);
  const int ng = qp / kQG;
  int it = 0;
  for (long long tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, ++it) {
    const int s = it & 1;
    const long long r0 = tile * tn;
    const int rows = (int)min((long long)tn, n - r0);
    if (tid == 0) {
      // stage s^1 was last read in the previous tile, before its barrier
      if (tile + gridDim.x < ntiles) copy_in(tile + gridDim.x, s ^ 1);
      // output stage s is free once the store of two tiles ago has read it
      bulk::bulk_wait_read<1>();
    }
    __syncthreads();
    bulk::mbar_wait(s ? bar1 : bar0, (it >> 1) & 1);
    const float* xs = reinterpret_cast<const float*>(
        smem + L.x_off + s * L.x_bytes + bulk::span_head(x + r0 * d));
    float* os = reinterpret_cast<float*>(
        smem + L.o_off + s * L.o_bytes + bulk::span_head(out + r0 * nq));
    // rows go to the output stage at a stride of Q words, which is free
    // of bank conflicts for odd Q; even Q goes through the padded tile
    float* dst = L.ps == nq ? os : reinterpret_cast<float*>(smem + L.p_off);
    for (int item = tid; item < rows * ng; item += blockDim.x) {
      const int g = item / rows, r = item - g * rows;
      const float* xr = xs + r * d;
      const float* qg = qt + g * kQG;
      float acc[kQG];
#pragma unroll
      for (int j = 0; j < kQG; ++j) acc[j] = 0.f;
      for (int k = 0; k < d; ++k) {
        const float xv = xr[k];
        const float4* qv = reinterpret_cast<const float4*>(qg + k * qp);
#pragma unroll
        for (int v = 0; v < kQG / 4; ++v) {
          const float4 qq = qv[v];
          float t;
          t = __fsub_rn(xv, qq.x);
          acc[4 * v] = __fadd_rn(acc[4 * v], __fmul_rn(t, t));
          t = __fsub_rn(xv, qq.y);
          acc[4 * v + 1] = __fadd_rn(acc[4 * v + 1], __fmul_rn(t, t));
          t = __fsub_rn(xv, qq.z);
          acc[4 * v + 2] = __fadd_rn(acc[4 * v + 2], __fmul_rn(t, t));
          t = __fsub_rn(xv, qq.w);
          acc[4 * v + 3] = __fadd_rn(acc[4 * v + 3], __fmul_rn(t, t));
        }
      }
      const int jn = min(kQG, nq - g * kQG);
      float* orow = dst + (size_t)r * L.ps + g * kQG;
#pragma unroll
      for (int j = 0; j < kQG; ++j) {
        if (j < jn) {
          const float v = acc[j];
          orow[j] = isnan(v) ? first_nan(xr, qg + j, qp, d) : v;
        }
      }
    }
    if (L.ps != nq) {
      // even Q: the padded tile into the contiguous output stage, each
      // warp a few rows at a time, its lanes on consecutive words
      __syncthreads();
      const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
      const int rpi = nq < 32 ? 32 / nq : 1;   // rows a warp copies at once
      const int lr = nq < 32 ? lane / nq : 0;
      const int lj = nq < 32 ? lane - lr * nq : lane;
      if (lr < rpi) {
        for (int r = warp * rpi + lr; r < rows; r += nw * rpi)
          for (int j = lj; j < nq; j += (nq < 32 ? nq : 32))
            os[(size_t)r * nq + j] = dst[(size_t)r * L.ps + j];
      }
    }
    bulk::fence_async_shared();
    __syncthreads();              // the output stage is written, the rows read
    if (tid == 0)
      bulk::store_span(out + r0 * nq,
                       smem + L.o_off + s * L.o_bytes,
                       (uint32_t)((long long)rows * nq * 4));
  }
  if (tid == 0) bulk::bulk_wait_all();
}

int launch_tiled(const float* x, const float* q, long long n, int d, int nq,
                 int qp, int tn, float* out, cudaStream_t s) {
  const TileLayout L(tn, d, nq, qp);
  const size_t smem = (size_t)L.total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        l2dist_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, l2dist_tiled_kernel, kTileThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  const long long ntiles = (n + tn - 1) / tn;
  const long long resident = (long long)bulk_sm_count() * per_sm;
  // the fewest CTAs that still give each the least number of tiles
  const long long per_cta = (ntiles + resident - 1) / resident;
  const long long blocks = (ntiles + per_cta - 1) / per_cta;
  l2dist_tiled_kernel<<<(unsigned)blocks, kTileThreads, smem, s>>>(
      x, q, n, d, nq, qp, tn, ntiles, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The D-chunked route (large D or Q)
// ---------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kSmemFloats = 12 * 1024;   // 48 KB of staged queries

// One thread per output element (i, j), consecutive threads on
// consecutive j, so the [N, Q] output is written fully coalesced and the
// rows a warp needs are read once into L1 and shared. The queries are
// staged in shared memory transposed, [D, Q], a chunk of dims at a time;
// each thread's sum stays in a register across the chunks, so the dims
// are still summed in ascending order.
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
  if (live)
    out[e] = isnan(acc) ? first_nan(x + i * d, q + (size_t)j * d, 1, d)
                        : acc;
}

int launch_chunked(const float* x, const float* q, long long n, int d,
                   int nq, float* out, cudaStream_t s) {
  int dim_chunk = kSmemFloats / nq;
  if (dim_chunk > d) dim_chunk = d;
  if (dim_chunk < 1) dim_chunk = 1;
  const size_t smem = (size_t)dim_chunk * nq * sizeof(float);
  const long long blocks = (n * nq + kThreads - 1) / kThreads;
  l2dist_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(x, q, n, d, nq,
                                                         dim_chunk, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the first CUDA error of the launch (0 on success). Launches on
// `stream` and never synchronises. Needs nq <= kSmemFloats (one staged
// dim of every query); the wrapper checks it.
extern "C" int l2dist_launch(const float* x, const float* q, long long n,
                             int d, int nq, float* out, void* stream) {
  if (n <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (nq > kSmemFloats || d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int qp = (nq + kQG - 1) / kQG * kQG;
  int tn = kTileRows;
  while (tn > 64 && ((long long)tn * d * 4 > kStageBytes ||
                     (long long)tn * nq * 4 > kStageBytes))
    tn >>= 1;
  if (d > 0 && (long long)tn * d * 4 <= kStageBytes &&
      (long long)tn * nq * 4 <= kStageBytes &&
      (long long)d * qp * 4 <= kQBytes)
    return launch_tiled(x, q, n, d, nq, qp, tn, out, s);
  return launch_chunked(x, q, n, d, nq, out, s);
}
