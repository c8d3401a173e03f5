// flash_attention for Hopper (sm_90a): GQA online-softmax attention, the
// ViT feature extractor's attention.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel). In the kernel layout, q [BH, S, G, D] and k, v
// [BH, S, D] (BH = batch x kv heads, G query heads per kv head), f32 or
// bf16, row-major:
//     out[b, i, g] = sum_j softmax_j(scale * q[b, i, g] . k[b, j]) v[b, j]
// with scale = D^-0.5, in q's dtype. As in the Pallas body: q is upcast to
// f32 and scaled BEFORE the product; the running max m, sum l and the
// D-wide accumulator are f32 and updated once per key tile; causal masking
// keeps qpos >= kpos and writes -1e30 (not -inf) for the rest, and key
// tiles wholly above the diagonal are skipped; l is floored at 1e-30
// before the divide. Keys past S (a ragged last tile) are -inf, so they
// add nothing. Built without fast-math; expf is the accurate one.
//
// Bound on the H100: at the ViT's shape (BH = 128 x 3, S = 17, G = 1,
// D = 64, f32) the bytes: q, k, v and out are 6.7 MB, 2.0 us at 3.35 TB/s,
// against 4 BH G S^2 D = 28 MFLOP (0.4 us at 67 TFLOP/s f32). At the
// paper's 400x400 patches (S = 626) the FLOPs: 38.5 GFLOP at batch 128,
// 0.58 ms. This kernel runs its two products as f32 FMAs on the CUDA
// cores, never on the tensor cores (that, with TMA and wgmma, is for the
// redesign), so at long S it stays far from a bf16 bound.
//
// Design: one CTA of 128 threads per (bh, tile of query (row, g) pairs).
// The pairs of one bh are numbered row * G + g, the order of q's layout,
// so any G works and a CTA's pairs are contiguous in memory. D / 8 lanes
// share a pair, each holding 8 of its dims (dims lane, lane + D/8, ...):
// the partial dot products meet by shuffles within the lane group, and
// lanes of a group read consecutive shared-memory words (no bank
// conflicts; groups read the same words, a broadcast). K and V tiles of
// 32 keys are staged in shared memory as f32 (32 KB at D = 128). Each
// thread keeps the tile's 32 scores, m, l and its 8 accumulators in
// registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileK = 32;       // keys staged per step
constexpr int kPerLane = 8;      // q and accumulator dims a lane holds
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s,
                       int g, int tiles, float scale) {
  constexpr int L = D / kPerLane;          // lanes sharing one (row, g) pair
  constexpr int kPairs = kThreads / L;     // pairs per CTA
  __shared__ float sk[kTileK][D];
  __shared__ float sv[kTileK][D];

  const long long bh = blockIdx.x / tiles;
  const long long p0 = (long long)(blockIdx.x % tiles) * kPairs;
  const long long npairs = (long long)s * g;
  const int lane = threadIdx.x % L;
  const long long p = p0 + threadIdx.x / L;
  // pairs past the end compute on the last pair (every lane of a warp
  // takes part in the shuffles) and store nothing
  const bool live = p < npairs;
  const long long pc = live ? p : npairs - 1;
  const int qpos = (int)(pc / g);
  int kend = s;
  if (CAUSAL) {                 // the CTA's last row bounds its keys
    const long long plast = min(p0 + kPairs, npairs) - 1;
    kend = (int)(plast / g) + 1;
  }

  float qr[kPerLane], acc[kPerLane];
  const T* qp = q + (bh * npairs + pc) * D;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    qr[e] = to_f32(qp[e * L + lane]) * scale;
    acc[e] = 0.f;
  }
  float m = kMasked, l = 0.f;
  const T* kb = k + bh * s * (long long)D;
  const T* vb = v + bh * s * (long long)D;

  for (int k0 = 0; k0 < kend; k0 += kTileK) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTileK * D; t += kThreads) {
      const int r = t / D, c = t % D;
      const int kp = k0 + r;
      const bool ok = kp < s;
      sk[r][c] = ok ? to_f32(kb[(long long)kp * D + c]) : 0.f;
      sv[r][c] = ok ? to_f32(vb[(long long)kp * D + c]) : 0.f;
    }
    __syncthreads();

    float sc[kTileK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        part = fmaf(qr[e], sk[j][e * L + lane], part);
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o, L);
      const int kp = k0 + j;
      if (kp >= s) part = -INFINITY;
      else if (CAUSAL && kp > qpos) part = kMasked;
      sc[j] = part;
      mt = fmaxf(mt, part);
    }
    // key k0 < kend <= s is in every tile, so mt is finite
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      sc[j] = expf(sc[j] - m_new);
      psum += sc[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        acc[e] = fmaf(sc[j], sv[j][e * L + lane], acc[e]);
    }
    m = m_new;
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = out + (bh * npairs + pc) * D;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      op[e * L + lane] = from_f32<T>(acc[e] / denom);
  }
}

template <int D, typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh,
             int s, int g, int causal, float scale, cudaStream_t stream) {
  constexpr int kPairs = kThreads / (D / kPerLane);
  const long long tiles = ((long long)s * g + kPairs - 1) / kPairs;
  const long long blocks = tiles * bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (causal)
    flash_attention_kernel<D, T, true><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(qt, kt, vt, ot, s, g,
                                                   (int)tiles, scale);
  else
    flash_attention_kernel<D, T, false><<<(unsigned)blocks, kThreads, 0,
                                          stream>>>(qt, kt, vt, ot, s, g,
                                                    (int)tiles, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int bh,
             int s, int g, int d, int causal, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_d<16, T>(q, k, v, out, bh, s, g, causal, scale, stream);
    case 32:
      return launch_d<32, T>(q, k, v, out, bh, s, g, causal, scale, stream);
    case 64:
      return launch_d<64, T>(q, k, v, out, bh, s, g, causal, scale, stream);
    case 128:
      return launch_d<128, T>(q, k, v, out, bh, s, g, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out all of it). d must be
// 16, 32, 64 or 128. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for an unsupported d / dtype or a
// grid past 2^31 - 1 blocks. Launches on `stream`, never synchronises.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int s, int g, int d, int dtype,
                                      int causal, float scale, void* stream) {
  if (bh <= 0 || s <= 0 || g <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_t<float>(q, k, v, out, bh, s, g, d, causal, scale, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, out, bh, s, g, d, causal, scale,
                                   st);
  return (int)cudaErrorInvalidValue;
}
