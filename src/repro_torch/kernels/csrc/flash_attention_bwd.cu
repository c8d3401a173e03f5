// flash_attention_bwd for Hopper (sm_90a): the gradients of flash attention
// (csrc/flash_attention.cu) from recomputed score tiles, on the tensor
// cores (mma.sync), with no S x S buffer.
//
// Replaces: src/repro/models/attention.py::_flash_core_bwd (the custom VJP
// of _flash_core; the Pallas kernel, src/repro/kernels/flash_attention.py,
// has no backward). In the kernel layout, q and dout [BH, S, G, D], k and
// v [BH, S, D], f32 or bf16, row-major; a bh's q rows are its M = S * G
// (position, head) pairs in q's order, row r at position r / G. With
// scale = D^-0.5, s = scale q k^T (causal: keys past the row's position
// masked), p = softmax(s), dp = dout v^T:
//     delta = sum_k p dp        ds = p (dp - delta)
//     dq = scale ds k           dk = scale ds^T q        dv = p^T dout
// dk and dv summed over all M rows (the G query heads of each kv head);
// each output in its input's dtype. delta is the plain version's sum_k p
// dp (kernels/ref.flash_attention_bwd_ref), not the reference's sum_d
// dout out: it keeps the backward consistent with the p it recomputes.
//
// Two kernels, launched one after the other on the caller's stream:
//   dq kernel, one CTA per (bh, 64 query rows): walks the visible key
//     tiles twice. The first walk takes the rows' max, sum and sum p dp
//     online (rescaled as the max grows), hence lse and delta, which it
//     writes ([BH, M] f32 scratch); the second forms p = exp(s - lse),
//     ds, and dq += ds k in registers.
//   dk/dv kernel, one CTA per (bh, 64 keys): walks the visible query
//     tiles (all G heads of each position), recomputes s^T and dp^T for
//     its keys from lse and delta, and adds dv += p^T dout and
//     dk += ds^T q in registers, in a fixed order.
// Each output element is written once, by one thread, after sums in a
// fixed order: no atomics, so two calls give bitwise equal outputs, and
// nothing is allocated or synchronised, so a CUDA graph captures it.
// Each CTA is four warps; a warp owns 16 rows (query rows in the dq
// kernel, keys in the dk/dv kernel) and takes the other side in chunks
// of 16 columns: a chunk's two score tiles (s and dp) live in registers
// as mma accumulators, become the A operand of the chunk's products, and
// are gone. Tiles of 64 (or 32) rows stream through shared memory,
// loaded by all threads in 16-byte vectors, rows past the end as zeros;
// rows are padded by 16 bytes, so a fragment's reads hit 32 banks.
// Causal: key tiles past a CTA's last row and query tiles before its
// first key are skipped, and so are a warp's chunks wholly masked.
//   bf16: mma.sync m16n8k16 (bf16 x bf16 -> f32); p and ds round to bf16
//   as the A operand of their products.
//   f32: 3xTF32, mma.sync m16n8k8: each operand x splits into hi (x with
//   its low 13 mantissa bits cleared) and lo (x - hi rounded to TF32),
//   and each product is lo.hi + hi.lo + hi.hi, about 2^-21 relative.
//
// Bound on the H100: five products of 2 BH G S^2 D FLOPs (s, dp, dv, dq,
// dk), halved when causal, at 989e12 bf16 FLOP/s (f32: 3 x at 495e12
// TF32), against q, k, v, dout read and dq, dk, dv written once at
// 3.35e12 B/s. At internlm2-1.8b's training step (BH 16, S 4,096, G 2,
// D 128, causal, bf16) the operations: 344 GFLOP, 0.347 ms. This kernel
// does nine products (s and dp in both kernels, and twice in the dq
// kernel's two walks), reads its fragments from shared memory one 32-bit
// word at a time (f32: split into TF32 halves at each read) and loads
// its tiles synchronously. Left for later: lse saved by the forward, the
// f32 halves split once a tile, a single pass in the FA2 manner, TMA
// loads into a ring, and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // four warps
constexpr int kWarpRows = 16;     // a warp's query rows (dq) or keys (dk/dv)
constexpr int kTileRows = 4 * kWarpRows;   // a CTA's
constexpr int kChunk = 16;        // columns of a score chunk
constexpr float kMasked = -1e30f;

// One instantiation's shapes: a shared tile's row stride kLd (D plus 16
// bytes), the rows of a streamed tile (keys in the dq kernel, query rows
// in the dk/dv kernel; 32 at D = 128 f32, so that two CTAs share an SM)
// and the dynamic shared memory of either kernel: two tiles of 64 rows,
// two streamed tiles, and the dk/dv kernel's lse and delta rows.
template <int D, typename T>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kLd = D + 16 / (int)sizeof(T);
  static constexpr int kStream = (kF32 && D == 128) ? 32 : 64;
  static constexpr int kSmem =
      (2 * kTileRows + 2 * kStream) * kLd * (int)sizeof(T) + 2 * kStream * 4;
};

// ---- PTX primitives
// d += a b on one warp: m16n8k16 bf16 / m16n8k8 tf32 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to TF32, to nearest with ties away from zero
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}
// ---- end of PTX primitives

// A warp's operands in the mma fragment layouts (PTX ISA, "Matrix
// fragments for mma.m16n8k16 / m16n8k8"): lane = 4 gq + tq; an
// accumulator c[0..3] holds (row gq, columns 2 tq, 2 tq + 1) and (row
// gq + 8, the same columns) of its 16 x 8 tile. Shared tiles are row
// major with row stride ld (elements). Loaders:
//   load_a(p):  A[row][k] = p[row * ld + k], 16 rows x kK
//   load_bt(p): B[k][n] = p[n * ld + k], kK x 8 (k runs along a row)
//   load_b(p):  B[k][n] = p[k * ld + n], kK x 8 (k runs down the rows),
//               with k in the order from_acc gives it
//   from_acc(x): the A operand of a product over kK columns of the
//               accumulators x[0 .. kK / 8 - 1] (16 x 8 each)
template <typename T>
struct Op;

template <>
struct Op<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ uint32_t word(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t half(const T* p) {
    return *reinterpret_cast<const uint16_t*>(p);
  }
  static __device__ __forceinline__ A load_a(const T* p, int ld, int gq,
                                             int tq) {
    A a;
    a.r[0] = word(p + gq * ld + 2 * tq);
    a.r[1] = word(p + (gq + 8) * ld + 2 * tq);
    a.r[2] = word(p + gq * ld + 2 * tq + 8);
    a.r[3] = word(p + (gq + 8) * ld + 2 * tq + 8);
    return a;
  }
  static __device__ __forceinline__ B load_bt(const T* p, int ld, int gq,
                                              int tq) {
    B b;
    b.r[0] = word(p + gq * ld + 2 * tq);
    b.r[1] = word(p + gq * ld + 2 * tq + 8);
    return b;
  }
  static __device__ __forceinline__ B load_b(const T* p, int ld, int gq,
                                             int tq) {
    B b;
    b.r[0] = half(p + 2 * tq * ld + gq) |
             half(p + (2 * tq + 1) * ld + gq) << 16;
    b.r[1] = half(p + (2 * tq + 8) * ld + gq) |
             half(p + (2 * tq + 9) * ld + gq) << 16;
    return b;
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ A from_acc(const float (*x)[4]) {
    A a;
    a.r[0] = pack(x[0][0], x[0][1]);
    a.r[1] = pack(x[0][2], x[0][3]);
    a.r[2] = pack(x[1][0], x[1][1]);
    a.r[3] = pack(x[1][2], x[1][3]);
    return a;
  }
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    mma_bf16(c, a.r, b.r);
  }
};

// f32 as 3xTF32. from_acc takes one accumulator (8 columns) as the k of
// an m16n8k8 product in the order (2 tq, 2 tq + 1) -> (tq, tq + 4), the
// A fragment's; load_b reads B's rows in the same order, so the sum over
// k is unchanged.
template <>
struct Op<float> {
  using T = float;
  static constexpr int kK = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    const float h = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
    hi = __float_as_uint(h);
    lo = __float_as_uint(tf32_rna(x - h));
  }
  static __device__ __forceinline__ A split_a(float x0, float x1, float x2,
                                              float x3) {
    A a;
    split(x0, a.hi[0], a.lo[0]);
    split(x1, a.hi[1], a.lo[1]);
    split(x2, a.hi[2], a.lo[2]);
    split(x3, a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ A load_a(const T* p, int ld, int gq,
                                             int tq) {
    return split_a(p[gq * ld + tq], p[(gq + 8) * ld + tq],
                   p[gq * ld + tq + 4], p[(gq + 8) * ld + tq + 4]);
  }
  static __device__ __forceinline__ B load_bt(const T* p, int ld, int gq,
                                              int tq) {
    B b;
    split(p[gq * ld + tq], b.hi[0], b.lo[0]);
    split(p[gq * ld + tq + 4], b.hi[1], b.lo[1]);
    return b;
  }
  static __device__ __forceinline__ B load_b(const T* p, int ld, int gq,
                                             int tq) {
    B b;
    split(p[2 * tq * ld + gq], b.hi[0], b.lo[0]);
    split(p[(2 * tq + 1) * ld + gq], b.hi[1], b.lo[1]);
    return b;
  }
  static __device__ __forceinline__ A from_acc(const float (*x)[4]) {
    return split_a(x[0][0], x[0][2], x[0][1], x[0][3]);
  }
  // the small products first
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

// c[j] (16 x 8, j = 0, 1) = X Y^T over D: X the warp's 16 rows and Y a
// chunk's 16 rows, both [rows, D] tiles in shared memory
template <int D, typename T>
__device__ __forceinline__ void chunk_scores(float (*c)[4], const T* x,
                                             const T* y, int ld, int gq,
                                             int tq) {
  using O = Op<T>;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / O::kK; ++kk) {
    const typename O::A a = O::load_a(x + kk * O::kK, ld, gq, tq);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      O::mma(c[j], a, O::load_bt(y + 8 * j * ld + kk * O::kK, ld, gq, tq));
  }
}

// acc (16 x D, acc[n] its columns 8n .. 8n + 7) += X Y: X the chunk's
// 16 x 16 accumulators x[0], x[1], Y a [16, D] tile in shared memory.
// Each 8 columns take the chunk's product in a fresh accumulator, added
// to acc by an f32 add: the tensor cores' own additions keep only the
// accumulator's precision, truncated, and over the thousands of chunks
// of a long sum (dk of key 0 over S G rows) that bias would add up.
template <int D, typename T>
__device__ __forceinline__ void add_chunk_product(float (*acc)[4],
                                                  const float (*x)[4],
                                                  const T* y, int ld, int gq,
                                                  int tq) {
  using O = Op<T>;
  constexpr int kSteps = kChunk / O::kK;
  typename O::A a[kSteps];
#pragma unroll
  for (int st = 0; st < kSteps; ++st)
    a[st] = O::from_acc(x + st * (O::kK / 8));
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      O::mma(part, a[st],
             O::load_b(y + st * O::kK * ld + 8 * n, ld, gq, tq));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// rows [r0, r0 + n) of a [rows, D] matrix into a shared tile of row
// stride LD, by every thread in 16-byte vectors; rows past `rows` zero
template <int D, int LD, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0,
                                          int n, int rows) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < n * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// dq, lse and delta: CTA (bh, query tile) of `tiles` a bh
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    T* __restrict__ dq, float* __restrict__ lse,
                    float* __restrict__ delta, int s, int g, int tiles,
                    int causal, float scale) {
  using C = Cfg<D, T>;
  constexpr int LD = C::kLd, NS = C::kStream;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kTileRows * LD;
  T* ks = dos + kTileRows * LD;
  T* vs = ks + NS * LD;

  const int m_rows = s * g;
  const int bh = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * kTileRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const size_t qoff = (size_t)bh * m_rows * D, koff = (size_t)bh * s * D;
  const int wr0 = m0 + warp * kWarpRows;     // the warp's first row
  const bool active = wr0 < m_rows;
  // keys the CTA and the warp see: causal, up to their last row's position
  int kend = s, wkend = s;
  if (causal) {
    kend = min(s, (min(m0 + kTileRows, m_rows) - 1) / g + 1);
    wkend = min(s, (min(wr0 + kWarpRows, m_rows) - 1) / g + 1);
  }
  const int ntiles = (kend + NS - 1) / NS;
  // the positions of this thread's rows wr0 + gq and wr0 + gq + 8
  const int qpos0 = (wr0 + gq) / g, qpos1 = (wr0 + gq + 8) / g;
  const T* qw = qs + warp * kWarpRows * LD;
  const T* dow = dos + warp * kWarpRows * LD;

  load_rows<D, LD>(qs, q + qoff, m0, kTileRows, m_rows);
  load_rows<D, LD>(dos, dout + qoff, m0, kTileRows, m_rows);

  float sc[2][4], dp[2][4];
  // sc[j][e] -> key k0 + 8j + 2tq + (e & 1) of row h = e >> 1: scaled,
  // -inf where masked or past S
  auto scaled = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * tq + (e & 1);
        const bool ok = kp < s && (!causal || kp <= ((e >> 1) ? qpos1
                                                              : qpos0));
        sc[j][e] = ok ? sc[j][e] * scale : -INFINITY;
      }
  };

  // walk 1: each row's max m, sum l and sum p dp (online)
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f},
        d_run[2] = {0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();                   // the previous tile is read
    load_rows<D, LD>(ks, k + koff, t * NS, NS, s);
    load_rows<D, LD>(vs, v + koff, t * NS, NS, s);
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < NS / kChunk; ++c) {
      const int k0 = t * NS + c * kChunk;
      if (k0 >= wkend) break;
      chunk_scores<D, T>(sc, qw, ks + c * kChunk * LD, LD, gq, tq);
      chunk_scores<D, T>(dp, dow, vs + c * kChunk * LD, LD, gq, tq);
      scaled(k0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // key 0 is in every row's first chunk, so m_run is finite after it
        const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
        const float corr = expf(m_run[h] - m_new);
        m_run[h] = m_new;
        l_run[h] *= corr;
        d_run[h] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = expf(sc[j][e] - m_run[h]);
          l_run[h] += p;
          d_run[h] += p * dp[j][e];
        }
    }
  }
  float lse_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = fmaxf(quad_sum(l_run[h]), 1e-30f);
    lse_r[h] = m_run[h] + logf(l);
    del_r[h] = quad_sum(d_run[h]) / l;
    const int r = wr0 + gq + 8 * h;
    if (active && tq == 0 && r < m_rows) {
      lse[(size_t)bh * m_rows + r] = lse_r[h];
      delta[(size_t)bh * m_rows + r] = del_r[h];
    }
  }

  // walk 2: p = exp(s - lse), ds = p (dp - delta), dq += ds k
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_rows<D, LD>(ks, k + koff, t * NS, NS, s);
    load_rows<D, LD>(vs, v + koff, t * NS, NS, s);
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < NS / kChunk; ++c) {
      const int k0 = t * NS + c * kChunk;
      if (k0 >= wkend) break;
      chunk_scores<D, T>(sc, qw, ks + c * kChunk * LD, LD, gq, tq);
      chunk_scores<D, T>(dp, dow, vs + c * kChunk * LD, LD, gq, tq);
      scaled(k0);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = expf(sc[j][e] - lse_r[h]);   // 0 where masked
          sc[j][e] = p * (dp[j][e] - del_r[h]);
        }
      add_chunk_product<D, T>(acc, sc, ks + c * kChunk * LD, LD, gq, tq);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + gq + 8 * h;
    if (active && r < m_rows) {
      T* out = dq + qoff + (size_t)r * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(out + 8 * n, acc[n][2 * h] * scale,
               acc[n][2 * h + 1] * scale);
    }
  }
}

// dk and dv: CTA (bh, key tile) of `tiles` a bh
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int s, int g, int tiles,
                      int causal, float scale) {
  using C = Cfg<D, T>;
  constexpr int LD = C::kLd, NS = C::kStream;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kTileRows * LD;
  T* qs = vs + kTileRows * LD;
  T* dos = qs + NS * LD;
  float* lses = reinterpret_cast<float*>(dos + NS * LD);
  float* dels = lses + NS;

  const int m_rows = s * g;
  const int bh = blockIdx.x / tiles;
  const int n0 = (blockIdx.x % tiles) * kTileRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const size_t qoff = (size_t)bh * m_rows * D, koff = (size_t)bh * s * D;
  const size_t roff = (size_t)bh * m_rows;
  const int kw0 = n0 + warp * kWarpRows;     // the warp's first key
  const bool active = kw0 < s;
  // this thread's keys kw0 + gq and kw0 + gq + 8
  const int key0 = kw0 + gq, key1 = kw0 + gq + 8;
  // causal: rows before the CTA's (the warp's) first key times G see none
  // of its keys
  const int t0 = causal ? n0 * g / NS : 0;
  const int wfirst = causal ? kw0 * g : 0;
  const int ntiles = (m_rows + NS - 1) / NS;
  const T* kw = ks + warp * kWarpRows * LD;
  const T* vw = vs + warp * kWarpRows * LD;

  load_rows<D, LD>(ks, k + koff, n0, kTileRows, s);
  load_rows<D, LD>(vs, v + koff, n0, kTileRows, s);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  float st[2][4], dpt[2][4];
  for (int t = t0; t < ntiles; ++t) {
    const int r0 = t * NS;
    __syncthreads();
    load_rows<D, LD>(qs, q + qoff, r0, NS, m_rows);
    load_rows<D, LD>(dos, dout + qoff, r0, NS, m_rows);
    for (int i = threadIdx.x; i < NS; i += kThreads) {
      const bool in = r0 + i < m_rows;
      lses[i] = in ? lse[roff + r0 + i] : 0.f;
      dels[i] = in ? delta[roff + r0 + i] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < NS / kChunk; ++c) {
      const int rc = r0 + c * kChunk;
      if (rc >= m_rows) break;
      if (rc + kChunk <= wfirst) continue;     // wholly masked
      // s^T and dp^T: the warp's 16 keys x the chunk's 16 rows
      chunk_scores<D, T>(st, kw, qs + c * kChunk * LD, LD, gq, tq);
      chunk_scores<D, T>(dpt, vw, dos + c * kChunk * LD, LD, gq, tq);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = (e >> 1) ? key1 : key0;
          const int rl = c * kChunk + 8 * j + 2 * tq + (e & 1);
          const int r = r0 + rl;
          // kp <= r / g, as kp * g <= r
          const bool ok = kp < s && r < m_rows && (!causal || kp * g <= r);
          const float p = ok ? expf(st[j][e] * scale - lses[rl]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dels[rl]);
        }
      add_chunk_product<D, T>(dva, st, dos + c * kChunk * LD, LD, gq, tq);
      add_chunk_product<D, T>(dka, dpt, qs + c * kChunk * LD, LD, gq, tq);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = h ? key1 : key0;
    if (active && kp < s) {
      const size_t at = koff + (size_t)kp * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        store2(dk + at + 8 * n, dka[n][2 * h] * scale,
               dka[n][2 * h + 1] * scale);
        store2(dv + at + 8 * n, dva[n][2 * h], dva[n][2 * h + 1]);
      }
    }
  }
}

// ---- host
template <int D, typename T>
int launch_d(const void* q, const void* k, const void* v, const void* dout,
             void* dq, void* dk, void* dv, void* lse, void* delta, int bh,
             int s, int g, int causal, float scale, cudaStream_t stream) {
  using C = Cfg<D, T>;
  const long long m = (long long)s * g;
  if (m > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  const long long qtiles = (m + kTileRows - 1) / kTileRows;
  const long long ktiles = ((long long)s + kTileRows - 1) / kTileRows;
  if (qtiles * bh > INT_MAX || ktiles * bh > INT_MAX)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;   // per instantiation, before its first launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  float* lsef = static_cast<float*>(lse);
  float* delf = static_cast<float*>(delta);
  flash_bwd_dq_kernel<D, T>
      <<<(unsigned)(qtiles * bh), kThreads, C::kSmem, stream>>>(
          qt, kt, vt, dot, static_cast<T*>(dq), lsef, delf, s, g,
          (int)qtiles, causal, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D, T>
      <<<(unsigned)(ktiles * bh), kThreads, C::kSmem, stream>>>(
          qt, kt, vt, dot, lsef, delf, static_cast<T*>(dk),
          static_cast<T*>(dv), s, g, (int)ktiles, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const void* dout,
             void* dq, void* dk, void* dv, void* lse, void* delta, int bh,
             int s, int g, int d, int causal, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_d<16, T>(q, k, v, dout, dq, dk, dv, lse, delta, bh, s, g,
                             causal, scale, stream);
    case 32:
      return launch_d<32, T>(q, k, v, dout, dq, dk, dv, lse, delta, bh, s, g,
                             causal, scale, stream);
    case 64:
      return launch_d<64, T>(q, k, v, dout, dq, dk, dv, lse, delta, bh, s, g,
                             causal, scale, stream);
    case 128:
      return launch_d<128, T>(q, k, v, dout, dq, dk, dv, lse, delta, bh, s,
                              g, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk and dv all of
// it); lse and delta are [bh, s * g] float32 scratch. d must be 16, 32, 64
// or 128; q, k, v and dout 16-byte aligned. Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for an
// unsupported d / dtype or a grid past 2^31 - 1 blocks. Launches both
// kernels on `stream`, never synchronises.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          void* dq, void* dk, void* dv,
                                          void* lse, void* delta, int bh,
                                          int s, int g, int d, int dtype,
                                          int causal, float scale,
                                          void* stream) {
  if (bh <= 0 || s <= 0 || g <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_t<float>(q, k, v, dout, dq, dk, dv, lse, delta, bh, s, g,
                           d, causal, scale, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, lse, delta, bh,
                                   s, g, d, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
