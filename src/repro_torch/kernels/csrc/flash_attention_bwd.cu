// flash_attention_bwd for Hopper (sm_90a): the gradients of flash attention
// (csrc/flash_attention.cu) from recomputed score tiles, on the tensor
// cores, with no S x S buffer.
//
// Replaces: src/repro/models/attention.py::_flash_core_bwd (the custom VJP
// of _flash_core; the Pallas kernel, src/repro/kernels/flash_attention.py,
// has no backward). In the kernel layout, q, out and dout [BH, S, G, D],
// k and v [BH, S, D], f32 or bf16, row-major, and lse [BH, S G] f32 (the
// forward's per-row log-sum-exp of its scaled scores); a bh's q rows are
// its M = S * G (position, head) pairs in q's order, row r at position
// r / G. With scale = D^-0.5, s = q k^T (causal: keys past the row's
// position masked), dp = dout v^T:
//     ds = p (dp - delta)
//     dq = scale ds k            dk = scale ds^T q        dv = p^T dout
// dk and dv summed over all M rows (the G query heads of each kv head);
// each output in its input's dtype. p and delta by route:
//   bf16, as the reference's _flash_core_bwd: p = exp(scale s - lse) from
//   the forward's lse, delta = sum_d dout out from the forward's out.
//   f32: p normalised over the scores this kernel recomputes, delta =
//   sum_k p dp (the softmax's VJP, as XLA differentiates the reference
//   ViT's softmax). The two deltas are equal in exact arithmetic, but the
//   forward's out and lse carry its own rounding: set against p recomputed
//   here, sum_k ds is then not zero, and times the keys' common component
//   it moved DINO's 400x400 wq / wk gradients by 1.5e-3 of their largest
//   entry. The plain version (kernels/ref.flash_attention_bwd_ref) takes
//   the same route by dtype.
//
// Bound on the H100: five products of 2 BH G S^2 D FLOPs (s, dp, dv, dq,
// dk), halved when causal, at 989e12 bf16 FLOP/s (f32: 3 x at 495e12
// TF32), against q, k, v, out, dout, lse read and dq, dk, dv written once
// at 3.35e12 B/s: the operations bound it at every path's shape but
// DINO's 64x64. At internlm2-1.8b's training step (BH 16, S 4,096, G 2,
// D 128, causal, bf16): 344 GFLOP, 0.347 ms; DINO's 400x400 patches (BH
// 48, S 626, D 64, f32): 0.073 ms.
//
// Design. Two kernels a call, launched one after the other on the
// caller's stream, and a third where the dk / dv kernel splits:
//   dq kernel, one CTA per (bh, query tile): bf16 computes delta for its
//     rows from dout and out and walks the visible key tiles once: s, dp
//     and dq += ds k (three products); f32 walks them twice, first for
//     each row's sum of p and of p dp (from the forward's lse, so no
//     online rescale; the backward's own lse and delta follow), then for
//     ds and dq (five products). Both write delta (f32 also its lse) as
//     [BH, M] f32 scratch for the dk / dv kernel.
//   dk / dv kernel, one CTA per (bh, key tile, split): walks the visible
//     query tiles (all G heads of each position), recomputes s^T and dp^T
//     for its keys, and adds dv += p^T dout and dk += ds^T q (four
//     products). Where BH times the key tiles gives fewer CTAs than SMs
//     (the mesh MoE's BH 1, 64 key tiles), each key tile's visible
//     query tiles are split evenly over several CTAs (a causal key tile by
//     the rows it sees), each writing f32 partials ([2, splits, BH, S,
//     D]); a third kernel adds them in split order and casts.
// Each output element is written once, by one thread, after sums in a
// fixed order: no atomics, so two calls give bitwise equal outputs, and
// nothing is allocated or synchronised, so a CUDA graph captures it.
// Causal: key tiles past a CTA's last row and query tiles before its
// first key are skipped, and the heaviest CTAs come first in the grid.
// p is exp2 of one FMA (the lse kept in log2 units), and the masks are
// tested only on the tiles that cross S, M or the diagonal.
//   bf16: warp-specialised, wgmma from TMA-loaded tiles (hopper.cuh, as
//   the forward). A CTA is a producer warpgroup (one thread issues the
//   TMA loads; setmaxnreg hands its registers to the consumers) and two
//   consumer warpgroups of 64 rows (dq: query rows; dk / dv: keys). The
//   resident pair (Q and dO, or K and V, 128 rows) loads once; the other
//   side streams in tiles of 64 rows through a two-stage ring with full /
//   empty mbarriers (the dk / dv kernel's ring also carries each tile's
//   lse and delta rows, which the producer writes). s and dp (or s^T and
//   dp^T) are wgmma m64nNk16 from shared memory, both operands K-major as
//   stored; p and ds stay in registers and are the register A operand of
//   dq += ds k, dv += p^T dout and dk += ds^T q, whose B (k, dout, q) is
//   read MN-major through the descriptor's transpose bit. The dk / dv
//   kernel takes each tile in two halves of 32 rows: beside its two
//   64 x D sums a whole tile's two 64 x 64 score blocks do not fit in
//   registers. The sums chain in the tensor cores across tiles, as the
//   forward's O does.
//   f32: 3xTF32 on mma.sync m16n8k8 (TF32 wgmma wants both operands
//   K-major, which dq += ds k and dk += ds^T q are not): each operand x
//   splits into hi (x with its low 13 mantissa bits cleared) and lo (x -
//   hi rounded to TF32), and each product is lo.hi + hi.lo + hi.hi, about
//   2^-21 relative. Every tile is split once as it lands in shared memory
//   (hi, then lo beside it), so fragment loads read ready halves; up to
//   D = 64 the dq kernel keeps its warps' Q and dO fragments in registers
//   for both walks. A warp owns 16 rows; tiles load by all threads in
//   16-byte vectors, rows past the end as zeros, rows padded by 16 bytes
//   so that a fragment's reads hit 32 banks. At D = 128 the resident
//   split tiles take 135 KB, so one CTA fits an SM: it holds two groups
//   of four warps that share them, each walking every other streamed
//   tile, and adds the two groups' sums in a fixed order at the end.
//   Each chunk's product is added in a fresh accumulator and folded into
//   the sum by an f32 add: the tensor cores' own additions truncate, and
//   over the thousands of chunks of a long sum (dk of key 0 over S G
//   rows) that bias would add up.
// What bounds it now: seven products (bf16) or nine (f32) where the bound
// counts five, the softmax between the products of a warpgroup, and for
// f32 the shared-memory bytes of the mma.sync fragments. Left for later:
// TF32 wgmma for f32 (dout and q transposed in shared memory), a single
// pass with dq summed in a fixed order, overlap of the next tile's s with
// this tile's ds, a persistent grid.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

// a dk / dv grid below one CTA an SM splits, to about kSplitWaves CTAs an
// SM (at two waves or more, as at BH 8, S 4,096, splits only add partials)
constexpr int kSplitWaves = 2;
constexpr int kMaxSplits = 16;

// p = exp(scale s - lse) as exp2(s sl2 - lse2), with sl2 = scale log2(e)
// and lse2 = lse log2(e): one FMA and the hardware's exp2 (relative error
// about 2^-22; below 2^-126 it flushes to 0)
__device__ __forceinline__ float prob(float s, float sl2, float lse2) {
  return ex2(fmaf(s, sl2, -lse2));
}

// ---- the f32 route: 3xTF32 on mma.sync, every tile split once

constexpr int kThreads = 128;     // a warp group: four warps
constexpr int kWarpRows = 16;     // a warp's query rows (dq) or keys (dk/dv)
constexpr int kTileRows = 4 * kWarpRows;   // a CTA's
constexpr int kChunk = 16;        // columns of a score chunk (dq kernel)

// One instantiation's shapes: a tile's row stride kLd (D plus 16 bytes),
// the rows of a streamed tile (keys in the dq kernel, query rows in the
// dk/dv kernel), the warp groups of a CTA and the dynamic shared memory
// of either kernel: two resident tiles of 64 rows, each group's two
// streamed tiles, each tile as hi then lo, and each group's lse and delta
// rows. At D = 128 the resident tiles alone take 135 KB, so one CTA fits
// an SM: two warp groups share them, each walking every other streamed
// tile, and add their sums at the end.
template <int D>
struct F32Cfg {
  static constexpr int kLd = D + 4;
  static constexpr int kGroups = D == 128 ? 2 : 1;
  static constexpr int kStream = D == 128 ? 16 : D == 64 ? 32 : 64;
  static __host__ __device__ constexpr int tile(int rows) {   // floats
    return 2 * rows * kLd;
  }
  static constexpr int kGroupFloats = 2 * tile(kStream) + 2 * kStream;
  // and the dq kernel's two sums of each of its rows
  static constexpr int kSmem =
      (2 * tile(kTileRows) + kGroups * kGroupFloats + 2 * kTileRows) * 4;
};

// a warp group's own barrier (ids 1, 2; 0 is __syncthreads)
template <int G>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (G == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(kThreads)
                 : "memory");
}

// two warp groups' register sums into group 0's, group 1's added after
// group 0's own (a fixed order), through the shared memory at red
// (kThreads * N floats, free once both groups are past their walks)
template <int G, int N>
__device__ __forceinline__ void add_groups(float* acc, float* red, int grp,
                                           int gtid) {
  if constexpr (G == 2) {
    __syncthreads();
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) red[i * kThreads + gtid] = acc[i];
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += red[i * kThreads + gtid];
    }
  }
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's operands in the m16n8k8 fragment layouts (PTX ISA, "Matrix
// fragments for mma.m16n8k8"): lane = 4 gq + tq; an accumulator c[0..3]
// holds (row gq, columns 2 tq, 2 tq + 1) and (row gq + 8, the same
// columns) of its 16 x 8 tile. A split tile is row major with row stride
// LD (floats), its hi half at p and its lo half at p + lo. Loaders:
//   load_a(p):  A[row][k] = p[row * LD + k], 16 rows x 8
//   load_bt(p): B[k][n] = p[n * LD + k], 8 x 8 (k runs along a row)
//   load_b(p):  B[k][n] = p[k * LD + n], 8 x 8 (k runs down the rows), k
//               in the order from_acc gives it
//   from_acc(x): the A operand of a product over the 8 columns of the
//               accumulator x, taken in the order (2 tq, 2 tq + 1) ->
//               (tq, tq + 4), the A fragment's; load_b reads B's rows in
//               the same order, so the sum over k is unchanged
template <int LD>
struct Op {
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  static __device__ __forceinline__ uint32_t u(float x) {
    return __float_as_uint(x);
  }
  static __device__ __forceinline__ A load_a(const float* p, int lo, int gq,
                                             int tq) {
    const int at[4] = {gq * LD + tq, (gq + 8) * LD + tq, gq * LD + tq + 4,
                       (gq + 8) * LD + tq + 4};
    A a;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a.hi[e] = u(p[at[e]]);
      a.lo[e] = u(p[lo + at[e]]);
    }
    return a;
  }
  static __device__ __forceinline__ B load_bt(const float* p, int lo, int gq,
                                              int tq) {
    const int at[2] = {gq * LD + tq, gq * LD + tq + 4};
    B b;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b.hi[e] = u(p[at[e]]);
      b.lo[e] = u(p[lo + at[e]]);
    }
    return b;
  }
  static __device__ __forceinline__ B load_b(const float* p, int lo, int gq,
                                             int tq) {
    const int at[2] = {2 * tq * LD + gq, (2 * tq + 1) * LD + gq};
    B b;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b.hi[e] = u(p[at[e]]);
      b.lo[e] = u(p[lo + at[e]]);
    }
    return b;
  }
  static __device__ __forceinline__ A from_acc(const float* x) {
    const float v[4] = {x[0], x[2], x[1], x[3]};
    A a;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32_hi(v[e]);
      a.hi[e] = u(h);
      a.lo[e] = u(tf32_rna(v[e] - h));
    }
    return a;
  }
  // the small products first
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

// rows [r0, r0 + n) of a [rows, D] f32 matrix into a split tile of row
// stride LD (hi at dst, lo at dst + lo), by nthr threads from tid in
// 16-byte vectors; rows past `rows` zero
template <int D, int LD>
__device__ __forceinline__ void load_split(float* dst, int lo,
                                           const float* src, int r0, int n,
                                           int rows, int tid, int nthr) {
  constexpr int kPerRow = D / 4;
  for (int i = tid; i < n * kPerRow; i += nthr) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows)
      x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + c);
    const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z),
                                 tf32_hi(x.w));
    *reinterpret_cast<float4*>(dst + r * LD + c) = h;
    *reinterpret_cast<float4*>(dst + lo + r * LD + c) =
        make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y),
                    tf32_rna(x.z - h.z), tf32_rna(x.w - h.w));
  }
}

// c[j] (16 x 8, j < J) = X Y^T over D: X the warp's 16 rows and Y a
// chunk's 8 J rows, split tiles in shared memory (lo halves at + xl, yl)
template <int D, int LD, int J>
__device__ __forceinline__ void chunk_scores(float (*c)[4], const float* x,
                                             int xl, const float* y, int yl,
                                             int gq, int tq) {
  using O = Op<LD>;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const typename O::A a = O::load_a(x + kk * 8, xl, gq, tq);
#pragma unroll
    for (int j = 0; j < J; ++j)
      O::mma(c[j], a, O::load_bt(y + 8 * j * LD + kk * 8, yl, gq, tq));
  }
}

// chunk_scores with X's fragments already in registers: a[kk] those of
// columns 8 kk .. 8 kk + 7
template <int D, int LD, int J>
__device__ __forceinline__ void chunk_scores_reg(
    float (*c)[4], const typename Op<LD>::A* a, const float* y, int yl,
    int gq, int tq) {
  using O = Op<LD>;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int j = 0; j < J; ++j)
      O::mma(c[j], a[kk], O::load_bt(y + 8 * j * LD + kk * 8, yl, gq, tq));
}

// acc (16 x D, acc[n] its columns 8n .. 8n + 7) += X Y: X the chunk's
// 16 x 8 J accumulators x[j], Y a [8 J, D] split tile (lo at + yl). Each
// 8 columns take the chunk's product in a fresh accumulator, added to acc
// by an f32 add.
template <int D, int LD, int J>
__device__ __forceinline__ void add_chunk_product(float (*acc)[4],
                                                  const float (*x)[4],
                                                  const float* y, int yl,
                                                  int gq, int tq) {
  using O = Op<LD>;
  typename O::A a[J];
#pragma unroll
  for (int j = 0; j < J; ++j) a[j] = O::from_acc(x[j]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < J; ++j)
      O::mma(part, a[j], O::load_b(y + j * 8 * LD + 8 * n, yl, gq, tq));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// delta = sum_d dout out (bf16) of `rows` rows from row r0 of a bh (two
// threads a row, each half of D, then added); written to dels[0 .. rows)
// and, for rows below m_rows, to delta. nthr threads from thread tid.
template <int D>
__device__ __forceinline__ void row_deltas(const bf16* out, const bf16* dout,
                                           float* dels, float* delta,
                                           int r0, int rows, int m_rows,
                                           int tid, int nthr) {
  for (int i = tid; i < 2 * rows; i += nthr) {
    const int lr = i / 2, r = r0 + lr;
    float acc = 0.f;
    if (r < m_rows) {
      const uint4* o = reinterpret_cast<const uint4*>(
          out + (size_t)r * D + (i % 2) * (D / 2));
      const uint4* d = reinterpret_cast<const uint4*>(
          dout + (size_t)r * D + (i % 2) * (D / 2));
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {     // 8 elements a 16-byte load
        const uint4 a = o[c], b = d[c];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]);
          const float2 y = __bfloat1622float2(b2[e]);
          acc += x.x * y.x;
          acc += x.y * y.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);   // i, i ^ 1 in one warp
    if (i % 2 == 0) {
      dels[lr] = acc;
      if (r < m_rows) delta[r] = acc;
    }
  }
}

// a warp group's walk over its key tiles (every G-th from its group's
// index) of the dq kernel: the tile's K and V split into the group's
// shared tiles (unless `load` is false: a group's one tile, still there
// from the walk before), then body(k0, c) for each of its 16-key chunks
// that the warp's rows see
template <int D, int G, typename Body>
__device__ __forceinline__ void walk_keys(float* ks, float* vs,
                                          const float* k, const float* v,
                                          int s, int ntiles, int wkend,
                                          bool active, int grp, int gtid,
                                          bool load, Body body) {
  constexpr int LD = F32Cfg<D>::kLd, NS = F32Cfg<D>::kStream;
  for (int t = grp; t < ntiles; t += G) {
    if (load) {
      group_sync<G>(grp);              // the previous tile is read
      load_split<D, LD>(ks, NS * LD, k, t * NS, NS, s, gtid, kThreads);
      load_split<D, LD>(vs, NS * LD, v, t * NS, NS, s, gtid, kThreads);
      group_sync<G>(grp);
    }
    if (!active) continue;
    for (int c = 0; c < NS / kChunk; ++c) {
      const int k0 = t * NS + c * kChunk;
      if (k0 >= wkend) break;
      body(k0, c);
    }
  }
}

// dq, lse and delta (f32): CTA (bh, query tile), the last tiles first.
// Two walks over the visible key tiles. The first takes, for each row, l
// = sum_k exp(scale s - lse) and d = sum_k exp(scale s - lse) dp, with
// the forward's lse as the offset (so no online rescale), and from them
// the backward's own lse + log l and delta = d / l (sum_k p dp, the
// softmax's VJP): p then sums to one over the very scores this kernel
// recomputes, so ds = p (dp - delta) sums to zero over each row whatever
// the forward's rounding. The second walk forms ds and dq += ds k.
template <int D>
__global__ void __launch_bounds__(kThreads * F32Cfg<D>::kGroups)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lse,
                 const float* __restrict__ dout, float* __restrict__ dq,
                 float* __restrict__ lse_b, float* __restrict__ delta,
                 int bhn, int s, int g, int tiles, int causal, float scale) {
  using C = F32Cfg<D>;
  constexpr int LD = C::kLd, NS = C::kStream, G = C::kGroups;
  constexpr int QL = kTileRows * LD, SL = NS * LD;   // lo offsets
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + C::tile(kTileRows);
  float* group_s = dos + C::tile(kTileRows);
  const int grp = threadIdx.x / kThreads, gtid = threadIdx.x % kThreads;
  float* ks = group_s + grp * C::kGroupFloats;
  float* vs = ks + C::tile(NS);

  const int m_rows = s * g;
  const int bh = blockIdx.x % bhn;
  const int m0 = (tiles - 1 - blockIdx.x / bhn) * kTileRows;
  const int warp = gtid / 32, lane = gtid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const size_t qoff = (size_t)bh * m_rows * D, koff = (size_t)bh * s * D;
  const size_t roff = (size_t)bh * m_rows;
  const int wr0 = m0 + warp * kWarpRows;     // the warp's first row
  const bool active = wr0 < m_rows;
  // keys the CTA and the warp see: causal, up to their last row's position
  int kend = s, wkend = s;
  if (causal) {
    kend = min(s, (min(m0 + kTileRows, m_rows) - 1) / g + 1);
    wkend = min(s, (min(wr0 + kWarpRows, m_rows) - 1) / g + 1);
  }
  const int ntiles = (kend + NS - 1) / NS;
  const int qpos0 = (wr0 + gq) / g, qpos1 = (wr0 + gq + 8) / g;
  const float* qw = qs + warp * kWarpRows * LD;
  const float* dow = dos + warp * kWarpRows * LD;

  load_split<D, LD>(qs, QL, q + qoff, m0, kTileRows, m_rows, threadIdx.x,
                    G * kThreads);
  load_split<D, LD>(dos, QL, dout + qoff, m0, kTileRows, m_rows,
                    threadIdx.x, G * kThreads);
  __syncthreads();
  float lse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + gq + 8 * h;
    lse_r[h] = r < m_rows ? lse[roff + r] * kLog2e : 0.f;
  }
  const float sl2 = scale * kLog2e;
  // up to D = 64 the warp's Q and dO fragments stay in registers for both
  // walks (at D = 128 they would take all of them)
  using O = Op<LD>;
  constexpr bool kRegA = D <= 64;
  typename O::A qa[kRegA ? D / 8 : 1], oa[kRegA ? D / 8 : 1];
  if constexpr (kRegA) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      qa[kk] = O::load_a(qw + kk * 8, QL, gq, tq);
      oa[kk] = O::load_a(dow + kk * 8, QL, gq, tq);
    }
  }
  float sc[2][4], dp[2][4];
  // s and dp of the warp's rows against a chunk's 16 keys, and p =
  // exp(scale s - lse) (0 where masked; masks only where the chunk
  // crosses S or the warp's diagonal)
  auto scores = [&](int k0, int c) {
    if constexpr (kRegA) {
      chunk_scores_reg<D, LD, 2>(sc, qa, ks + c * kChunk * LD, SL, gq, tq);
      chunk_scores_reg<D, LD, 2>(dp, oa, vs + c * kChunk * LD, SL, gq, tq);
    } else {
      chunk_scores<D, LD, 2>(sc, qw, QL, ks + c * kChunk * LD, SL, gq, tq);
      chunk_scores<D, LD, 2>(dp, dow, QL, vs + c * kChunk * LD, SL, gq,
                             tq);
    }
    const bool edge =
        k0 + kChunk > s || (causal && k0 + kChunk - 1 > wr0 / g);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, kp = k0 + 8 * j + 2 * tq + (e & 1);
        const bool ok = !edge || (kp < s && (!causal ||
                                             kp <= (h ? qpos1 : qpos0)));
        sc[j][e] = ok ? prob(sc[j][e], sl2, lse_r[h]) : 0.f;
      }
  };

  // walk 1: l and d for each row
  float l_run[2] = {0.f, 0.f}, d_run[2] = {0.f, 0.f};
  walk_keys<D, G>(ks, vs, k + koff, v + koff, s, ntiles, wkend, active,
                  grp, gtid, true, [&](int k0, int c) {
    scores(k0, c);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        l_run[e >> 1] += sc[j][e];
        d_run[e >> 1] += sc[j][e] * dp[j][e];
      }
  });
  // each row's sums over its quad, then group 1's added to group 0's;
  // the backward's lse (log2 units) and delta to both groups
  float* rowsum = group_s + G * C::kGroupFloats;   // [64 rows][2]
  float del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = warp * kWarpRows + gq + 8 * h;
    float l = quad_sum(l_run[h]), d = quad_sum(d_run[h]);
    if (G == 2 && grp == 1 && tq == 0) {
      rowsum[2 * lr] = l;
      rowsum[2 * lr + 1] = d;
    }
    if constexpr (G == 2) {
      __syncthreads();
      if (grp == 0) {
        l += rowsum[2 * lr];
        d += rowsum[2 * lr + 1];
      }
      __syncthreads();
    }
    l = fmaxf(l, 1e-30f);
    if (grp == 0 && tq == 0) {
      rowsum[2 * lr] = lse_r[h] + log2f(l);
      rowsum[2 * lr + 1] = d / l;
      const int r = wr0 + gq + 8 * h;
      if (active && r < m_rows) {
        lse_b[roff + r] = lse_r[h] + log2f(l);
        delta[roff + r] = d / l;
      }
    }
    if constexpr (G == 2) __syncthreads();
    lse_r[h] = G == 2 ? rowsum[2 * lr] : lse_r[h] + log2f(l);
    del_r[h] = G == 2 ? rowsum[2 * lr + 1] : d / l;
  }

  // walk 2: p = exp(scale s - lse), ds = p (dp - delta), dq += ds k;
  // where each group has one key tile, it is still in shared memory
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  walk_keys<D, G>(ks, vs, k + koff, v + koff, s, ntiles, wkend, active,
                  grp, gtid, ntiles > G, [&](int k0, int c) {
    scores(k0, c);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] *= dp[j][e] - del_r[e >> 1];
    add_chunk_product<D, LD, 2>(acc, sc, ks + c * kChunk * LD, SL, gq, tq);
  });
  add_groups<G, D / 2>(&acc[0][0], group_s, grp, gtid);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + gq + 8 * h;
    if (grp == 0 && active && r < m_rows) {
      float* o = dq + qoff + (size_t)r * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(o + 8 * n, acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

// the query tiles [tb, te) of split z of a key tile whose visible tiles
// are [t0, nt): an even share of them
__device__ __forceinline__ void split_range(int t0, int nt, int z,
                                            int splits, int& tb, int& te) {
  const long long n = nt - t0;
  tb = t0 + (int)(n * z / splits);
  te = t0 + (int)(n * (z + 1) / splits);
}

// the CTA's (bh, key tile, split) of blockIdx.x: key tile 0 first (under
// causal masking it sees the most rows)
struct DkdvBlock {
  int bh, kt, z;
  __device__ DkdvBlock(int bhn, int splits) {
    bh = blockIdx.x % bhn;
    const int rest = blockIdx.x / bhn;
    z = rest % splits;
    kt = rest / splits;
  }
};

// a key's dk (scaled) and dv: to the outputs, or as split z's partials
// part [2, splits, BH, S, D] f32
template <typename T>
__device__ __forceinline__ void store_dkdv(T* dk, T* dv, float* part,
                                           size_t at, size_t plane, int z,
                                           int splits, float k0, float k1,
                                           float v0, float v1, float scale) {
  if (splits == 1) {
    store2(dk + at, k0 * scale, k1 * scale);
    store2(dv + at, v0, v1);
  } else {
    store2(part + z * plane + at, k0, k1);
    store2(part + (splits + z) * plane + at, v0, v1);
  }
}

// dk and dv (f32): CTA (bh, key tile of 64, split), from the dq kernel's
// lse (log2 units) and delta
template <int D>
__global__ void __launch_bounds__(kThreads * F32Cfg<D>::kGroups)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, float* __restrict__ part, int bhn,
                   int s, int g, int splits, int causal, float scale) {
  using C = F32Cfg<D>;
  constexpr int LD = C::kLd, NS = C::kStream, G = C::kGroups;
  constexpr int KL = kTileRows * LD, SL = NS * LD;   // lo offsets
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + C::tile(kTileRows);
  float* group_s = vs + C::tile(kTileRows);
  const int grp = threadIdx.x / kThreads, gtid = threadIdx.x % kThreads;
  float* qs = group_s + grp * C::kGroupFloats;
  float* dos = qs + C::tile(NS);
  float* lses = dos + C::tile(NS);
  float* dels = lses + NS;

  const DkdvBlock blk(bhn, splits);
  const int bh = blk.bh;
  const int m_rows = s * g;
  const int n0 = blk.kt * kTileRows;
  const int warp = gtid / 32, lane = gtid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const size_t qoff = (size_t)bh * m_rows * D, koff = (size_t)bh * s * D;
  const size_t roff = (size_t)bh * m_rows;
  const int kw0 = n0 + warp * kWarpRows;     // the warp's first key
  const bool active = kw0 < s;
  const int key0 = kw0 + gq, key1 = kw0 + gq + 8;
  // causal: rows before the CTA's (the warp's) first key times G see none
  // of its keys
  const int t0 = causal ? n0 * g / NS : 0;
  const int wfirst = causal ? kw0 * g : 0;
  int tb, te;
  split_range(t0, (m_rows + NS - 1) / NS, blk.z, splits, tb, te);
  const float* kw = ks + warp * kWarpRows * LD;
  const float* vw = vs + warp * kWarpRows * LD;

  load_split<D, LD>(ks, KL, k + koff, n0, kTileRows, s, threadIdx.x,
                    G * kThreads);
  load_split<D, LD>(vs, KL, v + koff, n0, kTileRows, s, threadIdx.x,
                    G * kThreads);
  __syncthreads();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  // query rows a chunk: 8 at D = 128, whose dk and dv sums fill half the
  // registers, else 16
  constexpr int J = D == 128 ? 1 : 2, CR = 8 * J;
  const float sl2 = scale * kLog2e;
  float st[J][4], dpt[J][4];
  // group grp takes every G-th query tile of the split's
  for (int t = tb + grp; t < te; t += G) {
    const int r0 = t * NS;
    group_sync<G>(grp);
    load_split<D, LD>(qs, SL, q + qoff, r0, NS, m_rows, gtid, kThreads);
    load_split<D, LD>(dos, SL, dout + qoff, r0, NS, m_rows, gtid, kThreads);
    for (int i = gtid; i < NS; i += kThreads) {
      const bool in = r0 + i < m_rows;
      lses[i] = in ? lse2[roff + r0 + i] : 0.f;
      dels[i] = in ? delta[roff + r0 + i] : 0.f;
    }
    group_sync<G>(grp);
    if (!active) continue;
    for (int c = 0; c < NS / CR; ++c) {
      const int rc = r0 + c * CR;
      if (rc >= m_rows) break;
      if (rc + CR <= wfirst) continue;     // wholly masked
      // s^T and dp^T: the warp's 16 keys x the chunk's CR rows
      chunk_scores<D, LD, J>(st, kw, KL, qs + c * CR * LD, SL, gq, tq);
      chunk_scores<D, LD, J>(dpt, vw, KL, dos + c * CR * LD, SL, gq, tq);
      // (masked everywhere: a mask-free copy of this loop for the inner
      // chunks would not fit in registers beside the dk and dv sums)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = (e >> 1) ? key1 : key0;
          const int rl = c * CR + 8 * j + 2 * tq + (e & 1);
          const int r = r0 + rl;
          // kp <= r / g, as kp * g <= r
          const bool ok = kp < s && r < m_rows && (!causal || kp * g <= r);
          const float p = ok ? prob(st[j][e], sl2, lses[rl]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dels[rl]);
        }
      add_chunk_product<D, LD, J>(dva, st, dos + c * CR * LD, SL, gq, tq);
      add_chunk_product<D, LD, J>(dka, dpt, qs + c * CR * LD, SL, gq, tq);
    }
  }
  add_groups<G, D / 2>(&dka[0][0], group_s, grp, gtid);
  add_groups<G, D / 2>(&dva[0][0], group_s, grp, gtid);
  const size_t plane = (size_t)bhn * s * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = h ? key1 : key0;
    if (grp == 0 && active && kp < s) {
      const size_t at = koff + (size_t)kp * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store_dkdv(dk, dv, part, at + 8 * n, plane, blk.z, splits,
                   dka[n][2 * h], dka[n][2 * h + 1], dva[n][2 * h],
                   dva[n][2 * h + 1], scale);
    }
  }
}

// ---- the bf16 route: wgmma from TMA-loaded tiles, warp-specialised

// a producer warpgroup and two consumer warpgroups; the producer keeps
// kProdRegs registers a thread and the consumers take kConsRegs
// (128 x 40 + 256 x 232 = 384 x 168, what __launch_bounds__(384, 1)
// allows)
constexpr int kBf16Threads = 3 * kWG;
constexpr int kProdRegs = 40, kConsRegs = 232;
constexpr int kResRows = 2 * kRowsWG;   // rows of the resident tiles
constexpr int kStreamRows = 64;         // rows of a streamed tile
constexpr int kHalf = kStreamRows / 2;  // rows of a dk / dv kernel's step

template <int D>
struct Bf16Cfg : Rows<D, bf16> {
  using R = Rows<D, bf16>;
  static constexpr int kRes = kResRows * R::kRowBytes;         // one tile
  static constexpr int kStr = kStreamRows * R::kRowBytes;      // one tile
  // [two resident tiles | kStages x two streamed tiles | rows' floats |
  // barriers]; the dq kernel's floats are its 128 rows' delta, the
  // dk / dv kernel's each stage's lse and delta rows
  static constexpr int kOffStage = 2 * kRes;
  static constexpr int kOffRows = kOffStage + kStages * 2 * kStr;
  static constexpr int kRowFloats = 2 * kStages * kStreamRows;  // >= 128
  static constexpr int kOffBar = kOffRows + kRowFloats * 4;
  static constexpr int kSmem = kOffBar + 64 + 1024;
};

// s (or s^T, ...) of a warpgroup's 64 resident rows against N rows of a
// streamed tile: acc[N / 2] += X Y^T over D, X at x_s (a resident tile of
// kResRows rows, this warpgroup's rows from row wg * 64), Y at y_s (row
// `row` of a streamed tile of kStreamRows rows), both K-major as stored
template <int D, int N>
__device__ __forceinline__ void scores_ss(float* acc, uint32_t x_s,
                                          uint32_t y_s) {
  constexpr int CB = Rows<D, bf16>::kCB;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % (CB / 32)) * 32;
    const uint32_t ch = kk / (CB / 32);
    Mma<N>::ss_bf16(acc, smem_desc<CB>(x_s + ch * kResRows * CB + off),
                    smem_desc<CB>(y_s + ch * kStreamRows * CB + off));
  }
}

// acc[D / 2] += A Y: A the bf16 register fragments a[K / 16][4] of a
// 64 x K tile (its k K rows of a streamed tile), Y those rows at y_s (of
// a [kStreamRows, D] tile, read MN-major through the transpose bit)
template <int D, int K>
__device__ __forceinline__ void product_rs(float* acc, const uint32_t (*a)[4],
                                           uint32_t y_s) {
  using R = Rows<D, bf16>;
  constexpr int CB = R::kCB, CE = R::kChunkElems;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int c = 0; c < R::kChunks; ++c)
      Mma<CE>::rs_bf16_bt(acc + c * CE / 2, a[kk],
                          smem_desc<CB>(y_s + c * kStreamRows * CB +
                                        kk * 16 * CB));
}

// a 64 x N accumulator as the bf16 A fragments of its product
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (*a)[4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ void mbar_init_all(uint32_t bar_res,
                                              uint32_t bar_full,
                                              uint32_t bar_empty,
                                              uint32_t full_count) {
  mbar_init(bar_res, 1);
  for (int st = 0; st < kStages; ++st) {
    mbar_init(bar_full + 8 * st, full_count);
    mbar_init(bar_empty + 8 * st, 2 * kWG);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// dq and delta (bf16): CTA (bh, 128 query rows), the last tiles first
template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap domap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const bf16* __restrict__ out, const bf16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ delta,
            bf16* __restrict__ dq, int bhn, int s, int g, int tiles,
            int causal, float scale) {
  using C = Bf16Cfg<D>;
  constexpr int CB = C::kCB, CE = C::kChunkElems;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  const uint32_t raw = smem_u32(smem_tma);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sp = smem_tma + (base - raw);
  const uint32_t q_s = base, do_s = base + C::kRes;
  const uint32_t stage_s = base + C::kOffStage;
  float* dels = reinterpret_cast<float*>(sp + C::kOffRows);
  const uint32_t bar_res = base + C::kOffBar;
  const uint32_t bar_full = bar_res + 8, bar_empty = bar_full + 8 * kStages;

  const int m_rows = s * g;
  const int bh = blockIdx.x % bhn;
  const int m0 = (tiles - 1 - blockIdx.x / bhn) * kResRows;
  int kend = s;
  if (causal) kend = min(s, (min(m0 + kResRows, m_rows) - 1) / g + 1);
  const int ntiles = (kend + kStreamRows - 1) / kStreamRows;

  if (threadIdx.x == 0) mbar_init_all(bar_res, bar_full, bar_empty, 1);
  __syncthreads();

  if (threadIdx.x < kWG) {
    // producer: Q and dO once, then K / V tiles into the ring
    setmaxnreg_dec<kProdRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_res, 2 * C::kRes);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_3d(q_s + c * kResRows * CB, &qmap, bar_res, c * CE, m0, bh);
        tma_load_3d(do_s + c * kResRows * CB, &domap, bar_res, c * CE, m0,
                    bh);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages)
          mbar_wait(bar_empty + 8 * st, ((t / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        const uint32_t ks = stage_s + st * 2 * C::kStr;
        mbar_expect_tx(full, 2 * C::kStr);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_3d(ks + c * kStreamRows * CB, &kmap, full, c * CE,
                      t * kStreamRows, bh);
          tma_load_3d(ks + C::kStr + c * kStreamRows * CB, &vmap, full,
                      c * CE, t * kStreamRows, bh);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsRegs>();

  // consumer warpgroups: wg's query rows m0 + 64 wg ..
  const int tid = threadIdx.x - kWG;
  const int wg = tid / kWG, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int lrow0 = wg * kRowsWG + (warp % 4) * 16 + gq;   // and + 8
  const int row0 = m0 + lrow0;
  const size_t roff = (size_t)bh * m_rows;
  row_deltas<D>(out + roff * D, dout + roff * D, dels, delta + roff,
                      m0, kResRows, m_rows, tid, 2 * kWG);
  consumers_sync(2 * kWG);
  float lse_r[2], del_r[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    lse_r[h] = r < m_rows ? lse[roff + r] * kLog2e : 0.f;
    del_r[h] = dels[lrow0 + 8 * h];
    qpos[h] = r / g;
  }
  const float sl2 = scale * kLog2e;
  const int wrow0 = m0 + wg * kRowsWG;
  const bool wg_active = wrow0 < m_rows;
  int wkend = s;        // keys the warpgroup sees
  if (causal) wkend = min(s, (min(wrow0 + kRowsWG, m_rows) - 1) / g + 1);
  const uint32_t qa_s = q_s + wg * kRowsWG * CB;
  const uint32_t doa_s = do_s + wg * kRowsWG * CB;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_res, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages;
    const uint32_t ks = stage_s + st * 2 * C::kStr, vs = ks + C::kStr;
    mbar_wait(bar_full + 8 * st, (t / kStages) & 1);
    const int k0 = t * kStreamRows;
    if (wg_active && k0 < wkend) {
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_regs<32>(sc);
      fence_regs<32>(dp);
      wgmma_fence();
      scores_ss<D, 64>(sc, qa_s, ks);
      scores_ss<D, 64>(dp, doa_s, vs);
      wgmma_commit_wait();
      fence_regs<32>(sc);
      fence_regs<32>(dp);
      // sc[4j + 2h + c]: key k0 + 8j + 2tq + c of row row0 + 8h; masks
      // only where the tile crosses S or the warpgroup's diagonal
      auto ds = [&](bool edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, kp = k0 + 8 * j + 2 * tq + (e & 1);
            const bool ok = !edge || (kp < s && (!causal || kp <= qpos[h]));
            const float p = ok ? prob(sc[4 * j + e], sl2, lse_r[h]) : 0.f;
            sc[4 * j + e] = p * (dp[4 * j + e] - del_r[h]);
          }
      };
      if (k0 + kStreamRows > s ||
          (causal && k0 + kStreamRows - 1 > wrow0 / g))
        ds(true);
      else
        ds(false);
      uint32_t da[4][4];
      to_frags<64>(da, sc);
      fence_regs<D / 2>(acc);
      fence_regs<16>(&da[0][0]);
      wgmma_fence();
      product_rs<D, 64>(acc, da, ks);      // dq += ds k
      wgmma_commit_wait();
      fence_regs<D / 2>(acc);
    }
    mbar_arrive(bar_empty + 8 * st);    // the stage is free again
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r < m_rows) {
      bf16* o = dq + (roff + r) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(o + 8 * j, acc[4 * j + 2 * h] * scale,
               acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

// dk and dv (bf16): CTA (bh, 128 keys, split)
template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap domap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv,
              float* __restrict__ part, int bhn, int s, int g, int splits,
              int causal, float scale) {
  using C = Bf16Cfg<D>;
  constexpr int CB = C::kCB, CE = C::kChunkElems;
  constexpr int NS = kStreamRows;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  const uint32_t raw = smem_u32(smem_tma);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sp = smem_tma + (base - raw);
  const uint32_t k_s = base, v_s = base + C::kRes;
  const uint32_t stage_s = base + C::kOffStage;
  float* rowf = reinterpret_cast<float*>(sp + C::kOffRows);  // [st][lse|del]
  const uint32_t bar_res = base + C::kOffBar;
  const uint32_t bar_full = bar_res + 8, bar_empty = bar_full + 8 * kStages;

  const DkdvBlock blk(bhn, splits);
  const int bh = blk.bh;
  const int m_rows = s * g;
  const int n0 = blk.kt * kResRows;
  const size_t roff = (size_t)bh * m_rows;
  int tb, te;
  split_range(causal ? (int)((long long)n0 * g / NS) : 0,
              (m_rows + NS - 1) / NS, blk.z, splits, tb, te);

  // full barriers: the TMA thread's arrival and the 64 row loaders'
  if (threadIdx.x == 0)
    mbar_init_all(bar_res, bar_full, bar_empty, 1 + NS);
  __syncthreads();

  if (threadIdx.x < kWG) {
    // producer: K and V once; then Q / dO tiles into the ring, each with
    // its rows' lse and delta (threads 0 .. 63, one row each)
    setmaxnreg_dec<kProdRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_res, 2 * C::kRes);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_3d(k_s + c * kResRows * CB, &kmap, bar_res, c * CE, n0, bh);
        tma_load_3d(v_s + c * kResRows * CB, &vmap, bar_res, c * CE, n0, bh);
      }
    }
    if (threadIdx.x < NS) {
      for (int t = tb; t < te; ++t) {
        const int i = t - tb, st = i % kStages;
        if (i >= kStages)
          mbar_wait(bar_empty + 8 * st, ((i / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        const int r = t * NS + threadIdx.x;
        float* rows = rowf + st * 2 * NS;
        rows[threadIdx.x] = r < m_rows ? lse[roff + r] * kLog2e : 0.f;
        rows[NS + threadIdx.x] = r < m_rows ? delta[roff + r] : 0.f;
        if (threadIdx.x == 0) {
          const uint32_t qs = stage_s + st * 2 * C::kStr;
          mbar_expect_tx(full, 2 * C::kStr);
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load_3d(qs + c * NS * CB, &qmap, full, c * CE, t * NS, bh);
            tma_load_3d(qs + C::kStr + c * NS * CB, &domap, full, c * CE,
                        t * NS, bh);
          }
        }
        mbar_arrive(full);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsRegs>();

  // consumer warpgroups: wg's keys n0 + 64 wg ..
  const int tid = threadIdx.x - kWG;
  const int wg = tid / kWG, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wkey0 = n0 + wg * kRowsWG;
  const int key0 = wkey0 + (warp % 4) * 16 + gq;   // and + 8
  const bool wg_active = wkey0 < s;
  // causal: rows before the warpgroup's first key times G see none of it
  const long long wfirst = causal ? (long long)wkey0 * g : 0;
  const uint32_t ka_s = k_s + wg * kRowsWG * CB;
  const uint32_t va_s = v_s + wg * kRowsWG * CB;
  const float sl2 = scale * kLog2e;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(bar_res, 0);
  for (int t = tb; t < te; ++t) {
    const int i = t - tb, st = i % kStages;
    const uint32_t qs = stage_s + st * 2 * C::kStr, dos = qs + C::kStr;
    mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
    // the tile in two halves of kHalf rows: s^T and dp^T of a half, then
    // its dv and dk products (with the dk / dv sums in registers, a whole
    // tile's scores would not fit beside them)
    for (int hf = 0; hf < NS / kHalf; ++hf) {
      const int r0 = t * NS + hf * kHalf;
      if (!wg_active || r0 + kHalf <= wfirst) continue;
      const uint32_t qh = qs + hf * kHalf * CB, doh = dos + hf * kHalf * CB;
      float sc[kHalf / 2], dp[kHalf / 2];
#pragma unroll
      for (int e = 0; e < kHalf / 2; ++e) sc[e] = dp[e] = 0.f;
      fence_regs<kHalf / 2>(sc);
      fence_regs<kHalf / 2>(dp);
      wgmma_fence();
      scores_ss<D, kHalf>(sc, ka_s, qh);   // s^T = k q^T
      scores_ss<D, kHalf>(dp, va_s, doh);  // dp^T = v dout^T
      wgmma_commit_wait();
      fence_regs<kHalf / 2>(sc);
      fence_regs<kHalf / 2>(dp);
      const float* ls = rowf + st * 2 * NS + hf * kHalf;
      // sc[4j + 2h + c]: row r0 + 8j + 2tq + c of key key0 + 8h; masks
      // only where the half crosses S, M or the warpgroup's diagonal
      auto ds = [&](bool edge) {
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = key0 + 8 * (e >> 1);
            const int rl = 8 * j + 2 * tq + (e & 1), r = r0 + rl;
            const bool ok = !edge || (kp < s && r < m_rows &&
                                      (!causal || (long long)kp * g <= r));
            const float p = ok ? prob(sc[4 * j + e], sl2, ls[rl]) : 0.f;
            sc[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - ls[NS + rl]);
          }
      };
      if (wkey0 + kRowsWG > s || r0 + kHalf > m_rows ||
          (causal && (long long)(wkey0 + kRowsWG - 1) * g > r0))
        ds(true);
      else
        ds(false);
      uint32_t pa[kHalf / 16][4], da[kHalf / 16][4];
      to_frags<kHalf>(pa, sc);
      to_frags<kHalf>(da, dp);
      fence_regs<D / 2>(dka);
      fence_regs<D / 2>(dva);
      fence_regs<kHalf / 4>(&pa[0][0]);
      fence_regs<kHalf / 4>(&da[0][0]);
      wgmma_fence();
      product_rs<D, kHalf>(dva, pa, doh);  // dv += p^T dout
      product_rs<D, kHalf>(dka, da, qh);   // dk += ds^T q
      wgmma_commit_wait();
      fence_regs<D / 2>(dka);
      fence_regs<D / 2>(dva);
    }
    mbar_arrive(bar_empty + 8 * st);    // the stage is free again
  }
  const size_t plane = (size_t)bhn * s * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = key0 + 8 * h;
    if (kp < s) {
      const size_t at = ((size_t)bh * s + kp) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_dkdv(dk, dv, part, at + 8 * j, plane, blk.z, splits,
                   dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1],
                   dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1], scale);
    }
  }
}

// dk = scale * sum_z dk partial z, dv = sum_z dv partial z, in split
// order; n = BH S D elements, four a thread at a time
template <typename T>
__global__ void flash_bwd_reduce(const float* __restrict__ part,
                           T* __restrict__ dk, T* __restrict__ dv,
                           long long n, int splits, float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x * 4;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n; i += stride) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    for (int z = 0; z < splits; ++z) {
      const float4 x = *reinterpret_cast<const float4*>(part + z * n + i);
      const float4 y =
          *reinterpret_cast<const float4*>(part + (splits + z) * n + i);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
    }
    store2(dk + i, a.x * scale, a.y * scale);
    store2(dk + i + 2, a.z * scale, a.w * scale);
    store2(dv + i, b.x, b.y);
    store2(dv + i + 2, b.z, b.w);
  }
}

// ---- host

// keys a dk / dv CTA owns, by dtype
int key_tile(int dtype) { return dtype == 0 ? kTileRows : kResRows; }

int splits_for(long long bh, int s, int g, int dtype, int sms) {
  const long long ctas = bh * ((s + key_tile(dtype) - 1) / key_tile(dtype));
  if (ctas >= sms) return 1;
  const long long target = (long long)kSplitWaves * sms;
  long long sp = (target + ctas - 1) / ctas;
  const long long rows = (long long)s * g;   // at least a row tile a split
  const long long rtiles = (rows + 63) / 64;
  sp = sp < kMaxSplits ? sp : kMaxSplits;
  sp = sp < rtiles ? sp : rtiles;
  return sp < 1 ? 1 : (int)sp;
}

template <typename T>
int launch_reduce(float* part, void* dk, void* dv, int bh, int s, int d,
                  int splits, float scale, cudaStream_t stream) {
  const long long n = (long long)bh * s * d;
  long long blocks = (n / 4 + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  flash_bwd_reduce<T><<<(unsigned)blocks, 256, 0, stream>>>(
      part, static_cast<T*>(dk), static_cast<T*>(dv), n, splits, scale);
  return (int)cudaGetLastError();
}

// rows: [2, bh, s * g] f32 scratch, delta then (f32) the backward's lse
// in log2 units
template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void*,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* rows, float* part, int bh, int s, int g,
               int causal, float scale, int splits, cudaStream_t stream) {
  using C = F32Cfg<D>;
  const long long m = (long long)s * g;
  const long long qtiles = (m + kTileRows - 1) / kTileRows;
  const long long ktiles = ((long long)s + kTileRows - 1) / kTileRows;
  if (qtiles * bh > INT_MAX || ktiles * bh * splits > INT_MAX)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;   // per instantiation, before its first launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_f32<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  float* delta = rows;
  float* lse_b = rows + bh * m;
  flash_bwd_dq_f32<D><<<(unsigned)(qtiles * bh), C::kGroups * kThreads,
                        C::kSmem, stream>>>(
      qt, kt, vt, lse, dot, static_cast<float*>(dq), lse_b, delta, bh, s, g,
      (int)qtiles, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_f32<D><<<(unsigned)(ktiles * bh * splits),
                          C::kGroups * kThreads, C::kSmem, stream>>>(
          qt, kt, vt, dot, lse_b, delta, static_cast<float*>(dk),
          static_cast<float*>(dv), part, bh, s, g, splits, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_reduce<float>(part, dk, dv, bh, s, D, splits, scale, stream);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* out,
                const float* lse, const void* dout, void* dq, void* dk,
                void* dv, float* delta, float* part, int bh, int s, int g,
                int causal, float scale, int splits, cudaStream_t stream) {
  using C = Bf16Cfg<D>;
  const long long m = (long long)s * g;
  const long long qtiles = (m + kResRows - 1) / kResRows;
  const long long ktiles = ((long long)s + kResRows - 1) / kResRows;
  if (qtiles * bh > INT_MAX || ktiles * bh * splits > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // the dq kernel's maps: Q and dO by 128 rows, K and V by 64; the dk / dv
  // kernel's the other way round
  CUtensorMap qm, dom, km, vm, qs, dos, kr, vr;
  if (!encode<D, bf16>(&qm, q, m, bh, kResRows) ||
      !encode<D, bf16>(&dom, dout, m, bh, kResRows) ||
      !encode<D, bf16>(&km, k, s, bh, kStreamRows) ||
      !encode<D, bf16>(&vm, v, s, bh, kStreamRows) ||
      !encode<D, bf16>(&qs, q, m, bh, kStreamRows) ||
      !encode<D, bf16>(&dos, dout, m, bh, kStreamRows) ||
      !encode<D, bf16>(&kr, k, s, bh, kResRows) ||
      !encode<D, bf16>(&vr, v, s, bh, kResRows))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;   // per instantiation, before its first launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  flash_bwd_dq_bf16<D><<<(unsigned)(qtiles * bh), kBf16Threads, C::kSmem,
                   stream>>>(
      qm, dom, km, vm, static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), bh,
      s, g, (int)qtiles, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_bf16<D><<<(unsigned)(ktiles * bh * splits), kBf16Threads,
                     C::kSmem, stream>>>(
      qs, dos, kr, vr, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, bh, s, g, splits, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_reduce<bf16>(part, dk, dv, bh, s, D, splits, scale, stream);
}

#define BWD_ARGS                                                           \
  q, k, v, out, static_cast<const float*>(lse), dout, dq, dk, dv,          \
      static_cast<float*>(delta), static_cast<float*>(part), bh, s, g,     \
      causal, scale, splits, stream

int launch_any(const void* q, const void* k, const void* v, const void* out,
               const void* lse, const void* dout, void* dq, void* dk,
               void* dv, void* delta, void* part, int bh, int s, int g,
               int d, int dtype, int causal, float scale, int splits,
               cudaStream_t stream) {
  if (dtype == 0) {
    switch (d) {
      case 16: return launch_f32<16>(BWD_ARGS);
      case 32: return launch_f32<32>(BWD_ARGS);
      case 64: return launch_f32<64>(BWD_ARGS);
      case 128: return launch_f32<128>(BWD_ARGS);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 16: return launch_bf16<16>(BWD_ARGS);
      case 32: return launch_bf16<32>(BWD_ARGS);
      case 64: return launch_bf16<64>(BWD_ARGS);
      case 128: return launch_bf16<128>(BWD_ARGS);
    }
  }
  return (int)cudaErrorInvalidValue;
}

#undef BWD_ARGS

}  // namespace

// How many CTAs the dk / dv kernel splits each key tile's rows over, for
// a card of `sms` SMs: 1 where BH times its key tiles (64 keys f32, 128
// bf16) gives a CTA an SM or more, else enough splits for kSplitWaves
// CTAs an SM, at most 16 and a query tile of 64 rows each. The caller
// sizes the partials by it.
extern "C" int flash_attention_bwd_splits(int bh, int s, int g, int dtype,
                                          int sms) {
  if (bh <= 0 || s <= 0 || g <= 0 || sms <= 0) return 1;
  return splits_for(bh, s, g, dtype, sms);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk and dv all
// of it); lse (the forward's) is [bh, s * g] float32, delta [2, bh, s * g]
// float32 scratch (each row's delta, then for float32 the backward's own
// lse), part [2, splits, bh, s, d] float32 scratch where splits > 1 (else
// unused); float32 reads no out. d must be 16, 32, 64 or 128; q, k, v, out and dout 16-byte
// aligned. Returns cudaGetLastError() after the launches (0 on success),
// or cudaErrorInvalidValue for an unsupported d / dtype, a grid past
// 2^31 - 1 blocks or a tensor map that cuTensorMapEncodeTiled refuses.
// Launches every kernel on `stream`, never synchronises.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* out,
                                          const void* lse, const void* dout,
                                          void* dq, void* dk, void* dv,
                                          void* delta, void* part, int bh,
                                          int s, int g, int d, int dtype,
                                          int causal, float scale,
                                          int splits, void* stream) {
  if (bh <= 0 || s <= 0 || g <= 0) return (int)cudaGetLastError();
  if (splits < 1 || (long long)s * g > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  return launch_any(q, k, v, out, lse, dout, dq, dk, dv, delta, part, bh, s,
                    g, d, dtype, causal, scale, splits,
                    (cudaStream_t)stream);
}
