// flash_attention for Hopper (sm_90a): GQA online-softmax attention, the
// ViT feature extractor's attention, on the tensor cores (wgmma) with K/V
// staged by TMA.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel). In the kernel layout, q [BH, S, G, D] and k, v
// [BH, S, D] (BH = batch x kv heads, G query heads per kv head), f32 or
// bf16, row-major:
//     out[b, i, g] = sum_j softmax_j(scale * q[b, i, g] . k[b, j]) v[b, j]
// with scale = D^-0.5, in q's dtype. As in the Pallas body: the running
// max m, sum l and the D-wide accumulator are f32 and updated once per key
// tile; causal masking keeps qpos >= kpos and writes -1e30 (not -inf) for
// the rest, and key tiles wholly above the tile's last row are skipped;
// l is floored at 1e-30 before the divide. Keys past S (a ragged last
// tile) are -inf, so they add nothing. The scale multiplies the f32
// scores (the plain version's placement; Pallas scales q, 1e-6 apart).
// Built without fast-math; expf is the accurate one.
//
// Bound on the H100, by the route this kernel takes: bf16 products at
// 989e12 FLOP/s; f32 as 3xTF32 (below), 3 x the FLOPs at 495e12 TF32
// FLOP/s; bytes (q, k, v read once, out written once) at 3.35e12 B/s.
// At the ViT's shape (BH = 128 x 3, S = 17, G = 1, D = 64, f32) the bytes
// bound it: 6.7 MB, 2.0 us. At the paper's 400x400 patches (S = 626,
// batch 128, f32) the operations: 38.5 GFLOP, 3 x 38.5 / 495e12 =
// 0.23 ms. At S = 2048, causal GQA bf16 (BH = 8, G = 4, D = 128): 34 GFLOP,
// 0.035 ms.
//
// Design. Each bh is one attention of M = S * G query rows (q's [S * G, D]
// rows are its (row, g) pairs in q's order) against S keys. A CTA takes
// 64 query rows per consumer warpgroup, two warpgroups (128 rows), one
// where M <= 64 or, at D = 128 f32, where shared memory allows no more,
// plus one producer warp. The producer issues TMA loads through 3-D tensor
// maps (q as [BH, M, D], k and v as [BH, S, D]), so a tile never reads
// into the next bh; rows past the end come back as zeros, and the
// consumers mask those keys to -inf themselves. Q is loaded once; K/V
// tiles go into a two-stage ring with full / empty mbarriers. Where one
// key tile covers S (the ViT's S = 17) there is one stage and no producer
// warp: the first consumer thread issues the loads, and three CTAs fit on
// an SM, so the ViT's 384 CTAs run in one wave. A row of
// more than 128 bytes loads as 128-byte column chunks, each its own box;
// the swizzle follows the chunk width (32, 64 or 128 bytes), and so does
// the wgmma descriptor. Each consumer warpgroup computes S = Q K^T for its
// 64 rows into registers, runs the online softmax there (a row's max and
// sum over the four threads of a quad), and adds P V into its register
// accumulator.
//   bf16: S = Q K^T is wgmma m64n64k16 with Q and the K tile read from
//   shared memory, both K-major as stored. P converts to bf16 in registers
//   and is the register A operand of P V (the m64 accumulator's layout is
//   the bf16 A fragment's); V stays [keys, D] and is read as an MN-major B
//   (the descriptor's transpose bit).
//   f32: 3xTF32, never one pass. Each operand x splits into hi (x with its
//   low 13 mantissa bits cleared) and lo (x - hi rounded to TF32), and each
//   product is lo.hi + hi.lo + hi.hi with f32 accumulation: about 2^-21
//   relative against one TF32 pass's 2^-11. The consumers write Q's hi in
//   place and its lo beside it once; per tile they write K's hi in place
//   and its lo beside it, and V transposed (a TF32 B operand must be
//   K-major), and release the stage once Q K^T has read it. P's register
//   A fragment pairs columns (t, t + 4) where the accumulator holds
//   (2t, 2t + 1), so V^T's keys are stored permuted within each group of
//   8 to match. K/V tiles are 32 keys here, so that
//   stages, converted tiles and Q's hi/lo fit in shared memory. The
//   small products go first, while an accumulator is small, and each
//   tile's P V goes into a fresh accumulator that f32 adds fold into O:
//   every addition inside the tensor cores keeps only the accumulator's
//   own precision, so O never takes them across tiles.
// Where the caller asks (an lse pointer, the autograd Function's forward),
// the epilogue also writes each row's log-sum-exp m + log(max(l, 1e-30))
// in scaled-score units, the reference's residual for the backward
// (csrc/flash_attention_bwd.cu); a forward-only call passes null and
// writes nothing more. The wgmma, TMA and mbarrier helpers live in
// hopper.cuh, shared with the backward.
// What this does about each limit: both products run on the tensor cores
// (the earlier kernel ran f32 FMAs with a shared-memory load each), loads
// are TMA bulk copies that overlap the previous tile's products, and a
// row's exp is taken once, by the thread that holds the score. Left for
// later: warp-specialised ping-pong between the consumer warpgroups,
// overlap of the softmax with the next Q K^T, a persistent grid,
// setmaxnreg.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// Shapes and shared-memory layout of one instantiation (a row's column
// chunks: hopper::Rows)
template <int D, typename T>
struct Cfg : Rows<D, T> {
  using R = Rows<D, T>;
  static constexpr int kTile = R::kF32 ? 32 : 64;       // keys per stage
  static constexpr int kMaxWG = (R::kF32 && D == 128) ? 1 : 2;
  static constexpr int kKVBytes = kTile * R::kRowBytes; // one K or V tile
  // a CTA of `rows` query rows and `stages` K/V stages: [Q | Q lo (f32) |
  // stages (K, V) | converted K lo, V^T hi, V^T lo (f32) | barriers]
  static __host__ __device__ int q_bytes(int rows) {
    return rows * R::kRowBytes;
  }
  static __host__ __device__ int off_stage(int rows) {
    return q_bytes(rows) * (R::kF32 ? 2 : 1);
  }
  static __host__ __device__ int off_conv(int rows, int stages) {
    return off_stage(rows) + stages * 2 * kKVBytes;
  }
  static __host__ __device__ int off_bar(int rows, int stages) {
    return off_conv(rows, stages) + (R::kF32 ? 3 * kKVBytes : 0);
  }
  // barriers (5 x 8 bytes) and the slack that aligns the base to 1024
  static __host__ __device__ int smem_bytes(int rows, int stages) {
    return off_bar(rows, stages) + 64 + 1024;
  }
};


template <int D, typename T>
__global__ void __launch_bounds__(Cfg<D, T>::kMaxWG * kWG + 32, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       T* __restrict__ out, float* __restrict__ lse,
                       int s, int g, int n_wg, int tiles, int stages,
                       int causal, float scale) {
  using C = Cfg<D, T>;
  constexpr int CB = C::kCB, TK = C::kTile;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sp = smem_raw + (base - raw);

  const int rows = n_wg * kRowsWG;       // query rows of this CTA
  const int nc = n_wg * kWG;             // consumer threads
  const int m_rows = s * g;              // query rows of a bh
  const int bh = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * rows;
  int kend = s;
  if (causal) {                          // the CTA's last row bounds its keys
    const int plast = min(m0 + rows, m_rows) - 1;
    kend = plast / g + 1;
  }
  const int ntiles = (kend + TK - 1) / TK;

  const uint32_t bar_q = base + C::off_bar(rows, stages);
  const uint32_t bar_full = bar_q + 8;                // `stages` of them
  const uint32_t bar_empty = bar_full + 8 * kStages;  // `stages` of them
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, nc);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const uint32_t q_s = base;
  const uint32_t stage_s = base + C::off_stage(rows);
  // Q, then K/V tiles 0 .. n - 1 into the ring, by one thread
  auto issue_loads = [&](int n) {
    mbar_expect_tx(bar_q, C::q_bytes(rows));
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_3d(q_s + c * rows * CB, &qmap, bar_q, c * C::kChunkElems, m0,
                  bh);
    for (int t = 0; t < n; ++t) {
      const int st = t % stages;
      if (t >= stages)
        mbar_wait(bar_empty + 8 * st, ((t / stages) - 1) & 1);
      const uint32_t full = bar_full + 8 * st;
      const uint32_t ks = stage_s + st * 2 * C::kKVBytes;
      mbar_expect_tx(full, 2 * C::kKVBytes);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_3d(ks + c * TK * CB, &kmap, full, c * C::kChunkElems,
                    t * TK, bh);
        tma_load_3d(ks + C::kKVBytes + c * TK * CB, &vmap, full,
                    c * C::kChunkElems, t * TK, bh);
      }
    }
  };
  if (blockDim.x > n_wg * kWG) {
    // producer warp: its first thread issues every TMA load
    if (warp == 4 * n_wg) {
      if (threadIdx.x % 32 == 0) issue_loads(ntiles);
      return;
    }
  } else if (threadIdx.x == 0) {
    // a single key tile (S <= TK): nothing to refill, so no producer warp
    // (its registers would keep a third CTA off the SM at the ViT's
    // shape); the first consumer thread issues the loads
    issue_loads(ntiles);
  }

  // consumer warpgroups
  const int tid = threadIdx.x;
  const int wg = warp / 4;
  const int lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // quad and thread in quad
  const int row0 = m0 + wg * kRowsWG + (warp % 4) * 16 + gq;   // and + 8
  const int qpos[2] = {row0 / g, (row0 + 8) / g};
  const uint32_t qa_s = q_s + wg * kRowsWG * CB;   // this warpgroup's Q
  const uint32_t qlo_s = qa_s + C::q_bytes(rows);  // f32: Q's lo
  const uint32_t conv_s = base + C::off_conv(rows, stages);

  mbar_wait(bar_q, 0);
  if constexpr (C::kF32) {
    // Q's rows past the bh's end are never stored, and a row's products
    // touch no other row, so only the valid rows are split
    constexpr int kLine = CB / 4;             // floats of one chunk row
    const int valid = min(rows, m_rows - m0);
    float* qv = reinterpret_cast<float*>(sp);
    float* qlo = qv + rows * D;
    for (int i = tid; i < C::kChunks * valid * kLine; i += nc) {
      const int at = (i / (valid * kLine)) * rows * kLine +
                     i % (valid * kLine);
      const float x = qv[at], hi = tf32_hi(x);
      qv[at] = hi;
      qlo[at] = tf32_rna(x - hi);
    }
    fence_proxy_async();
    consumers_sync(nc);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % stages;
    const uint32_t ks = stage_s + st * 2 * C::kKVBytes;
    const uint32_t vs = ks + C::kKVBytes;
    mbar_wait(bar_full + 8 * st, (t / stages) & 1);

    float sc[TK / 2];
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) sc[i] = 0.f;
    if constexpr (C::kF32) {
      // K's hi in place, its lo beside it (K's layout); V^T hi and lo
      // ([D] rows of 32 keys, 128-byte swizzle, keys permuted within
      // groups of 8)
      const uint32_t khi_s = ks, klo_s = conv_s;
      uint8_t* cp = sp + (conv_s - base);
      float* kp = reinterpret_cast<float*>(sp + (ks - base));
      const uint8_t* vp = sp + (vs - base);
      consumers_sync(nc);   // the last tile's products are done with them
      for (int i = tid; i < TK * D; i += nc) {
        const float x = kp[i], hi = tf32_hi(x);
        kp[i] = hi;
        reinterpret_cast<float*>(cp)[i] = tf32_rna(x - hi);
      }
      for (int i = tid; i < TK * D; i += nc) {
        const int r = i % TK, d = i / TK;            // key, dim
        const uint32_t src = (d / C::kChunkElems) * TK * CB +
                             swz<CB>(r * CB + (d % C::kChunkElems) * 4);
        const int kc = (r & ~7) + (r % 8) / 2 + 4 * (r & 1);
        const uint32_t dst = (kc / 32) * D * 128 +
                             swz<128>(d * 128 + (kc % 32) * 4);
        const float x = *reinterpret_cast<const float*>(vp + src);
        const float hi = tf32_hi(x);
        *reinterpret_cast<float*>(cp + C::kKVBytes + dst) = hi;
        *reinterpret_cast<float*>(cp + 2 * C::kKVBytes + dst) =
            tf32_rna(x - hi);
      }
      fence_proxy_async();
      consumers_sync(nc);

      fence_regs<TK / 2>(sc);
      wgmma_fence();
      // the small products first, while the accumulator is small: each
      // addition into it keeps only its own precision
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const uint32_t off = (kk % (CB / 32)) * 32;
          const uint32_t qoff = (kk / (CB / 32)) * rows * CB + off;
          const uint32_t koff = (kk / (CB / 32)) * TK * CB + off;
          const uint64_t kh = smem_desc<CB>(khi_s + koff);
          const uint64_t qh = smem_desc<CB>(qa_s + qoff);
          if (pass == 0) {
            Mma<TK>::ss_tf32(sc, smem_desc<CB>(qlo_s + qoff), kh);
            Mma<TK>::ss_tf32(sc, qh, smem_desc<CB>(klo_s + koff));
          } else {
            Mma<TK>::ss_tf32(sc, qh, kh);
          }
        }
      }
      wgmma_commit_wait();
      fence_regs<TK / 2>(sc);
      mbar_arrive(bar_empty + 8 * st);    // the stage is free again
    } else {
      fence_regs<TK / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % (CB / 32)) * 32;
        Mma<TK>::ss_bf16(
            sc, smem_desc<CB>(qa_s + (kk / (CB / 32)) * rows * CB + off),
            smem_desc<CB>(ks + (kk / (CB / 32)) * TK * CB + off));
      }
      wgmma_commit_wait();
      fence_regs<TK / 2>(sc);
    }

    // online softmax: thread rows row0 (h = 0) and row0 + 8 (h = 1);
    // sc[4j + 2h + c] is column 8j + 2 tq + c of the tile
    const int k0 = t * TK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, kp = k0 + 8 * j + 2 * tq + (e & 1);
        float x = sc[4 * j + e] * scale;
        if (kp >= s) x = -INFINITY;
        else if (causal && kp > qpos[h]) x = kMasked;
        sc[4 * j + e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // key k0 < kend <= s is in every tile, so mx is finite
      const float m_new = fmaxf(m_run[h], mx[h]);
      corr[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      const int h = (i % 4) / 2;
      sc[i] = expf(sc[i] - m_run[h]);
      rsum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + rsum[h];

    // O += P V
    if constexpr (C::kF32) {
      const uint32_t vthi_s = conv_s + C::kKVBytes;
      const uint32_t vtlo_s = conv_s + 2 * C::kKVBytes;
      constexpr int NO = D < 64 ? D : 64;     // output columns a wgmma
      uint32_t ph[TK / 8][4], pl[TK / 8][4];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        // A fragment (row, key t) / (row, key t + 4) <- keys 2t, 2t + 1
        const float a[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1],
                            sc[4 * j + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float hi = tf32_hi(a[e]);
          ph[j][e] = __float_as_uint(hi);
          pl[j][e] = __float_as_uint(tf32_rna(a[e] - hi));
        }
      }
      // this tile's P V into a fresh accumulator (the small products
      // first), then into O by f32 adds: O never takes the tensor cores'
      // additions across tiles
      float pv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
      fence_regs<D / 2>(pv);
      fence_regs<TK / 2>(&ph[0][0]);
      fence_regs<TK / 2>(&pl[0][0]);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
        for (int j = 0; j < TK / 8; ++j) {
          const uint32_t off = (j / 4) * D * 128 + (j % 4) * 32;
#pragma unroll
          for (int n = 0; n < D / NO; ++n) {
            const uint32_t noff = off + n * NO * 128;
            const uint64_t vh = smem_desc<128>(vthi_s + noff);
            if (pass == 0) {
              Mma<NO>::rs_tf32(pv + n * NO / 2, pl[j], vh);
              Mma<NO>::rs_tf32(pv + n * NO / 2, ph[j],
                               smem_desc<128>(vtlo_s + noff));
            } else {
              Mma<NO>::rs_tf32(pv + n * NO / 2, ph[j], vh);
            }
          }
        }
      }
      wgmma_commit_wait();
      fence_regs<D / 2>(pv);
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        o[i] = fmaf(o[i], corr[(i % 4) / 2], pv[i]);
    } else {
      uint32_t pa[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i % 4) / 2];
      fence_regs<D / 2>(o);
      fence_regs<TK / 4>(&pa[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          Mma<C::kChunkElems>::rs_bf16_bt(
              o + c * C::kChunkElems / 2, pa[kk],
              smem_desc<CB>(vs + c * TK * CB + kk * 16 * CB));
      wgmma_commit_wait();
      fence_regs<D / 2>(o);
      mbar_arrive(bar_empty + 8 * st);    // the stage is free again
    }
  }

  // out = O / l; o[4j + 2h + c] is column 8j + 2 tq + c of row row0 + 8h;
  // where asked, the row's log-sum-exp m + log l (the backward's p)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int p = row0 + 8 * h;
    if (p < m_rows) {
      T* op = out + ((long long)bh * m_rows + p) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(op + 8 * j, o[4 * j + 2 * h] / denom,
               o[4 * j + 2 * h + 1] / denom);
      if (lse != nullptr && tq == 0)
        lse[(long long)bh * m_rows + p] = m_run[h] + logf(denom);
    }
  }
}


template <int D, typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* lse, int bh, int s, int g, int causal, float scale,
             cudaStream_t stream) {
  using C = Cfg<D, T>;
  const long long m = (long long)s * g;
  if (m > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  const int n_wg = (m <= kRowsWG || C::kMaxWG == 1) ? 1 : 2;
  const int rows = n_wg * kRowsWG;
  const long long tiles = (m + rows - 1) / rows;
  const long long blocks = tiles * bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!encode<D, T>(&qm, q, m, bh, rows) ||
      !encode<D, T>(&km, k, s, bh, C::kTile) ||
      !encode<D, T>(&vm, v, s, bh, C::kTile))
    return (int)cudaErrorInvalidValue;
  // one stage and no producer warp where one key tile covers S
  const bool one_tile = s <= C::kTile;
  const int stages = one_tile ? 1 : kStages;
  static bool attr_set = false;   // per instantiation, before its first launch
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::smem_bytes(C::kMaxWG * kRowsWG, kStages));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  flash_attention_kernel<D, T>
      <<<(unsigned)blocks, n_wg * kWG + (one_tile ? 0 : 32),
         C::smem_bytes(rows, stages), stream>>>(
          qm, km, vm, static_cast<T*>(out), lse, s, g, n_wg, (int)tiles,
          stages, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out,
             float* lse, int bh, int s, int g, int d, int causal, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_d<16, T>(q, k, v, out, lse, bh, s, g, causal, scale,
                             stream);
    case 32:
      return launch_d<32, T>(q, k, v, out, lse, bh, s, g, causal, scale,
                             stream);
    case 64:
      return launch_d<64, T>(q, k, v, out, lse, bh, s, g, causal, scale,
                             stream);
    case 128:
      return launch_d<128, T>(q, k, v, out, lse, bh, s, g, causal, scale,
                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out all of it). d must be
// 16, 32, 64 or 128; q, k, v and out 16-byte aligned (TMA). lse, where not
// null, is [bh, s * g] float32 and takes each row's log-sum-exp of its
// scaled scores, m + log(max(l, 1e-30)) (the reference's residual, which
// the backward's p = exp(scale s - lse) reads); null writes nothing more.
// Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported d / dtype, a grid past 2^31 - 1
// blocks or a tensor map that cuTensorMapEncodeTiled refuses. Launches on
// `stream`, never synchronises.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int bh, int s, int g, int d, int dtype,
                                      int causal, float scale, void* stream) {
  if (bh <= 0 || s <= 0 || g <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_t<float>(q, k, v, out, l, bh, s, g, d, causal, scale, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, out, l, bh, s, g, d, causal,
                                   scale, st);
  return (int)cudaErrorInvalidValue;
}
