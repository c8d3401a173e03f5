// flash_attention for Hopper (sm_90a): GQA online-softmax attention, the
// ViT feature extractor's and the LM's attention, on the tensor cores
// (wgmma) with tiles staged by TMA.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel). In the kernel layout, q [BH, S, G, D] and k, v
// [BH, S, D] (BH = batch x kv heads, G query heads per kv head), f32 or
// bf16, row-major:
//     out[b, i, g] = sum_j softmax_j(scale * q[b, i, g] . k[b, j]) v[b, j]
// with scale = D^-0.5, in q's dtype. As in the Pallas body: the running
// max m, sum l and the D-wide accumulator are f32 and updated once per key
// tile; causal masking keeps qpos >= kpos, and key tiles wholly above the
// tile's last row are skipped; l is floored at 1e-30 before the divide.
// Every row sees key 0, so a masked score adds nothing whether it is
// -1e30 (the Pallas body's) or -inf (keys past S, and every masked key of
// the bf16 route). Built without fast-math.
// Where the caller asks (an lse pointer, the autograd Function's forward),
// the epilogue also writes each row's log-sum-exp m + log(max(l, 1e-30))
// in scaled-score units, natural log, the reference's residual for the
// backward (csrc/flash_attention_bwd.cu); a forward-only call passes null.
//
// Bound on the H100, by the route this kernel takes: bf16 products at
// 989e12 FLOP/s; f32 as 3xTF32 (below), 3 x the FLOPs at 495e12 TF32
// FLOP/s; bytes (q, k, v read once, out written once) at 3.35e12 B/s.
// At the ViT's shape (BH = 128 x 3, S = 17, G = 1, D = 64, f32) the bytes
// bound it: 6.7 MB, 2.0 us. At the paper's 400x400 patches (S = 626,
// batch 128, f32) the operations: 38.5 GFLOP, 3 x 38.5 / 495e12 =
// 0.23 ms. At internlm2-1.8b's training inputs (BH 16, S 4,096, G 2,
// D 128, causal, bf16): 137 GFLOP, 0.139 ms.
//
// Design. Each bh is one attention of M = S * G query rows (q's [S * G, D]
// rows are its (row, g) pairs in q's order; row r is at position r / G)
// against S keys, read through 3-D tensor maps (q as [BH, M, D], k and v
// as [BH, S, D]), so a tile never reads into the next bh and rows past
// the end come back as zeros. A row of more than 128 bytes loads as
// 128-byte column chunks, each its own box; the swizzle follows the chunk
// width (32, 64 or 128 bytes), and so does the wgmma descriptor.
//
//   bf16 (flash_attention_kernel_bf16): warp-specialised. A CTA is a
//   producer warpgroup, which gives its registers back (setmaxnreg) and
//   whose first thread issues every TMA load, and two consumer warpgroups
//   of 64 query rows, which take them. An item is (query tile of 128
//   rows, bh, key split); Q loads once an item, K and V tiles of 128 keys
//   stream through a three-stage ring with full / empty mbarriers. Each
//   consumer computes S = Q K^T for its 64 rows as wgmma m64n128k16 from
//   shared memory (both K-major as stored), runs the online softmax in
//   registers (a row's max and sum over the four threads of a quad), and
//   adds P V, P converted to bf16 in registers as the register A operand
//   (the m64 accumulator's layout is the bf16 A fragment's), V read as an
//   MN-major B (the descriptor's transpose bit) at N = D (at D = 128 both
//   64-column chunks in one product, the descriptor's leading offset
//   stepping between them). Three things keep the tensor cores fed:
//     - ping-pong: the two consumers take turns on named barriers (ids 2
//       and 3) to issue their products, so one's softmax runs while the
//       other's products are in flight;
//     - overlap inside a warpgroup: a turn issues tile t's S, then tile
//       t - 1's P V, and the softmax of t waits for S alone, running
//       while P V is in flight;
//     - fewer instructions between products: p = exp2(s sl2 - m2), one
//       FMA and the hardware's exp2, with the running max m2 in scaled
//       log2 units (sl2 = scale log2 e); masks only on the tiles that
//       cross S or the warpgroup's diagonal. The epilogue writes lse =
//       (m2 + log2 l) ln 2, in the units the backward reads.
//   The grid is persistent, one CTA an SM, each walking every gridDim-th
//   item (in alternate directions a round), its next item's loads issued
//   under this one's last products; causal items run heaviest first (the
//   last query tiles, which walk the most keys), so the last round is
//   light. Where BH times the query tiles gives fewer CTAs than SMs (the
//   mesh's BH 1-4), each query tile's key tiles are split evenly over
//   `splits` items (the wrapper's count, from the SM count); each writes
//   f32 partials (o, m2, l) and flash_attention_combine adds them
//   in split order and writes out and lse.
//
//   f32 (flash_attention_kernel_f32): 3xTF32, never one pass. Each
//   operand x splits into hi (x with its low 13 mantissa bits cleared)
//   and lo (x - hi rounded to TF32), and each product is lo.hi + hi.lo +
//   hi.hi with f32 accumulation: about 2^-21 relative against one TF32
//   pass's 2^-11. flash_attention_presplit splits K into hi and lo
//   and V into V^T hi and lo (a TF32 B operand must be K-major) once a
//   call, in global memory; the main kernel TMA-loads those tiles, so no
//   CTA converts a K / V tile. P's register A fragment pairs columns (t,
//   t + 4) where the accumulator holds (2t, 2t + 1), so V^T's keys are
//   stored permuted within each group of 8 to match. A CTA is one or two
//   consumer warpgroups of 64 rows (one at D = 128, where Q's hi and lo
//   leave room for no more) and one producer warp; the consumers split Q
//   in place once. Tiles are 32 keys. The small products go first, while
//   an accumulator is small, and each tile's P V goes into a fresh
//   accumulator that f32 adds fold into O: every addition inside the
//   tensor cores keeps only the accumulator's own precision. The softmax
//   keeps the accurate expf. Where one key tile covers S (the ViT's S =
//   17) there is no pre-pass and no producer warp: the first consumer
//   thread issues the loads, the consumers split that one tile, and
//   three CTAs fit on an SM, so the ViT's 384 CTAs run in one wave.
//   Causal query tiles run heaviest first here too.
//
// Every output element is written once, by one thread, after sums in a
// fixed order: two calls with the same inputs give equal bits, whatever
// the schedule.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ---- the bf16 route

// a producer warpgroup and two consumer warpgroups; the producer keeps
// kProdRegs registers a thread and the consumers take kConsRegs
// (128 x 40 + 256 x 232 <= 65,536)
constexpr int kBfThreads = 3 * kWG;
constexpr int kProdRegs = 40, kConsRegs = 232;
constexpr int kBfRows = 2 * kRowsWG;   // query rows of an item
constexpr int kBfKeys = 128;           // keys of a tile
constexpr int kBfStages = 3;

template <int D>
struct BfCfg : Rows<D, bf16> {
  using R = Rows<D, bf16>;
  static constexpr int kQ = kBfRows * R::kRowBytes;    // Q of an item
  static constexpr int kKV = kBfKeys * R::kRowBytes;   // a K or V tile
  // [Q | kBfStages x (K, V) | barriers: Q full, Q empty, full, empty]
  static constexpr int kOffStage = kQ;
  static constexpr int kOffBar = kOffStage + kBfStages * 2 * kKV;
  static constexpr int kSmem = kOffBar + 64 + 1024;   // and 1024 alignment
};

// an item: query rows m0 .. m0 + 127 of bh, key tiles [tb, te) (split z)
struct Item {
  int bh, m0, z, tb, te;
};

// item w: the last query tiles first (under causal masking they walk the
// most keys), then bh, then the split
__device__ __forceinline__ Item bf_item(int w, int bhn, int splits,
                                        int qtiles, int s, int g,
                                        int causal) {
  Item it;
  const int per = bhn * splits;
  const int rest = w % per;
  it.m0 = (qtiles - 1 - w / per) * kBfRows;
  it.bh = rest / splits;
  it.z = rest % splits;
  int kend = s;
  if (causal) kend = min(s, (min(it.m0 + kBfRows, s * g) - 1) / g + 1);
  const long long nt = (kend + kBfKeys - 1) / kBfKeys;
  it.tb = (int)(nt * it.z / splits);
  it.te = (int)(nt * (it.z + 1) / splits);
  return it;
}

// the i-th item a CTA takes: every gridDim-th, in alternate directions a
// round (one round where the grid has a CTA an item)
__device__ __forceinline__ int walk(int i) {
  const int n = gridDim.x;
  return i * n + ((i & 1) ? n - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// the online softmax of one 64 x 128 score tile in registers: sc[4j + 2h
// + c] is key k0 + 8j + 2tq + c of row row0 + 8h; on return sc holds p,
// m2 the running max (scaled log2 units), l the thread's running sum and
// corr the factor that rescales the earlier O
template <bool kEdge>
__device__ __forceinline__ void bf_softmax(float* sc, float* m2, float* l,
                                           float* corr, int k0, int tq,
                                           const int* qpos, int s,
                                           int causal, float sl2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBfKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      if (kEdge) {
        const int kp = k0 + 8 * j + 2 * tq + (e & 1);
        if (kp >= s || (causal && kp > qpos[h])) sc[4 * j + e] = -INFINITY;
      }
      mx[h] = fmaxf(mx[h], sc[4 * j + e]);
    }
  float nm[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    nm[h] = fmaxf(m2[h], quad_max(mx[h]) * sl2);
    corr[h] = ex2(m2[h] - nm[h]);
    m2[h] = nm[h];
  }
#pragma unroll
  for (int i = 0; i < kBfKeys / 2; ++i) {
    const int h = (i % 4) / 2;
    sc[i] = ex2(fmaf(sc[i], sl2, -nm[h]));
    rsum[h] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rsum[h];
}

// S = Q K^T of a warpgroup's 64 rows (Q at qa_s, in a tile of kBfRows
// rows) against the 128 keys of the K tile at k_s, both K-major as stored
template <int D>
__device__ __forceinline__ void bf_scores(float* sc, uint32_t qa_s,
                                          uint32_t k_s) {
  constexpr int CB = Rows<D, bf16>::kCB;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % (CB / 32)) * 32;
    const uint32_t ch = kk / (CB / 32);
    Mma<kBfKeys>::ss_bf16(sc, smem_desc<CB>(qa_s + ch * kBfRows * CB + off),
                          smem_desc<CB>(k_s + ch * kBfKeys * CB + off));
  }
}

// O += P V: P the bf16 A fragments of a 64 x 128 tile, V at v_s (a
// [128 keys, D] tile, read MN-major through the transpose bit)
template <int D>
__device__ __forceinline__ void bf_pv(float* o, const uint32_t (*pa)[4],
                                      uint32_t v_s) {
  using R = Rows<D, bf16>;
  constexpr int CB = R::kCB, CE = R::kChunkElems;
#pragma unroll
  for (int kk = 0; kk < kBfKeys / 16; ++kk) {
    const uint64_t vd = smem_desc<CB>(v_s + kk * 16 * CB);
    if constexpr (D == 128) {
      // both 64-column chunks in one m64n128k16
      Mma<128>::rs_bf16_bt(o, pa[kk], with_atom_stride(vd, kBfKeys * CB));
    } else {
      Mma<CE>::rs_bf16_bt(o, pa[kk], vd);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBfThreads, 1)
flash_attention_kernel_bf16(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            float* __restrict__ part, int bhn, int s, int g,
                            int qtiles, int splits, int causal,
                            float scale) {
  using C = BfCfg<D>;
  constexpr int CB = C::kCB, CE = C::kChunkElems;
  extern __shared__ __align__(1024) uint8_t smem_bf[];
  const uint32_t raw = smem_u32(smem_bf);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, stage_s = base + C::kOffStage;
  const uint32_t bar_q = base + C::kOffBar, bar_qfree = bar_q + 8;
  const uint32_t bar_full = bar_q + 16;
  const uint32_t bar_empty = bar_full + 8 * kBfStages;
  const int items = qtiles * bhn * splits;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qfree, 2 * kWG);
    for (int st = 0; st < kBfStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // producer: per item Q, then its K / V tiles into the ring
    setmaxnreg_dec<kProdRegs>();
    if (threadIdx.x == 0) {
      int ring = 0, n = 0;
      for (int i = 0;; ++i) {
        const int w = walk(i);
        if (w >= items) break;
        const Item it = bf_item(w, bhn, splits, qtiles, s, g, causal);
        if (it.te == it.tb) continue;
        if (n > 0) mbar_wait(bar_qfree, (n - 1) & 1);
        mbar_expect_tx(bar_q, C::kQ);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_3d(q_s + c * kBfRows * CB, &qmap, bar_q, c * CE, it.m0,
                      it.bh);
        for (int t = it.tb; t < it.te; ++t, ++ring) {
          const int st = ring % kBfStages;
          if (ring >= kBfStages)
            mbar_wait(bar_empty + 8 * st, ((ring / kBfStages) - 1) & 1);
          const uint32_t full = bar_full + 8 * st;
          const uint32_t ks = stage_s + st * 2 * C::kKV;
          mbar_expect_tx(full, 2 * C::kKV);
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load_3d(ks + c * kBfKeys * CB, &kmap, full, c * CE,
                        t * kBfKeys, it.bh);
            tma_load_3d(ks + C::kKV + c * kBfKeys * CB, &vmap, full, c * CE,
                        t * kBfKeys, it.bh);
          }
        }
        ++n;
      }
    }
    return;
  }
  setmaxnreg_inc<kConsRegs>();

  // consumer warpgroup cwg: rows m0 + 64 cwg .. of each item
  const int ctid = threadIdx.x - kWG;
  const int cwg = ctid / kWG, warp = ctid / 32, lane = ctid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int lrow0 = cwg * kRowsWG + (warp % 4) * 16 + gq;   // and + 8
  const int m_rows = s * g;
  const long long all_rows = (long long)bhn * m_rows;
  const uint32_t qa_s = q_s + cwg * kRowsWG * CB;
  const float sl2 = scale * kLog2e;
  if (cwg == 1) named_arrive(2, 2 * kWG);   // warpgroup 0 goes first
  int ring = 0, n = 0;
  for (int i = 0;; ++i) {
    const int w = walk(i);
    if (w >= items) break;
    const Item it = bf_item(w, bhn, splits, qtiles, s, g, causal);
    const int nt = it.te - it.tb;
    const int row0 = it.m0 + lrow0;
    float o[D / 2];
#pragma unroll
    for (int k = 0; k < D / 2; ++k) o[k] = 0.f;
    float m2[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
    if (nt > 0) {
      const int qpos[2] = {row0 / g, (row0 + 8) / g};
      const int first_pos = (it.m0 + cwg * kRowsWG) / g;
      float sc[kBfKeys / 2], corr[2];
      uint32_t pa[kBfKeys / 16][4];
      // the softmax of tile j, with masks only where it crosses S or the
      // warpgroup's diagonal; to_pa makes its P the bf16 A fragments
      auto softmax = [&](int j) {
        const int k0 = (it.tb + j) * kBfKeys;
        if (k0 + kBfKeys > s || (causal && k0 + kBfKeys - 1 > first_pos))
          bf_softmax<true>(sc, m2, l, corr, k0, tq, qpos, s, causal, sl2);
        else
          bf_softmax<false>(sc, m2, l, corr, k0, tq, qpos, s, causal, sl2);
      };
      auto stage = [&](int j) {
        return stage_s + (ring + j) % kBfStages * 2 * C::kKV;
      };
      auto wait_full = [&](int j) {
        const int t = ring + j;
        mbar_wait(bar_full + 8 * (t % kBfStages), (t / kBfStages) & 1);
      };
      auto to_pa = [&]() {
#pragma unroll
        for (int kk = 0; kk < kBfKeys / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      };
      mbar_wait(bar_q, n & 1);
      // each turn issues this warpgroup's products between the other's:
      // tile 0's S alone, then tile j's S and tile j - 1's P V, then the
      // last tile's P V alone
      wait_full(0);
#pragma unroll
      for (int k = 0; k < kBfKeys / 2; ++k) sc[k] = 0.f;
      fence_regs<kBfKeys / 2>(sc);
      named_sync(2 + cwg, 2 * kWG);
      wgmma_fence();
      bf_scores<D>(sc, qa_s, stage(0));
      wgmma_commit();
      named_arrive(2 + (cwg ^ 1), 2 * kWG);
      wgmma_wait<0>();
      fence_regs<kBfKeys / 2>(sc);
      if (nt == 1) mbar_arrive(bar_qfree);   // Q read for the last time
      softmax(0);
      to_pa();
      for (int j = 1; j < nt; ++j) {
        wait_full(j);
#pragma unroll
        for (int k = 0; k < kBfKeys / 2; ++k) sc[k] = 0.f;
        fence_regs<kBfKeys / 2>(sc);
        fence_regs<D / 2>(o);
        fence_regs<kBfKeys / 4>(&pa[0][0]);
        named_sync(2 + cwg, 2 * kWG);
        wgmma_fence();
        bf_scores<D>(sc, qa_s, stage(j));
        wgmma_commit();
        bf_pv<D>(o, pa, stage(j - 1) + C::kKV);
        wgmma_commit();
        named_arrive(2 + (cwg ^ 1), 2 * kWG);
        wgmma_wait<1>();   // S alone: the softmax runs under P V
        fence_regs<kBfKeys / 2>(sc);
        if (j == nt - 1) mbar_arrive(bar_qfree);
        softmax(j);
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        mbar_arrive(bar_empty + 8 * ((ring + j - 1) % kBfStages));
#pragma unroll
        for (int k = 0; k < D / 2; ++k) o[k] *= corr[(k % 4) / 2];
        to_pa();
      }
      fence_regs<D / 2>(o);
      fence_regs<kBfKeys / 4>(&pa[0][0]);
      named_sync(2 + cwg, 2 * kWG);
      wgmma_fence();
      bf_pv<D>(o, pa, stage(nt - 1) + C::kKV);
      wgmma_commit();
      named_arrive(2 + (cwg ^ 1), 2 * kWG);
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      mbar_arrive(bar_empty + 8 * ((ring + nt - 1) % kBfStages));
      ring += nt;
      ++n;
    }
    // out = O / l and lse, or split z's partials (O, m2, l); o[4j + 2h +
    // c] is column 8j + 2tq + c of row row0 + 8h
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lr = quad_sum(l[h]);
      const int p = row0 + 8 * h;
      if (p >= m_rows) continue;
      const long long r = (long long)it.bh * m_rows + p;
      if (splits == 1) {
        const float denom = fmaxf(lr, 1e-30f);
        bf16* op = out + r * D + 2 * tq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          store2(op + 8 * j, o[4 * j + 2 * h] / denom,
                 o[4 * j + 2 * h + 1] / denom);
        if (lse != nullptr && tq == 0)
          lse[r] = (m2[h] + log2f(denom)) * kLn2;
      } else {
        const long long zr = it.z * all_rows + r;
        float* pp = part + zr * D + 2 * tq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          store2(pp + 8 * j, o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
        if (tq == 0) {
          float* ml = part + splits * all_rows * D;
          ml[zr] = m2[h];
          ml[splits * all_rows + zr] = lr;
        }
      }
    }
  }
}

// out and lse from the splits' partials, [splits, rows, D] O, then
// [splits, rows] m2 and [splits, rows] l: each row's O and l rescaled to
// the largest m2 and added in split order; four columns a thread
template <int D>
__global__ void flash_attention_combine(const float* __restrict__ part,
                                               bf16* __restrict__ out,
                                               float* __restrict__ lse,
                                               long long rows, int splits) {
  const float* mz = part + splits * rows * D;
  const float* lz = mz + splits * rows;
  const long long n = rows * (D / 4);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (D / 4);
    const int c = (int)(i % (D / 4)) * 4;
    float mmax = -INFINITY;
    for (int z = 0; z < splits; ++z) mmax = fmaxf(mmax, mz[z * rows + r]);
    float lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < splits; ++z) {
      const float wz = exp2f(mz[z * rows + r] - mmax);
      lsum += wz * lz[z * rows + r];
      const float4 x =
          *reinterpret_cast<const float4*>(part + (z * rows + r) * D + c);
      acc.x += wz * x.x;
      acc.y += wz * x.y;
      acc.z += wz * x.z;
      acc.w += wz * x.w;
    }
    const float denom = fmaxf(lsum, 1e-30f);
    store2(out + r * D + c, acc.x / denom, acc.y / denom);
    store2(out + r * D + c + 2, acc.z / denom, acc.w / denom);
    if (lse != nullptr && c == 0) lse[r] = (mmax + log2f(denom)) * kLn2;
  }
}

// ---- the f32 route

template <int D>
struct F32Cfg : Rows<D, float> {
  using R = Rows<D, float>;
  static constexpr int kTile = 32;                       // keys a tile
  static constexpr int kMaxWG = D == 128 ? 1 : 2;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kKV = kTile * R::kRowBytes;       // one split tile
  // a CTA of `rows` query rows: [Q hi | Q lo | stages x (K hi, K lo, V^T
  // hi, V^T lo) | V (one key tile: loaded raw, split here) | barriers]
  static __host__ __device__ int q_bytes(int rows) {
    return rows * R::kRowBytes;
  }
  static __host__ __device__ int off_stage(int rows) {
    return 2 * q_bytes(rows);
  }
  static __host__ __device__ int off_bar(int rows, int stages, int one) {
    return off_stage(rows) + stages * 4 * kKV + (one ? kKV : 0);
  }
  static __host__ __device__ int smem_bytes(int rows, int stages, int one) {
    return off_bar(rows, stages, one) + 64 + 1024;
  }
};

// V^T's column of key r: keys permuted within each group of 8 to match
// P's A fragment, (t, t + 4) <- (2t, 2t + 1)
__device__ __forceinline__ int vt_col(int r) {
  return (r & ~7) + (r % 8) / 2 + 4 * (r & 1);
}

// K -> K hi, K lo [BH, S_pad, D]; V -> V^T hi, V^T lo [BH, D, S_pad],
// keys permuted (vt_col); zeros for the keys past S. split holds the four
// planes in that order. Block (32 keys, bh).
template <int D>
__global__ void flash_attention_presplit(const float* __restrict__ k,
                                                const float* __restrict__ v,
                                                float* __restrict__ split,
                                                int s, int s_pad, int bhn) {
  __shared__ float vs[32][D + 1];
  const int bh = blockIdx.y, k0 = blockIdx.x * 32;
  const size_t plane = (size_t)bhn * s_pad * D;
  float* khi = split + (size_t)bh * s_pad * D;
  float* vhi = split + 2 * plane + (size_t)bh * D * s_pad;
  for (int i = threadIdx.x; i < 32 * D; i += blockDim.x) {
    const int r = i / D, d = i % D, key = k0 + r;
    const size_t src = ((size_t)bh * s + key) * D + d;
    const float x = key < s ? k[src] : 0.f, hi = tf32_hi(x);
    khi[(size_t)key * D + d] = hi;
    khi[plane + (size_t)key * D + d] = tf32_rna(x - hi);
    vs[r][d] = key < s ? v[src] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * D; i += blockDim.x) {
    const int d = i / 32, kc = i % 32;
    // the key stored at column kc (vt_col's inverse)
    const int r = (kc & ~7) + ((kc & 7) < 4 ? 2 * (kc & 7) : 2 * (kc & 7) - 7);
    const float x = vs[r][d], hi = tf32_hi(x);
    vhi[(size_t)d * s_pad + k0 + kc] = hi;
    vhi[plane + (size_t)d * s_pad + k0 + kc] = tf32_rna(x - hi);
  }
}

template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::kMaxWG * kWG + 32, 1)
flash_attention_kernel_f32(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap klomap,
                           const __grid_constant__ CUtensorMap vtmap,
                           const __grid_constant__ CUtensorMap vtlomap,
                           const __grid_constant__ CUtensorMap vmap,
                           float* __restrict__ out, float* __restrict__ lse,
                           int bhn, int s, int g, int n_wg, int tiles,
                           int stages, int one_tile, int causal,
                           float scale) {
  using C = F32Cfg<D>;
  constexpr int CB = C::kCB, TK = C::kTile, KV = C::kKV;
  extern __shared__ __align__(1024) uint8_t smem_f32[];
  const uint32_t raw = smem_u32(smem_f32);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sp = smem_f32 + (base - raw);

  const int rows = n_wg * kRowsWG;       // query rows of this CTA
  const int nc = n_wg * kWG;             // consumer threads
  const int m_rows = s * g;              // query rows of a bh
  const int bh = blockIdx.x % bhn;       // the last query tiles first
  const int m0 = (tiles - 1 - (int)blockIdx.x / bhn) * rows;
  int kend = s;
  if (causal) {                          // the CTA's last row bounds its keys
    const int plast = min(m0 + rows, m_rows) - 1;
    kend = plast / g + 1;
  }
  const int ntiles = (kend + TK - 1) / TK;

  const uint32_t bar_q = base + C::off_bar(rows, stages, one_tile);
  const uint32_t bar_full = bar_q + 8;                // `stages` of them
  const uint32_t bar_empty = bar_full + 8 * stages;   // `stages` of them
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
  const uint32_t vraw_s = stage_s + stages * 4 * KV;   // one key tile's V
  // Q, then tiles 0 .. n - 1 into the ring, by one thread: the split K
  // hi, K lo, V^T hi and V^T lo tiles, or (one key tile) K and V as they
  // are
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
      const uint32_t ks = stage_s + st * 4 * KV;
      mbar_expect_tx(full, (one_tile ? 2 : 4) * KV);
      for (int c = 0; c < C::kChunks; ++c) {
        const int x = c * C::kChunkElems;
        tma_load_3d(ks + c * TK * CB, &kmap, full, x, t * TK, bh);
        if (one_tile)
          tma_load_3d(vraw_s + c * TK * CB, &vmap, full, x, t * TK, bh);
        else
          tma_load_3d(ks + KV + c * TK * CB, &klomap, full, x, t * TK, bh);
      }
      if (!one_tile) {
        tma_load_3d(ks + 2 * KV, &vtmap, full, t * TK, 0, bh);
        tma_load_3d(ks + 3 * KV, &vtlomap, full, t * TK, 0, bh);
      }
    }
  };
  if (!one_tile) {
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
  const uint32_t qlo_s = qa_s + C::q_bytes(rows);  // Q's lo

  mbar_wait(bar_q, 0);
  {
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
    const uint32_t ks = stage_s + st * 4 * KV;
    const uint32_t khi_s = ks, klo_s = ks + KV;
    const uint32_t vthi_s = ks + 2 * KV, vtlo_s = ks + 3 * KV;
    mbar_wait(bar_full + 8 * st, (t / stages) & 1);
    if (one_tile) {
      // K's hi in place, its lo beside it (K's layout); V^T hi and lo
      // ([D] rows of 32 keys, 128-byte swizzle, keys permuted, vt_col)
      float* kp = reinterpret_cast<float*>(sp + (ks - base));
      const uint8_t* vp = sp + (vraw_s - base);
      uint8_t* vt = sp + (vthi_s - base);
      for (int i = tid; i < TK * D; i += nc) {
        const float x = kp[i], hi = tf32_hi(x);
        kp[i] = hi;
        kp[TK * D + i] = tf32_rna(x - hi);
      }
      for (int i = tid; i < TK * D; i += nc) {
        const int r = i % TK, d = i / TK;            // key, dim
        const uint32_t src = (d / C::kChunkElems) * TK * CB +
                             swz<CB>(r * CB + (d % C::kChunkElems) * 4);
        const uint32_t dst = swz<128>(d * 128 + vt_col(r) * 4);
        const float x = *reinterpret_cast<const float*>(vp + src);
        const float hi = tf32_hi(x);
        *reinterpret_cast<float*>(vt + dst) = hi;
        *reinterpret_cast<float*>(vt + KV + dst) = tf32_rna(x - hi);
      }
      fence_proxy_async();
      consumers_sync(nc);
    }

    float sc[TK / 2];
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) sc[i] = 0.f;
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
      // key k0 < kend <= s is in every tile, so mx is finite
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
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
    mbar_arrive(bar_empty + 8 * st);    // the stage is free again
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      o[i] = fmaf(o[i], corr[(i % 4) / 2], pv[i]);
  }

  // out = O / l; o[4j + 2h + c] is column 8j + 2 tq + c of row row0 + 8h;
  // where asked, the row's log-sum-exp m + log l (the backward's p)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float denom = fmaxf(quad_sum(l_run[h]), 1e-30f);
    const int p = row0 + 8 * h;
    if (p < m_rows) {
      float* op = out + ((long long)bh * m_rows + p) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(op + 8 * j, o[4 * j + 2 * h] / denom,
               o[4 * j + 2 * h + 1] / denom);
      if (lse != nullptr && tq == 0)
        lse[(long long)bh * m_rows + p] = m_run[h] + logf(denom);
    }
  }
}

// ---- host

// a [bh, D, s_pad] f32 plane as a 3-D map whose box is 32 keys (128
// bytes) by D rows, swizzled at 128 bytes: one V^T tile
template <int D>
bool encode_vt(CUtensorMap* map, const float* ptr, int s_pad, int bh) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)s_pad, (cuuint64_t)D,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)s_pad * 4,
                                 (cuuint64_t)s_pad * 4 * D};
  const cuuint32_t box[3] = {32, (cuuint32_t)D, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, float* part, int bh, int s, int g, int causal,
                float scale, int splits, int sms,
                cudaStream_t stream) {
  using C = BfCfg<D>;
  const long long m = (long long)s * g;
  const long long qtiles = (m + kBfRows - 1) / kBfRows;
  const long long items = qtiles * bh * splits;
  if (items > INT_MAX || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!encode<D, bf16>(&qm, q, m, bh, kBfRows) ||
      !encode<D, bf16>(&km, k, s, bh, kBfKeys) ||
      !encode<D, bf16>(&vm, v, s, bh, kBfKeys))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;   // per instantiation, before its first launch
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_bf16<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const long long grid = sms > 0 && sms < items ? sms : items;
  bf16* o = static_cast<bf16*>(out);
  flash_attention_kernel_bf16<D>
      <<<(unsigned)grid, kBfThreads, C::kSmem, stream>>>(
          qm, km, vm, o, lse, part, bh, s, g, (int)qtiles, splits, causal,
          scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long rows = (long long)bh * m;
  long long blocks = (rows * (D / 4) + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  flash_attention_combine<D><<<(unsigned)blocks, 256, 0, stream>>>(
      part, o, lse, rows, splits);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, float* split, int bh, int s, int g, int causal,
               float scale, cudaStream_t stream) {
  using C = F32Cfg<D>;
  const long long m = (long long)s * g;
  const int n_wg = (m <= kRowsWG || C::kMaxWG == 1) ? 1 : 2;
  const int rows = n_wg * kRowsWG;
  const long long tiles = (m + rows - 1) / rows;
  const long long blocks = tiles * bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  // one key tile: K and V as they are, split in the CTA, one stage and
  // no producer warp; else the pre-pass's split planes
  const int one_tile = s <= C::kTile;
  if (!one_tile && split == nullptr) return (int)cudaErrorInvalidValue;
  const int s_pad = (s + C::kTile - 1) / C::kTile * C::kTile;
  const int stages = one_tile ? 1 : C::kStages;
  CUtensorMap qm, km, klm, vtm, vtlm, vm;
  const size_t plane = (size_t)bh * s_pad * D;
  if (!encode<D, float>(&qm, q, m, bh, rows) ||
      !encode<D, float>(&vm, v, s, bh, C::kTile))
    return (int)cudaErrorInvalidValue;
  if (one_tile) {
    if (!encode<D, float>(&km, k, s, bh, C::kTile))
      return (int)cudaErrorInvalidValue;
    klm = vtm = vtlm = km;
  } else if (!encode<D, float>(&km, split, s_pad, bh, C::kTile) ||
             !encode<D, float>(&klm, split + plane, s_pad, bh, C::kTile) ||
             !encode_vt<D>(&vtm, split + 2 * plane, s_pad, bh) ||
             !encode_vt<D>(&vtlm, split + 3 * plane, s_pad, bh)) {
    return (int)cudaErrorInvalidValue;
  }
  static bool attr_set = false;   // per instantiation, before its first launch
  if (!attr_set) {
    const int most = C::smem_bytes(C::kMaxWG * kRowsWG, C::kStages, 0);
    const int one = C::smem_bytes(C::kMaxWG * kRowsWG, 1, 1);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_f32<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, most > one ? most : one);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  if (!one_tile) {
    flash_attention_presplit<D>
        <<<dim3((unsigned)(s_pad / 32), (unsigned)bh), 256, 0, stream>>>(
            kf, vf, split, s, s_pad, bh);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  flash_attention_kernel_f32<D>
      <<<(unsigned)blocks, n_wg * kWG + (one_tile ? 0 : 32),
         C::smem_bytes(rows, stages, one_tile), stream>>>(
          qm, km, klm, vtm, vtlm, vm, static_cast<float*>(out), lse, bh, s,
          g, n_wg, (int)tiles, stages, one_tile, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out all of it). d must be
// 16, 32, 64 or 128; q, k, v and out 16-byte aligned (TMA). lse, where not
// null, is [bh, s * g] float32 and takes each row's log-sum-exp of its
// scaled scores, m + log(max(l, 1e-30)) (the reference's residual, which
// the backward's p = exp(scale s - lse) reads); null writes nothing more.
// scratch: float32, for bfloat16 with splits > 1 the splits' partials,
// splits * bh * s * g * (d + 2) floats; for float32 with s > 32 the
// pre-pass's split K and V, 4 * bh * s_pad * d floats with s_pad = s
// rounded up to 32; else unused (may be null). splits (bfloat16 only,
// else 1): the key splits of each query tile. sms: the card's SMs (the
// persistent grid). Returns cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue for an unsupported d / dtype, a grid
// past 2^31 - 1 blocks, missing scratch or a tensor map that
// cuTensorMapEncodeTiled refuses. Launches on `stream`, never synchronises.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      void* scratch, int bh, int s, int g,
                                      int d, int dtype, int causal,
                                      float scale, int splits, int sms,
                                      void* stream) {
  if (bh <= 0 || s <= 0 || g <= 0) return (int)cudaGetLastError();
  if ((long long)s * g > INT_MAX / 2 || splits < 1 ||
      (dtype == 0 && splits != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  float* sc = static_cast<float*>(scratch);
#define FWD_ARGS q, k, v, out, l, sc, bh, s, g, causal, scale
  if (dtype == 0) {
    switch (d) {
      case 16: return launch_f32<16>(FWD_ARGS, st);
      case 32: return launch_f32<32>(FWD_ARGS, st);
      case 64: return launch_f32<64>(FWD_ARGS, st);
      case 128: return launch_f32<128>(FWD_ARGS, st);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 16: return launch_bf16<16>(FWD_ARGS, splits, sms, st);
      case 32: return launch_bf16<32>(FWD_ARGS, splits, sms, st);
      case 64: return launch_bf16<64>(FWD_ARGS, splits, sms, st);
      case 128: return launch_bf16<128>(FWD_ARGS, splits, sms, st);
    }
  }
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}
