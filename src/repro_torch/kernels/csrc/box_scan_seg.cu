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
// int32 at the end: the same f32 sums of the same 0/1 terms, exact below
// 2^24 boxes per query. Comparisons are never rewritten as subtractions
// and no fast-math is used, so +inf row padding, impossible (+inf, -inf)
// box padding and NaN give exactly the plain version's answer.
//
// Rows are read in place from the Morton-ordered index rows3 [NB, block,
// D]: candidate slot s holds block cand[s], and every row of a slot
// >= *n_hit (a device scalar: the zone prune's survivor count) is written
// as zero without being tested, with no host round trip. A flat x [N, D]
// is the case rows3 = x[None], cand = [0], n_hit = 1, block = N.
//
// Bound on the H100: the bytes. At the main path's shapes (C * block =
// 64K..256K rows, d' = 6, Q = 8) it reads min(n_hit, C) * block * D * 4
// bytes of rows and writes C * block * Q * 4 bytes of counts, zeros
// included (the larger part); the compares (two a row, box and dim up to
// the row group's first failing dim) take less time than those bytes.
//
// Design: a persistent grid (two CTAs an SM) over work items, an item
// being up to 1024 rows of one live slot. The boxes are staged while the
// first item's copy is in flight.
// - Each CTA reads *n_hit once. The dead slots' rows form one contiguous
//   range of `out`, which the grid zeroes with 16-byte stores.
// - The last warp's first thread copies each of the CTA's items (one
//   contiguous span of rows3, 24 KB at d' = 6) into a 2-stage ring with
//   one cp.async.bulk (bulk_copy.cuh: the aligned middle, plus at most
//   six edge words by plain loads), completing on full / empty mbarriers.
// - The boxes and ownership columns are staged in shared memory once per
//   CTA (in chunks only past 64 KB of them) as records of interleaved
//   (lo, hi) pairs, padded to 16 bytes, then the box's Q ownership values
//   padded to 8: a box's 6 dims are three 16-byte broadcast loads.
// - Register blocking: each of the 256 consumer threads holds R = 4 rows
//   of the item in registers (D <= 6) and releases the stage at once, so
//   the next item's copy overlaps the compares. A warp holds a contiguous
//   run of 128 rows of the Morton-ordered block. Its lanes test 32 boxes
//   at a time against the run's bounding box (NaN left out: a box that
//   misses it holds none of the rows), and the warp walks the ballot of
//   the boxes that meet it in box order. Each of those is tested against
//   a thread's 4 rows, two dims at a time, leaving the box as soon as
//   none of the 4 is still inside; a box that holds one of them adds its
//   8 ownership values (two more broadcast loads).
// - Counts go out as 16-byte stores where Q % 4 == 0, scalar stores
//   otherwise; Q > 8 runs the box loop once per group of 8 queries. D > 6
//   reads the rows from the staged item instead of registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kSegWarps = 8;                         // consumer warps
constexpr int kConsumers = 32 * kSegWarps;
constexpr int kSegThreads = kConsumers + 32;         // + producer warp
constexpr int kR = 4;                     // rows a consumer thread holds
constexpr int kMaxTileRows = kConsumers * kR;        // 1024
constexpr int kQC = 8;        // queries accumulated in registers a pass
constexpr int kStages = 2;
constexpr int kStageTarget = 32 * 1024;   // bytes of rows a stage
constexpr int kBoxBudget = 64 * 1024;     // bytes of box records a chunk
constexpr int kMaxDR = 6;                 // dims a row held in registers
// shared memory: barriers | warps' bounding boxes | box records | ring
constexpr int kBBoxOff = 64;
constexpr int kBoxOff = kBBoxOff + kSegWarps * kMaxDR * 2 * 4;
static_assert(kBBoxOff >= 16 * kStages && kBoxOff % 16 == 0, "layout");

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// out[a, b) = 0 over the grid: 16-byte stores for the aligned middle
// (out is 16-byte aligned), the first CTA the few words around it
__device__ void zero_range(int32_t* __restrict__ out, long long a,
                           long long b) {
  if (a >= b) return;
  const int tid = threadIdx.x;
  const long long a4 = min(b, (a + 3) & ~3LL);
  const long long b4 = max(a4, b & ~3LL);
  if (blockIdx.x == 0) {
    for (long long i = a + tid; i < a4; i += kConsumers) out[i] = 0;
    for (long long i = b4 + tid; i < b; i += kConsumers) out[i] = 0;
  }
  int4* o4 = reinterpret_cast<int4*>(out + a4);
  const long long n4 = (b4 - a4) / 4;
  for (long long i = (long long)blockIdx.x * kConsumers + tid; i < n4;
       i += (long long)gridDim.x * kConsumers)
    o4[i] = make_int4(0, 0, 0, 0);
}

// DR: the rows' dims held in registers (kMaxDR, for D <= kMaxDR), or 0
// (D > kMaxDR: read from the staged item)
// Two CTAs an SM: ptxas then keeps 96 registers and spills ~70 bytes a
// thread of the row values and sums, read back once an item. A
// spill-free build at 111 registers (__maxnreg__(112)) ran slower on the
// H100 at the fused batch's probe shapes.
template <int DR>
__global__ void __launch_bounds__(kSegThreads, 2)
box_scan_seg_kernel(const float* __restrict__ rows3,
                    const int32_t* __restrict__ cand,
                    const int32_t* __restrict__ n_hit, int block,
                    int n_cand, const float* __restrict__ lo,
                    const float* __restrict__ hi,
                    const float* __restrict__ onehot, int nb, int d, int nq,
                    int tile_rows, int stage_bytes, int ring_off,
                    int box_chunk, int pw, int qp,
                    int32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t bars = bulk::smem_u32(smem);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  float* s_box = reinterpret_cast<float*>(smem + kBoxOff);
  float* s_bbox = reinterpret_cast<float*>(smem + kBBoxOff);
  uint8_t* ring = smem + ring_off;
  const int stride = pw + qp;                      // floats a box record
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int nh = max(0, min(*n_hit, n_cand));
  const int tps = (block + tile_rows - 1) / tile_rows;   // items a slot
  // items to test; without boxes every count is 0
  const long long live = nb > 0 ? (long long)nh * tps : 0;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      bulk::mbar_init(full(st), 1);
      bulk::mbar_init(empty(st), kSegWarps);
    }
    bulk::mbar_init_fence();
  }
  __syncthreads();
  auto item_src = [&](long long it) {
    const long long slot = it / tps, t = it % tps;
    return rows3 + ((long long)cand[slot] * block + t * tile_rows) * d;
  };
  auto item_rows = [&](long long it) {
    return min(tile_rows, block - (int)(it % tps) * tile_rows);
  };

  if (warp == kSegWarps) {
    // producer: this CTA's items, in order, into the ring
    long long k = 0;
    for (long long it = blockIdx.x; it < live; it += gridDim.x, ++k) {
      const int st = (int)(k % kStages);
      if (k >= kStages)
        bulk::mbar_wait(empty(st), (uint32_t)((k / kStages) - 1) & 1);
      if (lane == 0)
        bulk::copy_span(ring + (size_t)st * stage_bytes, item_src(it),
                        (uint32_t)item_rows(it) * d * 4, full(st));
      __syncwarp();
    }
    return;
  }

  zero_range(out, nb > 0 ? (long long)nh * block * nq : 0,
             (long long)n_cand * block * nq);
  const int n_chunks = (nb + box_chunk - 1) / box_chunk;
  int staged = -1;                       // the chunk in s_box
  auto stage = [&](int c) {
    const int b0 = c * box_chunk, bn = min(box_chunk, nb - b0);
    consumers_sync();                    // the last chunk's readers
    for (int i = tid; i < bn * stride; i += kConsumers) {
      const int bb = i / stride, f = i % stride;
      const size_t b = (size_t)(b0 + bb);
      float v = 0.f;
      if (f < 2 * d)
        v = (f & 1 ? hi : lo)[b * d + f / 2];
      else if (f >= pw && f - pw < nq)
        v = onehot[b * nq + (f - pw)];
      s_box[i] = v;
    }
    consumers_sync();
    staged = c;
  };
  // the first chunk's reads overlap the first item's copy
  if (blockIdx.x < live) stage(0);
  // warp w holds the item's rows w * 128 + lane + 32 j: a contiguous run
  // of the Morton-ordered block, whose bounding box is tight
  auto row_of = [&](int j) { return warp * (32 * kR) + lane + 32 * j; };
  long long k = 0;
  for (long long it = blockIdx.x; it < live; it += gridDim.x, ++k) {
    const int st = (int)(k % kStages);
    const int rows = item_rows(it);
    const long long out_row =
        (it / tps) * (long long)block + (it % tps) * (long long)tile_rows;
    bulk::mbar_wait(full(st), (uint32_t)(k / kStages) & 1);
    const float* xs = reinterpret_cast<const float*>(
        ring + (size_t)st * stage_bytes + bulk::span_head(item_src(it)));
    bool live_r[kR];
    float xr[kR][DR > 0 ? DR : 1];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int r = row_of(j);
      live_r[j] = r < rows;
      if constexpr (DR > 0) {
#pragma unroll
        for (int kk = 0; kk < DR; ++kk)
          xr[j][kk] = (live_r[j] && kk < d) ? xs[r * d + kk] : 0.f;
      }
    }
    // the warp's bounding box of its live rows (NaN left out: a NaN row
    // is inside no box), in shared memory as (min, max) pairs laid out as
    // the box records' (lo, hi): a box that misses it holds none of them
    float* s_bb = s_bbox + warp * kMaxDR * 2;
    if constexpr (DR > 0) {
      // the rows are in registers: the stage can refill now
      __syncwarp();
      if (lane == 0) bulk::mbar_arrive(empty(st));
#pragma unroll
      for (int kk = 0; kk < DR; ++kk) {
        float mn = __int_as_float(0x7f800000), mx = -mn;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          if (live_r[j]) {
            mn = fminf(mn, xr[j][kk]);
            mx = fmaxf(mx, xr[j][kk]);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o /= 2) {
          mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        if (lane == 0) {
          s_bb[2 * kk] = mn;
          s_bb[2 * kk + 1] = mx;
        }
      }
      __syncwarp();
    }
    for (int q0 = 0; q0 < nq; q0 += kQC) {
      float acc[kR][kQC];
#pragma unroll
      for (int j = 0; j < kR; ++j)
#pragma unroll
        for (int qq = 0; qq < kQC; ++qq) acc[j][qq] = 0.f;
      for (int c = 0; c < n_chunks; ++c) {
        const int bn = min(box_chunk, nb - c * box_chunk);
        if (staged != c) stage(c);
        for (int g0 = 0; g0 < bn; g0 += 32) {
          // which of the next 32 boxes meet the warp's bounding box: lane
          // i tests box g0 + i (for D > kMaxDR every box counts as meeting)
          bool meets = g0 + lane < bn;
          if constexpr (DR > 0) {
            const float4* r4 = reinterpret_cast<const float4*>(
                s_box + (size_t)(g0 + lane) * stride);
            const float4* w4 = reinterpret_cast<const float4*>(s_bb);
#pragma unroll
            for (int p = 0; p < DR / 2; ++p) {
              if (meets && 2 * p < d) {
                const float4 b = r4[p], w = w4[p];
                meets = (b.x < w.y) && (w.x <= b.y);
                if (2 * p + 1 < d)
                  meets = meets && (b.z < w.w) && (w.z <= b.w);
              }
            }
          }
          // the meeting boxes in ascending order (warp-uniform)
          for (unsigned mask = __ballot_sync(0xffffffffu, meets); mask;
               mask &= mask - 1) {
            const int bb = g0 + __ffs(mask) - 1;
            const float* rec = s_box + (size_t)bb * stride;
            const float4* r4 = reinterpret_cast<const float4*>(rec);
            bool in[kR];
#pragma unroll
            for (int j = 0; j < kR; ++j) in[j] = live_r[j];
            bool any = true;
            if constexpr (DR > 0) {
#pragma unroll
              for (int p = 0; p < DR / 2; ++p) {
                if (2 * p < d && any) {
                  const float4 b = r4[p];      // lo, hi of dims 2p, 2p + 1
                  any = false;
#pragma unroll
                  for (int j = 0; j < kR; ++j) {
                    const float v0 = xr[j][2 * p], v1 = xr[j][2 * p + 1];
                    in[j] = in[j] && (v0 > b.x) && (v0 <= b.y);
                    if (2 * p + 1 < d)
                      in[j] = in[j] && (v1 > b.z) && (v1 <= b.w);
                    any |= in[j];
                  }
                }
              }
            } else {
              any = false;
#pragma unroll
              for (int j = 0; j < kR; ++j) {
                const float* row = xs + (size_t)row_of(j) * d;
                for (int kk = 0; kk < d && in[j]; ++kk) {
                  const float v = row[kk];
                  in[j] = (v > rec[2 * kk]) && (v <= rec[2 * kk + 1]);
                }
                any |= in[j];
              }
            }
            if (any) {
              const float4 o0 = r4[(pw + q0) / 4], o1 = r4[(pw + q0) / 4 + 1];
#pragma unroll
              for (int j = 0; j < kR; ++j) {
                if (in[j]) {
                  acc[j][0] += o0.x; acc[j][1] += o0.y;
                  acc[j][2] += o0.z; acc[j][3] += o0.w;
                  acc[j][4] += o1.x; acc[j][5] += o1.y;
                  acc[j][6] += o1.z; acc[j][7] += o1.w;
                }
              }
            }
          }
        }
      }
      const int qn = min(kQC, nq - q0);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        if (!live_r[j]) continue;
        int32_t* o = out + (out_row + row_of(j)) * nq + q0;
        if (nq % 4 == 0) {
#pragma unroll
          for (int v = 0; v < kQC / 4; ++v) {
            if (4 * v < qn)
              reinterpret_cast<int4*>(o)[v] = make_int4(
                  (int32_t)acc[j][4 * v], (int32_t)acc[j][4 * v + 1],
                  (int32_t)acc[j][4 * v + 2], (int32_t)acc[j][4 * v + 3]);
          }
        } else {
#pragma unroll
          for (int qq = 0; qq < kQC; ++qq)
            if (qq < qn) o[qq] = (int32_t)acc[j][qq];
        }
      }
    }
    if constexpr (DR == 0) {
      __syncwarp();
      if (lane == 0) bulk::mbar_arrive(empty(st));
    }
  }
}

template <int DR>
int launch(const float* x, const int32_t* cand, const int32_t* n_hit,
           int block, const float* lo, const float* hi,
           const float* onehot, int n, int nb, int d, int nq, int32_t* out,
           cudaStream_t s) {
  auto kernel = box_scan_seg_kernel<DR>;
  const int pw = (2 * d + 3) / 4 * 4;             // (lo, hi) pairs, padded
  const int qp = (nq + kQC - 1) / kQC * kQC;      // ownership, padded
  const int rec_bytes = (pw + qp) * (int)sizeof(float);
  int tile_rows = d > 0 ? kStageTarget / (4 * d) : kMaxTileRows;
  if (tile_rows > kMaxTileRows) tile_rows = kMaxTileRows;
  if (tile_rows > block) tile_rows = block;
  if (tile_rows < 1) tile_rows = 1;
  // + 16: a span not 16-byte aligned starts up to 12 bytes into its stage
  const int stage_bytes = (tile_rows * 4 * d + 16 + 127) / 128 * 128;
  int box_chunk = kBoxBudget / rec_bytes;
  if (box_chunk > nb) box_chunk = nb;
  if (box_chunk < 1) box_chunk = 1;
  const int ring_off = (kBoxOff + box_chunk * rec_bytes + 127) / 128 * 128;
  const size_t smem = (size_t)ring_off + (size_t)kStages * stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_cand = n / block;
  const long long items =
      (long long)n_cand * ((block + tile_rows - 1) / tile_rows);
  long long blocks = 2LL * bulk_sm_count();
  if (blocks > items) blocks = items;
  kernel<<<(unsigned)blocks, kSegThreads, smem, s>>>(
      x, cand, n_hit, block, n_cand, lo, hi, onehot, nb, d, nq, tile_rows,
      stage_bytes, ring_off, box_chunk, pw, qp, out);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  // rows in registers at the main path's d' = 6 and below
  if (d <= kMaxDR)
    return launch<kMaxDR>(x, cand, n_hit, block, lo, hi, onehot, n, nb, d,
                          nq, out, s);
  return launch<0>(x, cand, n_hit, block, lo, hi, onehot, n, nb, d, nq, out,
                   s);
}
