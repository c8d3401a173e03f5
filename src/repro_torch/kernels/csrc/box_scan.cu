// box_scan for Hopper (sm_90a): box-membership counts over a full scan,
// and over the surviving blocks of a pruned index (box_scan_pruned).
//
// Replaces: src/repro/kernels/box_scan.py::box_scan_pallas (body
// _box_scan_kernel). For rows x [N, D] and boxes lo/hi [B, D] (all f32,
// row-major):
//     out[i] = number of boxes b with lo[b, k] < x[i, k] <= hi[b, k]
//              on EVERY dim k
// as int32. It serves full_scan, the dtree/rforest scan over the whole
// [n, 384] feature matrix with full-width tree boxes; query_index (the
// engine's use_fused=False oracle) over the surviving blocks' rows at
// d' = 6; and, as box_scan_pruned, core/index.pruned_local_step, the
// per-shard step of the pruned distributed query:
//     box_scan_pruned(rows3 [NB, block, D], cand [C], n_hit [], lo, hi)
//       -> out [NB * block], out[b * block + r] = count of rows3[b, r]
//          where b == cand[s] for some s < min(n_hit, C), else 0,
// what the reference writes as a gather, a scan, a validity mask and
// out.at[cand].max(counts) into zeros. cand[0 : min(n_hit, C)] must be
// ascending, unique and in [0, NB) (zone_candidates' survivors are).
// Comparisons are written exactly as in the Pallas body and never as a
// subtraction, and no fast-math is used, so the (-inf, +inf) bounds of
// unconstrained tree dims, +inf row padding and NaN rows (inside no box)
// give exactly the plain version's answer.
//
// Bound on the H100: the bytes. x is read once (1.61 GB at the full
// scan's 1,048,576 x 384, 0.48 ms at 3.35 TB/s); the compares the data
// needs are N * D for the row check below plus two a constrained dim up to
// each box's first failing one, a small fraction of that. The pruned
// step reads only the surviving blocks and writes every count once: at
// the paper catalog's 90,429,772 rows of d' = 6, 20,021 surviving blocks
// of 1,024 (492 MB) read and 362 MB of counts written.
//
// Full-width path (8 < D <= kMaxListD): constrained-dim lists and a ring
// of row tiles filled by bulk asynchronous copies.
// - A tree leaf's box constrains at most max_depth dims and leaves the
//   rest at (-inf, +inf). Each CTA compiles a chunk of boxes into shared
//   memory as per-box lists of the dims they constrain, ascending, with
//   their (lo, hi): a dim is constrained unless lo == -inf && hi == +inf
//   (a NaN bound is constrained and lets no row in). Skipping the other
//   dims is exact only with a row check: a row holding NaN or -inf in any
//   dim is inside no box (x > -inf fails there), and any other row passes
//   every unconstrained dim. So
//       count = row_ok ? sum_b [every listed dim of b passes] : 0,
//       row_ok = all_k (x_k > -inf).
// - Rows stream through a persistent grid (one CTA an SM): the last warp's
//   first thread copies T consecutive rows (one contiguous T * D * 4-byte
//   span, ~48 KB) into a 3-stage ring with one cp.async.bulk a stage
//   (bulk_copy.cuh: rows whose byte length is not a multiple of 16 take
//   the same bulk copy for the aligned middle and plain loads for at most
//   six edge words), completing on full / empty mbarriers, so two stages
//   (~96 KB) are in flight an SM while the third is tested.
// - 16 consumer warps test the staged tile, a warp a row at a time: its
//   lanes take the boxes (lane j boxes j, j + 32, ...), each lane walking
//   its box's list and stopping at the first failing dim, and
//   __reduce_add_sync sums the lanes. Only a row the lists put in some box
//   pays for the row check (its lanes read dims lane, lane + 32, ...:
//   consecutive words, no bank conflicts); a row in no box counts 0
//   whatever it holds. A row costs a few warp instructions a box, not
//   B * D / 32.
//   Every row walks the same lists, so a lane keeps the first kCached
//   entries of its boxes lane and lane + 32 in registers and steps the
//   two together; a step then loads only the row's value from shared
//   memory (the entries' 16-byte loads were most of its bank traffic).
// - A box set whose lists overflow the kMaxEntries staged entries (or
//   kMaxChunkBoxes boxes) runs in passes over the rows, a chunk a pass,
//   `out` accumulated across passes.
//
// Pruned path (box_scan_pruned at any D; box_scan at D <= 8 as its
// one-block case rows3 = x[None], cand = [0], n_hit = 1): the design of
// box_scan_seg.cu without the box->query one-hot, one count a row.
// - Rows are read where they lie, live slots only: a persistent grid
//   (two CTAs an SM) walks work items, an item being up to 1,024 rows of
//   one live slot (one contiguous 24 KB span at d' = 6). The last warp's
//   first thread copies each of the CTA's items by one cp.async.bulk into
//   a 3-stage ring on full / empty mbarriers. Each CTA reads *n_hit once:
//   no gather, no host round trip, no read of a dead slot.
// - Every output word is written exactly once, with no memset pass. The
//   blocks no live slot holds are the gaps between consecutive live
//   candidates, and the head and the tail; counted in order they are
//   (NB - live) * block "dead" words, which the grid splits evenly. A CTA
//   finds the live slots around the ends of its share (a 32-way search
//   by one warp each over g(s) = cand[s] - s, the dead blocks before
//   cand[s], which never falls), and its warps zero the gaps between
//   them with 16-byte stores. A gap that spans most of the catalog is
//   then spread over the grid like any other.
// - The boxes are staged once a CTA (in chunks past 64 KB) as 16-byte
//   records of interleaved (lo, hi) pairs: two dims a broadcast load.
//   Each of the 256 consumer threads holds R = 4 rows of the item in
//   registers (D <= 8; a warp a contiguous run of 128 rows of the
//   Morton-ordered block) and releases the stage at once. The warp's
//   lanes test 32 boxes at a time against the run's bounding box (NaN
//   left out: a box that misses it holds none of the rows; below
//   kFilterBoxes boxes every box is tested), and the warp walks the
//   ballot of those that meet it, testing each against its 4 rows, two
//   dims a record, every compare predicated. D > 8 reads the rows from
//   the staged item and tests every box.
// - D > kMaxListD in box_scan keeps the earlier kernel at the end: a
//   warp per row reading x from device memory, boxes as (lo, hi) pairs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

// ---------------------------------------------------------------------
// full-width path: constrained-dim lists, rows streamed by bulk copies
// ---------------------------------------------------------------------

constexpr int kListWarps = 16;                          // consumer warps
constexpr int kConsumers = 32 * kListWarps;
constexpr int kListThreads = kConsumers + 32;           // + producer warp
constexpr int kMaxEntries = 4096;       // list entries staged a chunk
constexpr int kMaxListD = kMaxEntries - 1;  // a box's list always fits
constexpr int kMaxChunkBoxes = 256;
constexpr int kCached = 4;              // list entries a lane keeps a box
constexpr int kMaxStages = 8;
constexpr int kStageTarget = 48 * 1024;   // bytes of rows a stage
constexpr int kRingBudget = 150 * 1024;   // 3 stages of 48 KB + slack
// shared memory: barriers | box offsets, chunk size | entries | ring
constexpr int kOffOff = 16 * kMaxStages;
constexpr int kEntOff = 2048;
constexpr int kRingOff = kEntOff + 16 * kMaxEntries;
static_assert(kOffOff + 4 * (kMaxChunkBoxes + 2) <= kEntOff, "layout");

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ float neg_inf() { return -pos_inf(); }

// named barrier of the consumer warps (0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Compile boxes b0, b0 + 1, ... into lists: s_off[bb] .. s_off[bb + 1]
// index box bb's entries {dim (as float bits), lo, hi, 0} in s_ent. A
// list of even length gets one more entry, (-inf, +inf) at dim 0, which
// every row passing the row check passes: lanes walking lists of one
// length L then start L (odd) 16-byte slots apart, so the 8 lanes of each
// quarter-warp phase of a 16-byte load hit distinct banks (with L = 12 a
// phase's lanes fell on two slots: 4-way conflicts). Takes as many boxes
// as fit kMaxEntries and kMaxChunkBoxes (at least one, as D + 1 <=
// kMaxEntries) and leaves their number in *s_bn. Consumer warps only.
__device__ void compile_boxes(const float* __restrict__ lo,
                              const float* __restrict__ hi, int d, int nb,
                              int b0, int* s_off, int* s_bn, float4* s_ent) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = min(kMaxChunkBoxes, nb - b0);
  const float ninf = neg_inf(), pinf = pos_inf();
  // 1. each box's number of constrained dims, into s_off[bb + 1]
  for (int bb = warp; bb < m; bb += kListWarps) {
    const float* l = lo + (size_t)(b0 + bb) * d;
    const float* h = hi + (size_t)(b0 + bb) * d;
    int cnt = 0;
    for (int k0 = 0; k0 < d; k0 += 32) {
      const int k = k0 + lane;
      const bool c = k < d && !(l[k] == ninf && h[k] == pinf);
      cnt += __popc(__ballot_sync(0xffffffffu, c));
    }
    if (lane == 0) s_off[bb + 1] = cnt | 1;        // padded to odd
  }
  consumers_sync();
  // 2. offsets, and how many boxes fit
  if (threadIdx.x == 0) {
    int run = 0, bn = 0;
    s_off[0] = 0;
    for (; bn < m; ++bn) {
      const int c = s_off[bn + 1];
      if (bn > 0 && run + c > kMaxEntries) break;
      run += c;
      s_off[bn + 1] = run;
    }
    *s_bn = bn;
  }
  consumers_sync();
  // 3. the entries, ascending by dim
  const int bn = *s_bn;
  for (int bb = warp; bb < bn; bb += kListWarps) {
    const float* l = lo + (size_t)(b0 + bb) * d;
    const float* h = hi + (size_t)(b0 + bb) * d;
    int at = s_off[bb];
    for (int k0 = 0; k0 < d; k0 += 32) {
      const int k = k0 + lane;
      const float lv = k < d ? l[k] : 0.f, hv = k < d ? h[k] : 0.f;
      const bool c = k < d && !(lv == ninf && hv == pinf);
      const unsigned mask = __ballot_sync(0xffffffffu, c);
      if (c) {
        s_ent[at + __popc(mask & ((1u << lane) - 1u))] =
            make_float4(__int_as_float(k), lv, hv, 0.f);
      }
      at += __popc(mask);
    }
    if (lane == 0 && at < s_off[bb + 1])
      s_ent[at] = make_float4(__int_as_float(0), ninf, pinf, 0.f);
  }
}

// Walks entries [e, e1) of a box's list for one row while `in` holds,
// the next entry loaded beside this one's value (a step waits on one
// shared-memory load); returns whether the row passed them all.
__device__ __forceinline__ int walk(const float* row, const float4* s_ent,
                                    int e, int e1, bool in) {
  if (!in || e >= e1) return in;
  float4 en = s_ent[e];
  for (;;) {
    const float v = row[__float_as_int(en.x)];
    const bool last = ++e >= e1;
    const float4 next = s_ent[last ? e - 1 : e];
    if (!((v > en.y) && (v <= en.z))) return 0;
    if (last) return 1;
    en = next;
  }
}

__global__ void __launch_bounds__(kListThreads, 1)
box_scan_kernel_lists(const float* __restrict__ x,
                      const float* __restrict__ lo,
                      const float* __restrict__ hi, long long n, int d,
                      int nb, int tile_rows, int stages, int stage_bytes,
                      int32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  int* s_off = reinterpret_cast<int*>(smem + kOffOff);
  int* s_bn = s_off + kMaxChunkBoxes + 1;
  float4* s_ent = reinterpret_cast<float4*>(smem + kEntOff);
  uint8_t* ring = smem + kRingOff;
  const uint32_t bars = bulk::smem_u32(smem);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kMaxStages + st); };

  const long long n_tiles = (n + tile_rows - 1) / tile_rows;
  if ((long long)blockIdx.x >= n_tiles) return;
  // this CTA's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long my_tiles = (n_tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      bulk::mbar_init(full(st), 1);
      bulk::mbar_init(empty(st), kListWarps);
    }
    bulk::mbar_init_fence();
  }
  __syncthreads();

  auto tile_row0 = [&](long long g) {
    return (blockIdx.x + (g % my_tiles) * gridDim.x) * (long long)tile_rows;
  };
  // the producer warp's g-th tile (counted across passes) into stage
  // g % stages; the warp waits together and its first lane copies
  auto issue = [&](long long g) {
    const int st = (int)(g % stages);
    if (g >= stages)
      bulk::mbar_wait(empty(st), (uint32_t)((g / stages) - 1) & 1);
    if (lane == 0) {
      const long long r0 = tile_row0(g);
      const long long rows = min((long long)tile_rows, n - r0);
      bulk::copy_span(ring + (size_t)st * stage_bytes, x + r0 * d,
                      (uint32_t)(rows * d * 4), full(st));
    }
    __syncwarp();
  };
  const bool producer = warp == kListWarps;
  long long issued = 0;
  if (producer) {
    // the ring starts empty: the first stages need no box list
    for (; issued < min((long long)stages, my_tiles); ++issued) issue(issued);
  }

  long long g0 = 0;                       // first tile of this pass
  for (int b0 = 0; b0 < nb; g0 += my_tiles) {
    __syncthreads();                      // the last pass's lists are done
    if (!producer) compile_boxes(lo, hi, d, nb, b0, s_off, s_bn, s_ent);
    __syncthreads();
    const int bn = *s_bn;
    if (producer) {
      for (; issued < g0 + my_tiles; ++issued) issue(issued);
    } else {
      // every row walks the same lists: each lane keeps the first kCached
      // entries of its boxes lane and lane + 32 in registers (an
      // always-passing (-inf, +inf) entry at dim 0 past a list's end), so
      // most steps load only the row's value
      int cdim[2][kCached], cnext[2], cend[2];
      float clo[2][kCached], chi[2][kCached];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int bb = lane + 32 * i;
        const int e0 = bb < bn ? s_off[bb] : 0;
        cend[i] = bb < bn ? s_off[bb + 1] : 0;
        cnext[i] = e0 + kCached;
#pragma unroll
        for (int c = 0; c < kCached; ++c) {
          const float4 en = e0 + c < cend[i]
                                ? s_ent[e0 + c]
                                : make_float4(0.f, neg_inf(), pos_inf(), 0.f);
          cdim[i][c] = __float_as_int(en.x);
          clo[i][c] = en.y;
          chi[i][c] = en.z;
        }
      }
      for (long long g = g0; g < g0 + my_tiles; ++g) {
        const int st = (int)(g % stages);
        bulk::mbar_wait(full(st), (uint32_t)(g / stages) & 1);
        const long long r0 = tile_row0(g);
        const int rows = (int)min((long long)tile_rows, n - r0);
        const float* xs = reinterpret_cast<const float*>(
            ring + (size_t)st * stage_bytes + bulk::span_head(x + r0 * d));
        for (int r = warp; r < rows; r += kListWarps) {
          const float* row = xs + (size_t)r * d;
          // the lane's two cached boxes, stepped together, then the
          // rest of their lists and any boxes past 64 from shared memory
          bool in0 = lane < bn, in1 = lane + 32 < bn;
#pragma unroll
          for (int c = 0; c < kCached; ++c) {
            if (in0) {
              const float v = row[cdim[0][c]];
              in0 = (v > clo[0][c]) && (v <= chi[0][c]);
            }
            if (in1) {
              const float v = row[cdim[1][c]];
              in1 = (v > clo[1][c]) && (v <= chi[1][c]);
            }
          }
          int cnt = walk(row, s_ent, cnext[0], cend[0], in0) +
                    walk(row, s_ent, cnext[1], cend[1], in1);
          for (int bb = lane + 64; bb < bn; bb += 32)
            cnt += walk(row, s_ent, s_off[bb], s_off[bb + 1], true);
          cnt = __reduce_add_sync(0xffffffffu, cnt);
          // the row check, only where the lists found a box (uniform: cnt
          // is the warp's sum); a row that meets no box counts 0 either way
          if (cnt > 0) {
            bool ok = true;
            for (int k = lane; k < d; k += 32) ok &= row[k] > neg_inf();
            if (!__all_sync(0xffffffffu, ok)) cnt = 0;
          }
          if (lane == 0) {
            const long long i = r0 + r;
            out[i] = (b0 == 0 ? 0 : out[i]) + cnt;
          }
        }
        __syncwarp();
        if (lane == 0) bulk::mbar_arrive(empty(st));
      }
    }
    b0 += bn;
  }
}

int launch_lists(const float* x, const float* lo, const float* hi,
                 long long n, int d, int nb, int32_t* out, cudaStream_t s) {
  const long long row_bytes = 4LL * d;
  long long tile_rows = kStageTarget / row_bytes;
  if (tile_rows < 1) tile_rows = 1;
  if (tile_rows > n) tile_rows = n;
  // + 16: a span not 16-byte aligned starts up to 12 bytes into its stage
  const int stage_bytes =
      (int)((tile_rows * row_bytes + 16 + 127) / 128 * 128);
  int stages = kRingBudget / stage_bytes;
  if (stages > kMaxStages) stages = kMaxStages;
  const size_t smem = (size_t)kRingOff + (size_t)stages * stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      box_scan_kernel_lists, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (n + tile_rows - 1) / tile_rows;
  long long blocks = bulk_sm_count();
  if (blocks > n_tiles) blocks = n_tiles;
  box_scan_kernel_lists<<<(unsigned)blocks, kListThreads, smem, s>>>(
      x, lo, hi, n, d, nb, (int)tile_rows, stages, stage_bytes, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// pruned path: live slots read in place, every output word written once
// ---------------------------------------------------------------------

constexpr int kPrWarps = 8;                          // consumer warps
constexpr int kPrConsumers = 32 * kPrWarps;
constexpr int kPrThreads = kPrConsumers + 32;        // + producer warp
constexpr int kR = 4;                     // rows a consumer thread holds
constexpr int kItemRows = kPrConsumers * kR;         // 1024
constexpr int kPrStages = 3;
constexpr int kPrStageTarget = 32 * 1024;  // bytes of rows a stage
constexpr int kPrBoxBudget = 64 * 1024;    // bytes of box records a chunk
constexpr int kMaxDR = 8;                  // dims a row held in registers
constexpr long long kZeroShare = 16384;    // dead words a CTA, at least
// fewer boxes go untested against the warp's bounding box: its shuffles
// cost more than it spares (0.5 us of 6 at 442,368 rows x 2 boxes)
constexpr int kFilterBoxes = 5;
// shared memory: barriers | two slot ids | warps' bounding boxes | box
// records | ring
constexpr int kSpanOff = 16 * kPrStages;
constexpr int kPrBBoxOff = 64;
constexpr int kPrBoxOff = kPrBBoxOff + kPrWarps * kMaxDR * 2 * 4;
static_assert(kSpanOff + 8 <= kPrBBoxOff && kPrBoxOff % 16 == 0, "layout");

__device__ __forceinline__ void pruned_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kPrConsumers) : "memory");
}

// out[a, b) = 0 by one warp: 16-byte stores for the aligned middle (out
// is 16-byte aligned), plain ones for the few words around it
__device__ __forceinline__ void warp_zero(int32_t* __restrict__ out,
                                          long long a, long long b,
                                          int lane) {
  if (a >= b) return;
  const long long a4 = min(b, (a + 3) & ~3LL);
  const long long b4 = max(a4, b & ~3LL);
  if (lane < a4 - a) out[a + lane] = 0;
  if (lane < b - b4) out[b4 + lane] = 0;
  int4* o4 = reinterpret_cast<int4*>(out + a4);
  const long long n4 = (b4 - a4) / 4;
  for (long long i = lane; i < n4; i += 32) o4[i] = make_int4(0, 0, 0, 0);
}

// Slot s's block: cand[s], or s where there is no cand (the one-block
// case and the identity)
__device__ __forceinline__ long long slot_block(
    const int32_t* __restrict__ cand, long long s) {
  return cand != nullptr ? (long long)cand[s] : s;
}

// The first slot s in [0, nh) with slot_block(s) - s > k, or nh: the live
// blocks that come before dead block k (slot_block(s) - s counts the dead
// blocks before slot s's and never falls). One warp, 32 probes a round:
// three rounds at 32,768 slots.
__device__ int live_before(const int32_t* __restrict__ cand, int nh,
                           long long k, int lane) {
  int a = 0, b = nh;                       // the answer lies in [a, b]
  while (a < b) {
    const int step = (b - a + 31) / 32;
    const int p = a + lane * step;
    const bool t = p < b && slot_block(cand, p) - p > k;
    const unsigned m = __ballot_sync(0xffffffffu, t);
    if (m) {                               // in (probe j - 1, probe j]
      const int j = __ffs(m) - 1;
      b = a + j * step;
      a = j == 0 ? a : a + (j - 1) * step + 1;
    } else {                               // past the last probe < b
      a += min(31, (b - a - 1) / step) * step + 1;
    }
  }
  return a;
}

// D: the rows' dims, held in registers (1..kMaxDR), or 0 (any D: rows
// read from the staged item, every box tested)
template <int D>
__global__ void __launch_bounds__(kPrThreads, 2)
box_scan_pruned_kernel(const float* __restrict__ rows3,
                       const int32_t* __restrict__ cand,
                       const int32_t* __restrict__ n_hit, int n_blocks,
                       int block, int n_cand, const float* __restrict__ lo,
                       const float* __restrict__ hi, int nb, int d,
                       int tile_rows, int stage_bytes, int ring_off,
                       int box_chunk, int stride,
                       int32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t bars = bulk::smem_u32(smem);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kPrStages + st); };
  int* s_span = reinterpret_cast<int*>(smem + kSpanOff);
  float* s_bbox = reinterpret_cast<float*>(smem + kPrBBoxOff);
  float* s_box = reinterpret_cast<float*>(smem + kPrBoxOff);
  uint8_t* ring = smem + ring_off;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // live slots; without boxes every count is 0 and every block dead
  int nh = min(n_cand, n_blocks);
  if (n_hit != nullptr) nh = min(nh, max(0, *n_hit));
  if (nb == 0) nh = 0;
  const int tps = (block + tile_rows - 1) / tile_rows;   // items a slot
  const long long live = (long long)nh * tps;
  const bool filter = nb >= kFilterBoxes;
  if (tid == 0) {
    for (int st = 0; st < kPrStages; ++st) {
      bulk::mbar_init(full(st), 1);
      bulk::mbar_init(empty(st), kPrWarps);
    }
    bulk::mbar_init_fence();
  }
  __syncthreads();
  auto item_src = [&](long long it) {
    return rows3 + (slot_block(cand, it / tps) * block +
                    (it % tps) * (long long)tile_rows) * d;
  };
  auto item_rows = [&](long long it) {
    return min(tile_rows, block - (int)(it % tps) * tile_rows);
  };

  if (warp == kPrWarps) {
    // producer: this CTA's items, in order, into the ring
    long long k = 0;
    for (long long it = blockIdx.x; it < live; it += gridDim.x, ++k) {
      const int st = (int)(k % kPrStages);
      if (k >= kPrStages)
        bulk::mbar_wait(empty(st), (uint32_t)((k / kPrStages) - 1) & 1);
      if (lane == 0)
        bulk::copy_span(ring + (size_t)st * stage_bytes, item_src(it),
                        (uint32_t)item_rows(it) * d * 4, full(st));
      __syncwarp();
    }
    return;
  }

  // 1. this CTA's share [w0, w1) of the dead words, while the ring fills.
  // Gap s (s = 0 .. nh) is dead words [g(s - 1), g(s)) * block, g(-1) = 0,
  // g(nh) = NB - nh, and lies s blocks further on in out.
  const long long dead = (long long)(n_blocks - nh) * block;
  const long long w0 = dead * blockIdx.x / gridDim.x;
  const long long w1 = dead * (blockIdx.x + 1) / gridDim.x;
  if (w0 < w1) {
    if (warp < 2) {
      const int s = live_before(cand, nh, (warp == 0 ? w0 : w1 - 1) / block,
                                lane);
      if (lane == 0) s_span[warp] = s;
    }
    pruned_sync();
    const int s0 = s_span[0], s1 = s_span[1];
    for (int s = s0 + warp; s <= s1; s += kPrWarps) {
      const long long g0 =
          s == 0 ? 0 : (slot_block(cand, s - 1) - (s - 1)) * block;
      const long long g1 =
          s == nh ? dead : (slot_block(cand, s) - s) * block;
      const long long shift = (long long)s * block;
      warp_zero(out, max(g0, w0) + shift, min(g1, w1) + shift, lane);
    }
  }

  // 2. the live items
  const int n_chunks = (nb + box_chunk - 1) / box_chunk;
  int staged = -1;                       // the chunk in s_box
  auto stage = [&](int c) {
    const int b0 = c * box_chunk, bn = min(box_chunk, nb - b0);
    pruned_sync();                       // the last chunk's readers
    for (int i = tid; i < bn * stride; i += kPrConsumers) {
      const int bb = i / stride, f = i % stride;
      const size_t b = (size_t)(b0 + bb);
      s_box[i] = f < 2 * d ? (f & 1 ? hi : lo)[b * d + f / 2] : 0.f;
    }
    pruned_sync();
    staged = c;
  };
  if (blockIdx.x < live) stage(0);
  // warp w holds the item's rows w * 128 + lane + 32 j: a contiguous run
  // of the Morton-ordered block, whose bounding box is tight
  auto row_of = [&](int j) { return warp * (32 * kR) + lane + 32 * j; };
  constexpr int kPairs = (D + 1) / 2;      // 16-byte records a box
  long long k = 0;
  for (long long it = blockIdx.x; it < live; it += gridDim.x, ++k) {
    const int st = (int)(k % kPrStages);
    const int rows = item_rows(it);
    const long long out_row = slot_block(cand, it / tps) * block +
                              (it % tps) * (long long)tile_rows;
    bulk::mbar_wait(full(st), (uint32_t)(k / kPrStages) & 1);
    const float* xs = reinterpret_cast<const float*>(
        ring + (size_t)st * stage_bytes + bulk::span_head(item_src(it)));
    bool live_r[kR];
    float xr[kR][D > 0 ? 2 * kPairs : 1];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int r = row_of(j);
      live_r[j] = r < rows;
      if constexpr (D > 0) {
#pragma unroll
        for (int kk = 0; kk < 2 * kPairs; ++kk)
          xr[j][kk] = (live_r[j] && kk < D) ? xs[r * D + kk] : 0.f;
      }
    }
    // the warp's bounding box of its live rows (NaN left out: a NaN row
    // is inside no box), as (min, max) pairs laid out as the box
    // records' (lo, hi)
    float* s_bb = s_bbox + warp * kMaxDR * 2;
    if constexpr (D > 0) {
      // the rows are in registers: the stage can refill now
      __syncwarp();
      if (lane == 0) bulk::mbar_arrive(empty(st));
#pragma unroll
      for (int kk = 0; kk < D && filter; ++kk) {
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
    int cnt[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) cnt[j] = 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int bn = min(box_chunk, nb - c * box_chunk);
      if (staged != c) stage(c);
      for (int g0 = 0; g0 < bn; g0 += 32) {
        // which of the next 32 boxes meet the warp's bounding box: lane i
        // tests box g0 + i (for D = 0, or too few boxes to filter, every
        // box counts as meeting)
        bool meets = g0 + lane < bn;
        if constexpr (D > 0) {
          if (meets && filter) {
            const float4* r4 = reinterpret_cast<const float4*>(
                s_box + (size_t)(g0 + lane) * stride);
            const float4* w4 = reinterpret_cast<const float4*>(s_bb);
#pragma unroll
            for (int p = 0; p < kPairs; ++p) {
              const float4 b = r4[p], w = w4[p];
              meets = meets && (b.x < w.y) && (w.x <= b.y);
              if (2 * p + 1 < D) meets = meets && (b.z < w.w) && (w.z <= b.w);
            }
          }
        }
        // the meeting boxes in ascending order (warp-uniform)
        for (unsigned mask = __ballot_sync(0xffffffffu, meets); mask;
             mask &= mask - 1) {
          const float* rec = s_box + (size_t)(g0 + __ffs(mask) - 1) * stride;
          bool in[kR];
#pragma unroll
          for (int j = 0; j < kR; ++j) in[j] = live_r[j];
          if constexpr (D > 0) {
            // every compare, predicated: an early exit once none of the 4
            // rows is inside cost more in branches than it saved (1.3x at
            // 64 boxes on rows in no order)
            const float4* r4 = reinterpret_cast<const float4*>(rec);
#pragma unroll
            for (int p = 0; p < kPairs; ++p) {
              const float4 b = r4[p];          // lo, hi of dims 2p, 2p + 1
#pragma unroll
              for (int j = 0; j < kR; ++j) {
                const float v0 = xr[j][2 * p], v1 = xr[j][2 * p + 1];
                in[j] = in[j] && (v0 > b.x) && (v0 <= b.y);
                if (2 * p + 1 < D) in[j] = in[j] && (v1 > b.z) && (v1 <= b.w);
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < kR; ++j) {
              const float* row = xs + (size_t)row_of(j) * d;
              for (int kk = 0; kk < d && in[j]; ++kk) {
                const float v = row[kk];
                in[j] = (v > rec[2 * kk]) && (v <= rec[2 * kk + 1]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kR; ++j) cnt[j] += in[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j)
      if (live_r[j]) out[out_row + row_of(j)] = cnt[j];
    if constexpr (D == 0) {
      __syncwarp();
      if (lane == 0) bulk::mbar_arrive(empty(st));
    }
  }
}

template <int D>
int launch_pruned(const float* rows3, const int32_t* cand,
                  const int32_t* n_hit, int n_blocks, int block, int n_cand,
                  int d, const float* lo, const float* hi, int nb,
                  int32_t* out, cudaStream_t s) {
  auto kernel = box_scan_pruned_kernel<D>;
  // (lo, hi) pairs, padded to 16 bytes (a record even at d = 0)
  const int stride = d > 0 ? (2 * d + 3) / 4 * 4 : 4;
  const int rec_bytes = stride * (int)sizeof(float);
  int tile_rows = d > 0 ? kPrStageTarget / (4 * d) : kItemRows;
  if (tile_rows > kItemRows) tile_rows = kItemRows;
  if (tile_rows > block) tile_rows = block;
  if (tile_rows < 1) tile_rows = 1;
  // + 16: a span not 16-byte aligned starts up to 12 bytes into its stage
  const int stage_bytes = (tile_rows * 4 * d + 16 + 127) / 128 * 128;
  int box_chunk = kPrBoxBudget / rec_bytes;
  if (box_chunk > nb) box_chunk = nb;
  if (box_chunk < 1) box_chunk = 1;
  const int ring_off = (kPrBoxOff + box_chunk * rec_bytes + 127) / 128 * 128;
  const size_t smem = (size_t)ring_off + (size_t)kPrStages * stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kPrThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  // enough CTAs for every item were all slots live, or for the zeros
  // were none
  const long long items =
      (long long)n_cand * ((block + tile_rows - 1) / tile_rows);
  const long long words = (long long)n_blocks * block;
  long long blocks = (words + kZeroShare - 1) / kZeroShare;
  if (blocks < items) blocks = items;
  const long long resident = (long long)bulk_sm_count() * per_sm;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kPrThreads, smem, s>>>(
      rows3, cand, n_hit, n_blocks, block, n_cand, lo, hi, nb, d, tile_rows,
      stage_bytes, ring_off, box_chunk, stride, out);
  return (int)cudaGetLastError();
}

// cand or n_hit null: slot s holds block s, every slot live
int pruned(const float* rows3, const int32_t* cand, const int32_t* n_hit,
           int n_blocks, int block, int n_cand, int d, const float* lo,
           const float* hi, int nb, int32_t* out, cudaStream_t s) {
  switch (d) {
#define PRUNED_D(D)                                                       \
  case D:                                                                 \
    return launch_pruned<D>(rows3, cand, n_hit, n_blocks, block, n_cand,  \
                            d, lo, hi, nb, out, s);
    PRUNED_D(1) PRUNED_D(2) PRUNED_D(3) PRUNED_D(4)
    PRUNED_D(5) PRUNED_D(6) PRUNED_D(7) PRUNED_D(8)
#undef PRUNED_D
    default:
      return launch_pruned<0>(rows3, cand, n_hit, n_blocks, block, n_cand,
                              d, lo, hi, nb, out, s);
  }
}

// ---------------------------------------------------------------------
// D > kMaxListD: a warp a row, boxes as pairs
// ---------------------------------------------------------------------

constexpr int kThreads = 512;
constexpr int kSmemBudget = 192 * 1024;   // boxes staged per chunk

// A warp a row, its lanes on dims lane, lane + 32, ... read from device
// memory, voting after each group of 32 dims and leaving the box at the
// first group with a failing dim. Boxes are staged as (lo, hi) float2
// pairs in chunks of up to 192 KB; the grid is persistent and walks the
// rows once per chunk. Held to 32 registers it spilled a word, so it
// takes one CTA's bound (43 registers, two CTAs an SM).
__global__ void __launch_bounds__(kThreads, 1)
box_scan_kernel_warp(const float* __restrict__ x,
                     const float* __restrict__ lo,
                     const float* __restrict__ hi, long long n, int d,
                     int nb, int box_chunk, int32_t* __restrict__ out) {
  extern __shared__ float2 s_box[];                    // [box_chunk, d]
  const int lane = threadIdx.x % 32;
  const long long first =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const long long stride = (long long)gridDim.x * blockDim.x / 32;
  for (int b0 = 0; b0 < nb; b0 += box_chunk) {
    const int bn = min(box_chunk, nb - b0);
    __syncthreads();
    for (int t = threadIdx.x; t < bn * d; t += blockDim.x) {
      s_box[t] = make_float2(lo[(size_t)b0 * d + t], hi[(size_t)b0 * d + t]);
    }
    __syncthreads();
    for (long long i = first; i < n; i += stride) {
      const float* row = x + i * d;
      int cnt = 0;
      for (int bb = 0; bb < bn; ++bb) {
        const float2* bx = s_box + (size_t)bb * d;
        bool in = true;
        for (int c0 = 0; c0 < d && in; c0 += 32) {
          const int c = c0 + lane;
          bool ok = true;
          if (c < d) {
            const float v = row[c];
            ok = (v > bx[c].x) && (v <= bx[c].y);
          }
          in = __all_sync(0xffffffffu, ok);
        }
        cnt += in;
      }
      if (lane == 0) out[i] = (b0 == 0 ? 0 : out[i]) + cnt;
    }
  }
}

int launch_warp(const float* x, const float* lo, const float* hi,
                long long n, int d, int nb, int32_t* out, cudaStream_t s) {
  const int per_box = d * (int)sizeof(float2);
  int box_chunk = kSmemBudget / per_box;
  if (box_chunk > nb) box_chunk = nb;
  if (box_chunk < 1) box_chunk = 1;
  const size_t smem = (size_t)box_chunk * per_box;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        box_scan_kernel_warp, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, box_scan_kernel_warp, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  long long blocks = (n * 32 + kThreads - 1) / kThreads;
  const long long resident = (long long)bulk_sm_count() * per_sm;
  if (blocks > resident) blocks = resident;
  box_scan_kernel_warp<<<(unsigned)blocks, kThreads, smem, s>>>(
      x, lo, hi, n, d, nb, box_chunk, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the first CUDA error of the launch (0 on success). Launches on
// `stream` and never synchronises. The caller handles nb == 0 (all
// counts 0) without a launch. D <= 8 is box_scan_pruned's one-block case,
// in launches of at most 2^30 rows.
extern "C" int box_scan_launch(const float* x, const float* lo,
                               const float* hi, long long n, int d, int nb,
                               int32_t* out, void* stream) {
  if (n <= 0 || nb <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 8) {
    constexpr long long kMaxRows = 1LL << 30;
    for (long long r0 = 0; r0 < n; r0 += kMaxRows) {
      const int rows = (int)(n - r0 < kMaxRows ? n - r0 : kMaxRows);
      const int e = pruned(x + r0 * d, nullptr, nullptr, 1, rows, 1, d, lo,
                           hi, nb, out + r0, s);
      if (e != 0) return e;
    }
    return 0;
  }
  if (d <= kMaxListD) return launch_lists(x, lo, hi, n, d, nb, out, s);
  return launch_warp(x, lo, hi, n, d, nb, out, s);
}

// box_scan_pruned: rows3 [n_blocks, block, d], cand [n_cand] block ids,
// n_hit a device scalar (its survivor count) -> out [n_blocks * block].
// Returns cudaGetLastError() after the launch (0 on success); launches on
// `stream` and never synchronises. nb == 0 launches too: out all 0.
extern "C" int box_scan_pruned_launch(const float* rows3,
                                      const int32_t* cand,
                                      const int32_t* n_hit, int n_blocks,
                                      int block, int n_cand, int d,
                                      const float* lo, const float* hi,
                                      int nb, int32_t* out, void* stream) {
  if (n_blocks <= 0 || block <= 0) return (int)cudaGetLastError();
  return pruned(rows3, cand, n_hit, n_blocks, block, n_cand, d, lo, hi, nb,
                out, (cudaStream_t)stream);
}
