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
// Bound on the H100: the bytes. x is read once (1.61 GB at the full
// scan's 1,048,576 x 384, 0.48 ms at 3.35 TB/s); the compares the data
// needs are N * D for the row check below plus two a constrained dim up to
// each box's first failing one, a small fraction of that.
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
// Narrow path (D <= 8, the use_fused=False oracle at d' = 6) and D >
// kMaxListD: the earlier kernel below, a thread per row with the row in
// registers (D <= 8), or a warp per row reading x from device memory
// (D > kMaxListD), boxes staged as (lo, hi) pairs in shared memory.

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
// D <= 8 and D > kMaxListD: a thread or a warp a row, boxes as pairs
// ---------------------------------------------------------------------

constexpr int kThreads = 512;
constexpr int kSmemBudget = 192 * 1024;   // boxes staged per chunk

// G lanes per row (1 or 32). G = 1 (D <= V = 8): a thread a row, the row
// in registers. G = 32 (V = 0): a warp a row, its lanes on dims lane,
// lane + 32, ... read from device memory, voting after each group of 32
// dims and leaving the box at the first group with a failing dim. Boxes
// are staged as (lo, hi) float2 pairs in chunks of up to 192 KB; the
// grid is persistent and walks the rows once per chunk. Four CTAs an SM
// for G = 1 (32 registers); G = 32, held to those 32, spilled a word, so
// it takes one CTA's bound (43 registers, two CTAs an SM).
template <int G, int V>
__global__ void __launch_bounds__(kThreads, G == 1 ? 4 : 1)
box_scan_kernel(const float* __restrict__ x, const float* __restrict__ lo,
                const float* __restrict__ hi, long long n, int d, int nb,
                int box_chunk, int32_t* __restrict__ out) {
  static_assert((G == 1) == (V > 0), "rows in registers only for G = 1");
  extern __shared__ float2 s_box[];                    // [box_chunk, d]
  const int lane = threadIdx.x % G;
  const long long first =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const long long stride = (long long)gridDim.x * blockDim.x / G;
  for (int b0 = 0; b0 < nb; b0 += box_chunk) {
    const int bn = min(box_chunk, nb - b0);
    __syncthreads();
    for (int t = threadIdx.x; t < bn * d; t += blockDim.x) {
      s_box[t] = make_float2(lo[(size_t)b0 * d + t], hi[(size_t)b0 * d + t]);
    }
    __syncthreads();
    for (long long i = first; i < n; i += stride) {
      const float* row = x + i * d;
      float xr[V > 0 ? V : 1];
      if constexpr (V > 0) {
#pragma unroll
        for (int k = 0; k < V; ++k) xr[k] = k < d ? row[k] : 0.f;
      }
      int cnt = 0;
      for (int bb = 0; bb < bn; ++bb) {
        const float2* bx = s_box + (size_t)bb * d;
        bool in = true;
        if constexpr (V > 0) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if (k >= d || !in) break;
            in = (xr[k] > bx[k].x) && (xr[k] <= bx[k].y);
          }
        } else {
          for (int c0 = 0; c0 < d && in; c0 += G) {
            const int c = c0 + lane;
            bool ok = true;
            if (c < d) {
              const float v = row[c];
              ok = (v > bx[c].x) && (v <= bx[c].y);
            }
            in = __all_sync(0xffffffffu, ok);
          }
        }
        cnt += in;
      }
      if (lane == 0) out[i] = (b0 == 0 ? 0 : out[i]) + cnt;
    }
  }
}

template <int G, int V>
int launch(const float* x, const float* lo, const float* hi, long long n,
           int d, int nb, int32_t* out, cudaStream_t s) {
  auto kernel = box_scan_kernel<G, V>;
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
  long long blocks = (n * G + kThreads - 1) / kThreads;
  const long long resident = (long long)bulk_sm_count() * per_sm;
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
  if (d <= 8) return launch<1, 8>(x, lo, hi, n, d, nb, out, s);
  if (d <= kMaxListD) return launch_lists(x, lo, hi, n, d, nb, out, s);
  return launch<32, 0>(x, lo, hi, n, d, nb, out, s);
}
