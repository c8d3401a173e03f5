// zone_prune for Hopper (sm_90a): the index PRUNE stage, and the probe's
// compaction of its survivors into the candidate list.
//
// Replaces: src/repro/kernels/zone_prune.py::zone_prune_pallas
// (body _zone_prune_kernel). For zones zlo/zhi [NZ, D] and boxes
// blo/bhi [B, D] (f32, row-major), zone z overlaps box b iff on EVERY dim
//     zhi[z, d] > blo[b, d]  &&  zlo[z, d] <= bhi[b, d]
// (half-open boxes (lo, hi]: a zone whose max equals the box lo cannot
// hold a match). Comparisons are written exactly as in the Pallas body and
// never as a subtraction, so +-inf padding and NaN behave identically
// (any comparison with NaN is false -> no overlap).
//
// Bound on the H100: the bytes, far below one launch. On the engine's
// main path NZ = n / block (1024 at n = 2^20), D = 6 and B <= a few
// hundred boxes: the kernel reads NZ*D*8 + B*D*8 bytes (~50 KB, ~15 ns at
// 3.35 TB/s; the mask writes NZ*B more) and does at most NZ*B*D*2 compares (~6 M at B = 512, ~0.2 us
// at 33.5 T f32 lane-ops/s), where an empty kernel takes ~0.9 us of device
// time (measured). So the design gains most by making fewer launches.
//
// Two entries.
//
// zone_prune_launch: the [NZ, B] overlap mask (the Pallas kernel's own
// output: the use_fused=False host oracle's prune) or, with mask ==
// nullptr, the [NZ] hit vector (zone_hits: the distributed query's prune).
// - Mask. The NZ x B (zone, box) pairs are one flat index p = z * B + b,
//   the mask's own byte order. A warp takes R rounds of 32 consecutive
//   pairs, a pair a lane, and packs them by ballots: lane l writes pairs
//   4l .. 4l + 3 with one 32-bit store, a warp 32 R consecutive bytes; a
//   ragged tail takes byte stores. CTAs of 128 threads take tiles of
//   128 R pairs, one tile a CTA up to 16 CTAs an SM, looping past that.
//   Up to d = 8 the boxes are staged in shared memory by asynchronous
//   copies (cp.async), all in flight at once: all B once a CTA where a
//   tile holds B pairs, else each tile's window of boxes, which wraps at
//   B; a box's row sits d + 1 floats from the next, so the 32 consecutive
//   boxes of a round fall in 32 distinct banks at d' = 6.
//   R = 1 while the CTA cap holds the pairs (the host oracle's 1,024 zones
//   x 1-2 boxes): each lane loads its one zone's bounds into registers
//   before the staging's wait, so one round trip to memory serves both,
//   the shortest chain a thread has. Else R = 4 (131,072 zones): the zone
//   rows a tile touches, one contiguous slab of zlo and of zhi, are staged
//   too (cp.async, 16 bytes where aligned), and read by every lane that
//   meets them. 37 KB of shared memory at most. d' = 6, the engine's, has
//   a route with no per-dim predicate; wider zones are read from device
//   memory. The bound is the mask's NZ x B bytes written and the inputs
//   read, far below one launch. It replaced one thread a zone looping over
//   all B boxes with a byte store B apart for each (8 CTAs at 1,024
//   zones), which also wrote the hit vector beside the mask.
// - Hits: one thread a zone, which stops at its first overlapping box;
//   a block stops once all its zones hit.
//
// zone_candidates_launch: the fused probe's whole front end in ONE launch:
// per zone whether it overlaps any box, n_hit (the number of such zones,
// before any capacity cut, as a device int32) and cand [capacity] (the
// ascending ids of the first `capacity` of them, 0-filled past n_hit):
// jnp.nonzero(hit, size=capacity, fill_value=0) of the reference's
// fused_query. Before it the probe took 14 launches here (the hit vector,
// its sum, and the compaction's cumsum / where / scatter), 0.031 ms of
// device time a probe by CUDA graph against this entry's 0.008 (NVIDIA
// H100 80GB HBM3, 700 W; chip_smoke.py --only zone_prune). Its bound is
// still the bytes' ~15 ns, and an empty launch takes ~0.9 us of device
// time (measured the same way), so the body is what is left: ~7 us at
// 1,024 zones, the box tests' latency and the block's barriers.
// One rule places the zones: a thread tests zpt = clamp(ceil(NZ / (256 x
// SMs)), 4, 32) contiguous zones (a bit each in a register mask), in tiles
// of 256 threads x zpt zones, as few a thread as fill one wave of one CTA
// an SM. Up to 1,024 zones (256 threads x 4, the main path's NZ) that is
// one tile, one CTA, and it touches no scratch.
// - Within a tile: the boxes are staged in shared memory as (lo, hi)
//   pairs, in chunks, and read by broadcast; 4 zones against 4 boxes at a
//   time (test_zones). A block-wide exclusive scan of the per-thread hit
//   counts (__shfl_up_sync within each warp, then the 8 warp totals) gives
//   each thread its offset in the tile; it writes its hit ids below
//   `capacity`.
// - Across tiles: a single-pass scan with decoupled look-back. A CTA
//   takes its tile from an atomic ticket, not from blockIdx, so every tile
//   it waits on belongs to a CTA that is already running. It publishes its
//   tile's count as an aggregate; its first warp reads 32 predecessors'
//   status words at a time, stops at the nearest inclusive prefix and sums
//   the aggregates up to it; the CTA publishes its own inclusive prefix and
//   writes its hits. The scratch words (ticket, a done counter, a status
//   word per tile) are cached per device by the wrapper, zero at
//   allocation; the last CTA to finish (by the done counter) writes n_hit,
//   fills the tail of cand and zeroes the scratch again, so no memset
//   launch is added per call. 131,072 zones, the paper's scale, take
//   0.014 ms (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --only
//   zone_prune).
// - One tile (NZ <= 1,024): the block fills cand[n_hit:capacity) with 0
//   and thread 0 writes n_hit.
// Neither route synchronises with the host: n_hit stays on the device,
// where box_scan_seg_gather reads it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;               // the hit kernel's CTA
constexpr int kMaskThreads = 128;
constexpr int kMaskCtasPerSm = 16;          // 2,048 threads an SM
constexpr int kStagedDims = 8;              // the widest zones staged

// zone rows that a tile of tile_pairs consecutive pairs touches, at most
__host__ __device__ __forceinline__ int tile_zone_rows(int nb,
                                                       int tile_pairs) {
  return (tile_pairs - 1) / nb + 2;
}

// Asynchronous copies from device to shared memory (cp.async): no
// register holds the data on the way, so every copy a thread starts is in
// flight at once, and one wait covers them all.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start, by the whole CTA, the copies of src[s, e) into dst: element i
// lands at dst[i - (s & ~3)], so dst (16-byte aligned) mirrors src's
// 16-byte granules. 16-byte copies over the granules inside [s, e) where
// src is 16-byte aligned, 4-byte copies for the rest. Returns where
// element s landed.
__device__ __forceinline__ const float* stage(float* dst,
                                              const float* __restrict__ src,
                                              long long s, long long e) {
  const long long a0 = s & ~3ll;
  long long a = s, b = s;                   // the 16-byte part [a, b)
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    a = min((s + 3) & ~3ll, e);
    b = max(a, e & ~3ll);
  }
  for (long long j = threadIdx.x; j < (b - a) >> 2; j += blockDim.x)
    copy16(dst + (a - a0) + 4 * j, src + a + 4 * j);
  for (long long i = s + threadIdx.x; i < a; i += blockDim.x)
    copy4(dst + (i - a0), src + i);
  for (long long i = b + threadIdx.x; i < e; i += blockDim.x)
    copy4(dst + (i - a0), src + i);
  return dst + (s - a0);
}

// Start, by the whole CTA, the copies of boxes [b, b + n) (rows of d
// floats) into dst's rows [row, row + n) at a row stride of d + 1: an odd
// stride for d' = 6, so the 32 consecutive boxes of a warp's pairs sit in
// 32 distinct banks.
__device__ __forceinline__ void stage_boxes(float* dst,
                                            const float* __restrict__ src,
                                            int b, int n, int row, int d) {
  for (int i = threadIdx.x; i < n * d; i += blockDim.x)
    copy4(dst + (size_t)(row + i / d) * (d + 1) + i % d,
          src + (size_t)b * d + i);
}

// floats of a shared-memory region that stages n floats by stage() (3
// ahead of the first at most), kept a multiple of 4
__host__ __device__ __forceinline__ int region(int n) {
  return (n + 3 + 3) & ~3;
}

// zone (zl, zh) against box (bl, bh) on every dim, the Pallas body's
// comparisons. DR = 6: exactly d' = 6 dims, no per-dim predicate; DR > 0:
// d <= DR; DR = 0: any d.
template <int DR>
__device__ __forceinline__ bool overlaps(const float* zl, const float* zh,
                                         const float* bl, const float* bh,
                                         int d) {
  bool ov = true;
  if constexpr (DR > 0) {
#pragma unroll
    for (int k = 0; k < DR; ++k) {
      if (DR == 6 || k < d) ov &= (zh[k] > bl[k]) & (zl[k] <= bh[k]);
    }
  } else {
    for (int k = 0; k < d && ov; ++k) ov = (zh[k] > bl[k]) && (zl[k] <= bh[k]);
  }
  return ov;
}

// The [NZ, B] mask over flat pairs (the header's "Mask"), R rounds of 32
// pairs a warp. DR > 0 stages the boxes (at R = 4 the zone slab too) in
// shared memory; DR = 0 reads every input from device memory.
template <int DR, int R>
__global__ void __launch_bounds__(kMaskThreads)
zone_prune_kernel(const float* __restrict__ zlo, const float* __restrict__ zhi,
                  const float* __restrict__ blo, const float* __restrict__ bhi,
                  int nz, int nb, int d, uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) float mask_smem[];
  constexpr bool kStaged = DR > 0;
  constexpr int kTilePairs = kMaskThreads * R;
  const int lane = threadIdx.x & 31;
  const unsigned warp_pairs = (threadIdx.x >> 5) * (32 * R);
  // R = 1 reads its zones into registers (kZoneRegs), R = 4 stages them
  constexpr bool kZoneRegs = kStaged && R == 1;
  const int brows = min(nb, kTilePairs);
  const int zreg = kZoneRegs ? 0 : region(tile_zone_rows(nb, kTilePairs) * d);
  float* r_zlo = mask_smem;
  float* r_zhi = r_zlo + zreg;
  float* s_blo = r_zhi + zreg;              // [brows, d + 1]
  float* s_bhi = s_blo + (size_t)brows * (d + 1);
  const long long pairs = (long long)nz * nb;
  const long long tiles = (pairs + kTilePairs - 1) / kTilePairs;
  // B <= the tile's pairs: every box staged once a CTA, in box order
  const bool all_boxes = nb <= kTilePairs;
  const float *s_zlo = nullptr, *s_zhi = nullptr;
  if (kStaged && all_boxes) {
    stage_boxes(s_blo, blo, 0, nb, 0, d);
    stage_boxes(s_bhi, bhi, 0, nb, 0, d);
  }
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long p0 = t * kTilePairs;
    const int tile_n = (int)min((long long)kTilePairs, pairs - p0);
    // (z0, b0): the tile's first pair, by 32-bit division where it fits
    long long z0;
    int b0;
    if (pairs <= 0xFFFFFFFFll) {
      const unsigned u0 = (unsigned)p0;
      z0 = u0 / (unsigned)nb;
      b0 = (int)(u0 - (unsigned)z0 * (unsigned)nb);
    } else {
      z0 = p0 / nb;
      b0 = (int)(p0 - z0 * nb);
    }
    // R = 1: the lane's one pair, its zone's bounds loaded into registers
    // before the wait below, so that they share the staging's round trip
    float zl[kZoneRegs ? DR : 1], zh[kZoneRegs ? DR : 1];
    if constexpr (kZoneRegs) {
      const unsigned q = warp_pairs + lane;
      if (q < (unsigned)tile_n) {
        const size_t z = (size_t)(z0 + ((unsigned)b0 + q) / (unsigned)nb);
#pragma unroll
        for (int k = 0; k < DR; ++k) {
          if (DR == 6 || k < d) {
            zl[k] = __ldg(zlo + z * d + k);
            zh[k] = __ldg(zhi + z * d + k);
          }
        }
      }
    }
    if constexpr (kStaged) {
      __syncthreads();                      // the last tile is read
      if constexpr (!kZoneRegs) {
        const long long z1 =
            z0 + ((unsigned)b0 + tile_n - 1) / (unsigned)nb + 1;
        s_zlo = stage(r_zlo, zlo, z0 * d, z1 * d);
        s_zhi = stage(r_zhi, zhi, z0 * d, z1 * d);
      }
      if (!all_boxes) {                     // boxes b0, b0 + 1, ... mod B
        const int n1 = min(brows, nb - b0);
        stage_boxes(s_blo, blo, b0, n1, 0, d);
        stage_boxes(s_bhi, bhi, b0, n1, 0, d);
        stage_boxes(s_blo, blo, 0, brows - n1, n1, d);
        stage_boxes(s_bhi, bhi, 0, brows - n1, n1, d);
      }
      copies_done();
      __syncthreads();
    }
    // round j: lane l tests the warp's pair j * 32 + l, so a warp's 32
    // lanes take 32 consecutive pairs; the ballots hold the results
    uint32_t bal[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const unsigned q = warp_pairs + j * 32 + lane;    // in the tile
      bool ov = false;
      if (q < (unsigned)tile_n) {
        const unsigned o = (unsigned)b0 + q;            // from (z0, 0)
        const int r = (int)(o / (unsigned)nb);          // zone z0 + r
        const int b = (int)(o - (unsigned)r * nb);
        if constexpr (kStaged) {
          const int k = all_boxes ? b : (b >= b0 ? b - b0 : b + nb - b0);
          ov = kZoneRegs
                   ? overlaps<DR>(zl, zh, s_blo + k * (d + 1),
                                  s_bhi + k * (d + 1), d)
                   : overlaps<DR>(s_zlo + r * d, s_zhi + r * d,
                                  s_blo + k * (d + 1), s_bhi + k * (d + 1),
                                  d);
        } else {
          const size_t z = (size_t)(z0 + r);
          ov = overlaps<DR>(zlo + z * d, zhi + z * d, blo + (size_t)b * d,
                            bhi + (size_t)b * d, d);
        }
      }
      bal[j] = __ballot_sync(0xFFFFFFFFu, ov);
    }
    // lane l < 8 R writes the warp's pairs 4l .. 4l + 3: bits 4l % 32 ..
    // of ballot l / 8, one byte each, in one 32-bit store
    uint32_t v = bal[0];
#pragma unroll
    for (int j = 1; j < R; ++j) {
      if (lane >= j * 8) v = bal[j];
    }
    const uint32_t bits = (v >> ((4 * lane) & 31)) & 0xFu;
    const uint32_t word = (bits & 1u) | ((bits & 2u) << 7) |
                          ((bits & 4u) << 14) | ((bits & 8u) << 21);
    const int q = (int)warp_pairs + 4 * lane;
    const int n = lane < 8 * R ? min(4, tile_n - q) : 0;
    uint8_t* out = mask + p0 + q;
    if (n == 4) {
      *reinterpret_cast<uint32_t*>(out) = word;
    } else {
      for (int u = 0; u < n; ++u) out[u] = (uint8_t)(word >> (8 * u));
    }
  }
}

// One mask launch: R rounds a warp, the inputs staged up to d = 8 (d' = 6
// its own route), the CTAs capped at kMaskCtasPerSm an SM.
template <int R>
void launch_mask(const float* zlo, const float* zhi, const float* blo,
                 const float* bhi, int nz, int nb, int d, uint8_t* mask,
                 int sms, cudaStream_t s) {
  constexpr int kTilePairs = kMaskThreads * R;
  const long long tiles = ((long long)nz * nb + kTilePairs - 1) / kTilePairs;
  const int grid = (int)min(tiles, (long long)max(sms, 1) * kMaskCtasPerSm);
  if (d > kStagedDims) {
    zone_prune_kernel<0, R><<<grid, kMaskThreads, 0, s>>>(
        zlo, zhi, blo, bhi, nz, nb, d, mask);
    return;
  }
  // at most 513 zone rows of 8 floats, or 2 and 512 boxes of 9, twice:
  // 37 KB
  const size_t smem =
      2 * ((R == 1 ? 0 : (size_t)region(tile_zone_rows(nb, kTilePairs) * d)) +
           (size_t)min(nb, kTilePairs) * (d + 1)) * sizeof(float);
  if (d == 6) {
    zone_prune_kernel<6, R><<<grid, kMaskThreads, smem, s>>>(
        zlo, zhi, blo, bhi, nz, nb, d, mask);
  } else {
    zone_prune_kernel<kStagedDims, R><<<grid, kMaskThreads, smem, s>>>(
        zlo, zhi, blo, bhi, nz, nb, d, mask);
  }
}

// The [NZ] hit vector: one thread a zone, its bounds in registers (d <=
// 8) or read from device memory; the boxes staged in chunks.
template <int DR>
__global__ void zone_hits_kernel(const float* __restrict__ zlo,
                                 const float* __restrict__ zhi,
                                 const float* __restrict__ blo,
                                 const float* __restrict__ bhi,
                                 int nz, int nb, int d, int box_chunk,
                                 uint8_t* __restrict__ hit) {
  extern __shared__ float smem[];
  float* s_lo = smem;                       // [box_chunk, d]
  float* s_hi = smem + (size_t)box_chunk * d;
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = z < nz;
  float rlo[DR > 0 ? DR : 1], rhi[DR > 0 ? DR : 1];
  if (DR > 0 && live) {
#pragma unroll
    for (int k = 0; k < (DR > 0 ? DR : 1); ++k) {
      if (k < d) {
        rlo[k] = zlo[(size_t)z * d + k];
        rhi[k] = zhi[(size_t)z * d + k];
      }
    }
  }
  bool found = false;
  for (int b0 = 0; b0 < nb; b0 += box_chunk) {
    // stop once every zone of this block has a hit
    if (__syncthreads_and(found || !live)) break;
    const int bn = min(box_chunk, nb - b0);
    for (int t = threadIdx.x; t < bn * d; t += blockDim.x) {
      s_lo[t] = blo[(size_t)b0 * d + t];
      s_hi[t] = bhi[(size_t)b0 * d + t];
    }
    __syncthreads();
    if (!live || found) continue;
    for (int bb = 0; bb < bn && !found; ++bb) {
      found = DR > 0 ? overlaps<DR>(rlo, rhi, s_lo + bb * d, s_hi + bb * d, d)
                     : overlaps<0>(zlo + (size_t)z * d, zhi + (size_t)z * d,
                                   s_lo + bb * d, s_hi + bb * d, d);
    }
  }
  if (live) hit[z] = found ? 1 : 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a negative size or a mask that is not 4-byte
// aligned. Launches on `stream` and never synchronises. With mask, the
// [NZ, B] mask is written and hit is not touched (it may be null); with
// mask == nullptr, the [NZ] hit vector.
extern "C" int zone_prune_launch(const float* zlo, const float* zhi,
                                 const float* blo, const float* bhi,
                                 int nz, int nb, int d,
                                 uint8_t* mask, uint8_t* hit,
                                 void* stream) {
  if (nz < 0 || nb < 0 || d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mask != nullptr) {
    if (reinterpret_cast<uintptr_t>(mask) & 3)
      return (int)cudaErrorInvalidValue;
    const long long pairs = (long long)nz * nb;
    if (pairs == 0) return (int)cudaGetLastError();
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // one round a warp (a pair a thread) while the CTAs of 128 pairs fit
    // under the cap: the shortest chain a thread, for the host oracle's
    // few boxes; 4 rounds beyond it (131,072 zones)
    if (pairs <= (long long)max(sms, 1) * kMaskCtasPerSm * kMaskThreads)
      launch_mask<1>(zlo, zhi, blo, bhi, nz, nb, d, mask, sms, s);
    else
      launch_mask<4>(zlo, zhi, blo, bhi, nz, nb, d, mask, sms, s);
    return (int)cudaGetLastError();
  }
  if (nz == 0) return (int)cudaGetLastError();
  // boxes staged in chunks of at most 32 KB of shared memory
  int box_chunk = 32768 / (2 * (d > 0 ? d : 1) * (int)sizeof(float));
  if (box_chunk > 256) box_chunk = 256;
  if (box_chunk < 1) box_chunk = 1;
  const size_t smem = (size_t)box_chunk * 2 * d * sizeof(float);
  const dim3 grid((nz + kThreads - 1) / kThreads);
  if (d <= kStagedDims) {
    zone_hits_kernel<kStagedDims><<<grid, kThreads, smem, s>>>(
        zlo, zhi, blo, bhi, nz, nb, d, box_chunk, hit);
  } else {
    zone_hits_kernel<0><<<grid, kThreads, smem, s>>>(
        zlo, zhi, blo, bhi, nz, nb, d, box_chunk, hit);
  }
  return (int)cudaGetLastError();
}

namespace {

constexpr int kCandThreads = 256;
constexpr int kCandWarps = kCandThreads / 32;
constexpr int kMaxZpt = 32;               // zones a thread holds in its mask
constexpr int kR = 4;                     // zones a thread tests at once
constexpr int kB = 4;                     // boxes it tests them against
// a tile's status word: flag in the top two bits, a count below
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long load_volatile(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The hits among a thread's zones [z0, z0 + zn) (bit i: zone z0 + i)
// against the boxes of one staged chunk. D <= DR (DR > 0; DR = 6 is the
// path's d' exactly, with no per-dim predicates): kR zones at a time in
// registers against kB boxes at a time, each box's dims read once from
// shared memory for all kR zones, every dim tested without a short
// circuit, so a group's loads and compares issue together; a group of
// zones leaves the box loop once all of them hit. (One box at a time, with
// an exit test after each, was latency-bound: 0.0096 ms at the main
// path's 1,024 zones against 0.0077 so, by chip_smoke.py --only
// zone_prune on an H100.)
// DR = 0: one zone at a time, its bounds read from device memory.
template <int DR>
__device__ __forceinline__ uint32_t test_zones(
    const float* __restrict__ zlo, const float* __restrict__ zhi,
    const float2* s_box, long long z0, int zn, int bn, int d,
    uint32_t found) {
  if constexpr (DR > 0) {
    constexpr bool kExact = DR == 6;
    for (int g0 = 0; g0 < zn; g0 += kR) {
      const int gn = min(kR, zn - g0);
      const uint32_t want = ((1u << gn) - 1u) << g0;
      if ((found & want) == want) continue;
      float rlo[kR][DR], rhi[kR][DR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int k = 0; k < DR; ++k) {
          rlo[r][k] = rhi[r][k] = 0.f;
          if (r < gn && (kExact || k < d)) {
            const size_t e = (size_t)(z0 + g0 + r) * d + k;
            rlo[r][k] = zlo[e];
            rhi[r][k] = zhi[e];
          }
        }
      }
      for (int bb = 0; bb < bn && (found & want) != want; bb += kB) {
        float2 b[kB][DR];
#pragma unroll
        for (int u = 0; u < kB; ++u) {
#pragma unroll
          for (int k = 0; k < DR; ++k) {
            b[u][k] = make_float2(0.f, 0.f);
            if (bb + u < bn && (kExact || k < d))
              b[u][k] = s_box[(size_t)(bb + u) * d + k];
          }
        }
#pragma unroll
        for (int u = 0; u < kB; ++u) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            bool ov = r < gn && bb + u < bn;
#pragma unroll
            for (int k = 0; k < DR; ++k) {
              if (kExact || k < d)
                ov &= (rhi[r][k] > b[u][k].x) & (rlo[r][k] <= b[u][k].y);
            }
            if (ov) found |= 1u << (g0 + r);
          }
        }
      }
    }
  } else {
    for (int i = 0; i < zn; ++i) {
      if (found >> i & 1u) continue;
      const size_t z = (size_t)(z0 + i);
      for (int bb = 0; bb < bn; ++bb) {
        const float2* bx = s_box + (size_t)bb * d;
        bool ov = true;
        for (int k = 0; k < d && ov; ++k) {
          ov = (zhi[z * d + k] > bx[k].x) && (zlo[z * d + k] <= bx[k].y);
        }
        if (ov) {
          found |= 1u << i;
          break;
        }
      }
    }
  }
  return found;
}

template <int DR>
__global__ void __launch_bounds__(kCandThreads)
zone_candidates_kernel(const float* __restrict__ zlo,
                       const float* __restrict__ zhi,
                       const float* __restrict__ blo,
                       const float* __restrict__ bhi, int nz, int nb, int d,
                       int box_chunk, int zpt, int capacity,
                       int* __restrict__ cand, int* __restrict__ n_hit,
                       unsigned long long* __restrict__ scratch) {
  extern __shared__ float2 s_box[];         // [box_chunk, d] (lo, hi)
  __shared__ int s_warp[kCandWarps];
  __shared__ int s_tile, s_total, s_base, s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = gridDim.x;
  unsigned long long* ticket = scratch;
  unsigned long long* done = scratch + 1;
  unsigned long long* status = scratch + 2;
  int tile = 0;
  if (ntiles > 1) {
    if (tid == 0) s_tile = (int)atomicAdd(ticket, 1ull);
    __syncthreads();
    tile = s_tile;
  }
  const long long z0 =
      ((long long)tile * kCandThreads + tid) * (long long)zpt;
  const int zn = (int)max(0ll, min((long long)zpt, (long long)nz - z0));
  const uint32_t all = zn == 32 ? 0xFFFFFFFFu : ((1u << zn) - 1u);
  uint32_t found = 0;                       // bit i: zone z0 + i hits
  for (int b0 = 0; b0 < nb; b0 += box_chunk) {
    // stop once every zone of the block has a hit
    if (__syncthreads_and(found == all)) break;
    const int bn = min(box_chunk, nb - b0);
    for (int t = tid; t < bn * d; t += blockDim.x) {
      s_box[t] = make_float2(blo[(size_t)b0 * d + t], bhi[(size_t)b0 * d + t]);
    }
    __syncthreads();
    found = test_zones<DR>(zlo, zhi, s_box, z0, zn, bn, d, found);
    __syncthreads();                        // the chunk is read
  }
  // block-wide exclusive scan of the per-thread hit counts: within each
  // warp by shuffles, then over the warp totals
  const int count = __popc(found);
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kCandWarps ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, wi, o);
      if (lane >= o) wi += v;
    }
    if (lane < kCandWarps) s_warp[lane] = wi - w;   // exclusive
    if (lane == kCandWarps - 1) s_total = wi;       // the tile's total
  }
  __syncthreads();
  const int tile_total = s_total;
  long long base = 0;
  if (ntiles > 1) {
    // decoupled look-back by warp 0: its lanes read 32 predecessors'
    // status words at once (each spins until its word is published),
    // stop at the nearest inclusive prefix and sum the aggregates up to it
    if (warp == 0) {
      if (tile == 0) {
        if (lane == 0)
          atomicExch(&status[0], kPrefix | (unsigned long long)tile_total);
      } else {
        if (lane == 0)
          atomicExch(&status[tile],
                     kAggregate | (unsigned long long)tile_total);
        unsigned long long excl = 0;
        for (int j = tile - 1;; j -= 32) {
          const int idx = j - lane;
          unsigned long long w = kPrefix;   // before tile 0: a prefix of 0
          if (idx >= 0) {
            do {
              w = load_volatile(&status[idx]);
            } while (w == 0);
          }
          const unsigned pre = __ballot_sync(0xFFFFFFFFu, (w & kPrefix) != 0);
          const int stop = pre ? __ffs(pre) - 1 : 31;
          unsigned long long v = lane <= stop ? (w & kValueMask) : 0;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
          excl += v;
          if (pre) break;
        }
        if (lane == 0) {
          atomicExch(&status[tile],
                     kPrefix | (excl + (unsigned long long)tile_total));
          s_base = (int)excl;
        }
      }
    }
    if (tile == 0 && tid == 0) s_base = 0;
    __syncthreads();
    base = s_base;
  }
  long long pos = base + s_warp[warp] + incl - count;
  for (uint32_t f = found; f != 0; f &= f - 1) {
    if (pos < capacity) cand[pos] = (int)(z0 + __ffs(f) - 1);
    ++pos;
  }
  int total = tile_total;
  if (ntiles > 1) {
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      s_last = atomicAdd(done, 1ull) == (unsigned long long)(ntiles - 1);
    }
    __syncthreads();
    if (!s_last) return;
    // the last CTA to finish: every other CTA is done with the scratch
    __threadfence();
    total = (int)(load_volatile(&status[ntiles - 1]) & kValueMask);
    __syncthreads();                        // all have read the total
    for (int t = tid; t < ntiles; t += blockDim.x) status[t] = 0;
    if (tid == 0) {
      *ticket = 0;
      *done = 0;
    }
  }
  for (int s = max(total, 0) + tid; s < capacity; s += blockDim.x) cand[s] = 0;
  if (tid == 0) *n_hit = total;
}

template <int DR>
cudaError_t launch_candidates(dim3 grid, size_t smem, cudaStream_t s,
                              const float* zlo, const float* zhi,
                              const float* blo, const float* bhi, int nz,
                              int nb, int d, int box_chunk, int zpt,
                              int capacity, int* cand, int* n_hit,
                              unsigned long long* scratch) {
  zone_candidates_kernel<DR><<<grid, kCandThreads, smem, s>>>(
      zlo, zhi, blo, bhi, nz, nb, d, box_chunk, zpt, capacity, cand, n_hit,
      scratch);
  return cudaGetLastError();
}

}  // namespace

// Zones a thread tests: as few as fill one wave of tiles, at least kR
// (the register block) and at most kMaxZpt (the mask's bits). The tiles
// number at most ceil(nz / 1,024), so 2 + ceil(nz / 1,024) scratch words
// always suffice.
static int zone_candidates_zpt(int nz, int sms) {
  const long long per_wave = (long long)kCandThreads * (sms > 0 ? sms : 1);
  long long zpt = ((long long)nz + per_wave - 1) / per_wave;
  if (zpt < kR) zpt = kR;
  if (zpt > kMaxZpt) zpt = kMaxZpt;
  return (int)zpt;
}

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue where the scratch is too small for the tiles.
// Launches on `stream` and never synchronises. scratch: `scratch_words`
// uint64 words, zero, used by one launch at a time (unused by one tile).
extern "C" int zone_candidates_launch(const float* zlo, const float* zhi,
                                      const float* blo, const float* bhi,
                                      int nz, int nb, int d, int capacity,
                                      int* cand, int* n_hit,
                                      unsigned long long* scratch,
                                      long long scratch_words,
                                      void* stream) {
  if (nz < 0 || nb < 0 || d < 0 || capacity < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int zpt = zone_candidates_zpt(nz, sms);
  const long long per_tile = (long long)kCandThreads * zpt;
  const long long tiles_ll = ((long long)nz + per_tile - 1) / per_tile;
  const int tiles = tiles_ll > 0 ? (int)tiles_ll : 1;
  if (tiles > 1 &&
      (scratch == nullptr || scratch_words < 2 + (long long)tiles))
    return (int)cudaErrorInvalidValue;
  int box_chunk = 32768 / (2 * (d > 0 ? d : 1) * (int)sizeof(float));
  if (box_chunk > 256) box_chunk = 256;
  if (box_chunk < 1) box_chunk = 1;
  const size_t smem = (size_t)box_chunk * 2 * d * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  auto launch = d == 6  ? launch_candidates<6>
                : d <= 8 ? launch_candidates<8>
                         : launch_candidates<0>;
  return (int)launch(dim3(tiles), smem, s, zlo, zhi, blo, bhi, nz, nb, d,
                     box_chunk, zpt, capacity, cand, n_hit, scratch);
}
