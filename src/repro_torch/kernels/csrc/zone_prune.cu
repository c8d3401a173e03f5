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
// 3.35 TB/s) and does at most NZ*B*D*2 compares (~6 M at B = 512, ~0.2 us
// at 33.5 T f32 lane-ops/s), where an empty kernel takes ~0.9 us of device
// time (measured). So the design gains most by making fewer launches.
//
// Two entries.
//
// zone_prune_launch: one thread per zone, the [NZ, B] overlap mask (the
// Pallas kernel's own output, kept for the kernel tests and the
// use_fused=False host oracle) or, with mask == nullptr, the [NZ] hit
// vector (a zone stops at its first overlapping box).
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

constexpr int kThreads = 128;

template <int DR>
__global__ void zone_prune_kernel(const float* __restrict__ zlo,
                                  const float* __restrict__ zhi,
                                  const float* __restrict__ blo,
                                  const float* __restrict__ bhi,
                                  int nz, int nb, int d, int box_chunk,
                                  uint8_t* __restrict__ mask,
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
    // hit-only mode: stop once every zone of this block has a hit
    if (mask == nullptr && __syncthreads_and(found || !live)) break;
    const int bn = min(box_chunk, nb - b0);
    __syncthreads();
    for (int t = threadIdx.x; t < bn * d; t += blockDim.x) {
      s_lo[t] = blo[(size_t)b0 * d + t];
      s_hi[t] = bhi[(size_t)b0 * d + t];
    }
    __syncthreads();
    if (!live || (found && mask == nullptr)) continue;
    for (int bb = 0; bb < bn; ++bb) {
      bool ov = true;
      if (DR > 0) {
#pragma unroll
        for (int k = 0; k < (DR > 0 ? DR : 1); ++k) {
          if (k < d) {
            ov = ov && (rhi[k] > s_lo[bb * d + k]) &&
                 (rlo[k] <= s_hi[bb * d + k]);
          }
        }
      } else {
        for (int k = 0; k < d && ov; ++k) {
          ov = (zhi[(size_t)z * d + k] > s_lo[bb * d + k]) &&
               (zlo[(size_t)z * d + k] <= s_hi[bb * d + k]);
        }
      }
      if (mask != nullptr) {
        mask[(size_t)z * nb + b0 + bb] = ov ? 1 : 0;
      } else if (ov) {
        found = true;
        break;
      }
      found = found || ov;
    }
  }
  if (live) hit[z] = found ? 1 : 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Launches on
// `stream` and never synchronises. mask may be null (hit-only mode).
extern "C" int zone_prune_launch(const float* zlo, const float* zhi,
                                 const float* blo, const float* bhi,
                                 int nz, int nb, int d,
                                 uint8_t* mask, uint8_t* hit,
                                 void* stream) {
  if (nz <= 0) return (int)cudaGetLastError();
  // boxes staged in chunks of at most 32 KB of shared memory
  int box_chunk = 32768 / (2 * (d > 0 ? d : 1) * (int)sizeof(float));
  if (box_chunk > 256) box_chunk = 256;
  if (box_chunk < 1) box_chunk = 1;
  const size_t smem = (size_t)box_chunk * 2 * d * sizeof(float);
  const dim3 grid((nz + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 8) {
    zone_prune_kernel<8><<<grid, kThreads, smem, s>>>(
        zlo, zhi, blo, bhi, nz, nb, d, box_chunk, mask, hit);
  } else {
    zone_prune_kernel<0><<<grid, kThreads, smem, s>>>(
        zlo, zhi, blo, bhi, nz, nb, d, box_chunk, mask, hit);
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
