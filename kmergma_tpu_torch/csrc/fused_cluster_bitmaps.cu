// K3: the fused multi-cluster lower-bound bitmap pass, which at m = 1 is
// also K1, and K8: the round trip of every table entry through K3's lookup,
// written by hand for Hopper (sm_90a).
//
// K3 replaces kmergma_tpu/ops/scan_cluster_fused.py::_fused_cluster_kernel
// (entry fused_cluster_record_bitmaps): K1 for m cluster profiles in one
// pass over the codes.  K1, kmergma_tpu/ops/scan_fused.py::_fused_kernel
// (entry fused_record_bitmaps), is this kernel at m = 1: one bitmap kernel
// serves one profile or many.  For one tile of t windows a
// block computes the rolling K codes and the depth-limited left and right
// pair counts Lc, Rc once (csrc/pair_counts.cuh), then for each cluster c
// (width w_c = ws_c - k + 1, size r_c)
//   delta_c[p] = 2 r_c^2 (Lc[p + w_c] - Rc[p]) + 2 r_c (S_c[K[p]] - S_c[K[p + w_c]]),
// their prefix sum from the tile's base, and one any(L < thr_c) flag per
// `block` windows, masked to p < nw_c (windowsizes differ, so window
// counts do).  The bitmap is cluster-major, int32[m, n_tiles * t / block]
// (the TPU's (tile, cluster) interleave was a lane-layout matter).
//
// What bound the first design: latency.  The six k = 6 tables (96 KB)
// beside the tile left room for one 256-thread block per SM (8 warps), one
// block per tile re-staged the tables each time (3,907 x 96 KB of L2 reads
// at 16 Mbp), and the scan took one window per thread per round: 16 rounds
// of shuffles and three block barriers per cluster, about 290 barriers per
// tile, each behind a chain of shared loads, lookups and shuffles.
//
// This design:
//   - Persistent blocks.  The grid is min(n_tiles, SMs x resident blocks);
//     each block stages the m tables once (cp.async) and walks tiles
//     blockIdx.x, + gridDim.x, ...; 512 threads a block.  A tile's raw codes
//     (and in pass 2 its pair counts) arrive by cp.async while the block
//     computes the tile before, into two buffers.  The codes are packed 16
//     to a word and every K code is one 64-bit shift of two words.
//   - Pass 1 computes the pair counts (for k <= 8 and depth <= 16 from
//     16-bit K codes tiled in registers, 16 positions a lane, see
//     pair_counts16) and leaves them, 2 bytes a window, in a scratch buffer
//     for pass 2, which so never recomputes them.  It telescopes each
//     tile's total:
//       2 r^2 (sum_x Lc[x] - sum_p Rc[p] - E_c)
//         + 2 r (sum_{i < L} S[K[i]] - sum_{t + w - L <= i < t + w} S[K[i]]),
//     L = min(t, w), E_c the Lc of the w_max - w_min positions outside
//     [w, t + w): one block sum for all clusters, then one warp per cluster
//     for its 2 L table reads; a reassociation of integer sums, so
//     bit-exact, and no scan.
//   - Windows tiled in registers (pass 2).  A warp owns kSeg = 256
//     consecutive windows of a round.  Its lanes compute the deltas with
//     neighbouring lanes on neighbouring windows (every K, Lc, Rc read free
//     of bank conflicts; a lane's K[p] and Rc[p] stay in registers for all
//     clusters), store them in a per-warp buffer padded by one word per 32,
//     and read them back as kJ = 8 consecutive windows per lane, again free
//     of conflicts.  Each lane sums its 8, one shuffle scan per warp and one
//     block barrier for kPair = 2 clusters give every lane its offsets, and
//     the lane walks its 8 bounds in registers.  A warp's windows lie in one
//     bitmap block (block is a multiple of 256), so its flag is one
//     __any_sync and one shared store.  The empty half of the last pair
//     (m odd; K1's m = 1) skips its scan.
// What bounds it now: shared-memory instruction issue.  Pass 1 is mostly
// the pair counts' XOR tests (ALU work, after the register tiling); pass 2
// is mostly the clusters' deltas: per window and
// cluster two table gathers (with their bank conflicts), two plain loads and
// the buffer's store and load.  `-Xptxas -v` (the build log chip_smoke
// prints) gives each pass's registers; the shared memory of the layout
// leaves one 512-thread block per SM either way; the per-pass times are
// chip_smoke's.
//
// Why two launches still.  The TPU kernel chains the absolute base through
// a scalar carry over a sequential grid.  CUDA blocks run in no order, and a
// chain across them inside one launch needs blocks to spin on each other's
// flags (decoupled look-back), which the pass-1 total, cheap since it
// telescopes, does not pay for.  Pass 1 (kEmit = false) writes each
// (cluster, tile) delta total in int64, the wrapper turns them into tile
// bases in torch (checked to fit int32), pass 2 recomputes the tile from its
// bases and emits the bitmap.  Prefix sums wrap in uint32 like the plain
// int32 twin.
//
// The m tables live in shared memory when they fit beside the tile (96 KB at
// m = 6, k = 6; `cluster_smem_plan`), and are read through the read-only
// cache with __ldg otherwise (six k = 7 tables are 384 KB): a template
// parameter, not a fallback.  Shared-memory plans, occupancy and the
// dynamic shared-memory attribute are computed once per (device, kernel,
// bytes) and cached; a launch makes no device query.
//
// K8 replaces kmergma_tpu/ops/scan_cluster_fused.py::pack_lookup_roundtrip
// (the kernel inside it).  On the TPU it certified, per chip, that the MXU
// one-hot lookup returned every S_c[v] exactly.  Here one block per cluster
// stages that cluster's slice of the stack with K3's helper, at the offset
// K3 gives it, in the placement K3 would choose for the same shapes, and
// writes every S_c[v] back through K3's lookup: the guard that K3's table
// staging and indexing are right on the card.

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "pair_counts.cuh"

namespace {

constexpr int kThreads = 512;              // threads per K3 block
constexpr int kWarps = kThreads / 32;
constexpr int kJ = 8;                      // consecutive windows a lane owns per round
constexpr int kSeg = 32 * kJ;              // windows a warp owns per round
constexpr int kRound = kThreads * kJ;      // windows a block covers per round
constexpr int kSegPad = kSeg + kSeg / 32;  // a warp's delta buffer, one pad word per 32
constexpr int kPair = 2;                   // pass-2 clusters per block barrier
constexpr int kMaxClusters = 32;
constexpr int kRtThreads = 1024;           // threads per K8 block
static_assert(256 % kSeg == 0, "a warp's windows must lie in one bitmap block");

struct Clusters {
  int m;
  int w[kMaxClusters];
  int r[kMaxClusters];
  int thr[kMaxClusters];
  int nw[kMaxClusters];
};

// The m tables S_c (c-major, nbins each): staged in shared memory, or read
// through the read-only cache.
template <bool kInSmem>
struct Tables {
  const int32_t* base;
  int nbins;
  __device__ __forceinline__ int get(int c, int v) const {
    if constexpr (kInSmem) {
      return base[c * nbins + v];
    } else {
      return __ldg(base + c * nbins + v);
    }
  }
};

// Stages entries [lo, hi) of the c-major stack at their own offsets, as
// 16-byte cp.async copies when the stack is 16-byte aligned (lo and hi are
// multiples of 4: nbins = 4^k).  Block-cooperative; the caller runs
// __pipeline_wait_prior(0) and a barrier before the first get().  K3 stages
// the whole stack, K8 one cluster's slice.
template <bool kInSmem>
__device__ __forceinline__ Tables<kInSmem> stage_tables(const int32_t* __restrict__ s_stack,
                                                        int lo, int hi, int nbins, int32_t* smem) {
  if constexpr (kInSmem) {
    if ((reinterpret_cast<uintptr_t>(s_stack) & 15) == 0) {
      for (int q = lo / 4 + static_cast<int>(threadIdx.x); q < hi / 4; q += blockDim.x) {
        __pipeline_memcpy_async(smem + 4 * q, s_stack + 4 * q, 16);
      }
      __pipeline_commit();
    } else {
      for (int i = lo + static_cast<int>(threadIdx.x); i < hi; i += blockDim.x) smem[i] = s_stack[i];
    }
    return {smem, nbins};
  } else {
    return {s_stack, nbins};
  }
}

// The pair counts from 16-bit K codes, tiled in registers (depth <= 16).
// Two positions share a 32-bit word of k2 (K at an even position in the low
// half), and k2 is padded by one word per 8 (word i at pad8(i)), so a lane
// that owns a unit of kUnitWords consecutive words (16 positions) reads them
// and its 8-word halo with the lanes of its warp on 32 distinct banks.  It
// loads the unit once (16 words, one a position) and does its 16 XOR tests a
// word from registers: one XOR tests both halves at once, and the words up
// to 16 positions away serve all the compares, byte-permuted for odd
// distances.  A half of x is nonzero iff bit 15 of ((x & 0x7fff) + 0x7fff) |
// x is set (no carry leaves a half); with K codes below 4096 (k <= 6) a half
// is nonzero iff bit 12 of x + 0xfff is set, one operation fewer, summed
// over eight distances at a time so no count leaves its half.  The counts of
// unequal halves, at most 16 each, sit in the two halves of one word; the
// unit's 16 count bytes leave as one 16-byte store.  A tile has t / 16 left
// and t / 16 right units, one a thread at t = 4096 and 512 threads.
constexpr int kUnitWords = 8;
constexpr int kUnit = 2 * kUnitWords;  // positions a lane owns

__host__ __device__ __forceinline__ int pad8(int i) { return i + (i >> 3); }

__device__ __forceinline__ uint32_t unequal_halves(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  return ((((x & 0x7fff7fffu) + 0x7fff7fffu) | x) & 0x80008000u) >> 15;
}

// n[i] = the pair counts of the two positions of word q0 + i, i < 8: left
// (kLeft, partners 1..depth before) or right (after).  Returns their sum.
template <bool kNarrow, bool kLeft>
__device__ __forceinline__ int unit_counts(const uint32_t* __restrict__ k2, int q0, int depth,
                                           uint32_t n[kUnitWords]) {
  uint32_t w[2 * kUnitWords];  // left: words q0 - 8 .. q0 + 7; right: q0 .. q0 + 15
#pragma unroll
  for (int j = 0; j < 2 * kUnitWords; ++j) w[j] = k2[pad8(kLeft ? q0 - 8 + j : q0 + j)];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kUnitWords; ++i) {
    const uint32_t own = kLeft ? w[8 + i] : w[i];
    uint32_t ne = 0;
    uint32_t near = 0;  // kNarrow: flags at bits 12 and 28, distances 1..8
    uint32_t far = 0;   // and 9..16
#pragma unroll
    for (int d = 1; d <= 16; ++d) {
      // the partners of (K[2(q0 + i)], K[2(q0 + i) + 1]) at distance d
      uint32_t other;
      if (kLeft) {
        other = d % 2 == 0 ? w[8 + i - d / 2] : __byte_perm(w[8 + i - (d + 1) / 2], w[8 + i - (d - 1) / 2], 0x5432);
      } else {
        other = d % 2 == 0 ? w[i + d / 2] : __byte_perm(w[i + (d - 1) / 2], w[i + (d + 1) / 2], 0x5432);
      }
      if (d <= depth) {
        if (kNarrow) {
          const uint32_t f = ((own ^ other) + 0x0fff0fffu) & 0x10001000u;
          if (d <= 8) {
            near += f;
          } else {
            far += f;
          }
        } else {
          ne += unequal_halves(own, other);
        }
      }
    }
    if (kNarrow) ne = (near >> 12) + (far >> 12);
    n[i] = static_cast<uint32_t>(depth) * 0x00010001u - ne;
    sum += static_cast<int>((n[i] & 0xffffu) + (n[i] >> 16));
  }
  return sum;
}

// A unit's 8 count words (two positions each) as 16 bytes.
__device__ __forceinline__ void store_unit(const uint32_t n[kUnitWords], uint8_t* __restrict__ dst) {
  uint32_t b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = n[2 * i];
    const uint32_t c = n[2 * i + 1];
    b[i] = (a & 0xffu) | ((a >> 8) & 0xff00u) | ((c & 0xffu) << 16) | ((c << 8) & 0xff000000u);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(b[0], b[1], b[2], b[3]);
}

// A tile's pair counts (block-cooperative): Lc over [lo, hi) into lc[x -
// lc_lo], lc_lo = lo & ~1 (lo > 16), the first t of them in units, the rest
// (hi - lc_lo - t, the spread of the widths) one position a thread from the
// int32 K codes kc; Rc over [0, t) into rc[p].  k2 holds K[0 .. hi] in
// padded words.  lsum, rsum: this thread's sums over [lo, hi) and [0, t).
template <bool kNarrow>
__device__ __forceinline__ void pair_counts16(const uint32_t* __restrict__ k2, const int32_t* __restrict__ kc,
                                              int lo, int hi, int t, int depth, uint8_t* __restrict__ lc,
                                              uint8_t* __restrict__ rc, int& lsum, int& rsum) {
  const int lc_lo = lo & ~1;
  const int n_units = t / kUnit;
  for (int u = threadIdx.x; u < 2 * n_units; u += blockDim.x) {
    uint32_t n[kUnitWords];
    if (u < n_units) {
      const int q0 = (lc_lo >> 1) + kUnitWords * u;
      lsum += unit_counts<kNarrow, true>(k2, q0, depth, n);
      if (2 * q0 < lo) lsum -= static_cast<int>(n[0] & 0xffffu);  // Lc[lo - 1]: below the range
      store_unit(n, lc + kUnit * u);
    } else {
      const int v = u - n_units;
      rsum += unit_counts<kNarrow, false>(k2, kUnitWords * v, depth, n);
      store_unit(n, rc + kUnit * v);
    }
  }
  for (int x = lc_lo + t + static_cast<int>(threadIdx.x); x < hi; x += blockDim.x) {
    const int v = kc[x];
    int c = 0;
    for (int d = 1; d <= depth; ++d) c += kc[x - d] == v;
    lc[x - lc_lo] = static_cast<uint8_t>(c);
    lsum += c;
  }
}

// A tile's pair counts as pass 1 leaves them for pass 2, in shared memory
// and in the scratch buffer alike: the left counts Lc[lc_lo .. t + w_max),
// lc_lo = w_min & ~1 (the unit grid of pair_counts16), padded to 16 bytes,
// then t right counts Rc[0 .. t).
__host__ __device__ inline int lc_lo(int w_min) { return w_min & ~1; }
__host__ __device__ inline int lc_bytes(int t, int w_min, int w_max) { return (t + w_max - lc_lo(w_min) + 15) / 16 * 16; }
__host__ __device__ inline int count_bytes(int t, int w_min, int w_max) { return lc_bytes(t, w_min, w_max) + t; }

// Byte offsets of K3's dynamic shared memory, each section 16-byte
// aligned: the tables (when staged); pass-1 sums (int64: one per cluster,
// then the cluster-independent pair term per warp); per-warp delta buffers
// for kPair clusters; two buffers each of a tile's raw codes (16-byte copies
// from a 16-byte aligned start, room for k <= 16) and pair counts, so the
// next tile's arrive while this one is computed; the raw codes packed 16 to
// a word, two bits each, first code highest; flags (m x t / 256, room for
// the finest bitmap block, so the placement does not depend on it); t +
// w_max K codes (int32); K[0 .. t + w_max] as 16-bit halves in padded words
// (pad8), with room for the units' loads, for the 16-bit pair counts.
struct Layout {
  size_t wtot, xbuf, raw, raw_bytes, cnt, cnt_bytes, codes2, flags, kc, k16, end;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Layout cluster_layout(bool tables_in_smem, int m, int nbins, int t,
                                                 int w_min, int w_max) {
  Layout l;
  l.wtot = tables_in_smem ? align16(static_cast<size_t>(m) * nbins * sizeof(int32_t)) : 0;
  l.xbuf = l.wtot + align16(static_cast<size_t>(m + kWarps) * sizeof(long long));
  l.raw = l.xbuf + static_cast<size_t>(kPair) * kWarps * kSegPad * sizeof(uint32_t);
  l.raw_bytes = align16(static_cast<size_t>(t + w_max) + 15 + 15);
  l.cnt = l.raw + 2 * l.raw_bytes;
  l.cnt_bytes = count_bytes(t, w_min, w_max);
  l.codes2 = l.cnt + 2 * l.cnt_bytes;
  l.flags = l.codes2 + align16((l.raw_bytes / 16 + 1) * sizeof(uint32_t));
  l.kc = l.flags + align16(static_cast<size_t>(m) * (t / 256) * sizeof(int32_t));
  l.k16 = l.kc + align16(static_cast<size_t>(t + w_max) * sizeof(int32_t));
  l.end = l.k16 + static_cast<size_t>(pad8((t + w_max) / 2 + kUnitWords) + 1) * sizeof(uint32_t);
  return l;
}

// One device's limits, queried once.
struct DeviceInfo {
  int optin;
  int sms;
};

std::mutex g_cache_mu;

cudaError_t device_info(DeviceInfo* out) {
  static std::map<int, DeviceInfo> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_cache_mu);
  auto it = cache.find(dev);
  if (it == cache.end()) {
    DeviceInfo info{};
    err = cudaDeviceGetAttribute(&info.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    it = cache.emplace(dev, info).first;
  }
  *out = it->second;
  return cudaSuccess;
}

// Raises the kernel's dynamic shared-memory limit to `smem` when it is
// below (kmg::allow_smem_once, which never lowers it) and returns its
// resident blocks per SM at `threads` and `smem`, once per (device, kernel,
// smem).
cudaError_t kernel_ready(const void* kernel, int threads, size_t smem, int* blocks_per_sm) {
  static std::map<std::tuple<int, const void*, size_t>, int> occupancy;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_cache_mu);
  const auto key = std::make_tuple(dev, kernel, smem);
  auto it = occupancy.find(key);
  if (it == occupancy.end()) {
    err = kmg::allow_smem_once(kernel, smem);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    it = occupancy.emplace(key, n).first;
  }
  *blocks_per_sm = it->second;
  return cudaSuccess;
}

// K3's placement: the tables go in shared memory when they fit beside the
// rest of the layout under the opt-in limit.
struct SmemPlan {
  bool tables_in_smem;
  size_t smem;         // K3's dynamic shared memory, either pass
  size_t table_bytes;  // the whole stack
  int sms;
};

cudaError_t cluster_smem_plan(int m, int nbins, int t, int w_min, int w_max, SmemPlan* plan) {
  DeviceInfo info;
  const cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  // the kernels' static shared arrays (wsum, carries: 512 bytes), and slack
  const size_t static_bytes = 1024;
  const Layout with = cluster_layout(true, m, nbins, t, w_min, w_max);
  plan->tables_in_smem = with.end + static_bytes <= static_cast<size_t>(info.optin);
  plan->smem = plan->tables_in_smem ? with.end : cluster_layout(false, m, nbins, t, w_min, w_max).end;
  plan->table_bytes = static_cast<size_t>(m) * nbins * sizeof(int32_t);
  plan->sms = info.sms;
  return cudaSuccess;
}

template <bool kTablesInSmem, bool kEmit>
__global__ void __launch_bounds__(kThreads)
fused_cluster_kernel(const int8_t* __restrict__ codes, const int32_t* __restrict__ s_stack,
                     int nbins, int k, Clusters cl, int w_min, int w_max, int depth, int t,
                     int block, int n_tiles, const int32_t* __restrict__ bases,
                     long long* __restrict__ totals, int32_t* __restrict__ bitmap,
                     uint8_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t wsum[2][kPair][kWarps];
  __shared__ uint32_t carries[2][kMaxClusters];  // pass 2: each cluster's running base, by round parity

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = t / block;
  const Layout lay = cluster_layout(kTablesInSmem, cl.m, nbins, t, w_min, w_max);
  long long* wtot = reinterpret_cast<long long*>(smem + lay.wtot);
  uint32_t* xbuf = reinterpret_cast<uint32_t*>(smem + lay.xbuf) + warp * kSegPad;
  uint32_t* codes2 = reinterpret_cast<uint32_t*>(smem + lay.codes2);
  int32_t* flags = reinterpret_cast<int32_t*>(smem + lay.flags);
  int32_t* kc = reinterpret_cast<int32_t*>(smem + lay.kc);
  uint16_t* k16 = reinterpret_cast<uint16_t*>(smem + lay.k16);
  const int lcb = lc_bytes(t, w_min, w_max);
  const int lo0 = lc_lo(w_min);
  // pass 1's pair counts: on 16-bit K codes (depth <= 16, and 16 K codes
  // left of every Lc position) or plain
  const bool pairs16 = !kEmit && nbins <= 65536 && depth <= 16 && w_min > 16;
  const uint32_t kmask = static_cast<uint32_t>(nbins - 1);

  // a tile's codes [tile_pos, tile_pos + t + w_max + k) as whole 16-byte
  // granules from the aligned one at or below the first; in pass 2 its pair
  // counts too
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);
  const int8_t* granules = codes - mis;
  const int n_granules = (mis + t + w_max + k + 15) / 16;
  auto prefetch = [&](int tile, int b) {
    const int8_t* src = granules + static_cast<long long>(tile) * t;
    unsigned char* dst = smem + lay.raw + b * lay.raw_bytes;
    for (int q = tid; q < n_granules; q += kThreads) __pipeline_memcpy_async(dst + 16 * q, src + 16 * q, 16);
    if constexpr (kEmit) {
      const uint8_t* csrc = counts + static_cast<long long>(tile) * lay.cnt_bytes;
      unsigned char* cdst = smem + lay.cnt + b * lay.cnt_bytes;
      for (int q = tid; q < static_cast<int>(lay.cnt_bytes / 16); q += kThreads) {
        __pipeline_memcpy_async(cdst + 16 * q, csrc + 16 * q, 16);
      }
    }
    __pipeline_commit();
  };

  const Tables<kTablesInSmem> tab =
      stage_tables<kTablesInSmem>(s_stack, 0, cl.m * nbins, nbins, reinterpret_cast<int32_t*>(smem));
  if constexpr (kEmit) {
    for (int e = tid; e < cl.m * nb; e += kThreads) flags[e] = 0;
  }
  int buf = 0;
  int rb = 0;
  prefetch(blockIdx.x, rb);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long tile_pos = static_cast<long long>(tile) * t;
    __pipeline_wait_prior(0);
    // this tile's codes (and counts) have landed; the other buffers were
    // last read before the previous tile's last barrier
    __syncthreads();
    if (tile + gridDim.x < n_tiles) prefetch(tile + gridDim.x, rb ^ 1);
    const uint4* raw = reinterpret_cast<const uint4*>(smem + lay.raw + rb * lay.raw_bytes);
    for (int q = tid; q < n_granules; q += kThreads) {
      const uint4 v = raw[q];
      codes2[q] = kmg::pack4(v.x) << 24 | kmg::pack4(v.y) << 16 | kmg::pack4(v.z) << 8 | kmg::pack4(v.w);
    }
    if constexpr (kEmit) {
      // the tile's bases; the carries were last read before the previous
      // tile's last barrier
      for (int c = tid; c < cl.m; c += kThreads) {
        carries[0][c] = static_cast<uint32_t>(bases[static_cast<long long>(c) * n_tiles + tile]);
      }
    }
    // pass 1 computes the counts into buffer 0; pass 2 finds them in rb
    uint8_t* lc = smem + lay.cnt + (kEmit ? rb : 0) * lay.cnt_bytes;  // Lc[lc_lo .. t + w_max)
    uint8_t* rc = lc + lcb;                                            // Rc[0 .. t)
    rb ^= 1;
    __syncthreads();
    // K[i]: the 2k bits from code i + mis of the 2-bit stream
    for (int i = tid; i <= t + w_max; i += kThreads) {
      const int g = i + mis;
      const unsigned long long x =
          static_cast<unsigned long long>(codes2[g >> 4]) << 32 | codes2[(g >> 4) + 1];
      const uint32_t v = static_cast<uint32_t>(x >> (64 - 2 * ((g & 15) + k))) & kmask;
      if (i < t + w_max) kc[i] = static_cast<int32_t>(v);
      if (pairs16) k16[2 * pad8(i >> 1) + (i & 1)] = static_cast<uint16_t>(v);
    }
    __syncthreads();

    if constexpr (!kEmit) {
      int lsum = 0;  // this thread's share of sum_x Lc[x]
      int rsum = 0;  // and of sum_p Rc[p]
      if (pairs16) {
        const uint32_t* k2 = reinterpret_cast<const uint32_t*>(k16);
        if (nbins <= 4096) {
          pair_counts16<true>(k2, kc, w_min, t + w_max, t, depth, lc, rc, lsum, rsum);
        } else {
          pair_counts16<false>(k2, kc, w_min, t + w_max, t, depth, lc, rc, lsum, rsum);
        }
      } else {
        for (int x = w_min + tid; x < t + w_max; x += kThreads) {
          const int v = kc[x];
          int n = 0;
          for (int d = 1; d <= depth; ++d) n += kc[x - d] == v;
          lc[x - lo0] = static_cast<uint8_t>(n);
          lsum += n;
        }
        for (int p = tid; p < t; p += kThreads) {
          const int n = kmg::right_pair_count(kc, p, depth);
          rc[p] = static_cast<uint8_t>(n);
          rsum += n;
        }
      }
      __syncthreads();
      // the counts for pass 2
      uint4* dst = reinterpret_cast<uint4*>(counts + static_cast<long long>(tile) * lay.cnt_bytes);
      for (int q = tid; q < static_cast<int>(lay.cnt_bytes / 16); q += kThreads) dst[q] = reinterpret_cast<const uint4*>(lc)[q];
      // The telescoped tile total of cluster c:
      //   2 r^2 (D - E_c) + 2 r (G_c),  D = sum_x Lc[x] - sum_p Rc[p] over
      // the whole tile (once for every cluster), E_c = Lc over the w_max -
      // w_min positions outside [w, t + w), G_c = the two table edges.
      long long d = lsum - rsum;
      for (int off = 16; off > 0; off >>= 1) d += __shfl_down_sync(0xffffffffu, d, off);
      if (lane == 0) wtot[cl.m + warp] = d;
      // one warp per cluster: its few terms are latency, not work
      const int spread = w_max - w_min;
      for (int c = warp; c < cl.m; c += kWarps) {
        const int w = cl.w[c];
        const int edge = t < w ? t : w;
        int e = 0;
        for (int j = lane; j < spread; j += 32) e += lc[(j < w - w_min ? j : t + j) + w_min - lo0];
        long long g = 0;
        for (int i = lane; i < edge; i += 32) g += tab.get(c, kc[i]) - tab.get(c, kc[t + w - edge + i]);
        long long sum = 2LL * cl.r[c] * g - 2LL * cl.r[c] * cl.r[c] * e;
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
        if (lane == 0) wtot[c] = sum;
      }
    } else {
      // Round by round (one on the main path, t = kRound), kPair clusters
      // per block barrier: their deltas, lane-striped (window seg + 32 j +
      // lane) into padded buffers and back as kJ consecutive windows per
      // lane, their warp scans, one barrier, then each walk.  K[i] and Rc[i]
      // of a lane's windows serve every cluster from registers; the carries
      // go from round to round in shared memory, by round parity.
      int par = 0;
      for (int r0 = 0; r0 < t; r0 += kRound) {
        const int seg = r0 + warp * kSeg;  // the warp's first window in the tile
        const bool live = seg < t;         // warp-uniform: t is a multiple of kSeg
        int k_i[kJ];
        int rc_i[kJ];
        if (live) {
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            k_i[j] = kc[seg + 32 * j + lane];
            rc_i[j] = rc[seg + 32 * j + lane];
          }
        }
        for (int c0 = 0; c0 < cl.m; c0 += kPair) {
          uint32_t y[kPair][kJ];
          uint32_t s[kPair];
          uint32_t incl[kPair];
#pragma unroll
          for (int h = 0; h < kPair; ++h) {
            const int c = c0 + h;
            s[h] = 0;
            if (live && c < cl.m) {
              const int w = cl.w[c];
              const int r2 = 2 * cl.r[c] * cl.r[c];
              const int r1 = 2 * cl.r[c];
              uint32_t* xb = xbuf + h * kWarps * kSegPad;
#pragma unroll
              for (int j = 0; j < kJ; ++j) {
                // scaled lower-bound delta of cluster c's transition i -> i + 1
                const int i = seg + 32 * j + lane;
                const int ab = static_cast<int>(lc[i + w - lo0]) - rc_i[j];
                xb[33 * j + lane] = static_cast<uint32_t>(r2 * ab + r1 * (tab.get(c, k_i[j]) - tab.get(c, kc[i + w])));
              }
              __syncwarp();
              const int row = lane * kJ + (lane * kJ) / 32;
#pragma unroll
              for (int j = 0; j < kJ; ++j) {
                y[h][j] = xb[row + j];
                s[h] += y[h][j];
              }
              // the buffer is written again only after the barrier below
            }
            incl[h] = s[h];
            if (c < cl.m) {  // block-uniform: no scan for the empty half of a pair (m odd, m = 1 for K1)
#pragma unroll
              for (int off = 1; off < 32; off <<= 1) {
                const uint32_t v = __shfl_up_sync(0xffffffffu, incl[h], off);
                if (lane >= off) incl[h] += v;
              }
              if (lane == 31) wsum[buf][h][warp] = incl[h];
            }
          }
          __syncthreads();
#pragma unroll
          for (int h = 0; h < kPair; ++h) {
            const int c = c0 + h;
            if (c >= cl.m) break;
            // every warp scans the warp sums itself: no second barrier
            uint32_t ws = lane < kWarps ? wsum[buf][h][lane] : 0u;
#pragma unroll
            for (int off = 1; off < kWarps; off <<= 1) {
              const uint32_t v = __shfl_up_sync(0xffffffffu, ws, off);
              if (lane >= off) ws += v;
            }
            const uint32_t before = __shfl_sync(0xffffffffu, ws, warp > 0 ? warp - 1 : 0);
            const uint32_t round_total = __shfl_sync(0xffffffffu, ws, kWarps - 1);
            const uint32_t carry = carries[par][c];
            if (live) {
              uint32_t run = carry + (warp > 0 ? before : 0u) + incl[h] - s[h];
              const long long pos = tile_pos + seg + lane * kJ;
              const int thr = cl.thr[c];
              const long long nw = cl.nw[c];
              int below = 0;
#pragma unroll
              for (int j = 0; j < kJ; ++j) {
                below |= (static_cast<int32_t>(run) < thr) & (pos + j < nw);
                run += y[h][j];
              }
              if (__any_sync(0xffffffffu, below) && lane == 0) flags[c * nb + seg / block] = 1;
            }
            // read again after the next round's barriers; this parity is
            // written again only after every warp has passed them
            if (tid == 0) carries[par ^ 1][c] = carry + round_total;
          }
          buf ^= 1;
        }
        par ^= 1;
      }
    }
    __syncthreads();
    if constexpr (!kEmit) {
      for (int c = tid; c < cl.m; c += kThreads) {
        long long d = 0;
        for (int i = 0; i < kWarps; ++i) d += wtot[cl.m + i];
        totals[static_cast<long long>(c) * n_tiles + tile] = wtot[c] + 2LL * cl.r[c] * cl.r[c] * d;
      }
    } else {
      // each flag is read and cleared by one thread; the next tile sets
      // flags only after its barriers
      for (int e = tid; e < cl.m * nb; e += kThreads) {
        const int c = e / nb;
        bitmap[(static_cast<long long>(c) * n_tiles + tile) * nb + (e - c * nb)] = flags[e];
        flags[e] = 0;
      }
    }
  }
}

template <bool kTablesInSmem, bool kEmit>
const void* cluster_kernel() {
  return reinterpret_cast<const void*>(fused_cluster_kernel<kTablesInSmem, kEmit>);
}

const void* pick_cluster_kernel(bool tables_in_smem, bool emit) {
  if (tables_in_smem) return emit ? cluster_kernel<true, true>() : cluster_kernel<true, false>();
  return emit ? cluster_kernel<false, true>() : cluster_kernel<false, false>();
}

// (grid, blocks per SM) of one K3 pass: persistent blocks, at most one
// per tile.
cudaError_t cluster_grid(const SmemPlan& plan, bool emit, int n_tiles, int* grid, int* blocks_per_sm) {
  const cudaError_t err = kernel_ready(pick_cluster_kernel(plan.tables_in_smem, emit), kThreads, plan.smem, blocks_per_sm);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(plan.sms) * *blocks_per_sm;
  *grid = static_cast<int>(n_tiles < resident ? n_tiles : resident);
  return cudaSuccess;
}

template <bool kTablesInSmem>
__global__ void __launch_bounds__(kRtThreads)
lookup_roundtrip_kernel(const int32_t* __restrict__ s_stack, int nbins, int32_t* __restrict__ out) {
  extern __shared__ int32_t rt_smem[];
  const int c = blockIdx.x;
  const Tables<kTablesInSmem> tab = stage_tables<kTablesInSmem>(s_stack, c * nbins, (c + 1) * nbins, nbins, rt_smem);
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int v = threadIdx.x; v < nbins; v += kRtThreads) {
    out[static_cast<long long>(c) * nbins + v] = tab.get(c, v);
  }
}

}  // namespace

// 1 if K3 stages the m tables in shared memory at these shapes, 0 if it
// reads them through __ldg; a negative cudaError_t on failure.
extern "C" int kmg_cluster_tables_in_smem(int m, int nbins, int t, int w_min, int w_max) {
  SmemPlan plan;
  const cudaError_t err = cluster_smem_plan(m, nbins, t, w_min, w_max, &plan);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return plan.tables_in_smem ? 1 : 0;
}

// shape[4] = {grid, threads per block, resident blocks per SM, SMs} of K3's
// pass 1 (emit = 0) or pass 2 (emit = 1) for these shapes.  Returns a
// cudaError_t.
extern "C" int kmg_cluster_launch_shape(int m, int nbins, int t, int w_min, int w_max, int n_tiles,
                                        int emit, int* shape) {
  SmemPlan plan;
  cudaError_t err = cluster_smem_plan(m, nbins, t, w_min, w_max, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  int per_sm = 0;
  err = cluster_grid(plan, emit != 0, n_tiles, &grid, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  shape[0] = grid;
  shape[1] = kThreads;
  shape[2] = per_sm;
  shape[3] = plan.sms;
  return 0;
}

// Bytes of pair counts K3's pass 1 leaves per tile for pass 2.
extern "C" int kmg_cluster_count_bytes(int t, int w_min, int w_max) { return count_bytes(t, w_min, w_max); }

// emit = 0: pass 1, writes totals[m * n_tiles] (int64) and the tiles' pair
// counts, counts[n_tiles * kmg_cluster_count_bytes(t, min(w), max(w))]
// (16-byte aligned).  emit = 1: pass 2, reads bases[m * n_tiles] (int32)
// and those counts, and writes bitmap[m * n_tiles * t / block].
// w, r, thr, nw: m per-cluster values in host memory (1 <= m <= 32), each
// w > depth.  codes must hold n_tiles * t + max(w) + k - 1 bytes; t must be
// a multiple of block, and block a multiple of 256.  Returns
// cudaGetLastError().
extern "C" int kmg_fused_cluster_bitmaps(const void* codes, const void* s_stack, int m,
                                         int nbins, int k, const int* w, const int* r,
                                         const int* thr, const int* nw, int depth, int t,
                                         int block, int n_tiles, const void* bases,
                                         void* totals, void* bitmap, void* counts, int emit,
                                         void* stream) {
  if (m < 1 || m > kMaxClusters || block % 256 != 0 || t % block != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Clusters cl;
  cl.m = m;
  int w_min = w[0];
  int w_max = w[0];
  for (int c = 0; c < m; ++c) {
    cl.w[c] = w[c];
    cl.r[c] = r[c];
    cl.thr[c] = thr[c];
    cl.nw[c] = nw[c];
    w_min = w[c] < w_min ? w[c] : w_min;
    w_max = w[c] > w_max ? w[c] : w_max;
  }
  SmemPlan plan;
  cudaError_t err = cluster_smem_plan(m, nbins, t, w_min, w_max, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  int per_sm = 0;
  err = cluster_grid(plan, emit != 0, n_tiles, &grid, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid < 1) return static_cast<int>(cudaSuccess);
  auto c = static_cast<const int8_t*>(codes);
  auto s = static_cast<const int32_t*>(s_stack);
  auto b = static_cast<const int32_t*>(bases);
  auto tot = static_cast<long long*>(totals);
  auto bm = static_cast<int32_t*>(bitmap);
  auto cnt = static_cast<uint8_t*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = plan.smem;
  if (plan.tables_in_smem) {
    if (emit) {
      fused_cluster_kernel<true, true><<<grid, kThreads, smem, st>>>(c, s, nbins, k, cl, w_min, w_max, depth, t, block, n_tiles, b, tot, bm, cnt);
    } else {
      fused_cluster_kernel<true, false><<<grid, kThreads, smem, st>>>(c, s, nbins, k, cl, w_min, w_max, depth, t, block, n_tiles, b, tot, bm, cnt);
    }
  } else {
    if (emit) {
      fused_cluster_kernel<false, true><<<grid, kThreads, smem, st>>>(c, s, nbins, k, cl, w_min, w_max, depth, t, block, n_tiles, b, tot, bm, cnt);
    } else {
      fused_cluster_kernel<false, false><<<grid, kThreads, smem, st>>>(c, s, nbins, k, cl, w_min, w_max, depth, t, block, n_tiles, b, tot, bm, cnt);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out[m * nbins] = every S_c[v] read back through K3's lookup, with the
// tables placed as K3 places them for a tile of t windows and window
// widths w_min..w_max: one block per cluster, staging only its slice.
// Returns cudaGetLastError().
extern "C" int kmg_lookup_roundtrip(const void* s_stack, int m, int nbins, int t, int w_min,
                                    int w_max, void* out, void* stream) {
  if (m < 1 || m > kMaxClusters) return static_cast<int>(cudaErrorInvalidValue);
  SmemPlan plan;
  cudaError_t err = cluster_smem_plan(m, nbins, t, w_min, w_max, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<const int32_t*>(s_stack);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  int per_sm = 0;
  if (plan.tables_in_smem) {
    err = kernel_ready(reinterpret_cast<const void*>(lookup_roundtrip_kernel<true>), kRtThreads, plan.table_bytes, &per_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    lookup_roundtrip_kernel<true><<<m, kRtThreads, plan.table_bytes, st>>>(s, nbins, o);
  } else {
    lookup_roundtrip_kernel<false><<<m, kRtThreads, 0, st>>>(s, nbins, o);
  }
  return static_cast<int>(cudaGetLastError());
}
