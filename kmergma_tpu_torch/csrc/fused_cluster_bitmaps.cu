// K3: the fused multi-cluster lower-bound bitmap pass, and K8: the
// round trip of every table entry through K3's lookup, written by hand for
// Hopper (sm_90a).
//
// K3 replaces kmergma_tpu/ops/scan_cluster_fused.py::_fused_cluster_kernel
// (entry fused_cluster_record_bitmaps): K1 (csrc/fused_bitmaps.cu) for m
// cluster profiles in one pass over the codes.  For one tile of t windows a
// block computes the rolling K codes and the depth-limited left and right
// pair counts Lc, Rc once (csrc/pair_counts.cuh), then for each cluster c
// (width w_c = ws_c - k + 1, size r_c)
//   delta_c[p] = 2 r_c^2 (Lc[p + w_c] - Rc[p]) + 2 r_c (S_c[K[p]] - S_c[K[p + w_c]]),
// their prefix sum from the tile's base, and one any(L < thr_c) flag per
// `block` windows, masked to p < nw_c (windowsizes differ, so window
// counts do).  The bitmap is cluster-major, int32[m, n_tiles * t / block]
// (the TPU's (tile, cluster) interleave was a lane-layout matter).
//
// What bounds it on an H100: shared-memory reads.  The pair counts cost
// 2 * depth compares per window for all clusters together, each cluster
// then two table reads and a block scan per window; device memory sees one
// byte of codes per window and m int32 per `block` windows of bitmap.  The
// m tables live in shared memory when they fit beside the tile (96 KB at
// m = 6, k = 6; `cluster_smem_plan`), and are read through the read-only
// cache with __ldg otherwise (six k = 7 tables are 384 KB): a template
// parameter, not a fallback.  The carry chain is K1's: pass 1
// (kEmit = false) writes each (cluster, tile) delta total in int64, the
// wrapper turns them into tile bases, pass 2 recomputes the tile from its
// bases and emits the bitmap.  Prefix sums wrap in uint32 like the plain
// int32 twin.
//
// K8 replaces kmergma_tpu/ops/scan_cluster_fused.py::pack_lookup_roundtrip
// (the kernel inside it).  On the TPU it certified, per chip, that the MXU
// one-hot lookup returned every S_c[v] exactly.  Here it stages the tables
// with K3's helper, in the placement K3 would choose for the same shapes,
// and writes every S_c[v] back through K3's lookup: the guard that K3's
// table staging and indexing are right on the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "pair_counts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClusters = 32;

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

// Block-cooperative; the caller synchronises before the first get().
template <bool kInSmem>
__device__ __forceinline__ Tables<kInSmem> stage_tables(const int32_t* __restrict__ s_stack,
                                                        int m, int nbins, int32_t* smem) {
  if constexpr (kInSmem) {
    for (int i = threadIdx.x; i < m * nbins; i += blockDim.x) smem[i] = s_stack[i];
    return {smem, nbins};
  } else {
    return {s_stack, nbins};
  }
}

// Dynamic shared memory of K3 for a tile: t + w_max K codes (int32), then
// t + w_max - w_min left counts and t right counts (bytes); the tables go
// in front when all of it fits the opt-in limit with 1 KB left for the
// static arrays.
struct SmemPlan {
  bool tables_in_smem;
  size_t tile_bytes;
  size_t table_bytes;
};

cudaError_t cluster_smem_plan(int m, int nbins, int t, int w_min, int w_max, SmemPlan* plan) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  plan->tile_bytes = static_cast<size_t>(t + w_max) * sizeof(int32_t) + (t + w_max - w_min) + t;
  plan->table_bytes = static_cast<size_t>(m) * nbins * sizeof(int32_t);
  plan->tables_in_smem = plan->tile_bytes + plan->table_bytes + 1024 <= static_cast<size_t>(optin);
  return cudaSuccess;
}

template <bool kTablesInSmem, bool kEmit>
__global__ void __launch_bounds__(kThreads)
fused_cluster_kernel(const int8_t* __restrict__ codes, const int32_t* __restrict__ s_stack,
                     int nbins, int k, Clusters cl, int w_min, int w_max, int depth, int t,
                     int block, int n_tiles, const int32_t* __restrict__ bases,
                     long long* __restrict__ totals, int32_t* __restrict__ bitmap) {
  extern __shared__ int32_t smem[];
  int32_t* kc = smem + (kTablesInSmem ? cl.m * nbins : 0);    // t + w_max
  uint8_t* lc = reinterpret_cast<uint8_t*>(kc + t + w_max);   // Lc[w_min .. t + w_max)
  uint8_t* rc = lc + (t + w_max - w_min);                     // Rc[0 .. t)
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ long long warp_totals[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long tile_pos = static_cast<long long>(blockIdx.x) * t;

  const Tables<kTablesInSmem> tab = stage_tables<kTablesInSmem>(s_stack, cl.m, nbins, smem);
  kmg::build_kcodes(codes + tile_pos, k, t + w_max, kc);
  __syncthreads();
  kmg::left_pair_counts(kc, w_min, t + w_max, depth, lc);
  for (int p = tid; p < t; p += kThreads) rc[p] = static_cast<uint8_t>(kmg::right_pair_count(kc, p, depth));
  __syncthreads();

  for (int c = 0; c < cl.m; ++c) {
    const int w = cl.w[c];
    const int r2 = 2 * cl.r[c] * cl.r[c];
    const int r1 = 2 * cl.r[c];
    // scaled lower-bound delta of cluster c's transition i -> i + 1
    auto delta_at = [&](int i) -> int {
      const int ab = static_cast<int>(lc[i + w - w_min]) - static_cast<int>(rc[i]);
      return r2 * ab + r1 * (tab.get(c, kc[i]) - tab.get(c, kc[i + w]));
    };
    if constexpr (!kEmit) {
      long long sum = 0;
      for (int i = tid; i < t; i += kThreads) sum += delta_at(i);
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
      if (lane == 0) warp_totals[warp] = sum;
      __syncthreads();
      if (tid == 0) {
        long long total = 0;
        for (int i = 0; i < kWarps; ++i) total += warp_totals[i];
        totals[static_cast<long long>(c) * n_tiles + blockIdx.x] = total;
      }
      // warp_totals is written again by the next cluster
      __syncthreads();
    } else {
      // K1's block scan, one round of kThreads consecutive windows at a time
      uint32_t carry = static_cast<uint32_t>(bases[static_cast<long long>(c) * n_tiles + blockIdx.x]);
      const long long out_base = (static_cast<long long>(c) * n_tiles + blockIdx.x) * (t / block);
      const int thr = cl.thr[c];
      const long long nw = cl.nw[c];
      int flag = 0;
      for (int r0 = 0; r0 < t; r0 += kThreads) {
        const int i = r0 + tid;
        const uint32_t x = static_cast<uint32_t>(delta_at(i));
        uint32_t incl = x;
        for (int off = 1; off < 32; off <<= 1) {
          const uint32_t y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        if (lane == 31) warp_sums[warp] = incl;
        __syncthreads();
        if (warp == 0) {
          uint32_t s = lane < kWarps ? warp_sums[lane] : 0u;
          for (int off = 1; off < kWarps; off <<= 1) {
            const uint32_t y = __shfl_up_sync(0xffffffffu, s, off);
            if (lane >= off) s += y;
          }
          if (lane < kWarps) warp_sums[lane] = s;
        }
        __syncthreads();
        const uint32_t excl = (warp > 0 ? warp_sums[warp - 1] : 0u) + incl - x;
        const int32_t bound = static_cast<int32_t>(carry + excl);
        const int below = (bound < thr) && (tile_pos + i < nw);
        carry += warp_sums[kWarps - 1];
        // also the barrier that keeps warp_sums stable until every thread
        // has read it
        flag |= __syncthreads_or(below);
        if ((r0 + kThreads) % block == 0) {
          if (tid == 0) bitmap[out_base + r0 / block] = flag ? 1 : 0;
          flag = 0;
        }
      }
    }
  }
}

template <bool kTablesInSmem, bool kEmit>
cudaError_t launch_cluster(const int8_t* codes, const int32_t* s_stack, int nbins, int k,
                           const Clusters& cl, int w_min, int w_max, int depth, int t,
                           int block, int n_tiles, const int32_t* bases, long long* totals,
                           int32_t* bitmap, size_t smem, cudaStream_t stream) {
  auto kernel = fused_cluster_kernel<kTablesInSmem, kEmit>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, kThreads, smem, stream>>>(codes, s_stack, nbins, k, cl, w_min, w_max,
                                              depth, t, block, n_tiles, bases, totals, bitmap);
  return cudaGetLastError();
}

template <bool kTablesInSmem>
__global__ void __launch_bounds__(kThreads)
lookup_roundtrip_kernel(const int32_t* __restrict__ s_stack, int m, int nbins,
                        int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const Tables<kTablesInSmem> tab = stage_tables<kTablesInSmem>(s_stack, m, nbins, smem);
  __syncthreads();
  const int c = blockIdx.y;
  for (int v = blockIdx.x * kThreads + threadIdx.x; v < nbins; v += gridDim.x * kThreads) {
    out[static_cast<long long>(c) * nbins + v] = tab.get(c, v);
  }
}

template <bool kTablesInSmem>
cudaError_t launch_roundtrip(const int32_t* s_stack, int m, int nbins, int32_t* out,
                             size_t smem, cudaStream_t stream) {
  auto kernel = lookup_roundtrip_kernel<kTablesInSmem>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int gx = (nbins + kThreads - 1) / kThreads < 8 ? (nbins + kThreads - 1) / kThreads : 8;
  kernel<<<dim3(gx, m), kThreads, smem, stream>>>(s_stack, m, nbins, out);
  return cudaGetLastError();
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

// emit = 0: pass 1, writes totals[m * n_tiles] (int64).  emit = 1: pass 2,
// reads bases[m * n_tiles] (int32) and writes bitmap[m * n_tiles * t / block].
// w, r, thr, nw: m per-cluster values in host memory (1 <= m <= 32), each
// w > depth.  codes must hold n_tiles * t + max(w) + k - 1 bytes; t must be
// a multiple of block, and block a multiple of 256.  Returns
// cudaGetLastError().
extern "C" int kmg_fused_cluster_bitmaps(const void* codes, const void* s_stack, int m,
                                         int nbins, int k, const int* w, const int* r,
                                         const int* thr, const int* nw, int depth, int t,
                                         int block, int n_tiles, const void* bases,
                                         void* totals, void* bitmap, int emit, void* stream) {
  if (m < 1 || m > kMaxClusters) return static_cast<int>(cudaErrorInvalidValue);
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
  const size_t smem = plan.tile_bytes + (plan.tables_in_smem ? plan.table_bytes : 0);
  auto c = static_cast<const int8_t*>(codes);
  auto s = static_cast<const int32_t*>(s_stack);
  auto b = static_cast<const int32_t*>(bases);
  auto tot = static_cast<long long*>(totals);
  auto bm = static_cast<int32_t*>(bitmap);
  auto st = static_cast<cudaStream_t>(stream);
  if (plan.tables_in_smem) {
    err = emit ? launch_cluster<true, true>(c, s, nbins, k, cl, w_min, w_max, depth, t, block, n_tiles, b, tot, bm, smem, st)
               : launch_cluster<true, false>(c, s, nbins, k, cl, w_min, w_max, depth, t, block, n_tiles, b, tot, bm, smem, st);
  } else {
    err = emit ? launch_cluster<false, true>(c, s, nbins, k, cl, w_min, w_max, depth, t, block, n_tiles, b, tot, bm, smem, st)
               : launch_cluster<false, false>(c, s, nbins, k, cl, w_min, w_max, depth, t, block, n_tiles, b, tot, bm, smem, st);
  }
  return static_cast<int>(err);
}

// out[m * nbins] = every S_c[v] read back through K3's lookup, with the
// tables placed as K3 places them for a tile of t windows and window
// widths w_min..w_max.  Returns cudaGetLastError().
extern "C" int kmg_lookup_roundtrip(const void* s_stack, int m, int nbins, int t, int w_min,
                                    int w_max, void* out, void* stream) {
  if (m < 1 || m > kMaxClusters) return static_cast<int>(cudaErrorInvalidValue);
  SmemPlan plan;
  cudaError_t err = cluster_smem_plan(m, nbins, t, w_min, w_max, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<const int32_t*>(s_stack);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  err = plan.tables_in_smem ? launch_roundtrip<true>(s, m, nbins, o, plan.table_bytes, st)
                            : launch_roundtrip<false>(s, m, nbins, o, 0, st);
  return static_cast<int>(err);
}
