// K1: the fused lower-bound bitmap pass, written by hand for Hopper (sm_90a).
//
// Replaces kmergma_tpu/ops/scan_fused.py::_fused_kernel (entry
// fused_record_bitmaps).  For one tile of t windows a block computes
//   - the rolling k-mer codes K[i] from the int8 2-bit codes,
//   - the net pair counts at partner distances 1..depth
//       ab[p] = sum_d [K[p+w-d] == K[p+w]] - [K[p+d] == K[p]],
//   - the profile projections g = S[K],
//   - the scaled lower-bound deltas 2r^2 ab[p] + 2r (g[p] - g[p+w]),
//   - their prefix sum from the tile's base L, and
//   - one any(L < thr) flag per `block` windows, masked to p < nw.
//
// What bounds it on an H100: shared-memory reads.  A window costs
// 2*depth + 2 reads of K (34 at depth 16) and two table reads; device
// memory sees the codes once (one byte per base) and one int32 per
// `block` windows of bitmap.  So K and the 4^k table S live in shared
// memory (S is 16 KB at k=6, 64 KB at k=7 through the opt-in limit; a
// table too big for shared memory is read through the read-only cache
// with __ldg, chosen by a template parameter, not a fallback), and
// neighbouring threads take neighbouring windows, so every shared read
// is free of bank conflicts.
//
// Carry chain: the TPU kernel chains the absolute base through a scalar
// carry over a sequential grid.  CUDA blocks run in no order, so the
// kernel runs twice.  Pass 1 (kEmit = false) writes each tile's delta
// total in int64.  The wrapper turns the totals into per-tile bases
// (l0 plus an exclusive prefix sum, checked to fit int32).  Pass 2
// (kEmit = true) recomputes the tile from its base and emits the bitmap.
// Prefix sums run in uint32 and wrap like the plain int32 twin, so the
// bitmap is bit-identical to it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kTableInSmem, bool kEmit>
__global__ void __launch_bounds__(kThreads)
fused_bitmaps_kernel(const int8_t* __restrict__ codes,
                     const int32_t* __restrict__ s_profile, int nbins,
                     int k, int w, int r, int depth, int t, int block,
                     int thr, long long nw,
                     const int32_t* __restrict__ bases,
                     long long* __restrict__ totals,
                     int32_t* __restrict__ bitmap) {
  extern __shared__ int32_t smem[];
  int32_t* s_tab = smem;                                 // nbins, if in smem
  int32_t* kc = smem + (kTableInSmem ? nbins : 0);       // t + w K codes
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ long long warp_totals[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long tile_pos = static_cast<long long>(blockIdx.x) * t;

  if constexpr (kTableInSmem) {
    for (int i = tid; i < nbins; i += kThreads) s_tab[i] = s_profile[i];
  }
  const int8_t* c = codes + tile_pos;
  for (int i = tid; i < t + w; i += kThreads) {
    int v = 0;
    for (int j = 0; j < k; ++j) v = v * 4 + c[i + j];
    kc[i] = v;
  }
  __syncthreads();

  const int r2 = 2 * r * r;
  const int r1 = 2 * r;
  auto lookup = [&](int v) -> int {
    if constexpr (kTableInSmem) {
      return s_tab[v];
    } else {
      return __ldg(s_profile + v);
    }
  };
  // scaled lower-bound delta of transition i -> i + 1 (tile-local)
  auto delta_at = [&](int i) -> int {
    const int kl = kc[i];
    const int kr = kc[i + w];
    int ab = 0;
    for (int d = 1; d <= depth; ++d) {
      ab += static_cast<int>(kc[i + w - d] == kr) - static_cast<int>(kc[i + d] == kl);
    }
    return r2 * ab + r1 * (lookup(kl) - lookup(kr));
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
      totals[blockIdx.x] = total;
    }
  } else {
    // window i of the tile: L = base + sum of deltas 0..i-1 (exclusive
    // prefix), one round of kThreads consecutive windows at a time
    uint32_t carry = static_cast<uint32_t>(bases[blockIdx.x]);
    const long long out_base = static_cast<long long>(blockIdx.x) * (t / block);
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

template <bool kTableInSmem, bool kEmit>
cudaError_t launch(const int8_t* codes, const int32_t* s_profile, int nbins,
                   int k, int w, int r, int depth, int t, int block,
                   int n_tiles, int thr, long long nw, const int32_t* bases,
                   long long* totals, int32_t* bitmap, size_t smem,
                   cudaStream_t stream) {
  auto kernel = fused_bitmaps_kernel<kTableInSmem, kEmit>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, kThreads, smem, stream>>>(codes, s_profile, nbins, k, w, r,
                                              depth, t, block, thr, nw, bases,
                                              totals, bitmap);
  return cudaGetLastError();
}

}  // namespace

// emit = 0: pass 1, writes totals[n_tiles] (int64).  emit = 1: pass 2,
// reads bases[n_tiles] (int32) and writes bitmap[n_tiles * t / block].
// codes must hold n_tiles * t + w + k - 1 bytes; t must be a multiple of
// block, and block a multiple of 256.  Returns cudaGetLastError().
extern "C" int kmg_fused_bitmaps(const void* codes, const void* s_profile,
                                 int nbins, int k, int w, int r, int depth,
                                 int t, int block, int n_tiles, int thr,
                                 long long nw, const void* bases, void* totals,
                                 void* bitmap, int emit, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t kc_bytes = static_cast<size_t>(t + w) * sizeof(int32_t);
  const size_t tab_bytes = static_cast<size_t>(nbins) * sizeof(int32_t);
  // 1 KB left for the kernel's static shared arrays
  const bool table_in_smem = kc_bytes + tab_bytes + 1024 <= static_cast<size_t>(optin);
  const size_t smem = kc_bytes + (table_in_smem ? tab_bytes : 0);
  auto c = static_cast<const int8_t*>(codes);
  auto s = static_cast<const int32_t*>(s_profile);
  auto b = static_cast<const int32_t*>(bases);
  auto tot = static_cast<long long*>(totals);
  auto bm = static_cast<int32_t*>(bitmap);
  auto st = static_cast<cudaStream_t>(stream);
  if (table_in_smem) {
    err = emit ? launch<true, true>(c, s, nbins, k, w, r, depth, t, block, n_tiles, thr, nw, b, tot, bm, smem, st)
               : launch<true, false>(c, s, nbins, k, w, r, depth, t, block, n_tiles, thr, nw, b, tot, bm, smem, st);
  } else {
    err = emit ? launch<false, true>(c, s, nbins, k, w, r, depth, t, block, n_tiles, thr, nw, b, tot, bm, smem, st)
               : launch<false, false>(c, s, nbins, k, w, r, depth, t, block, n_tiles, thr, nw, b, tot, bm, smem, st);
  }
  return static_cast<int>(err);
}
