// Device helpers of the cluster kernels (K3 csrc/fused_cluster_bitmaps.cu,
// K5 csrc/pair_multi.cu): a tile's rolling k-mer codes in shared memory and
// the depth-limited equal-k-mer pair counts on either side of a position.
//
// The net pair delta of window transition p at width w,
//   ab_w[p] = sum_{d=1..depth} [K[p+w-d] == K[p+w]] - [K[p+d] == K[p]],
// splits into a term of x = p + w alone and a term of p alone:
//   Lc[x] = sum_d [K[x-d] == K[x]],  Rc[p] = sum_d [K[p+d] == K[p]],
//   ab_w[p] = Lc[p + w] - Rc[p],
// so 2 * depth compares per position serve every window width.  Counts are
// at most depth and are kept as bytes (the wrappers hold depth <= 255).

#pragma once

#include <cstdint>

namespace kmg {

// kc[i] = the code of the k-mer at c[i], for i in [0, n) (block-cooperative;
// reads c[0 .. n + k - 2]).
__device__ __forceinline__ void build_kcodes(const int8_t* __restrict__ c, int k, int n,
                                             int32_t* __restrict__ kc) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int v = 0;
    for (int j = 0; j < k; ++j) v = v * 4 + c[i + j];
    kc[i] = v;
  }
}

// lc[x - lo] = Lc[x] for x in [lo, hi) (block-cooperative; lo >= depth).
__device__ __forceinline__ void left_pair_counts(const int32_t* __restrict__ kc, int lo, int hi,
                                                 int depth, uint8_t* __restrict__ lc) {
  for (int x = lo + static_cast<int>(threadIdx.x); x < hi; x += blockDim.x) {
    const int v = kc[x];
    int n = 0;
    for (int d = 1; d <= depth; ++d) n += kc[x - d] == v;
    lc[x - lo] = static_cast<uint8_t>(n);
  }
}

// Rc[p]
__device__ __forceinline__ int right_pair_count(const int32_t* __restrict__ kc, int p, int depth) {
  const int v = kc[p];
  int n = 0;
  for (int d = 1; d <= depth; ++d) n += kc[p + d] == v;
  return n;
}

}  // namespace kmg
