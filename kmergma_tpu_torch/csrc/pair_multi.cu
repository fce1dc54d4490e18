// K5: the net pair counts of every windowsize group in one pass, written by
// hand for Hopper (sm_90a).
//
// Replaces kmergma_tpu/ops/scan_pallas.py::_codes_pair_roll_multi_kernel
// (K5r, entry codes_pair_roll_multi) and ::_codes_pair_multi_kernel (K5,
// entry codes_pair_multi).  The two are bit-identical variants of one
// contract that differ only in how Mosaic held the per-depth accumulators
// in VMEM (rolled or statically unrolled), so one kernel serves both.  From
// int8 2-bit codes it writes the K codes K[0:nkc] and, for G windowsize
// groups w_g = ws_g - k + 1 at one pair depth,
//   ab[g, p] = sum_{d=1..depth} [K[p+w_g-d] == K[p+w_g]] - [K[p+d] == K[p]]
// for p in [0, nt), as Lc[p + w_g] - Rc[p] (csrc/pair_counts.cuh): the
// compares are shared by every group, as the TPU's one compare stream was.
//
// What bounds it on an H100: shared-memory reads, 2 * depth per position
// (32 at depth 16) whatever G is, against one byte of codes read and
// 4 (G + 1) bytes written per position in device memory.  A block stages
// its tile's t + w_max K codes (int32) and the t + w_max - w_min left
// counts (bytes) in shared memory; neighbouring threads take neighbouring
// positions, so the compares are free of bank conflicts and the writes of
// each group's row coalesce.

#include <cstdint>
#include <cuda_runtime.h>

#include "pair_counts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 32;

struct Groups {
  int n;
  int w[kMaxGroups];
};

__global__ void __launch_bounds__(kThreads)
pair_multi_kernel(const int8_t* __restrict__ codes, int k, Groups groups, int w_min,
                  int w_max, int depth, int t, int nt, int nkc,
                  int32_t* __restrict__ ab, int32_t* __restrict__ kc_out) {
  extern __shared__ int32_t smem[];
  int32_t* kc = smem;                                         // t + w_max
  uint8_t* lc = reinterpret_cast<uint8_t*>(kc + t + w_max);   // t + w_max - w_min
  const long long tile_pos = static_cast<long long>(blockIdx.x) * t;

  kmg::build_kcodes(codes + tile_pos, k, t + w_max, kc);
  __syncthreads();
  for (int i = threadIdx.x; i < t && tile_pos + i < nkc; i += kThreads) kc_out[tile_pos + i] = kc[i];
  kmg::left_pair_counts(kc, w_min, t + w_max, depth, lc);
  __syncthreads();
  for (int p = threadIdx.x; p < t && tile_pos + p < nt; p += kThreads) {
    const int rc = kmg::right_pair_count(kc, p, depth);
    for (int g = 0; g < groups.n; ++g) {
      ab[static_cast<long long>(g) * nt + tile_pos + p] =
          static_cast<int>(lc[p + groups.w[g] - w_min]) - rc;
    }
  }
}

}  // namespace

// ab[n_groups * nt], kc[nkc]; w[n_groups] (host memory) the groups' window
// widths, each > depth.  codes must hold n_tiles * t + max(w) + k - 1
// bytes, with n_tiles * t >= max(nt, nkc).  Returns cudaGetLastError().
extern "C" int kmg_pair_multi(const void* codes, int k, int n_groups, const int* w,
                              int depth, int t, int n_tiles, int nt, int nkc, void* ab,
                              void* kc, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  Groups groups;
  groups.n = n_groups;
  int w_min = w[0];
  int w_max = w[0];
  for (int g = 0; g < n_groups; ++g) {
    groups.w[g] = w[g];
    w_min = w[g] < w_min ? w[g] : w_min;
    w_max = w[g] > w_max ? w[g] : w_max;
  }
  const size_t smem = static_cast<size_t>(t + w_max) * sizeof(int32_t) + (t + w_max - w_min);
  cudaError_t err = cudaFuncSetAttribute(
      pair_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_multi_kernel<<<n_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), k, groups, w_min, w_max, depth, t, nt, nkc,
      static_cast<int32_t*>(ab), static_cast<int32_t*>(kc));
  return static_cast<int>(cudaGetLastError());
}
