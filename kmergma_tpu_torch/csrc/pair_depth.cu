// K4, K4r and K6: the net pair delta at one window width and any depth,
// written by hand for Hopper (sm_90a).
//
// Replaces three kernels of kmergma_tpu/ops/scan_pallas.py that compute one
// function,
//   ab[p] = sum_{d=1..depth} [K[p+w-d] == K[p+w]] - [K[p+d] == K[p]],
// for p in [0, nt): _codes_pair_kernel (K4, entry codes_pair_ab_kcodes) and
// _codes_pair_roll_kernel (K4r, entry codes_pair_roll) take codes and also
// write the K codes K[0:nkc]; _pair_counts_kernel (K6, entry pair_counts via
// pair_ab_from_kcodes) takes K codes.  K4r differed from K4 only in keeping
// Mosaic's VMEM O(1) in depth, so kmg_pair_depth_codes serves both, and
// kmg_pair_depth_kcodes serves K6.  depth runs from 0 to w - 1 (282 on the
// strobemer span engine's exact pass, 14 to 16 on the cluster split pass);
// a count is at most depth, so it stays an int.
//
// What bounds it on an H100: shared-memory reads, 2 * depth compares per
// position, against one code (1 or 4 bytes) read and one or two int32
// written per position in device memory.  A block stages its tile's t + w
// K codes (int32) in shared memory, built from t + w + k - 1 codes (K4) or
// copied (K6); each thread then takes positions p = tid, tid + 256, ... and
// loops over the depth, so neighbouring threads read neighbouring words and
// the compares are free of bank conflicts.  No register tiling across
// positions yet: a simple kernel that is right comes first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// ab[tile_pos + p] for the tile's positions, from its K codes in shared
// memory (kc[i] = K[tile_pos + i], i < t + w).
__device__ __forceinline__ void tile_pair_deltas(const int32_t* __restrict__ kc, long long tile_pos,
                                                 int w, int depth, int t, int nt,
                                                 int32_t* __restrict__ ab) {
  for (int p = threadIdx.x; p < t && tile_pos + p < nt; p += kThreads) {
    const int kl = kc[p];
    const int kr = kc[p + w];
    int a = 0;
    int b = 0;
    for (int d = 1; d <= depth; ++d) {
      a += static_cast<int>(kc[p + w - d] == kr);
      b += static_cast<int>(kc[p + d] == kl);
    }
    ab[tile_pos + p] = a - b;
  }
}

template <typename Code>
__global__ void __launch_bounds__(kThreads)
pair_depth_codes_kernel(const Code* __restrict__ codes, int k, int w, int depth, int t,
                        int nt, int nkc, int32_t* __restrict__ ab,
                        int32_t* __restrict__ kc_out) {
  extern __shared__ int32_t kc[];  // t + w
  const long long tile_pos = static_cast<long long>(blockIdx.x) * t;
  const Code* c = codes + tile_pos;
  for (int i = threadIdx.x; i < t + w; i += kThreads) {
    int v = 0;
    for (int j = 0; j < k; ++j) v = v * 4 + static_cast<int>(c[i + j]);
    kc[i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < t && tile_pos + i < nkc; i += kThreads) kc_out[tile_pos + i] = kc[i];
  tile_pair_deltas(kc, tile_pos, w, depth, t, nt, ab);
}

__global__ void __launch_bounds__(kThreads)
pair_depth_kcodes_kernel(const int32_t* __restrict__ kcodes, long long n_kcodes, int w,
                         int depth, int t, int nt, int32_t* __restrict__ ab) {
  extern __shared__ int32_t kc[];  // t + w
  const long long tile_pos = static_cast<long long>(blockIdx.x) * t;
  for (int i = threadIdx.x; i < t + w; i += kThreads) {
    kc[i] = tile_pos + i < n_kcodes ? kcodes[tile_pos + i] : 0;
  }
  __syncthreads();
  tile_pair_deltas(kc, tile_pos, w, depth, t, nt, ab);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Code>
int launch_codes(const void* codes, int k, int w, int depth, int t, int n_tiles, int nt,
                 int nkc, void* ab, void* kc, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(t + w) * sizeof(int32_t);
  cudaError_t err = allow_smem(pair_depth_codes_kernel<Code>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_depth_codes_kernel<Code><<<n_tiles, kThreads, smem, stream>>>(
      static_cast<const Code*>(codes), k, w, depth, t, nt, nkc, static_cast<int32_t*>(ab),
      static_cast<int32_t*>(kc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 / K4r: ab[nt], kc[nkc] from codes of code_bytes bytes each (1: int8
// 2-bit codes or uint8 strobe codes, both 0..255 as read here; 4: int32).
// codes must hold n_tiles * t + w + k - 1 entries, with n_tiles * t >=
// max(nt, nkc).  Returns cudaGetLastError().
extern "C" int kmg_pair_depth_codes(const void* codes, int code_bytes, int k, int w, int depth,
                                    int t, int n_tiles, int nt, int nkc, void* ab, void* kc,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth < 0 || depth >= w) return static_cast<int>(cudaErrorInvalidValue);
  switch (code_bytes) {
    case 1:
      return launch_codes<uint8_t>(codes, k, w, depth, t, n_tiles, nt, nkc, ab, kc, s);
    case 4:
      return launch_codes<int32_t>(codes, k, w, depth, t, n_tiles, nt, nkc, ab, kc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6: ab[nt] from K codes kcodes[n_kcodes] (n_kcodes >= nt + w), with
// n_tiles * t >= nt.  Returns cudaGetLastError().
extern "C" int kmg_pair_depth_kcodes(const void* kcodes, long long n_kcodes, int w, int depth,
                                     int t, int n_tiles, int nt, void* ab, void* stream) {
  if (depth < 0 || depth >= w) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(t + w) * sizeof(int32_t);
  cudaError_t err = allow_smem(pair_depth_kcodes_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_depth_kcodes_kernel<<<n_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(kcodes), n_kcodes, w, depth, t, nt,
      static_cast<int32_t*>(ab));
  return static_cast<int>(cudaGetLastError());
}
