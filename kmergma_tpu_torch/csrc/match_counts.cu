// K2: full-depth match counts, written by hand for Hopper (sm_90a).
//
// Replaces kmergma_tpu/ops/scan_pallas.py::_match_counts_kernel (entry
// match_counts).  For each row of K codes (t transitions plus a w halo):
//   AB[p] = sum_{d=1..w} [K[p+w-d] == K[p+w]] - sum_{d=1..w} [K[p+d-1] == K[p]]
// the change in the entering and leaving k-mers' window counts; w is
// ws - k + 1 (284 at the defaults).
//
// What bounds it on an H100: shared-memory reads, 2w per position (568
// at the defaults); device memory sees each K code about once and each
// AB once.  One block stages its row of t + w int32 codes in shared
// memory (5.2 KB at t = 1024), then each thread loops d = 1..w over
// positions p = tid, tid + 256, ...: neighbouring threads read
// neighbouring words, so the reads are free of bank conflicts.  The
// TPU kernel's cyclic rolls and 8-row padding were Mosaic constraints
// and are gone.
//
// Rows may overlap in memory: row i starts at kcodes + i * row_stride,
// so a whole record is tiled with row_stride = t and no copy, and region
// rows come in with row_stride = t + w.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
match_counts_kernel(const int32_t* __restrict__ kcodes, long long row_stride,
                    int t, int w, int32_t* __restrict__ out) {
  extern __shared__ int32_t row_s[];
  const int32_t* row = kcodes + static_cast<long long>(blockIdx.x) * row_stride;
  for (int i = threadIdx.x; i < t + w; i += kThreads) row_s[i] = row[i];
  __syncthreads();
  int32_t* o = out + static_cast<long long>(blockIdx.x) * t;
  for (int p = threadIdx.x; p < t; p += kThreads) {
    const int kl = row_s[p];
    const int kr = row_s[p + w];
    int a = 0;
    int b = 0;
    for (int d = 1; d <= w; ++d) {
      a += static_cast<int>(row_s[p + w - d] == kr);
      b += static_cast<int>(row_s[p + d - 1] == kl);
    }
    o[p] = a - b;
  }
}

}  // namespace

// out[n_rows * t] = AB of each row.  Returns cudaGetLastError().
extern "C" int kmg_match_counts(const void* kcodes, long long row_stride,
                                int n_rows, int t, int w, void* out,
                                void* stream) {
  const size_t smem = static_cast<size_t>(t + w) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      match_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  match_counts_kernel<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(kcodes), row_stride, t, w,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
