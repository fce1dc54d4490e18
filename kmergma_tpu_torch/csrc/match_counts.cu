// K2: full-depth match counts, written by hand for Hopper (sm_90a).
//
// Replaces kmergma_tpu/ops/scan_pallas.py::_match_counts_kernel (entry
// match_counts).  For each row of K codes (t transitions plus a w halo):
//   AB[p] = sum_{d=1..w} [K[p+w-d] == K[p+w]] - sum_{d=1..w} [K[p+d-1] == K[p]]
// the change in the entering and leaving k-mers' window counts; w is
// ws - k + 1 (284 at the defaults).  That is the net pair delta at depth
// w - 1 plus [K[p] == K[p+w]] - 1 (the left sum's d = w term and the right
// sum's d = 1 term), so K2 runs the register-blocked routine of
// csrc/pair_counts.cuh with that term folded into its epilogue.
//
// A block takes a tile of up to 2048 positions of one row, 16 a thread in
// two thread groups that split the columns (128 threads for the
// 1024-position region rows, 256 for the whole-record scan's rows of
// 2048), stages its codes in shared memory with one pad word per 16, and
// each thread streams the columns of its two runs past its 16 targets held
// in registers: 37 shared loads a position at the defaults, where a loop
// over each position's partners loads 568.  What bounds it on an H100:
// integer issue, the 2 (w - 1) compares a position, two to an XOR and a
// DPX halfword minimum when the tile's codes fit 16 bits; device memory
// sees each K code about once and each AB once.
//
// Rows may overlap in memory: row i starts at kcodes + i * row_stride,
// so a whole record is tiled with row_stride = t and no copy, and region
// rows come in with row_stride = t + w.

#include <cstdint>
#include <cuda_runtime.h>

#include "pair_counts.cuh"

namespace {

template <bool kSmall>
__global__ void __launch_bounds__(kmg::kPairMaxThreads)
match_counts_kernel(const int32_t* __restrict__ kcodes, long long row_stride, int t, int w,
                    int tiles_per_row, int32_t* __restrict__ out) {
  extern __shared__ int32_t s[];
  const int tile_len = static_cast<int>(blockDim.x) / kmg::pair_groups(kSmall) * kmg::kPairR;
  const long long row = blockIdx.x / tiles_per_row;
  const int tile = (blockIdx.x % tiles_per_row) * tile_len;
  const int32_t* r = kcodes + row * row_stride;
  const int row_len = t + w;
  const bool narrow = kmg::pair_stage_rows(s, tile_len, w, r + tile, -tile, row_len - tile);
  const int n_out = t - tile < tile_len ? t - tile : tile_len;
  kmg::pair_tile_deltas<kSmall, true>(s, tile_len, w, w - 1, narrow, n_out, out + row * t + tile);
}

}  // namespace

// out[n_rows * t] = AB of each row.  Returns cudaGetLastError().
extern "C" int kmg_match_counts(const void* kcodes, long long row_stride,
                                int n_rows, int t, int w, void* out,
                                void* stream) {
  if (w < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (t < 1 || n_rows < 1) return static_cast<int>(cudaSuccess);
  const bool small = w - 1 <= kmg::kPairR;
  const int tile_len = kmg::pair_tile_len(t);
  const int threads = tile_len / kmg::kPairR * kmg::pair_groups(small);
  const int tiles_per_row = (t + tile_len - 1) / tile_len;
  const long long blocks = static_cast<long long>(n_rows) * tiles_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kmg::pair_tile_words(tile_len, w)) * sizeof(int32_t);
  auto kernel = small ? match_counts_kernel<true> : match_counts_kernel<false>;
  const cudaError_t err = kmg::allow_smem_once(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<int>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(kcodes), row_stride, t, w, tiles_per_row, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
