// K7: the bench's synthetic genome, written by hand for Hopper (sm_90a).
//
// Replaces bench.py::_pallas_hash_genome (its kernel body).  Code i of the
// genome is a splitmix-style hash of the position:
//   x = uint32(i) * 0x9E3779B9 + seed
//   x = (x ^ x >> 16) * 0x85EBCA6B
//   x = (x ^ x >> 13) * 0xC2B2AE35
//   code = (x >> 7) & 3
// in uint32 arithmetic that wraps; positions come from a 64-bit index cast
// to uint32, so a genome of more than 2^32 codes wraps exactly as
// jnp.arange(total, dtype=uint32) does, and the seed is uint32(seed).
//
// What bounds it on an H100: the bytes written, one per code (0.153 ms for
// 512 Mbp at 3.35 TB/s); the hash is about 10 integer operations a code
// (0.076 ms at 67 T/s).  Each thread hashes 16 consecutive positions and
// writes them with one 16-byte store, so neighbouring threads store
// neighbouring 16-byte chunks; a grid-stride loop covers any length, and
// the n % 16 codes after the last full chunk are written one by one.  The
// TPU kernel's int32 blocks and cast to int8 were Mosaic's layout: this
// kernel writes int8 directly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;  // codes per 16-byte store
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint32_t hash_code(uint32_t pos, uint32_t seed) {
  uint32_t x = pos * 0x9E3779B9u + seed;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return (x >> 7) & 3u;
}

__global__ void __launch_bounds__(kThreads)
hash_genome_kernel(int8_t* __restrict__ out, long long n, uint32_t seed) {
  const long long n_chunks = n / kPerThread;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint4* out16 = reinterpret_cast<uint4*>(out);
  for (long long c = first; c < n_chunks; c += stride) {
    const long long base = c * kPerThread;
    uint32_t words[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t pos = static_cast<uint32_t>(base + 4 * j + b);
        word |= hash_code(pos, seed) << (8 * b);
      }
      words[j] = word;
    }
    out16[c] = make_uint4(words[0], words[1], words[2], words[3]);
  }
  const long long tail = n_chunks * kPerThread;
  if (first < n - tail) {
    out[tail + first] = static_cast<int8_t>(hash_code(static_cast<uint32_t>(tail + first), seed));
  }
}

}  // namespace

// out[n] = the hashed 2-bit codes of positions 0..n-1 (int8); out must be
// 16-byte aligned.  Returns cudaGetLastError().
extern "C" int kmg_hash_genome(void* out, long long n, unsigned int seed, void* stream) {
  if (n <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_chunks = n / kPerThread;
  long long blocks = (n_chunks + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;  // the tail alone (n < 16)
  hash_genome_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(out), n, static_cast<uint32_t>(seed));
  return static_cast<int>(cudaGetLastError());
}
