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
// for p in [0, nt), as Ru[p] - Lu[p + w_g], the unequal-pair counts of
// csrc/pair_counts.cuh: the pairs are counted once for every group, as the
// TPU's one compare stream was.
//
// What bounds it on an H100: the 4 (G + 1) bytes written a position (ab
// and K), against one byte of codes read and, at depth 16, 16 compares a
// position.  A block takes a tile of t positions and:
//   1. packs the tile's codes, 16 to a word, two bits each, from 16-byte
//      loads (codes past the end read as zeros);
//   2. counts the pairs of every left end in [0, t + w_max): one thread a
//      unit of 16 left ends, its K codes built in registers, each equal pair
//      compared once for both of its counts (pair_unit_counts, two to an
//      instruction when the codes fit 16 bits), the partial left counts of
//      the next unit handed over by a warp shuffle, and from a warp's last
//      lane to the next warp's first through shared memory; Ru over [0, t)
//      and Lu over [0, t + w_max) land in shared memory as bytes;
//   3. writes each group's row, ab[g, p] = Ru[p] - Lu[p + w_g], and the K
//      codes by coalesced 16-byte stores (rows padded to whole fours).
// The tile is chosen by the wrapper from the record's length: 256
// positions on short records (a 60 kb record launches 238 blocks, so every
// SM has one), up to 2048 on long ones, where the w_max halo of left ends
// is 14% of the work and three blocks of 160 threads fit an SM (4096
// positions, two blocks of 288 an SM, were slower on a 4 Mbp record).
// Depths above 16 (never the split pass's, which clamps to 16) take a
// plain loop over K codes staged in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "pair_counts.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxGroups = 32;
constexpr int kUnit = kmg::kPairR;  // left ends a thread owns

struct Groups {
  int n;
  int w[kMaxGroups];
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// A tile's units and the byte offsets of its shared memory, each section
// 16-byte aligned: the codes packed 16 to a word (the units' and the K
// codes' reach, k codes past the last unit); Lu of [0, 16 units) with a
// word of slack for the rows' unaligned reads; Ru of [0, t); one carry of
// four words per chunk of 32 units; the staged K codes of the plain route.
struct Shape {
  int n_units, n_chunks, n_words;
  size_t lc, rc, edge, kc, end;
};

__host__ __device__ inline Shape multi_shape(int t, int w_max, int k, bool small) {
  Shape s;
  s.n_units = (t + w_max + kUnit - 1) / kUnit;
  s.n_chunks = (s.n_units + 31) / 32;
  const int ex = k > 16 ? k - 16 : 0;
  s.n_words = s.n_units + 5 + (ex + 15) / 16;
  s.lc = align16(static_cast<size_t>(s.n_words) * sizeof(uint32_t));
  s.rc = s.lc + align16(static_cast<size_t>(kUnit) * s.n_units + 8);
  s.edge = s.rc + align16(static_cast<size_t>(t));
  s.kc = s.edge + align16(static_cast<size_t>(s.n_chunks) * sizeof(uint4));
  s.end = s.kc + (small ? 0 : align16(static_cast<size_t>(kUnit) * s.n_units * sizeof(int32_t)));
  return s;
}

// Byte counts of a uint4 added lane by lane (no byte carries: every count
// is at most the depth, <= 16 where this is used).
__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) { return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w); }

// kSmall: depth <= 16, the once-counted units; else the plain loop.
template <bool kSmall>
__global__ void __launch_bounds__(kMaxThreads)
pair_multi_kernel(const int8_t* __restrict__ codes, long long n_codes, int k, Groups groups, int w_min,
                  int w_max, int depth, int t, int ab_stride, int kc_stride, int32_t* __restrict__ ab,
                  int32_t* __restrict__ kc_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shape sh = multi_shape(t, w_max, k, kSmall);
  uint32_t* codes2 = reinterpret_cast<uint32_t*>(smem);
  uint8_t* lu = smem + sh.lc;
  uint8_t* ru = smem + sh.rc;
  uint4* edge = reinterpret_cast<uint4*>(smem + sh.edge);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long tile_pos = static_cast<long long>(blockIdx.x) * t;
  const int kk = k < 16 ? k : 16;  // the K code keeps the last 16 codes of a longer k-mer (mod 2^32)
  // code s of codes2 is the tile's code s - mis - ex: K[x] starts at s = x + mis + ex
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);
  const int base = mis + (k - kk);

  // 1. the tile's codes from the aligned granule at or below its first
  {
    const uint4* gran = reinterpret_cast<const uint4*>(codes - mis) + tile_pos / 16;
    const long long end = mis + n_codes - tile_pos;  // valid bytes from gran
    for (int q = tid; q < sh.n_words; q += blockDim.x) {
      const long long b = 16LL * q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (b < end) {
        v = __ldg(gran + q);
        const long long n = end - b;  // bytes of this granule inside the codes
        if (n < 16) {
          auto keep = [n](uint32_t x, int first) {
            const long long r = n - first;
            return r >= 4 ? x : r <= 0 ? 0u : x & ((1u << (8 * r)) - 1u);
          };
          v = make_uint4(keep(v.x, 0), keep(v.y, 4), keep(v.z, 8), keep(v.w, 12));
        }
      }
      codes2[q] = kmg::pack4(v.x) << 24 | kmg::pack4(v.y) << 16 | kmg::pack4(v.z) << 8 | kmg::pack4(v.w);
    }
  }
  __syncthreads();

  // 2. Ru over [0, t) and Lu over [w_min, t + w_max) as bytes
  if constexpr (kSmall) {
    for (int u0 = 0; u0 < sh.n_units; u0 += blockDim.x) {  // uniform: every lane shuffles
      const int u = u0 + tid;
      const int ur = u < sh.n_units ? u : sh.n_units - 1;
      uint32_t kv[2 * kUnit + 1];
      kmg::unit_kcodes(codes2, kUnit * ur + base, kk, kv);
      bool narrow = kk <= 8;
      if (!narrow) {
        uint32_t any = 0u;
#pragma unroll
        for (int i = 0; i <= 2 * kUnit; ++i) any |= kv[i];
        narrow = __all_sync(0xffffffffu, (any >> 16) == 0u);
      }
      uint32_t own[4], carry[4], rc[4];
      if (narrow) {
        kmg::pair_unit_counts<true>(kv, depth, own, carry, rc);
      } else {
        kmg::pair_unit_counts<false>(kv, depth, own, carry, rc);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t in = __shfl_up_sync(0xffffffffu, carry[r], 1);
        if (lane > 0) own[r] += in;
      }
      if (u < sh.n_units) {
        reinterpret_cast<uint4*>(lu)[u] = make_uint4(own[0], own[1], own[2], own[3]);
        if (kUnit * u < t) reinterpret_cast<uint4*>(ru)[u] = make_uint4(rc[0], rc[1], rc[2], rc[3]);
        if (lane == 31) edge[u >> 5] = make_uint4(carry[0], carry[1], carry[2], carry[3]);
      }
    }
    __syncthreads();
    // the first unit of chunk c takes the carry of chunk c - 1's last
    for (int c = 1 + tid; c < sh.n_chunks; c += blockDim.x) {
      uint4* x = reinterpret_cast<uint4*>(lu) + 32 * c;
      *x = add4(*x, edge[c - 1]);
    }
  } else {
    int32_t* kcs = reinterpret_cast<int32_t*>(smem + sh.kc);
    for (int i = tid; i < kUnit * sh.n_units; i += blockDim.x) {
      kcs[i] = static_cast<int32_t>(kmg::kcode_at(codes2, i + base, kk));
    }
    __syncthreads();
    for (int x = w_min + tid; x < t + w_max; x += blockDim.x) {
      const int v = kcs[x];
      int n = 0;
      for (int d = 1; d <= depth; ++d) n += kcs[x - d] != v;
      lu[x] = static_cast<uint8_t>(n);
    }
    for (int p = tid; p < t; p += blockDim.x) {
      const int v = kcs[p];
      int n = 0;
      for (int d = 1; d <= depth; ++d) n += kcs[p + d] != v;
      ru[p] = static_cast<uint8_t>(n);
    }
  }
  __syncthreads();

  // 3. four positions a thread a step: every group's row, then the K codes
  const uint32_t* luw = reinterpret_cast<const uint32_t*>(lu);
  const uint32_t* ruw = reinterpret_cast<const uint32_t*>(ru);
  for (int q = tid; q < t / 4; q += blockDim.x) {
    const int p = 4 * q;
    const long long pos = tile_pos + p;
    if (pos < ab_stride) {
      const uint32_t r = ruw[q];
      const int r0 = r & 0xff, r1 = (r >> 8) & 0xff, r2 = (r >> 16) & 0xff, r3 = r >> 24;
      for (int g = 0; g < groups.n; ++g) {
        const int x = p + groups.w[g];
        const uint32_t l = __funnelshift_r(luw[x >> 2], luw[(x >> 2) + 1], 8 * (x & 3));
        *reinterpret_cast<int4*>(ab + static_cast<long long>(g) * ab_stride + pos) =
            make_int4(r0 - static_cast<int>(l & 0xff), r1 - static_cast<int>((l >> 8) & 0xff),
                      r2 - static_cast<int>((l >> 16) & 0xff), r3 - static_cast<int>(l >> 24));
      }
    }
    if (pos < kc_stride) {
      *reinterpret_cast<int4*>(kc_out + pos) = make_int4(
          static_cast<int>(kmg::kcode_at(codes2, p + base, kk)), static_cast<int>(kmg::kcode_at(codes2, p + 1 + base, kk)),
          static_cast<int>(kmg::kcode_at(codes2, p + 2 + base, kk)), static_cast<int>(kmg::kcode_at(codes2, p + 3 + base, kk)));
    }
  }
}

}  // namespace

// ab[n_groups, ab_stride] (rows padded to a multiple of 4, 16-byte
// aligned), kc[kc_stride] (a multiple of 4); w[n_groups] (host memory) the
// groups' window widths, each > depth.  codes[0 .. n_codes) are read, zeros
// past them.  t (a multiple of 16) positions a block, n_tiles blocks of
// threads (a multiple of 32, at most 512; whole units go round when
// fewer); n_tiles * t >= max(ab_stride, kc_stride).  Returns
// cudaGetLastError().
extern "C" int kmg_pair_multi(const void* codes, long long n_codes, int k, int n_groups, const int* w, int depth,
                              int t, int n_tiles, int threads, int ab_stride, int kc_stride, void* ab, void* kc,
                              void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || k < 1 || depth < 0 || t <= 0 || t % kUnit != 0 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || ab_stride % 4 != 0 || kc_stride % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Groups groups;
  groups.n = n_groups;
  int w_min = w[0];
  int w_max = w[0];
  for (int g = 0; g < n_groups; ++g) {
    groups.w[g] = w[g];
    w_min = w[g] < w_min ? w[g] : w_min;
    w_max = w[g] > w_max ? w[g] : w_max;
  }
  if (depth >= w_min) return static_cast<int>(cudaErrorInvalidValue);
  const bool small = depth <= kUnit;
  const size_t smem = multi_shape(t, w_max, k, small).end;
  auto kernel = small ? pair_multi_kernel<true> : pair_multi_kernel<false>;
  const cudaError_t err = kmg::allow_smem_once(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n_codes, k, groups, w_min, w_max, depth, t, ab_stride, kc_stride,
      static_cast<int32_t*>(ab), static_cast<int32_t*>(kc));
  return static_cast<int>(cudaGetLastError());
}
