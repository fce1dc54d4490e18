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
// Routes are chosen by shape inside the C entry points (a dispatch, not a
// fallback): the sliding histogram for K4r's main shape, else the
// register-blocked routine, itself on one of two routes by depth:
//
// The sliding histogram (byte codes, k = 1, depth = w - 1: the strobe span
// engine's exact pass at s = 2, K4r's main shape).  At that depth both sums
// run over the same open interval (p, p + w):
//   ab[p] = H_p[K[p+w]] - H_p[K[p]],  H_p the histogram of K[p+1 .. p+w-1],
//   H_{p+1} = H_p - e_{K[p+1]} + e_{K[p+w]},
// so a thread that walks a contiguous segment of positions with its own
// histogram does O(1) work a position: w - 1 increments to start, then two
// reads and two updates a step.  The 256 bins of 16-bit counts (a count is at
// most w - 1 < 65536) sit two to a 32-bit word, word-major with the thread
// minor, so a warp's lanes hit 32 distinct banks whatever their codes.  A
// thread's codes come 16 at a time by aligned 16-byte loads (the window's
// right edge through a byte funnel), a chunk ahead.  The segment length is
// chosen so that the grid is one wave of resident threads.  What bounds it
// on an H100: the 4 bytes of ab and 4 of K written per position.  Lanes a
// segment apart that each store their own 16 results write 32 scattered
// pieces per instruction, which cost more than the whole histogram walk, so
// the K codes leave coalesced, a block's range at a time, and ab through a
// per-warp buffer, eight lanes' 64-byte chunks an instruction.
//
// The register-blocked routine (every other shape: int32 strobe codes at
// s = 3, 4,096 values; K4 on 2-bit genome codes; K6), csrc/pair_counts.cuh:
// a block stages its tile's K codes (int32) in shared memory with one pad
// word per 16, built from the codes (K4) or copied (K6), and each of its
// t / 16 threads owns 16 consecutive positions, their targets in registers.
// Depth <= 16 (K6's split pass, K4 at depth 14) holds each thread's 32
// codes of either side in registers and compares on registers; deeper
// (K4r's s = 3 pass at depth 280, K6 deeper) streams each column of the
// thread's two runs of depth + 15 codes once.  Shared loads fall from 2 *
// depth a position to about 2 (depth + 15) / 16; the 2 * depth compares
// remain, two to an instruction pair when the codes fit 16 bits.  What
// bounds it on an H100: instruction issue (the compares, the staging, the
// stores) at every depth, above the device-memory bytes (4 in, 4 or 8 out a
// position) even at depth 16.  At k > 1 the K codes are built in shared
// memory from the tile's codes in device memory, rolling from one to the
// next.  The tile's padded K codes fill a block's shared memory: at t =
// 2048 on an H100 (227 KB a block) w reaches 52,628, and a wider w fails at
// launch.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#include "pair_counts.cuh"

namespace {

constexpr int kHistThreads = 64;                  // threads per sliding-histogram block
constexpr int kHistWords = 128;                   // 256 bins, two 16-bit counts a word
constexpr int kChunk = 16;                        // positions a thread takes per step of its loop

// 16 bytes of codes from byte q + off of the aligned granules lo = codes[q ..
// q + 16), hi = codes[q + 16 .. q + 32) (0 <= off < 16), as four words.
__device__ __forceinline__ void funnel16(const uint4& lo, const uint4& hi, int off, uint32_t out[4]) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int s = 8 * (off & 3);
  switch (off >> 2) {
#define KMG_FUNNEL_CASE(Q)                                                  \
  case Q:                                                                   \
    for (int i = 0; i < 4; ++i) out[i] = __funnelshift_r(w[Q + i], w[Q + i + 1], s); \
    break;
    KMG_FUNNEL_CASE(0)
    KMG_FUNNEL_CASE(1)
    KMG_FUNNEL_CASE(2)
    KMG_FUNNEL_CASE(3)
#undef KMG_FUNNEL_CASE
  }
}

// The aligned 16-byte granule g of `base` (16-byte aligned), or zeros when it
// holds no byte below `end` (it then may lie past the allocation).
__device__ __forceinline__ uint4 granule(const uint4* __restrict__ base, long long g, long long end) {
  return 16 * g < end ? base[g] : make_uint4(0u, 0u, 0u, 0u);
}

// Byte b of four words (b a compile-time constant after unrolling).
__device__ __forceinline__ int byte_of(const uint32_t v[4], int b) { return (v[b >> 2] >> (8 * (b & 3))) & 0xff; }

// Byte b of a granule, b known only at run time (no indexed registers).
__device__ __forceinline__ int byte_at(const uint4& g, int b) {
  const int q = b >> 2;
  const uint32_t v = q == 0 ? g.x : q == 1 ? g.y : q == 2 ? g.z : g.w;
  return (v >> (8 * (b & 3))) & 0xff;
}

// K4r's sliding histogram: thread g takes the segment [g * seg, (g + 1) *
// seg) of positions (seg a multiple of kChunk) and writes ab[p] for p < nt
// and kc[p] = codes[p] for p < nkc.  A warp's 32 chunks of each (16
// positions a lane, one chunk each) leave through padded per-warp buffers,
// four lanes to a chunk's 64 bytes, so a store instruction writes 8 whole
// chunks instead of 32 scattered quarters.  codes holds n_codes bytes, every
// one that is read below it.
__global__ void __launch_bounds__(kHistThreads)
pair_roll_hist_kernel(const uint8_t* __restrict__ codes, long long n_codes, int w, int seg, int nt,
                      int nkc, int32_t* __restrict__ ab, int32_t* __restrict__ kc) {
  __shared__ uint32_t hist[kHistWords * kHistThreads];  // word j of thread tid at j * kHistThreads + tid
  __shared__ int32_t xbuf[kHistThreads / 32][32 * (kChunk + 1)];  // a warp's ab chunks, lane-major, padded
  __shared__ uint32_t cbuf[kHistThreads / 32][32 * 5];             // and its chunks of codes, 4 words a lane
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int32_t* xb = xbuf[tid >> 5];
  uint32_t* cb = cbuf[tid >> 5];
  uint32_t* h = hist + tid;
  const long long g0 = static_cast<long long>(blockIdx.x) * kHistThreads;  // the block's first thread
  const long long p0 = (g0 + tid) * seg;
  const long long n_out = nt > nkc ? nt : nkc;
  if (g0 * seg >= n_out) return;  // block-uniform
  // codes as granules of the aligned address at or below codes
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);
  const uint4* gran = reinterpret_cast<const uint4*>(codes - mis);
  const long long end = n_codes + mis;
#pragma unroll 8
  for (int j = 0; j < kHistWords; ++j) h[j * kHistThreads] = 0u;
  auto one = [](int v) { return 1u << (16 * (v & 1)); };  // bin v's unit in its word
  const bool any_ab = p0 < nt;
  if (any_ab) {
    // H_{p0}: K[p0 + 1 .. p0 + w - 1], 16 codes a step, the next granule in flight
    const long long a = p0 + mis;
    const int off = static_cast<int>(a & 15);
    uint4 lo = granule(gran, a >> 4, end);
    uint4 hi = granule(gran, (a >> 4) + 1, end);
    for (int c = 0; c < w; c += kChunk) {
      const uint4 nx = granule(gran, ((a + c) >> 4) + 2, end);
      uint32_t v[4];
      funnel16(lo, hi, off, v);
#pragma unroll
      for (int b = 0; b < kChunk; ++b) {
        const int x = byte_of(v, b);
        if (c + b >= 1 && c + b < w) h[(x >> 1) * kHistThreads] += one(x);
      }
      lo = hi;
      hi = nx;
    }
  }
  const long long p_end = p0 + seg < n_out ? p0 + seg : n_out;
  // left codes K[p .. p + 16) (and K[p + 16], for the last step's K[p + 1]),
  // right codes K[p + w .. p + w + 16), each from two granules, the next
  // chunk's granules loaded a chunk ahead
  const long long al = p0 + mis;
  const long long ar = p0 + w + mis;
  const int offl = static_cast<int>(al & 15);
  const int offr = static_cast<int>(ar & 15);
  uint4 l_lo = granule(gran, al >> 4, end);
  uint4 l_hi = granule(gran, (al >> 4) + 1, end);
  uint4 r_lo = granule(gran, ar >> 4, end);
  uint4 r_hi = granule(gran, (ar >> 4) + 1, end);
  // every thread of a warp walks the same chunks (the buffer is shared);
  // positions at or past p_end are computed from padding and not stored
  for (int c = 0; c < seg; c += kChunk) {
    const long long p = p0 + c;
    const uint4 l_nx = granule(gran, ((al + c) >> 4) + 2, end);
    const uint4 r_nx = granule(gran, ((ar + c) >> 4) + 2, end);
    uint32_t kl[4];
    funnel16(l_lo, l_hi, offl, kl);
    int32_t a[kChunk];
    if (p < p_end && p < nt) {
      uint32_t kr[4];
      funnel16(r_lo, r_hi, offr, kr);
      // K[p + 16] lies in l_hi at the same offset as K[p] in l_lo
      const int k16 = byte_at(l_hi, offl);
#pragma unroll
      for (int b = 0; b < kChunk; ++b) {
        const int vl = byte_of(kl, b);
        const int vr = byte_of(kr, b);
        const int vn = b + 1 < kChunk ? byte_of(kl, b + 1) : k16;  // K[p + b + 1]
        // three loads issued together, then one or two stores: H[vn] -= 1
        // and H[vr] += 1 (the bin of vn holds K[p + 1], so no borrow leaves
        // it; at w = 1 the two updates meet in one bin)
        uint32_t* hr = h + (vr >> 1) * kHistThreads;
        uint32_t* hn = h + (vn >> 1) * kHistThreads;
        const uint32_t wr = *hr;
        const uint32_t wl = h[(vl >> 1) * kHistThreads];
        const uint32_t wn = *hn;
        a[b] = static_cast<int>((wr >> (16 * (vr & 1))) & 0xffffu) - static_cast<int>((wl >> (16 * (vl & 1))) & 0xffffu);
        const bool same = hr == hn;
        *hn = wn - one(vn) + (same ? one(vr) : 0u);
        if (!same) *hr = wr + one(vr);
      }
    }
#pragma unroll
    for (int b = 0; b < kChunk; ++b) xb[lane * (kChunk + 1) + b] = a[b];
#pragma unroll
    for (int j = 0; j < 4; ++j) cb[lane * 5 + j] = kl[j];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int src = 8 * i + (lane >> 2);  // the lane whose chunk this lane writes a quarter of
      const int q = 4 * (lane & 3);
      const long long pq = (g0 + (tid & ~31) + src) * seg + c + q;
      const int32_t* x = xb + src * (kChunk + 1) + q;
      if (pq + 4 <= nt) {
        *reinterpret_cast<int4*>(ab + pq) = make_int4(x[0], x[1], x[2], x[3]);
      } else {
        for (int j = 0; j < 4; ++j) {
          if (pq + j < nt) ab[pq + j] = x[j];
        }
      }
      const uint32_t k4 = cb[src * 5 + (lane & 3)];  // codes K[pq .. pq + 4)
      if (pq + 4 <= nkc) {
        *reinterpret_cast<int4*>(kc + pq) = make_int4(k4 & 0xff, (k4 >> 8) & 0xff, (k4 >> 16) & 0xff, k4 >> 24);
      } else {
        for (int j = 0; j < 4; ++j) {
          if (pq + j < nkc) kc[pq + j] = (k4 >> (8 * j)) & 0xff;
        }
      }
    }
    __syncwarp();
    l_lo = l_hi;
    l_hi = l_nx;
    r_lo = r_hi;
    r_hi = r_nx;
  }
}

// The staged K codes of a tile from its codes c[0 .. t + w + k - 1), padded
// as the staged ones (block-cooperative): each thread takes a run of
// consecutive staged codes x, K[x] zero off [0, t + w), the first by its sum
// and the rest rolling.  The codes are read where they lie, through the
// read-only cache (a tile's codes are a few KB, and a warp's runs touch a
// few lines a load), so the tile's shared memory holds the K codes alone and
// w reaches as far as K6's.  Returns this thread's OR of the K codes.
template <typename Code>
__device__ __forceinline__ uint32_t build_kcodes_rolling(const Code* __restrict__ c, int k, int t, int w,
                                                         int32_t* __restrict__ s) {
  auto code = [c](int i) { return static_cast<uint32_t>(static_cast<int>(__ldg(c + i))); };  // sign as c[i] reads
  const int span = kmg::pair_tile_span(t, w);
  const int run = (span + static_cast<int>(blockDim.x) - 1) / static_cast<int>(blockDim.x);
  const int i_lo = static_cast<int>(threadIdx.x) * run;
  const int i_hi = i_lo + run < span ? i_lo + run : span;
  const uint32_t pow_k = k < 16 ? 1u << (2 * k) : 0u;
  uint32_t v = 0;
  bool rolling = false;
  uint32_t any = 0;
#pragma unroll 4
  for (int i = i_lo; i < i_hi; ++i) {
    const int x = i - kmg::kPairHalo;
    uint32_t kx = 0;
    if (x >= 0 && x < t + w) {
      if (rolling) {
        v = 4u * v - pow_k * code(x - 1) + code(x + k - 1);
      } else {
        for (int j = 0; j < k; ++j) v = 4u * v + code(x + j);
        rolling = true;
      }
      kx = v;
    }
    s[kmg::pair_pad(i)] = static_cast<int32_t>(kx);
    any |= kx;
  }
  return any;
}

// K4 and K4r's other shapes: one tile of t positions a block (t / 16 x
// pair_groups threads).  At k = 1 the codes are the K codes and are staged
// as they are (int32 codes four a load); at k > 1 each thread builds a run
// of consecutive K codes from the tile's t + w + k - 1 codes, rolling:
// K[x] = 4 K[x - 1] - 4^k c[x - 1] + c[x + k - 1], modulo 2^32 as the sum
// it replaces.  Then the K codes (kc_out[p] = K[p] for p <
// nkc) and ab from the staged tile.
template <typename Code, bool kSmall>
__global__ void __launch_bounds__(kmg::kPairMaxThreads)
pair_depth_codes_kernel(const Code* __restrict__ codes, int k, int w, int depth, int nt, int nkc,
                        int32_t* __restrict__ ab, int32_t* __restrict__ kc_out) {
  extern __shared__ int32_t s[];
  const int t = static_cast<int>(blockDim.x) / kmg::pair_groups(kSmall) * kmg::kPairR;
  const long long tile_pos = static_cast<long long>(blockIdx.x) * t;
  const Code* c = codes + tile_pos;
  bool narrow;
  if (k == 1 && sizeof(Code) == sizeof(int32_t)) {
    narrow = kmg::pair_stage_rows(s, t, w, reinterpret_cast<const int32_t*>(c), 0, t + w);
  } else if (k == 1) {
    narrow = kmg::pair_stage(s, t, w, [&](int x) { return x >= 0 && x < t + w ? static_cast<int>(c[x]) : 0; });
  } else {
    const uint32_t any = build_kcodes_rolling(c, k, t, w, s);
    narrow = __syncthreads_or(static_cast<int>(any >> 16)) == 0;
  }
  const long long n_kc = nkc - tile_pos;
  kmg::pair_store(s, kmg::kPairHalo, n_kc < t ? static_cast<int>(n_kc) : t, kc_out + tile_pos);
  const long long left = nt - tile_pos;
  kmg::pair_tile_deltas<kSmall, false>(s, t, w, depth, narrow, left < t ? static_cast<int>(left) : t, ab + tile_pos);
}

// K6: one tile of t positions a block (t / 16 x pair_groups threads), its K
// codes copied (zero past n_kcodes).
template <bool kSmall>
__global__ void __launch_bounds__(kmg::kPairMaxThreads)
pair_depth_kcodes_kernel(const int32_t* __restrict__ kcodes, long long n_kcodes, int w, int depth, int nt,
                         int32_t* __restrict__ ab) {
  extern __shared__ int32_t s[];
  const int t = static_cast<int>(blockDim.x) / kmg::pair_groups(kSmall) * kmg::kPairR;
  const long long tile_pos = static_cast<long long>(blockIdx.x) * t;
  const bool narrow = kmg::pair_stage_rows(s, t, w, kcodes + tile_pos, -tile_pos, n_kcodes - tile_pos);
  const long long left = nt - tile_pos;
  kmg::pair_tile_deltas<kSmall, false>(s, t, w, depth, narrow, left < t ? static_cast<int>(left) : t, ab + tile_pos);
}

// The tile of the register-blocked kernels: whole warps of 16-position
// threads, at most kPairMaxTile positions.
bool pair_tile_ok(int t) { return t > 0 && t % (32 * kmg::kPairR) == 0 && t <= kmg::kPairMaxTile; }

// Resident sliding-histogram blocks per SM and the SM count of the current
// device, queried once per device (with the shared-memory carveout raised to
// its maximum, so the 32 KB blocks fill the SM).
cudaError_t roll_hist_residency(int* sms, int* blocks_per_sm) {
  static std::mutex mu;
  static int cached_dev = -1;
  static int cached_sms = 0;
  static int cached_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev != cached_dev) {
    err = cudaFuncSetAttribute(pair_roll_hist_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached_blocks, pair_roll_hist_kernel, kHistThreads, 0);
    }
    if (err != cudaSuccess) return err;
    if (cached_blocks < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev;
  }
  *sms = cached_sms;
  *blocks_per_sm = cached_blocks;
  return cudaSuccess;
}

// The sliding histogram over max(nt, nkc) positions: one wave of resident
// threads, each with a segment of positions that is a multiple of kChunk
// (at 16 Mbp on an H100: 384 positions a thread, 652 blocks, 5 resident an
// SM).
int launch_roll_hist(const uint8_t* codes, long long n_codes, int w, int nt, int nkc, int32_t* ab,
                     int32_t* kc, cudaStream_t stream) {
  const long long n_out = nt > nkc ? nt : nkc;
  if (n_out <= 0) return static_cast<int>(cudaSuccess);
  int sms = 0;
  int blocks_per_sm = 0;
  const cudaError_t err = roll_hist_residency(&sms, &blocks_per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(sms) * blocks_per_sm * kHistThreads;
  const long long per_thread = (n_out + resident - 1) / resident;
  const int seg = static_cast<int>((per_thread + kChunk - 1) / kChunk * kChunk);
  const long long threads = (n_out + seg - 1) / seg;
  const int grid = static_cast<int>((threads + kHistThreads - 1) / kHistThreads);
  pair_roll_hist_kernel<<<grid, kHistThreads, 0, stream>>>(codes, n_codes, w, seg, nt, nkc, ab, kc);
  return static_cast<int>(cudaGetLastError());
}

template <typename Code>
int launch_codes(const void* codes, int k, int w, int depth, int t, int n_tiles, int nt,
                 int nkc, void* ab, void* kc, cudaStream_t stream) {
  if (!pair_tile_ok(t)) return static_cast<int>(cudaErrorInvalidValue);
  const bool small = depth <= kmg::kPairR;
  const size_t smem = static_cast<size_t>(kmg::pair_tile_words(t, w)) * sizeof(int32_t);
  auto kernel = small ? pair_depth_codes_kernel<Code, true> : pair_depth_codes_kernel<Code, false>;
  const cudaError_t err = kmg::allow_smem_once(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles, t / kmg::kPairR * kmg::pair_groups(small), smem, stream>>>(
      static_cast<const Code*>(codes), k, w, depth, nt, nkc, static_cast<int32_t*>(ab), static_cast<int32_t*>(kc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 / K4r: ab[nt], kc[nkc] from codes of code_bytes bytes each (1: int8
// 2-bit codes or uint8 strobe codes, both 0..255 as read here; 4: int32).
// codes must hold n_tiles * t + w + k - 1 entries, with n_tiles * t >=
// max(nt, nkc).  Byte codes at k = 1 and depth = w - 1 take the sliding
// histogram (t and n_tiles then only size the codes), every other shape the
// register-blocked routine (t a multiple of 512, at most 2048; w at most
// 52,628 at t = 2048 on an H100).  Returns cudaGetLastError().
extern "C" int kmg_pair_depth_codes(const void* codes, int code_bytes, int k, int w, int depth,
                                    int t, int n_tiles, int nt, int nkc, void* ab, void* kc,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth < 0 || depth >= w) return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1 && k == 1 && depth == w - 1 && w < 65536) {
    return launch_roll_hist(static_cast<const uint8_t*>(codes), static_cast<long long>(n_tiles) * t + w, w, nt,
                            nkc, static_cast<int32_t*>(ab), static_cast<int32_t*>(kc), s);
  }
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
// n_tiles * t >= nt (t a multiple of 512, at most 2048; w at most 52,628 at
// t = 2048 on an H100).  Returns cudaGetLastError().
extern "C" int kmg_pair_depth_kcodes(const void* kcodes, long long n_kcodes, int w, int depth,
                                     int t, int n_tiles, int nt, void* ab, void* stream) {
  if (depth < 0 || depth >= w || !pair_tile_ok(t)) return static_cast<int>(cudaErrorInvalidValue);
  const bool small = depth <= kmg::kPairR;
  const size_t smem = static_cast<size_t>(kmg::pair_tile_words(t, w)) * sizeof(int32_t);
  auto kernel = small ? pair_depth_kcodes_kernel<true> : pair_depth_kcodes_kernel<false>;
  const cudaError_t err = kmg::allow_smem_once(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles, t / kmg::kPairR * kmg::pair_groups(small), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(kcodes), n_kcodes, w, depth, nt, static_cast<int32_t*>(ab));
  return static_cast<int>(cudaGetLastError());
}
