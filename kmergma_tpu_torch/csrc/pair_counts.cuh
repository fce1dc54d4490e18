// Device helpers of the pair kernels: the depth-limited equal-k-mer pair
// counts on either side of a position (K3 csrc/fused_cluster_bitmaps.cu, K5
// csrc/pair_multi.cu), and the register-blocked net pair delta at one width
// (K2 csrc/match_counts.cu; K4, K4r's other shapes and K6 csrc/pair_depth.cu).
//
// The net pair delta of window transition p at width w and depth d,
//   ab_w[p] = sum_{j=1..d} [K[p+w-j] == K[p+w]] - [K[p+j] == K[p]],
// splits into a term of x = p + w alone and a term of p alone:
//   Lc[x] = sum_j [K[x-j] == K[x]],  Rc[p] = sum_j [K[p+j] == K[p]],
//   ab_w[p] = Lc[p + w] - Rc[p],
// so K3 and K5 count the pairs once for every window width.  K3 counts 2 d
// compares a position (each side's on its own).  K5 counts each equal pair
// once (pair_unit_counts below): the compare e(a, a + j) = [K[a] == K[a+j]]
// adds to Rc[a] and to Lc[a + j], d compares a position.  Their counts are
// at most d and are kept as bytes (the wrappers hold d <= 255).
//
// The once-counted unit (pair_unit_counts, d <= 16).  A thread owns a unit of
// kPairR = 16 consecutive left ends a0 .. a0 + 15 and builds the 33 K codes
// K[a0 .. a0 + 32] in registers from four words of 2-bit codes.  Its pairs
// (a, a + j), j <= d, give the whole Rc of its unit and the part of Lc at a0
// + 1 .. a0 + 31 whose left end is in the unit: Lc of its own 16 positions
// but for the pairs that start in the unit before, and a carry for the next
// unit's 16.  The caller hands the carry to the next lane by one warp
// shuffle, and from a warp's last lane to the next warp's first through
// shared memory.  The counts are of unequal pairs (d minus the equal ones),
// which makes ab = Ru[p] - Lu[p + w] and keeps every partial count between
// 0 and d.  Codes that fit 16 bits (k <= 8, or a warp whose K codes all do)
// are compared two to a word: pe[q] = (K[2q], K[2q+1]), po[q] = (K[2q+1],
// K[2q+2]); a target pair pe[m] against its partners at distance j (pe[m +
// j/2] for even j, po[m + (j-1)/2] for odd) by one XOR and one DPX halfword
// minimum, the result added to Rc's word m and to the even- or odd-aligned
// Lc word it lands on.  Both halves count at most d <= 16 unequal pairs, so
// no half carries into the other and no bias is needed.  About 1.5
// instructions a compare, d compares a position.
//
// The register-blocked routine (pair_tile_deltas) computes ab at one width
// for a staged tile.  A thread owns kPairR = 16 consecutive positions p0 ..
// p0 + 15 and keeps their targets K[p0 + i] and K[p0 + w + i] in registers.
// Position i's partners are the columns K[p0 + w - d + j] (left, entering
// code) and K[p0 + 1 + j] (right, leaving code) with i <= j <= i + d - 1,
// so the thread reads each column of its two runs of d + 15 codes once and
// compares it with every target whose window holds it: the middle columns
// (15 <= j < d) with all 16, the 15 at each edge under triangular masks that
// the unrolling makes compile-time.  That is about 2 (d + 15) / 16 shared
// loads a position instead of 2 d (37 for K2 at d = 283, 4 for K6 at d =
// 16).  Two routes, chosen by depth at compile time in the C entry points:
//   - d <= 16 (K6's split pass, K4): the thread loads its 32 codes of each
//     side into registers and runs the 16 distances unrolled, each behind a
//     uniform d test, all on registers;
//   - d >= 15 (K2 at w - 1 = 283, K4r's s = 3 pass, K6 deeper): the thread
//     streams the columns from shared memory, and two thread groups split
//     them (the head and the first half of the middle, the rest and the
//     tail), so a 1024-position K2 row keeps 128 threads busy.
// Lanes that own positions 16 apart would read shared words 16 apart, a
// 16-way bank conflict; the staged tile keeps one pad word per 16 (word x at
// x + x / 16), so lane l's word 16 l + c lies in bank 17 l + c + c / 16 mod
// 32, distinct across the warp for every c: no conflicts on either route.
// The results leave through the same padded buffer, coalesced.
//
// What bounds it is integer issue, so the compares are packed when they
// can be: a tile whose staged codes all fit 16 bits (k <= 8; the staging
// barrier ORs them, so k = 10's codes up to 2^20 take the int32 compares
// tile by tile, whatever k the caller had) holds two targets to a word and
// tests both halves with one XOR and one DPX halfword minimum
// (__vimin3_u16x2), the net count biased by d in each half so no half
// borrows: about 1.25 instructions a compare against 2.5 for ISETP, select
// and add.  Staging keeps 24 loads in flight a thread, a whole 2048-position
// tile at w <= 992, since a block's tile staging, not its compares, set the
// pace with fewer in flight.  The measurements behind each choice are in
// PERF.md.

#pragma once

#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>
#include <cuda_runtime.h>

namespace kmg {

// Rc[p]
__device__ __forceinline__ int right_pair_count(const int32_t* __restrict__ kc, int p, int depth) {
  const int v = kc[p];
  int n = 0;
  for (int d = 1; d <= depth; ++d) n += kc[p + d] == v;
  return n;
}

// ---- the register-blocked net pair delta ----------------------------------

constexpr int kPairR = 16;             // consecutive positions a thread owns
constexpr int kPairHalo = 16;          // staged codes before the tile (the small route's left run at w < 16)
constexpr int kPairMaxTile = 2048;     // positions a tile
constexpr int kPairMaxThreads = 256;   // threads a block: a 2048-position tile on the streaming route
constexpr int kPairStageBatch = 24;    // loads in flight a thread while staging (a whole tile at w <= 992)

// Thread groups that share a tile's targets and split its columns: the
// small route 1, the streaming route 2 (each half of the middle columns,
// the first with the head, the second with the tail), so a row of 1024
// positions keeps 128 threads busy.
__host__ __device__ constexpr int pair_groups(bool small) { return small ? 1 : 2; }

// Staged word x sits at pair_pad(x): one pad word per 16.
__host__ __device__ __forceinline__ int pair_pad(int x) { return x + (x >> 4); }

// Codes a tile of T positions stages: K[tile + x] for x in [-kPairHalo, T +
// max(w, kPairR)), the reach of both routes' loads.
__host__ __device__ inline int pair_tile_span(int T, int w) { return kPairHalo + T + (w > kPairR ? w : kPairR); }

// Words of a tile's staged codes, the span rounded up to whole fours for
// the 16-byte staging (the results reuse them).
__host__ __device__ inline int pair_tile_words(int T, int w) { return pair_pad((pair_tile_span(T, w) + 3) / 4 * 4 - 1) + 1; }

// Positions a tile for rows of t positions: whole warps of 16-position
// threads, at most kPairMaxTile.
__host__ inline int pair_tile_len(long long t) {
  const long long per_warp = 32LL * kPairR;
  const long long T = (t + per_warp - 1) / per_warp * per_warp;
  return static_cast<int>(T < per_warp ? per_warp : T > kPairMaxTile ? kPairMaxTile : T);
}

// put(i, get(i)) for i in [0, n) (block-cooperative), kPairStageBatch loads
// in flight a thread.  Returns this thread's OR of the values.
template <typename Get, typename Put>
__device__ __forceinline__ int pair_copy(int n, Get get, Put put) {
  int any = 0;
  const int step = kPairStageBatch * static_cast<int>(blockDim.x);
  for (int base = threadIdx.x; base < n; base += step) {
    int v[kPairStageBatch];
#pragma unroll
    for (int b = 0; b < kPairStageBatch; ++b) {
      const int i = base + b * static_cast<int>(blockDim.x);
      v[b] = i < n ? get(i) : 0;
    }
#pragma unroll
    for (int b = 0; b < kPairStageBatch; ++b) {
      const int i = base + b * static_cast<int>(blockDim.x);
      if (i < n) put(i, v[b]);
      any |= v[b];
    }
  }
  return any;
}

// s[pair_pad(x + kPairHalo)] = get(x) for every staged x of a tile of T
// positions (block-cooperative; get returns 0 off the row), then a barrier.
// Returns (the same on every thread) whether every staged code fits 16
// bits, so the tile may take the packed compares.
template <typename Get>
__device__ __forceinline__ bool pair_stage(int32_t* __restrict__ s, int T, int w, Get get) {
  const int any = pair_copy(
      pair_tile_span(T, w), [&](int i) { return get(i - kPairHalo); }, [&](int i, int v) { s[pair_pad(i)] = v; });
  return __syncthreads_or(static_cast<int>(static_cast<unsigned>(any) >> 16)) == 0;
}

// pair_stage for int32 codes in memory: K[tile + x] = src[x] for x in [lo,
// hi), 0 elsewhere.  When src is 16-byte aligned, four codes come a load
// (16-byte loads where all four lie in [lo, hi), single ones at the edges),
// eight loads in flight a thread; otherwise one code a load.
__device__ __forceinline__ bool pair_stage_rows(int32_t* __restrict__ s, int T, int w,
                                                const int32_t* __restrict__ src, long long lo, long long hi) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) != 0) {
    return pair_stage(s, T, w, [&](int x) { return x >= lo && x < hi ? src[x] : 0; });
  }
  const int span = pair_tile_span(T, w);
  // staged index i = x + kPairHalo holds src[i - kPairHalo] for i in [i_lo, i_hi)
  const int i_lo = static_cast<int>(lo + kPairHalo < 0 ? 0 : lo + kPairHalo > span ? span : lo + kPairHalo);
  const int i_hi = static_cast<int>(hi + kPairHalo < i_lo ? i_lo : hi + kPairHalo > span ? span : hi + kPairHalo);
  const int n4 = (span + 3) / 4;
  constexpr int kB = kPairStageBatch / 3;  // 16-byte loads in flight a thread
  uint32_t any = 0;
  for (int base = threadIdx.x; base < n4; base += kB * static_cast<int>(blockDim.x)) {
    int4 v[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int i = 4 * (base + b * static_cast<int>(blockDim.x));
      const int x = i - kPairHalo;  // a multiple of 4, so src + x is 16-byte aligned
      if (i >= i_lo && i + 4 <= i_hi) {
        v[b] = *reinterpret_cast<const int4*>(src + x);
      } else {
        v[b].x = i >= i_lo && i < i_hi ? src[x] : 0;
        v[b].y = i + 1 >= i_lo && i + 1 < i_hi ? src[x + 1] : 0;
        v[b].z = i + 2 >= i_lo && i + 2 < i_hi ? src[x + 2] : 0;
        v[b].w = i + 3 >= i_lo && i + 3 < i_hi ? src[x + 3] : 0;
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int i = 4 * (base + b * static_cast<int>(blockDim.x));
      if (i < span) {  // span may end inside the last four; the pad words past it are unused
        int32_t* d = s + pair_pad(i);  // i a multiple of 4: its four words are adjacent
        d[0] = v[b].x;
        d[1] = v[b].y;
        d[2] = v[b].z;
        d[3] = v[b].w;
        any |= static_cast<uint32_t>(v[b].x | v[b].y | v[b].z | v[b].w);
      }
    }
  }
  return __syncthreads_or(static_cast<int>(any >> 16)) == 0;
}

// out[p] = s[pair_pad(p + off)] for p < n (block-cooperative; off a
// multiple of 4), four values a 16-byte store when out is 16-byte aligned.
__device__ __forceinline__ void pair_store(const int32_t* __restrict__ s, int off, int n, int32_t* __restrict__ out) {
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    for (int p = 4 * static_cast<int>(threadIdx.x); p < n; p += 4 * static_cast<int>(blockDim.x)) {
      const int32_t* r = s + pair_pad(p + off);  // p + off a multiple of 4: its four words are adjacent
      if (p + 4 <= n) {
        *reinterpret_cast<int4*>(out + p) = make_int4(r[0], r[1], r[2], r[3]);
      } else {
        for (int j = 0; p + j < n; ++j) out[p + j] = r[j];
      }
    }
  } else {
    for (int p = threadIdx.x; p < n; p += blockDim.x) out[p] = s[pair_pad(p + off)];
  }
}

// Which columns a thread group compares: kAll every one (the small route),
// kFirst the head and the first half of the middle, kSecond the rest.
enum PairPart { kAll = 0, kFirst = 1, kSecond = 2 };

// acc[i] = this part's share of the ab of tile position i0 + i, i < kPairR,
// from the staged tile s.  kSmall: depth <= kPairR, else depth >= kPairR -
// 1.  kMatch adds K2's [K[p] == K[p + w]] - 1 (K2 is this function at depth
// w - 1 plus that term), in the first part.
template <bool kSmall, bool kMatch, int kPart>
__device__ __forceinline__ void pair_deltas(const int32_t* __restrict__ s, int i0, int w, int depth,
                                            int acc[kPairR]) {
  auto at = [s](int x) { return s[pair_pad(x + kPairHalo)]; };
  int el[kPairR];  // K[p0 + w + i], the entering codes
  int ll[kPairR];  // K[p0 + i], the leaving codes
  if constexpr (kSmall) {
    int lr[2 * kPairR];  // K[p0 + w - 16 + m]: lr[16 + i] = el[i]
    int rr[2 * kPairR];  // K[p0 + m]: rr[i] = ll[i]
#pragma unroll
    for (int m = 0; m < 2 * kPairR; ++m) {
      lr[m] = at(i0 + w - kPairR + m);
      rr[m] = at(i0 + m);
    }
#pragma unroll
    for (int i = 0; i < kPairR; ++i) {
      el[i] = lr[kPairR + i];
      ll[i] = rr[i];
      acc[i] = 0;
    }
#pragma unroll
    for (int j = 1; j <= kPairR; ++j) {
      if (j <= depth) {
#pragma unroll
        for (int i = 0; i < kPairR; ++i) {
          acc[i] += static_cast<int>(lr[kPairR + i - j] == el[i]);
          acc[i] -= static_cast<int>(rr[i + j] == ll[i]);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPairR; ++i) {
      el[i] = at(i0 + w + i);
      ll[i] = at(i0 + i);
      acc[i] = 0;
    }
    const int lb = i0 + w - depth;  // column j of the left run: K[p0 + w - depth + j]
    const int rb = i0 + 1;          // of the right run: K[p0 + 1 + j]
    const int mid = (kPairR - 1 + depth) / 2;
    if constexpr (kPart != kSecond) {
      // the first 15 columns serve the targets i <= j
#pragma unroll
      for (int j = 0; j < kPairR - 1; ++j) {
        const int cl = at(lb + j);
        const int cr = at(rb + j);
#pragma unroll
        for (int i = 0; i <= j; ++i) {
          acc[i] += static_cast<int>(cl == el[i]);
          acc[i] -= static_cast<int>(cr == ll[i]);
        }
      }
    }
    // columns 15 .. depth - 1 serve every target
    const int j0 = kPart == kSecond ? mid : kPairR - 1;
    const int j1 = kPart == kFirst ? mid : depth;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const int cl = at(lb + j);
      const int cr = at(rb + j);
#pragma unroll
      for (int i = 0; i < kPairR; ++i) {
        acc[i] += static_cast<int>(cl == el[i]);
        acc[i] -= static_cast<int>(cr == ll[i]);
      }
    }
    if constexpr (kPart != kFirst) {
      // the last 15, depth + q, serve the targets i > q
#pragma unroll
      for (int q = 0; q < kPairR - 1; ++q) {
        const int cl = at(lb + depth + q);
        const int cr = at(rb + depth + q);
#pragma unroll
        for (int i = q + 1; i < kPairR; ++i) {
          acc[i] += static_cast<int>(cl == el[i]);
          acc[i] -= static_cast<int>(cr == ll[i]);
        }
      }
    }
  }
  if constexpr (kMatch && kPart != kSecond) {
#pragma unroll
    for (int i = 0; i < kPairR; ++i) acc[i] += static_cast<int>(ll[i] == el[i]) - 1;
  }
}

// Two 16-bit codes to a word (a low, b high).
__device__ __forceinline__ uint32_t pack2(int a, int b) {
  return __byte_perm(static_cast<uint32_t>(a), static_cast<uint32_t>(b), 0x5410);
}

// Per 16-bit half: [x_half != 0] where mask_half is 1, else 0 (one DPX
// instruction: the halves' unsigned three-way minimum, with the mask twice).
__device__ __forceinline__ uint32_t unequal2(uint32_t x, uint32_t mask) { return __vimin3_u16x2(x, mask, mask); }

// pair_deltas on codes that fit 16 bits: target pairs (positions 2m, 2m + 1)
// two to a word, one XOR and one halfword minimum testing both halves, and
// the part's net count kept as depth + sum(unequal right) - sum(unequal
// left) in 16-bit halves: between 0 and 2 depth, so no half borrows (depth
// < 2^15).
template <bool kSmall, bool kMatch, int kPart>
__device__ __forceinline__ void pair_deltas16(const int32_t* __restrict__ s, int i0, int w, int depth,
                                              int acc[kPairR]) {
  auto at = [s](int x) { return s[pair_pad(x + kPairHalo)]; };
  constexpr int kM = kPairR / 2;
  uint32_t el2[kM];  // (K[p0 + w + 2m], K[p0 + w + 2m + 1])
  uint32_t ll2[kM];  // (K[p0 + 2m], K[p0 + 2m + 1])
  uint32_t acc2[kM];
  const uint32_t bias = static_cast<uint32_t>(depth) * 0x00010001u;
  if constexpr (kSmall) {
    int lr[2 * kPairR];  // K[p0 + w - 16 + m]
    int rr[2 * kPairR];  // K[p0 + m]
#pragma unroll
    for (int m = 0; m < 2 * kPairR; ++m) {
      lr[m] = at(i0 + w - kPairR + m);
      rr[m] = at(i0 + m);
    }
    // pl[q] = (lr[q], lr[q + 1]), pr[q] = (rr[q], rr[q + 1])
    uint32_t pl[2 * kPairR - 1];
    uint32_t pr[2 * kPairR - 1];
#pragma unroll
    for (int q = 0; q < 2 * kPairR - 1; ++q) {
      pl[q] = pack2(lr[q], lr[q + 1]);
      pr[q] = pack2(rr[q], rr[q + 1]);
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      el2[m] = pl[kPairR + 2 * m];
      ll2[m] = pr[2 * m];
      acc2[m] = bias;
    }
#pragma unroll
    for (int j = 1; j <= kPairR; ++j) {
      if (j <= depth) {
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          acc2[m] = acc2[m] + unequal2(pr[2 * m + j] ^ ll2[m], 0x00010001u) -
                    unequal2(pl[kPairR + 2 * m - j] ^ el2[m], 0x00010001u);
        }
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      el2[m] = pack2(at(i0 + w + 2 * m), at(i0 + w + 2 * m + 1));
      ll2[m] = pack2(at(i0 + 2 * m), at(i0 + 2 * m + 1));
      acc2[m] = bias;
    }
    const int lb = i0 + w - depth;
    const int rb = i0 + 1;
    const int mid = (kPairR - 1 + depth) / 2;
    // column j in both halves of a word: (K[lb + j], K[lb + j]), (K[rb + j], K[rb + j])
    auto cols = [&](int j, uint32_t& cl, uint32_t& cr) {
      cl = __byte_perm(static_cast<uint32_t>(at(lb + j)), 0u, 0x1010);
      cr = __byte_perm(static_cast<uint32_t>(at(rb + j)), 0u, 0x1010);
    };
    if constexpr (kPart != kSecond) {
      // the first 15 columns serve the targets i <= j: both halves of pair
      // m when 2m + 1 <= j, the low half when 2m == j
#pragma unroll
      for (int j = 0; j < kPairR - 1; ++j) {
        uint32_t cl, cr;
        cols(j, cl, cr);
#pragma unroll
        for (int m = 0; 2 * m <= j; ++m) {
          const uint32_t mask = 2 * m + 1 <= j ? 0x00010001u : 0x00000001u;
          acc2[m] = acc2[m] + unequal2(cr ^ ll2[m], mask) - unequal2(cl ^ el2[m], mask);
        }
      }
    }
    // columns 15 .. depth - 1 serve every target
    const int j0 = kPart == kSecond ? mid : kPairR - 1;
    const int j1 = kPart == kFirst ? mid : depth;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      uint32_t cl, cr;
      cols(j, cl, cr);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        acc2[m] = acc2[m] + unequal2(cr ^ ll2[m], 0x00010001u) - unequal2(cl ^ el2[m], 0x00010001u);
      }
    }
    if constexpr (kPart != kFirst) {
      // the last 15, depth + q, serve the targets i > q: both halves of
      // pair m when 2m > q, the high half when 2m == q
#pragma unroll
      for (int q = 0; q < kPairR - 1; ++q) {
        uint32_t cl, cr;
        cols(depth + q, cl, cr);
#pragma unroll
        for (int m = (q + 1) / 2; m < kM; ++m) {
          const uint32_t mask = 2 * m > q ? 0x00010001u : 0x00010000u;
          acc2[m] = acc2[m] + unequal2(cr ^ ll2[m], mask) - unequal2(cl ^ el2[m], mask);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    acc[2 * m] = static_cast<int>(acc2[m] & 0xffffu) - depth;
    acc[2 * m + 1] = static_cast<int>(acc2[m] >> 16) - depth;
    if constexpr (kMatch && kPart != kSecond) {  // + [K[p] == K[p + w]] - 1
      const uint32_t ne = unequal2(ll2[m] ^ el2[m], 0x00010001u);
      acc[2 * m] -= static_cast<int>(ne & 0xffffu);
      acc[2 * m + 1] -= static_cast<int>(ne >> 16);
    }
  }
}

// One part of a tile's deltas, on the packed compares when the tile allows.
template <bool kSmall, bool kMatch, int kPart>
__device__ __forceinline__ void pair_part(const int32_t* __restrict__ s, int i0, int w, int depth, bool narrow,
                                          int acc[kPairR]) {
  if (narrow && depth < (1 << 15)) {
    pair_deltas16<kSmall, kMatch, kPart>(s, i0, w, depth, acc);
  } else {
    pair_deltas<kSmall, kMatch, kPart>(s, i0, w, depth, acc);
  }
}

// out[p] = ab of tile position p for p < n_out, from the staged tile s of T
// positions (block-cooperative, T / 16 x pair_groups(kSmall) threads; the
// caller staged s with pair_stage and passes what it returned as narrow:
// a tile whose codes fit 16 bits takes the packed compares).  The second
// group's sums meet the first's in s, and the results leave through s,
// coalesced.
template <bool kSmall, bool kMatch>
__device__ __forceinline__ void pair_tile_deltas(int32_t* __restrict__ s, int T, int w, int depth, bool narrow,
                                                 int n_out, int32_t* __restrict__ out) {
  int acc[kPairR];
  if constexpr (kSmall) {
    const int i0 = kPairR * static_cast<int>(threadIdx.x);
    pair_part<true, kMatch, kAll>(s, i0, w, depth, narrow, acc);
    __syncthreads();  // every thread has read the staged codes
#pragma unroll
    for (int i = 0; i < kPairR; ++i) s[pair_pad(i0 + i)] = acc[i];
  } else {
    const int n_thr = T / kPairR;
    const bool second = static_cast<int>(threadIdx.x) >= n_thr;  // warp-uniform: n_thr is a multiple of 32
    const int i0 = kPairR * (static_cast<int>(threadIdx.x) - (second ? n_thr : 0));
    if (second) {
      pair_part<false, kMatch, kSecond>(s, i0, w, depth, narrow, acc);
    } else {
      pair_part<false, kMatch, kFirst>(s, i0, w, depth, narrow, acc);
    }
    __syncthreads();
    if (second) {
#pragma unroll
      for (int i = 0; i < kPairR; ++i) s[pair_pad(i0 + i)] = acc[i];
    }
    __syncthreads();
    if (!second) {
#pragma unroll
      for (int i = 0; i < kPairR; ++i) s[pair_pad(i0 + i)] += acc[i];
    }
  }
  __syncthreads();
  pair_store(s, 0, n_out, out);
}

// ---- the once-counted unit ------------------------------------------------

// Four 2-bit codes, one per byte (first byte lowest), as 8 bits with the
// first code highest.
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  return ((w & 3u) << 6) | ((w >> 4) & 0x30u) | ((w >> 14) & 0x0cu) | ((w >> 24) & 3u);
}

// Four byte counts as one word, the first lowest.
__device__ __forceinline__ uint32_t bytes4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return a | b << 8 | c << 16 | d << 24;
}

// The K code of kk <= 16 codes whose first is code s of the 2-bit stream
// codes2 (16 codes a word, first code highest).
__device__ __forceinline__ uint32_t kcode_at(const uint32_t* __restrict__ codes2, int s, int kk) {
  const uint32_t top = __funnelshift_l(codes2[(s >> 4) + 1], codes2[s >> 4], 2 * (s & 15));
  return top >> (32 - 2 * kk);
}

// kv[i] = the K code of kk <= 16 codes from code s + i of codes2, i <= 32:
// the 48 codes from s aligned into three words once, then two shifts a code.
__device__ __forceinline__ void unit_kcodes(const uint32_t* __restrict__ codes2, int s, int kk,
                                            uint32_t kv[2 * kPairR + 1]) {
  const uint32_t* w = codes2 + (s >> 4);
  const int sh = 2 * (s & 15);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
  const uint32_t y0 = __funnelshift_l(w1, w0, sh);
  const uint32_t y1 = __funnelshift_l(w2, w1, sh);
  const uint32_t y2 = __funnelshift_l(w3, w2, sh);
  const int down = 32 - 2 * kk;
#pragma unroll
  for (int i = 0; i < kPairR; ++i) {
    kv[i] = __funnelshift_l(y1, y0, 2 * i) >> down;
    kv[kPairR + i] = __funnelshift_l(y2, y1, 2 * i) >> down;
  }
  kv[2 * kPairR] = y2 >> down;
}

// One unit's unequal-pair counts at depth <= 16 from its K codes kv[0 ..
// 32] (see the head of this file), each as four words of byte counts, the
// first position lowest: rc = Ru of positions 0 .. 15, own = the unit's
// share of Lu of positions 0 .. 15, carry = its share of Lu of positions 16
// .. 31 (the next unit's).  kNarrow: every kv fits 16 bits.
template <bool kNarrow>
__device__ __forceinline__ void pair_unit_counts(const uint32_t kv[2 * kPairR + 1], int depth, uint32_t own[4],
                                                 uint32_t carry[4], uint32_t rc[4]) {
  if constexpr (kNarrow) {
    constexpr int kM = kPairR / 2;
    uint32_t pe[kPairR];  // (K[2q], K[2q + 1])
    uint32_t po[kPairR];  // (K[2q + 1], K[2q + 2])
#pragma unroll
    for (int q = 0; q < kPairR; ++q) {
      pe[q] = pack2(kv[2 * q], kv[2 * q + 1]);
      po[q] = pack2(kv[2 * q + 1], kv[2 * q + 2]);
    }
    uint32_t r2[kM];      // Ru of (2m, 2m + 1)
    uint32_t le[kPairR];  // Lu of (2q, 2q + 1)
    uint32_t lo[kPairR];  // Lu of (2q + 1, 2q + 2); lo[15] stays 0
#pragma unroll
    for (int q = 0; q < kPairR; ++q) {
      le[q] = 0u;
      lo[q] = 0u;
      if (q < kM) r2[q] = 0u;
    }
#pragma unroll
    for (int j = 1; j <= kPairR; ++j) {
      if (j <= depth) {
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const uint32_t e = unequal2(pe[m] ^ ((j & 1) ? po[m + (j - 1) / 2] : pe[m + j / 2]), 0x00010001u);
          r2[m] += e;
          if (j & 1) {
            lo[m + (j - 1) / 2] += e;
          } else {
            le[m + j / 2] += e;
          }
        }
      }
    }
    // h[q] = Lu of (2q, 2q + 1): the even word, the odd word before's high
    // half and this odd word's low half
    uint32_t h[kPairR];
#pragma unroll
    for (int q = 0; q < kPairR; ++q) h[q] = le[q] + __byte_perm(q > 0 ? lo[q - 1] : 0u, lo[q], 0x5432);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      own[r] = __byte_perm(h[2 * r], h[2 * r + 1], 0x6420);
      carry[r] = __byte_perm(h[kM + 2 * r], h[kM + 2 * r + 1], 0x6420);
      rc[r] = __byte_perm(r2[2 * r], r2[2 * r + 1], 0x6420);
    }
  } else {
    uint32_t ru[kPairR];
    uint32_t lu[2 * kPairR];
#pragma unroll
    for (int i = 0; i < 2 * kPairR; ++i) {
      lu[i] = 0u;
      if (i < kPairR) ru[i] = 0u;
    }
#pragma unroll
    for (int j = 1; j <= kPairR; ++j) {
      if (j <= depth) {
#pragma unroll
        for (int i = 0; i < kPairR; ++i) {
          const uint32_t e = kv[i] != kv[i + j];
          ru[i] += e;
          lu[i + j] += e;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      own[r] = bytes4(lu[4 * r], lu[4 * r + 1], lu[4 * r + 2], lu[4 * r + 3]);
      carry[r] = bytes4(lu[kPairR + 4 * r], lu[kPairR + 4 * r + 1], lu[kPairR + 4 * r + 2], lu[kPairR + 4 * r + 3]);
      rc[r] = bytes4(ru[4 * r], ru[4 * r + 1], ru[4 * r + 2], ru[4 * r + 3]);
    }
  }
}

// Raises a kernel's dynamic shared-memory limit to smem when it is above
// the limit already set (never lowers it), so the attribute call runs once
// per (device, kernel, larger size) and not on every launch.  Every kernel
// of the port that takes more than 48 KB sets its limit here (K3 and K8
// through kernel_ready).
inline cudaError_t allow_smem_once(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> limits;
  if (smem <= 48 * 1024) return cudaSuccess;  // within every kernel's default
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& limit = limits[std::make_pair(dev, kernel)];
  if (smem > limit) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not sticky: the next launch's cudaGetLastError() must not report it again
      return err;
    }
    limit = smem;
  }
  return cudaSuccess;
}

}  // namespace kmg
