// A1: the device aligner's forward DP and run traceback, written by hand
// for Hopper (sm_90a).
//
// Replaces the jitted XLA of kmergma_tpu/ops/align_device.py (_forward_tl,
// _traceback_rle_one and _get_jit().run); the JAX package has no Pallas
// kernel for it.  One query (m letters, its NUC44 rows int32[m, 15])
// against B subjects of any lengths: the semi-global affine-gap DP, global
// in the query with free end gaps in the subject, row by row
//   E[i,j] = max(H[i-1,j] + go + ge, E[i-1,j] + ge)
//   G[i,j] = max(H[i-1,j-1] + sub(a_i, b_j), E[i,j])
//   F[i,j] = go + ge j + max_{j' < j} (G[i,j'] - ge j')   (G[i,0] = H[i,0])
//   H[i,j] = max(G[i,j], F[i,j]),  H[i,0] = E[i,0] = go + ge i
// and, for every cell, the decision the traceback takes there with the
// length of its run, TL = (runlen << 2) | op (op 0 diagonal, 2 query gap,
// 3 subject gap; the diagonal chain C, the query-gap run EL straight up,
// the subject-gap run FL along the row since its last break).  Then the
// traceback from the LAST column attaining the maximum of H[m] jumps a run
// a step.  Integer arithmetic throughout, the JAX tie rules (match over D
// over I, extend over open), NEG = -2^30: bit-identical to the twin.
//
// Layout.  One block of one warp per subject.  A tile is 512 columns, 16
// consecutive ones a lane; the previous row's H, E, C and EL of a lane's
// columns stay in its registers across the rows when the subject is one
// tile (up to 511 letters, every hit window of the miners), else in device
// scratch that only the owning lane reads and writes.  The left neighbour
// column comes from the next lane down by shuffle, or from the previous
// tile's carry.  F's running maximum and FL's last break are warp-wide
// max-scans (shuffles), each seeded by the carry of the tiles before; the
// query row's 15 scores sit in lanes 0-14 and a column's substitution score
// is one shuffle.  TL goes to device memory as int32[B, m, n1] with n1 =
// n + 1 rounded up to 4 (16-byte stores, four a lane a row).  After the last
// row lane 0 walks the runs, one load a run.
//
// What bounds it on an H100: the TL bytes, 4 m (n + 1) a subject written
// once (1,000 windows of 389 x 390 are 607 MB, 0.18 ms at 3.35 TB/s),
// against about 30 integer operations a cell (0.07 ms at 67 T/s).  A
// subject's rows are sequential, so a launch needs enough subjects (one
// warp each) to fill the SMs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kCols = 16;                 // columns a lane owns in a tile
constexpr int kTile = kLanes * kCols;     // columns a tile
constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kLanes)
align_dp_kernel(const int32_t* __restrict__ a_sub, int m, const int8_t* __restrict__ b_flat,
                const long long* __restrict__ b_off, const long long* __restrict__ col_off,
                int go, int ge, int rle_cap, int32_t* tl, int32_t* scratch,
                int32_t* __restrict__ scores, int32_t* __restrict__ rle,
                int32_t* __restrict__ n_runs, int32_t* __restrict__ j0_out) {
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const int8_t* b = b_flat + b_off[s];
  const int n = static_cast<int>(b_off[s + 1] - b_off[s]);
  const long long c0 = col_off[s];
  const int n1 = static_cast<int>(col_off[s + 1] - c0);  // n + 1 rounded up to 4
  int32_t* tls = tl + c0 * m;                             // this subject's TL rows
  const int n_tiles = (n + kTile) / kTile;                // tiles of the n + 1 columns
  const bool wide = n_tiles > 1;
  int32_t* st = wide ? scratch + 4 * c0 : nullptr;        // H, E, C, EL rows of n1 each

  int H[kCols], E[kCols], C[kCols], EL[kCols], letter[kCols];
  // the previous row's G (then TL) and diagonal targets of the current tile
  int G[kCols], dg[kCols];

  auto load_letters = [&](int J0) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = J0 + q;
      letter[q] = (j >= 1 && j <= n) ? static_cast<int>(b[j - 1]) : 0;
    }
  };

  // row 0: H = 0, E = NEG, C = EL = 0 (every tile's columns start there)
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    H[q] = 0;
    E[q] = kNeg;
    C[q] = 0;
    EL[q] = 0;
  }
  if (wide) {
    for (int t = 0; t < n_tiles; ++t) {
      for (int q = 0; q < kCols; ++q) {
        const int j = t * kTile + lane * kCols + q;
        if (j <= n) {
          st[j] = 0;
          st[n1 + j] = kNeg;
          st[2 * n1 + j] = 0;
          st[3 * n1 + j] = 0;
        }
      }
    }
  } else {
    load_letters(lane * kCols);
  }

  int best = INT_MIN, best_j = -1;  // the last row's maximum and its last column
  for (int i = 1; i <= m; ++i) {
    const int col = go + ge * i;
    const int arow = lane < 15 ? a_sub[(i - 1) * 15 + lane] : 0;
    int carry_run = kNeg;          // max of base over the tiles before
    int carry_h = 0, carry_c = 0;  // previous row's H and C left of the tile
    int carry_f = kNeg;            // this row's F left of the tile
    int carry_brk = -1;            // last break of FL before the tile
    for (int t = 0; t < n_tiles; ++t) {
      const int J0 = t * kTile + lane * kCols;
      if (wide) {
        load_letters(J0);
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int j = J0 + q;
          if (j <= n) {
            H[q] = st[j];
            E[q] = st[n1 + j];
            C[q] = st[2 * n1 + j];
            EL[q] = st[3 * n1 + j];
          }
        }
      }
      // the previous row's H and C one column left of the lane's first
      int hl = __shfl_up_sync(kFull, H[kCols - 1], 1);
      int cl = __shfl_up_sync(kFull, C[kCols - 1], 1);
      if (lane == 0) {
        hl = carry_h;
        cl = carry_c;
      }
      carry_h = __shfl_sync(kFull, H[kCols - 1], kLanes - 1);
      carry_c = __shfl_sync(kFull, C[kCols - 1], kLanes - 1);

      // E (and with it EL), the diagonal target and G; the lane's max of
      // base = G - ge j (H[i,0] at j = 0; dead columns past n add nothing)
      int agg = kNeg;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = J0 + q;
        const int sub = __shfl_sync(kFull, arow, letter[q]);
        const int hleft = q == 0 ? hl : H[q - 1];
        int e;
        if (j == 0) {
          e = col;
          dg[q] = kNeg;
          G[q] = col;
        } else {
          e = max(H[q] + go + ge, E[q] + ge);
          dg[q] = hleft + sub;
          G[q] = max(dg[q], e);
        }
        EL[q] = (i > 1 && e == E[q] + ge) ? EL[q] + 1 : 1;
        E[q] = e;
        if (j <= n) agg = max(agg, j == 0 ? col : G[q] - ge * j);
      }
      const int incl = warp_incl_max(agg, lane);
      int run = __shfl_up_sync(kFull, incl, 1);
      run = lane == 0 ? carry_run : max(run, carry_run);
      carry_run = max(carry_run, __shfl_sync(kFull, incl, kLanes - 1));

      // F, H, the decisions and C, walking the lane's columns in order
      unsigned dmask = 0, fmask = 0, xmask = 0;  // diag_ok, f_ok, ext_f per column
      int f_prev = 0, f_first = 0;
      int c_left = cl;  // the previous row's C one column left
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = J0 + q;
        int f, h;
        if (j == 0) {
          f = kNeg;
          h = col;
        } else {
          f = go + ge * j + run;
          h = max(G[q], f);
        }
        run = max(run, j == 0 ? col : G[q] - ge * j);
        const bool diag_ok = j > 0 && h == dg[q];
        const bool f_ok = j > 0 && h == f;
        dmask |= static_cast<unsigned>(diag_ok) << q;
        fmask |= static_cast<unsigned>(f_ok) << q;
        if (q > 0 && j > 1 && f == f_prev + ge) xmask |= 1u << q;
        if (q == 0) f_first = f;
        f_prev = f;
        const int c_old = C[q];
        C[q] = diag_ok ? c_left + 1 : 0;
        c_left = c_old;
        H[q] = h;
        if (i == m && j <= n && h >= best) {
          best = h;
          best_j = j;
        }
      }
      int fl_left = __shfl_up_sync(kFull, f_prev, 1);
      if (lane == 0) fl_left = carry_f;
      carry_f = __shfl_sync(kFull, f_prev, kLanes - 1);
      if (J0 > 1 && f_first == fl_left + ge) xmask |= 1u;

      // FL's last break: a warp max-scan of brk = ext_f ? -1 : j
      const unsigned breaks = ~xmask & 0xffffu;
      const int lane_brk = breaks ? J0 + 31 - __clz(breaks) : -1;
      const int bincl = warp_incl_max(lane_brk, lane);
      int last_brk = __shfl_up_sync(kFull, bincl, 1);
      last_brk = lane == 0 ? carry_brk : max(last_brk, carry_brk);
      carry_brk = max(carry_brk, __shfl_sync(kFull, bincl, kLanes - 1));

#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = J0 + q;
        if (!((xmask >> q) & 1u)) last_brk = max(last_brk, j);
        const int fl = j - last_brk + 1;
        G[q] = ((dmask >> q) & 1u) ? (C[q] << 2)
               : ((fmask >> q) & 1u) ? ((fl << 2) | 3) : ((EL[q] << 2) | 2);
      }
      int32_t* row = tls + static_cast<long long>(i - 1) * n1 + J0;
#pragma unroll
      for (int v = 0; v < kCols / 4; ++v) {
        if (J0 + 4 * v < n1) {
          reinterpret_cast<int4*>(row)[v] = make_int4(G[4 * v], G[4 * v + 1], G[4 * v + 2], G[4 * v + 3]);
        }
      }
      if (wide) {
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int j = J0 + q;
          if (j <= n) {
            st[j] = H[q];
            st[n1 + j] = E[q];
            st[2 * n1 + j] = C[q];
            st[3 * n1 + j] = EL[q];
          }
        }
      }
    }
  }

  // the endpoint: the largest score, ties to the later column
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best, d);
    const int oj = __shfl_xor_sync(kFull, best_j, d);
    if (ov > best || (ov == best && oj > best_j)) {
      best = ov;
      best_j = oj;
    }
  }
  if (m == 0) {  // no query rows: H[0] = 0 everywhere
    best = 0;
    best_j = n;
  }
  int32_t* out = rle + static_cast<long long>(s) * rle_cap;
  for (int q = lane; q < rle_cap; q += kLanes) out[q] = 0;
  __syncwarp();  // the TL rows and the zeroed slots, before lane 0 reads and writes them
  if (lane == 0) {
    const int lead = n - best_j;
    out[0] = (lead << 2) | 3;
    int pos = lead > 0 ? 1 : 0;
    int i = m, j = best_j;
    // every run moves i or j down by at least 1, so m + n steps end it
    for (long long step = 0; i > 0 && j >= 0 && step <= static_cast<long long>(m) + n; ++step) {
      const int v = tls[static_cast<long long>(i - 1) * n1 + j];
      const int t = v >> 2, op = v & 3;
      out[pos < rle_cap - 1 ? pos : rle_cap - 1] = v;
      i -= op == 3 ? 0 : t;
      j -= op == 2 ? 0 : t;
      ++pos;
    }
    scores[s] = best;
    n_runs[s] = pos;
    j0_out[s] = best_j;
  }
}

}  // namespace

// One query against n_sub subjects.  a_sub int32[m, 15]; b_flat int8 letter
// indices; b_off int64[n_sub + 1] subject offsets into b_flat; col_off
// int64[n_sub + 1] prefix sums of n1 = n + 1 rounded up to 4; tl int32
// [m * col_off[n_sub]] (16-byte aligned); scratch int32[4 * col_off[n_sub]]
// when a subject is longer than 511 letters, else null.  Outputs scores,
// n_runs, j0 int32[n_sub] and rle int32[n_sub, rle_cap].  Returns
// cudaGetLastError().
extern "C" int kmg_align_dp(const void* a_sub, int m, const void* b_flat, const void* b_off,
                            const void* col_off, int n_sub, int go, int ge, int rle_cap, void* tl,
                            void* scratch, void* scores, void* rle, void* n_runs, void* j0,
                            void* stream) {
  if (n_sub < 0 || m < 0 || rle_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_sub == 0) return static_cast<int>(cudaSuccess);
  align_dp_kernel<<<n_sub, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_sub), m, static_cast<const int8_t*>(b_flat),
      static_cast<const long long*>(b_off), static_cast<const long long*>(col_off), go, ge, rle_cap,
      static_cast<int32_t*>(tl), static_cast<int32_t*>(scratch), static_cast<int32_t*>(scores),
      static_cast<int32_t*>(rle), static_cast<int32_t*>(n_runs), static_cast<int32_t*>(j0));
  return static_cast<int>(cudaGetLastError());
}
