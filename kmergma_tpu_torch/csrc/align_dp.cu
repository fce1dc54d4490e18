// A1: the device aligner's forward DP and traceback, written by hand for
// Hopper (sm_90a).
//
// Replaces the jitted XLA of kmergma_tpu/ops/align_device.py (_forward_tl,
// _traceback_rle_one and _get_jit().run); the JAX package has no Pallas
// kernel for it.  One query (m letters, its NUC44 rows int32[m, 15])
// against B subjects of any lengths: the semi-global affine-gap DP, global
// in the query with free end gaps in the subject,
//   E[i,j] = max(H[i-1,j] + go + ge, E[i-1,j] + ge)
//   G[i,j] = max(H[i-1,j-1] + sub(a_i, b_j), E[i,j])
//   F[i,j] = max(G[i,j-1] + go + ge, F[i,j-1] + ge)   (G[i,0] = H[i,0], F[i,0] = NEG)
//   H[i,j] = max(G[i,j], F[i,j]),  H[0,j] = 0, E[0,j] = NEG, H[i,0] = E[i,0] = go + ge i
// (F unrolled is the running maximum go + ge j + max_{j' < j} (G[i,j'] - ge j')
// of the JAX scan, for any go), then the traceback from the LAST column
// attaining the maximum of H[m].  Integer arithmetic throughout, the JAX tie
// rules (match over D over I, extend over open), NEG = -2^30: bit-identical
// to the twins.
//
// Forward: a row-band wavefront.  One block of one warp a subject.  Lane L
// owns a band of R consecutive query rows (R = ceil(m / 32) rounded up to
// 1, 2, 4, ..., 16; queries past 32 x 16 rows go in strips of 32 R rows)
// and walks the subject's columns in order, one a step, one step behind
// lane L - 1: at each step it takes the H and E of the row above its band
// from lane L - 1 by one shuffle pair and runs its R rows down the column.
// E flows down the band in a register, H[i, j-1] and F[i, j] of every band
// row stay in registers, so no row needs a warp scan.  E and F are DPX
// __viaddmax_s32 (max(a + b, c)), H a DPX __vimax3_s32; "extended" is the
// maximum equal to the extend term, so extend wins ties.
// A strip's last row goes to a buffer for the next strip.  The strip's
// query profile, sub(a_i, c) for its rows and the 15 letters, sits in
// shared memory, R/2 64-bit loads a step.
//
// Decisions, not run lengths: each cell keeps 4 bits, diag_ok (H from the
// diagonal), f_ok (H from F), ext_e (E extended) and ext_f (F extended),
// 8 columns of a row in one 32-bit word, the words of a column group
// row after row (uint32[ceil((n + 1) / 8)][pitch], see Layout): a lane
// shifts each row's nibble into a register and stores its R words, side by
// side, every step.  They live in shared memory (dynamic) beside the subject's and the
// query's letters and the strip buffers; a subject past the caller's budget
// keeps the same layout in device memory (the kSmem = false instantiation).
//
// Traceback: the warp walks cell by cell from the endpoint as a 3-state
// walk (H: diag_ok steps diagonally, else f_ok enters F, else E; in E or F:
// step, and stay while ext_e / ext_f), the same path as the JAX run jumps
// (a diagonal run is the chain of diag_ok, an E run ends at the first
// !ext_e, an F run at its last break).  Every lane follows the same path;
// at each run the 32 lanes read the run's next 32 cells (and, on the
// diagonal, their two letters) at once, so a ballot gives the run's length
// and its = / X pattern.  In one walk lane 0 writes the JAX RLE, (len << 2)
// | op (op 0 diagonal, 2 query gap, 3 subject gap), and the CIGAR runs
// over "=XID", merged across run boundaries, the free end gaps included;
// each in traceback order, a run past the cap overwriting the last slot.
//
// What bounds it on an H100: about 30 integer operations a cell of the
// function (0.05 ms for 1,024 windows of 389 x 290 at 67 T/s); its bytes,
// the letters in and the runs out, are under 2 MB.  What bounds this
// kernel: a subject's columns are serial (n + 32 steps of R cells) and a
// warp issues its cells' integer instructions on its own SM sub-partition,
// whose INT32 lanes take a warp instruction in two cycles; a launch holds
// three subjects an SM (a 389-letter window against a 289-letter query
// keeps 57 KB of decisions).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRMax = 16;
constexpr int kLetters = 15;
constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
// the decision bits of a cell
constexpr unsigned kDiag = 1u, kFOk = 2u, kExtE = 4u, kExtF = 8u;

// A1's per-launch arguments.  Each output row is int32[3 + cap]: score,
// run count, endpoint j0, then the runs.
struct Args {
  const int32_t* a_sub;     // int32[m, 15]
  const int8_t* a_idx;      // int8[m] query letters (for the CIGAR runs), or null
  const int8_t* b_flat;     // subject letters end to end
  const long long* b_off;   // int64[B + 1], every subject's offset
  const long long* sel;     // int64[n_launch]: the subjects of this launch
  const long long* dec_off; // int64[n_launch]: word offsets into dec (device-memory layout)
  uint32_t* dec;            // decisions and strip buffers (device-memory layout)
  int32_t* rle_out;         // int32[B, 3 + cap] or null
  int32_t* cig_out;         // int32[B, 3 + cap] or null
  int m, go, ge, cap;
};

__host__ __device__ inline int rows_per_lane(int m) {
  const int need = (m + kLanes - 1) / kLanes;
  if (need <= 1) return 1;
  return need >= kRMax ? kRMax : (need + 1) & ~1;
}

__host__ __device__ inline long long round16(long long x) { return (x + 15) & ~15LL; }

// The shared memory layout of a subject of n letters (bytes): the strip's
// query profile int32[15][stride], then (kSmem) the query letters, the
// subject letters, two strip buffers of H and E when there is more than one
// strip, and the decisions uint32[words][pitch]: word j / 8 of query row i
// at j / 8 x pitch + i - 1, the rows padded to the bands (R per lane) and
// the pitch made odd, so that the lanes' stores spread over the banks.
struct Layout {
  int R, strips, stride, words, pitch;  // words: 32-bit words a row
  long long prof, a, b, bnd, dec, total;
};

__host__ __device__ inline Layout layout(int m, int n, bool smem) {
  Layout L;
  L.R = rows_per_lane(m);
  const int strip_rows = kLanes * L.R;
  L.strips = (m + strip_rows - 1) / strip_rows;
  const int first = m < strip_rows ? m : strip_rows;
  L.stride = ((first + L.R - 1) / L.R * L.R + 1) & ~1;
  L.words = (n + 1 + 7) / 8;
  L.pitch = ((m + L.R - 1) / L.R * L.R) | 1;
  L.prof = 0;
  L.a = 4LL * kLetters * L.stride;
  if (!smem) {
    L.b = L.bnd = L.dec = L.total = L.a;
    return L;
  }
  L.b = L.a + round16(m);
  L.bnd = L.b + round16(n);
  L.dec = L.bnd + (L.strips > 1 ? 16LL * (n + 1) : 0);
  L.total = L.dec + 4LL * L.pitch * L.words;
  return L;
}

template <int R, bool kSmem>
__global__ void __launch_bounds__(kLanes) align_dp_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int s = static_cast<int>(p.sel[blockIdx.x]);
  const int m = p.m, go = p.go, ge = p.ge, goe = go + ge;
  const int8_t* b = p.b_flat + p.b_off[s];
  const int n = static_cast<int>(p.b_off[s + 1] - p.b_off[s]);
  const Layout L = layout(m, n, kSmem);
  const int stride = L.stride, pitch = L.pitch;
  int32_t* prof = reinterpret_cast<int32_t*>(smem + L.prof);

  const int8_t* al;  // query letters
  const int8_t* bl;  // subject letters
  int32_t* bnd;      // two strip buffers of H and E, (n + 1) each
  uint32_t* D;       // decisions, word w of row i at D[w pitch + i - 1]
  if constexpr (kSmem) {
    int8_t* sa = reinterpret_cast<int8_t*>(smem + L.a);
    int8_t* sb = reinterpret_cast<int8_t*>(smem + L.b);
    if (p.a_idx != nullptr)
      for (int k = lane; k < m; k += kLanes) sa[k] = p.a_idx[k];
    for (int k = lane; k < n; k += kLanes) sb[k] = b[k];
    al = sa;
    bl = sb;
    bnd = reinterpret_cast<int32_t*>(smem + L.bnd);
    D = reinterpret_cast<uint32_t*>(smem + L.dec);
  } else {
    al = p.a_idx;
    bl = b;
    D = p.dec + p.dec_off[blockIdx.x];
    bnd = reinterpret_cast<int32_t*>(D + static_cast<long long>(pitch) * L.words);
  }

  int best = INT_MIN, best_j = -1;  // H[m]'s maximum and its last column
  for (int strip = 0; strip < L.strips; ++strip) {
    const int r0 = strip * kLanes * R;  // rows r0 + 1 .. of the strip
    const int rows = min(kLanes * R, m - r0);
    const int nl = (rows + R - 1) / R;  // live lanes
    const bool last = strip == L.strips - 1;
    __syncwarp();  // the previous strip has read the profile
    for (int k = lane; k < rows * kLetters; k += kLanes) {
      const int r = k / kLetters, c = k - r * kLetters;
      prof[c * stride + r] = p.a_sub[static_cast<long long>(r0) * kLetters + k];
    }
    for (int k = rows + lane; k < nl * R; k += kLanes)
      for (int c = 0; c < kLetters; ++c) prof[c * stride + k] = 0;
    __syncwarp();

    const bool live = lane < nl;
    const int base = r0 + lane * R;            // the band's rows are base + 1 .. base + R
    const int rm = last ? m - 1 - base : -1;   // row m's place in the band
    const int32_t* bnd_h = bnd + ((strip + 1) & 1) * 2 * (n + 1);  // written by the strip before
    int32_t* out_h = bnd + (strip & 1) * 2 * (n + 1);
    const int32_t* pr = prof + lane * R;

    int Hp[R];        // H[i, j - 1]
    int Fn[R];        // F[i, j]
    unsigned acc[R];  // the row's nibbles, newest at the top
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Hp[r] = 0;
      Fn[r] = kNeg;
      acc[r] = 0;
    }
    unsigned extf = 0;         // ext_f of the band's rows at column j
    int hd = 0;                // H[base, j - 1]
    int hout = 0, eout = kNeg; // the band's last row at column j, for lane + 1
    int hm = 0;                // H[m, j]
    int c_next = 0;            // the subject letter of the next column
    if (live && n > 0) c_next = bl[0];

    for (int t = 0; t < n + nl; ++t) {
      const int j = t - lane;
      int hin = __shfl_up_sync(kFull, hout, 1);
      int ein = __shfl_up_sync(kFull, eout, 1);
      if (!live || j < 0 || j > n) continue;
      if (lane == 0) {
        hin = strip == 0 ? 0 : bnd_h[j];
        ein = strip == 0 ? kNeg : bnd_h[n + 1 + j];
      }
      const int q = j & 7;
      if (j == 0) {
        // column 0: H = E = go + ge i, no diagonal, no F; E extends below row 1
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = base + 1 + r;
          const int col = go + ge * i;
          Hp[r] = col;
          Fn[r] = col + goe;  // F[i, 1]; ext_f there is false
          acc[r] = (acc[r] >> 4) | ((i > 1 ? kExtE : 0u) << 28);
          if (r == rm) hm = col;
        }
        extf = 0;
        hd = hin;
        hout = eout = go + ge * (base + R);
      } else {
        const int c = c_next;
        if (j < n) c_next = bl[j];
        int sub[R];
        if constexpr (R % 2 == 0) {
#pragma unroll
          for (int r = 0; r < R; r += 2) {
            const int2 v = *reinterpret_cast<const int2*>(pr + c * stride + r);
            sub[r] = v.x;
            sub[r + 1] = v.y;
          }
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) sub[r] = pr[c * stride + r];
        }
        int hu = hin, eu = ein, hdiag = hd;
        hd = hin;
        unsigned extf_next = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int e_ext = eu + ge;
          const int e = __viaddmax_s32(hu, goe, e_ext);  // E, extend winning ties
          const int dg = hdiag + sub[r];
          const int f = Fn[r];
          const int h = __vimax3_s32(dg, e, f);
          const int f_ext = f + ge;
          Fn[r] = __viaddmax_s32(max(dg, e), goe, f_ext);  // F[i, j + 1] from G[i, j]
          const unsigned nib = (h == dg ? kDiag : 0u) | (h == f ? kFOk : 0u) | (e == e_ext ? kExtE : 0u) |
                               (((extf >> r) & 1u) << 3);
          extf_next |= static_cast<unsigned>(Fn[r] == f_ext) << r;
          acc[r] = (acc[r] >> 4) | (nib << 28);
          hdiag = Hp[r];
          Hp[r] = h;
          hu = h;
          eu = e;
          if (r == rm) hm = h;
        }
        extf = extf_next;
        hout = hu;
        eout = eu;
      }
      // this column's nibble lands at 4 (j & 7) of word j / 8; the band's
      // rows are consecutive there (padded rows past m included)
      const int shift = 4 * (7 - q);
      uint32_t* dw = D + (j >> 3) * pitch + base;
#pragma unroll
      for (int r = 0; r < R; ++r) dw[r] = acc[r] >> shift;
      if (!last && lane == kLanes - 1) {
        out_h[j] = hout;
        out_h[n + 1 + j] = eout;
      }
      if (rm >= 0 && rm < R && hm >= best) {
        best = hm;
        best_j = j;
      }
    }
  }
  __syncwarp();  // the decisions, before lane 0 reads them

  if (m == 0) {  // no query rows: H[0] = 0 everywhere
    best = 0;
    best_j = n;
  } else {
    const int owner = ((m - 1) % (kLanes * R)) / R;
    best = __shfl_sync(kFull, best, owner);
    best_j = __shfl_sync(kFull, best_j, owner);
  }
  const int cap = p.cap;
  int32_t* rle = p.rle_out ? p.rle_out + static_cast<long long>(s) * (3 + cap) : nullptr;
  int32_t* cig = p.cig_out ? p.cig_out + static_cast<long long>(s) * (3 + cap) : nullptr;
  for (int k = lane; k < cap; k += kLanes) {
    if (rle) rle[3 + k] = 0;
    if (cig) cig[3 + k] = 0;
  }
  __syncwarp();  // the zeroed slots, before lane 0 writes the runs

  // The walk, warp-wide: every lane follows the same path (i, j); at each
  // run the lanes read the next 32 cells of it at once and ballot their
  // bits, and lane 0 writes.
  auto bits = [&](int i, int j) -> unsigned {
    return (D[(j >> 3) * pitch + i - 1] >> (4 * (j & 7))) & 15u;
  };
  const int lead = n - best_j;
  int n_rle = lead > 0 ? 1 : 0, n_cig = 0;
  if (rle && lane == 0) rle[3] = (lead << 2) | 3;
  auto put_rle = [&](int v) {
    if (rle && lane == 0) rle[3 + min(n_rle, cap - 1)] = v;
    ++n_rle;
  };
  int cop = 3, clen = lead;  // the open CIGAR run: the trailing free subject gap
  auto cells = [&](int op, int len) {
    if (op == cop) {
      clen += len;
      return;
    }
    if (clen > 0) {
      if (cig && lane == 0) cig[3 + min(n_cig, cap - 1)] = (clen << 2) | cop;
      ++n_cig;
    }
    cop = op;
    clen = len;
  };
  int i = m, j = best_j;
  while (i > 0) {
    const unsigned d = bits(i, j);
    int len = 0, k;
    if (d & kDiag) {  // the diagonal chain: lane l reads cell (i - l, j - l)
      do {
        const int ii = i - lane, jj = j - lane;
        const bool in = ii > 0 && jj > 0;
        const unsigned chain = __ballot_sync(kFull, in && (bits(ii, jj) & kDiag));
        const unsigned eq = cig ? __ballot_sync(kFull, in && al[ii - 1] == bl[jj - 1]) : 0u;
        k = chain == kFull ? kLanes : __ffs(~chain) - 1;  // cells 0 .. k - 1 are diagonal
        for (int c = 0; cig && c < k;) {  // their = / X runs
          const unsigned same = (((eq >> c) & 1u) ? ~eq : eq) >> c;
          const int run = min(same ? __ffs(same) - 1 : kLanes - c, k - c);
          cells(((eq >> c) & 1u) ? 0 : 1, run);
          c += run;
        }
        i -= k;
        j -= k;
        len += k;
      } while (k == kLanes);
      put_rle(len << 2);
    } else {  // a gap: lane l reads cell (i, j - l) of a subject gap or (i - l, j) of a query gap
      const bool along = d & kFOk;
      const unsigned ext_bit = along ? kExtF : kExtE;
      bool more;
      do {
        const int ii = along ? i : i - lane, jj = along ? j - lane : j;
        const unsigned ext = __ballot_sync(kFull, ii > 0 && jj >= 0 && (bits(ii, jj) & ext_bit));
        more = ext == kFull;                // all 32 extended: the run goes on past them
        k = more ? kLanes : __ffs(~ext);    // else it takes cells 0 .. k - 1, the last not extended
        if (along) {
          j -= k;
        } else {
          i -= k;
        }
        len += k;
      } while (more);
      cells(along ? 3 : 2, len);
      put_rle((len << 2) | (along ? 3 : 2));
    }
  }
  if (j > 0) cells(3, j);  // the leading free subject gap
  cells(-1, 0);            // close the last run
  if (lane != 0) return;
  if (rle) {
    rle[0] = best;
    rle[1] = n_rle;
    rle[2] = best_j;
  }
  if (cig) {
    cig[0] = best;
    cig[1] = n_cig;
    cig[2] = best_j;
  }
}

template <int R, bool kSmem>
int launch_r(const Args& a, int n_launch, long long smem, cudaStream_t stream) {
  auto kernel = align_dp_kernel<R, kSmem>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_launch, kLanes, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSmem>
int launch(const Args& a, int n_launch, long long smem, cudaStream_t stream) {
  switch (rows_per_lane(a.m)) {
    case 1: return launch_r<1, kSmem>(a, n_launch, smem, stream);
    case 2: return launch_r<2, kSmem>(a, n_launch, smem, stream);
    case 4: return launch_r<4, kSmem>(a, n_launch, smem, stream);
    case 6: return launch_r<6, kSmem>(a, n_launch, smem, stream);
    case 8: return launch_r<8, kSmem>(a, n_launch, smem, stream);
    case 10: return launch_r<10, kSmem>(a, n_launch, smem, stream);
    case 12: return launch_r<12, kSmem>(a, n_launch, smem, stream);
    case 14: return launch_r<14, kSmem>(a, n_launch, smem, stream);
    default: return launch_r<16, kSmem>(a, n_launch, smem, stream);
  }
}

template <int R, bool kSmem>
int info_r(long long smem, int* out) {
  auto kernel = align_dp_kernel<R, kSmem>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kLanes, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <bool kSmem>
int info(int m, long long smem, int* out) {
  switch (rows_per_lane(m)) {
    case 1: return info_r<1, kSmem>(smem, out);
    case 2: return info_r<2, kSmem>(smem, out);
    case 4: return info_r<4, kSmem>(smem, out);
    case 6: return info_r<6, kSmem>(smem, out);
    case 8: return info_r<8, kSmem>(smem, out);
    case 10: return info_r<10, kSmem>(smem, out);
    case 12: return info_r<12, kSmem>(smem, out);
    case 14: return info_r<14, kSmem>(smem, out);
    default: return info_r<16, kSmem>(smem, out);
  }
}

}  // namespace

// One query against n_launch of B subjects.  a_sub int32[m, 15]; a_idx
// int8[m] query letters (needed for cig_out, else may be null); b_flat
// int8 letter indices; b_off int64[B + 1] subject offsets; sel int64
// [n_launch] the subjects to align; max_n the longest of them.  dec_off
// null keeps the decisions in shared memory; else int64[n_launch] word
// offsets into dec (the decisions, pitch x words, then the strip buffers
// past one strip; _global_words in ops/align_device.py).  rle_out and
// cig_out (either may be null) are int32[B, 3 + cap]: score, run count,
// endpoint, then the runs.  Returns cudaGetLastError().
extern "C" int kmg_align_dp(const void* a_sub, const void* a_idx, int m, const void* b_flat, const void* b_off,
                            const void* sel, const void* dec_off, int n_launch, int max_n, int go, int ge, int cap,
                            void* dec, void* rle_out, void* cig_out, void* stream) {
  if (n_launch < 0 || m < 0 || max_n < 0 || cap < 1 || (cig_out != nullptr && a_idx == nullptr && m > 0) ||
      (dec_off != nullptr && dec == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_launch == 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.a_sub = static_cast<const int32_t*>(a_sub);
  a.a_idx = static_cast<const int8_t*>(a_idx);
  a.b_flat = static_cast<const int8_t*>(b_flat);
  a.b_off = static_cast<const long long*>(b_off);
  a.sel = static_cast<const long long*>(sel);
  a.dec_off = static_cast<const long long*>(dec_off);
  a.dec = static_cast<uint32_t*>(dec);
  a.rle_out = static_cast<int32_t*>(rle_out);
  a.cig_out = static_cast<int32_t*>(cig_out);
  a.m = m;
  a.go = go;
  a.ge = ge;
  a.cap = cap;
  const bool smem = dec_off == nullptr;
  const long long bytes = layout(m, max_n, smem).total;
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);  // past a block's 227 KB
  const auto st = static_cast<cudaStream_t>(stream);
  return smem ? launch<true>(a, n_launch, bytes, st) : launch<false>(a, n_launch, bytes, st);
}

// A launch's shape for a query of m rows and subjects up to max_n letters:
// out[0] rows a lane, [1] dynamic shared memory a block (bytes), [2]
// resident blocks an SM, [3] registers a thread, [4] local (spill) bytes a
// thread, [5] strips.  Returns a cudaError_t.
extern "C" int kmg_align_launch_info(int m, int max_n, int smem, int* out) {
  const Layout L = layout(m, max_n, smem != 0);
  out[0] = L.R;
  out[1] = static_cast<int>(L.total);
  out[5] = L.strips;
  return smem ? info<true>(m, L.total, out) : info<false>(m, L.total, out);
}
