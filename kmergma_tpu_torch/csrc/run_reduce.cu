// R1: the planned record's run reduce, written by hand for Hopper (sm_90a).
//
// Replaces the tail of the JAX package's planned dispatch: the below mask
// of kmergma_tpu/ops/scan.py::_below_and_words and the segmented scan of
// ::_device_run_reduce (jitted XLA, no Pallas), which _plan_and_summarize
// runs for one profile and _regions_summarized_multi_body for m at once.
// For each profile i of a record it reads K2's exact region distances
// d (int32[n_i, rspan]), the region starts (int64[n_i]) and the true
// region count nvr (a 0-dim int32 on the card, read here: no host sync),
// and writes its part of the one device-to-host buffer:
//   [nvr, d[0,0], n_runs, run_arg_win[R], run_min[R], edge_win[R],
//    edge_val[R], edge_ok[R]]
// bit for bit as the plain version (ops/scan_kernels._run_reduce_multi_plain)
// writes it, slots past n_runs included.
//
// The flat sequence e = row * rspan + col carries the JAX scan's element
// (rise, fl ? d : INT_MAX, e), combined by (count, min, first argmin):
// a segment restarts where the right side holds a rise, ties keep the left
// argument.
//
// At the main path's sizes (256 region rows of 1,024 at one profile, some
// 60 of them live) the work is under a microsecond of device memory, so
// the launch count and the passes over d set the time, not the bytes.
// This design is one launch, a single-pass chained scan with decoupled
// look-back (Merrill and Garland, 2016) over the same monoid, restarted
// per profile:
//   - One block a region row of every profile.  A block takes its row from
//     a per-launch atomic ticket, so rows start in order and every row a
//     block waits on already runs: the look-back cannot deadlock.  The
//     block that takes the last ticket sets the counter back to 0 for the
//     next launch on the stream.  Rows at or past a profile's live rows
//     (max(1, min(nvr, n))) hold no flags and leave at once; no live row
//     waits on them.
//   - The row's distances cross from device memory once, into shared
//     memory (16-byte loads when the row is aligned), with the one flag on
//     each side of it; the fold and the run writing both read that copy.
//     These loads go out with the region count's, before the live-row
//     test waits on it.
//   - The block folds its row (one chunk a thread, a block scan), publishes
//     the row's aggregate with a status flag, then its first warp looks back
//     over the profile's earlier rows 32 at a time: each lane waits for its
//     row's flag, the window folds up to the nearest row that published its
//     inclusive prefix, and the walk stops there or at the profile's first
//     row.  The block publishes its inclusive prefix, then writes each run
//     of its row at its fall, in its global slot when below R.
//   - A publication is the payload (16 bytes, stored past L1), a fence
//     (acq_rel at GPU scope), then the flag: a release pattern.  A reader
//     spins on the flag with acquire loads, then reads the payload past L1.
//     Flags carry the call's epoch (flag = epoch << 2 | state), so the
//     status buffer, which the wrapper keeps for each device and stream
//     across calls, needs no clearing launch.
//   - The block that holds a profile's last live row knows n_runs: it
//     writes the header and the slots past n_runs (edge_val there is the
//     last element of d, as the plain version's clamped searchsorted gives).
//   - Any number of profiles: their descriptors (64 bytes each) travel in
//     the launch parameters, up to kMaxProfiles a launch (510: CUDA 12.1
//     and later allow 32,764 bytes of parameters); more profiles take one
//     launch for each kMaxProfiles into the same output.  A launch copies
//     all 510 slots; builds with 8 and 64 slots for small calls saved
//     0.1-0.5 us of 6-13 us at m = 1 and 6 on an H100, and were dropped.
// What bounds it on an H100: the launch and the look-back's chain of
// device-memory round trips at these sizes; device memory (d read once, a
// run's slots written once) only on far larger rows.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAggregate = 1u, kInclusive = 2u;

struct Profile {
  const int32_t* d;
  const long long* starts;
  const int32_t* nvr;
  int32_t* out;
  long long nw, mi;
  int thr, R, n_rows, row_off;  // row_off: the profile's first row among the call's
};
static_assert(sizeof(Profile) == 64, "a profile descriptor is 64 bytes");

// the scan's carry: rises so far, the running minimum and its first index
struct __align__(16) Seg {
  long long arg;
  int cnt, mn;
};

struct ArgsHead {
  unsigned* ticket;
  unsigned* flags;
  Seg* agg;
  Seg* inc;
  int m, rspan;
  unsigned epoch;
  int pad;
};

#if CUDART_VERSION >= 12010
constexpr int kParamBytes = 32764;
#else
constexpr int kParamBytes = 4096;
#endif
constexpr int kMaxProfiles = (kParamBytes - static_cast<int>(sizeof(ArgsHead)) - 64) / static_cast<int>(sizeof(Profile));

// a launch's parameters: the head and kMaxProfiles profile slots
struct Args {
  ArgsHead h;
  Profile p[kMaxProfiles];
};
static_assert(sizeof(Args) <= kParamBytes, "R1's launch parameters exceed the limit");

__device__ __forceinline__ Seg seg_identity() { return Seg{0, 0, INT_MAX}; }

// a then b: b restarts the segment when it holds a rise
__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  const bool take_b = b.cnt > 0 || b.mn < a.mn;
  return Seg{take_b ? b.arg : a.arg, a.cnt + b.cnt, take_b ? b.mn : a.mn};
}

__device__ __forceinline__ Seg shfl_up(const Seg& v, int o) {
  return Seg{__shfl_up_sync(kFull, v.arg, o), __shfl_up_sync(kFull, v.cnt, o), __shfl_up_sync(kFull, v.mn, o)};
}

__device__ __forceinline__ Seg shfl_down(const Seg& v, int o) {
  return Seg{__shfl_down_sync(kFull, v.arg, o), __shfl_down_sync(kFull, v.cnt, o), __shfl_down_sync(kFull, v.mn, o)};
}

__device__ __forceinline__ Seg shfl(const Seg& v, int lane) {
  return Seg{__shfl_sync(kFull, v.arg, lane), __shfl_sync(kFull, v.cnt, lane), __shfl_sync(kFull, v.mn, lane)};
}

// exclusive scan of one Seg a thread over the block (blockDim a multiple
// of 32, at most 1024); *total gets the whole block's fold
__device__ Seg block_exclusive(Seg v, Seg* total) {
  __shared__ Seg warps[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  Seg inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const Seg u = shfl_up(inc, o);
    if (lane >= o) inc = combine(u, inc);
  }
  if (lane == 31) warps[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    Seg w = lane < n_warps ? warps[lane] : seg_identity();
    for (int o = 1; o < 32; o <<= 1) {
      const Seg u = shfl_up(w, o);
      if (lane >= o) w = combine(u, w);
    }
    if (lane < n_warps) warps[lane] = w;
  }
  __syncthreads();
  Seg ex = shfl_up(inc, 1);
  if (lane == 0) ex = seg_identity();
  const Seg out = wid > 0 ? combine(warps[wid - 1], ex) : ex;
  *total = warps[n_warps - 1];
  __syncthreads();  // warps[] is reused by the next call
  return out;
}

// --- publication and look-back ----------------------------------------------

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acq_rel() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void store_seg(Seg* p, const Seg& v) {
  const longlong2 raw{v.arg, static_cast<long long>((static_cast<unsigned long long>(static_cast<unsigned>(v.mn)) << 32) |
                                                    static_cast<unsigned>(v.cnt))};
  __stcg(reinterpret_cast<longlong2*>(p), raw);
}

__device__ __forceinline__ Seg load_seg(const Seg* p) {
  const longlong2 raw = __ldcg(reinterpret_cast<const longlong2*>(p));
  const unsigned long long hi = static_cast<unsigned long long>(raw.y);
  return Seg{raw.x, static_cast<int>(static_cast<unsigned>(hi)), static_cast<int>(static_cast<unsigned>(hi >> 32))};
}

// the payload, a fence, then the flag: a release pattern, which the
// reader's acquire load of the flag pairs with
__device__ __forceinline__ void publish(const ArgsHead& h, int grow, unsigned state, const Seg& v) {
  store_seg((state == kInclusive ? h.inc : h.agg) + grow, v);
  fence_acq_rel();
  store_relaxed(h.flags + grow, (h.epoch << 2) | state);
}

// The exclusive prefix of call row `grow` over its profile's rows from
// `first` on, by the first warp of the block (every lane returns it).  Lane
// j waits for row hi - j; the window folds in row order up to the nearest
// row with an inclusive prefix (or the profile's start), else the walk
// moves 32 rows back.
__device__ Seg look_back(const ArgsHead& h, int first, int grow) {
  const int lane = threadIdx.x & 31;
  Seg acc = seg_identity();  // the fold of the rows after the window, up to grow - 1
  for (int hi = grow - 1;; hi -= 32) {
    const int j = hi - lane;
    Seg v = seg_identity();
    bool inclusive = true;  // before the profile's first row: its start
    if (j >= first) {
      unsigned st = load_acquire(h.flags + j);
      while ((st >> 2) != h.epoch) {
        __nanosleep(32);
        st = load_acquire(h.flags + j);
      }
      inclusive = (st & 3u) == kInclusive;
      v = load_seg((inclusive ? h.inc : h.agg) + j);
    }
    const unsigned incs = __ballot_sync(kFull, inclusive);
    const int stop = incs ? __ffs(incs) - 1 : 31;
    Seg w = lane <= stop ? v : seg_identity();
    // lane l ends with rows hi - l - 2o + 1 .. hi - l folded in row order
    for (int o = 1; o < 32; o <<= 1) {
      const Seg u = shfl_down(w, o);
      if (lane + o < 32) w = combine(u, w);
    }
    acc = combine(shfl(w, 0), acc);
    if (incs) return acc;
  }
}

// --- one region row ---------------------------------------------------------

// region row `row` continues row - 1 in the record
__device__ __forceinline__ bool adjacent(const Profile& P, int rspan, int row) {
  return row > 0 && P.starts[row] == P.starts[row - 1] + rspan;
}

// the flag of one element: below the threshold, inside the record, up to
// the last stream index, on a planned row, and not window 0
__device__ __forceinline__ bool flag_of(const Profile& P, int nvr, long long start, int row, int col, int dv) {
  const long long win = start + col;
  return row < nvr && win < P.nw && win <= P.mi && (row | col) != 0 && dv < P.thr;
}

__device__ __forceinline__ Seg element(const int32_t* dv, const uint8_t* fl, long long base, int c) {
  return Seg{base + c, fl[c + 1] && !fl[c] ? 1 : 0, fl[c + 1] ? dv[c] : INT_MAX};
}

// the profile that holds call row `grow` (the last whose row_off <= grow)
__device__ __forceinline__ int find_profile(const Args& a, int grow) {
  int lo = 0, hi = a.h.m - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.p[mid].row_off <= grow) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) run_reduce_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int s_grow;
  __shared__ Seg s_prefix;
  const ArgsHead& h = a.h;
  const int rspan = h.rspan;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(h.ticket, 1u);
    if (t == gridDim.x - 1) atomicExch(h.ticket, 0u);  // every ticket is taken: ready for the next launch
    s_grow = a.p[0].row_off + static_cast<int>(t);
  }
  __syncthreads();
  const int grow = s_grow;
  const Profile& P = a.p[find_profile(a, grow)];
  const int row = grow - P.row_off;

  // the row's distances, once, and its flags with one from each side; the
  // loads go out together with nvr's, before the live-row test needs it
  int32_t* dv = smem;
  uint8_t* fl = reinterpret_cast<uint8_t*>(smem + rspan);
  const long long base = static_cast<long long>(row) * rspan;
  const int32_t* drow = P.d + base;
  const int nvr = *P.nvr;
  const long long start = P.starts[row];
  const bool first_t = threadIdx.x == 0, last_t = threadIdx.x == blockDim.x - 1;
  const bool has_prev = first_t && row > 0, has_next = last_t && row + 1 < P.n_rows;
  const long long nb_start = has_prev ? P.starts[row - 1] : has_next ? P.starts[row + 1] : 0;
  const int nb_d = has_prev ? P.d[base - 1] : has_next ? P.d[base + rspan] : 0;
  if ((rspan & 3) == 0 && (reinterpret_cast<uintptr_t>(drow) & 15) == 0) {
    const int4* src = reinterpret_cast<const int4*>(drow);
    int4* dst = reinterpret_cast<int4*>(dv);
    for (int i = threadIdx.x; i < (rspan >> 2); i += blockDim.x) dst[i] = __ldcs(src + i);
  } else {
    for (int c = threadIdx.x; c < rspan; c += blockDim.x) dv[c] = drow[c];
  }
  const int live = max(1, min(nvr, P.n_rows));
  if (row >= live) return;  // no flags, and no live row waits on it
  __syncthreads();
  for (int c = threadIdx.x; c < rspan; c += blockDim.x) fl[c + 1] = flag_of(P, nvr, start, row, c, dv[c]);
  // one flag from each neighbouring row, where it continues this one
  if (first_t) fl[0] = has_prev && nb_start + rspan == start && flag_of(P, nvr, nb_start, row - 1, rspan - 1, nb_d);
  if (last_t) fl[rspan + 1] = has_next && nb_start == start + rspan && flag_of(P, nvr, nb_start, row + 1, 0, nb_d);
  __syncthreads();

  // the row's fold: a chunk a thread, then the block
  const int per = (rspan + blockDim.x - 1) / blockDim.x;
  const int c0 = min(static_cast<int>(threadIdx.x) * per, rspan), c1 = min(c0 + per, rspan);
  Seg s = seg_identity();
  for (int c = c0; c < c1; ++c) s = combine(s, element(dv, fl, base, c));
  Seg total;
  const Seg ex = block_exclusive(s, &total);

  // publish the aggregate (row 0: the inclusive prefix), look back, publish
  // the inclusive prefix
  const int first = grow - row;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) publish(h, grow, row == 0 ? kInclusive : kAggregate, total);
    Seg prefix = seg_identity();
    if (row > 0) prefix = look_back(h, first, grow);
    if (threadIdx.x == 0) {
      s_prefix = prefix;
      if (row > 0) publish(h, grow, kInclusive, combine(prefix, total));
    }
  }
  __syncthreads();
  const Seg prefix = s_prefix;

  // each run of the row written at its fall
  const int R = P.R;
  const long long nfl = static_cast<long long>(P.n_rows) * rspan;
  int32_t* out = P.out + 3;
  s = combine(prefix, ex);
  for (int c = c0; c < c1; ++c) {
    s = combine(s, element(dv, fl, base, c));
    if (!fl[c + 1] || fl[c + 2]) continue;  // not a fall
    const int id = s.cnt - 1;
    if (id >= R) continue;
    const long long arg_row = s.arg / rspan;
    const long long win = start + c;
    const bool next_contig = c + 1 < rspan || (row + 1 < P.n_rows && adjacent(P, rspan, row + 1));
    const long long next = base + c + 1 < nfl ? base + c + 1 : nfl - 1;
    out[id] = static_cast<int32_t>(P.starts[arg_row] + (s.arg - arg_row * rspan));
    out[R + id] = s.mn;
    out[2 * R + id] = static_cast<int32_t>(win + 1);
    out[3 * R + id] = next < base + rspan ? dv[next - base] : P.d[next];
    out[4 * R + id] = next_contig && win + 1 <= P.mi;
  }

  // the last live row: the header and the slots no run fills
  if (row == live - 1) {
    const int n_runs = combine(prefix, total).cnt;
    if (threadIdx.x == 0) {
      P.out[0] = nvr;
      P.out[1] = P.d[0];
      P.out[2] = n_runs;
    }
    // past n_runs the plain version's searchsorted lands on the last element
    const int32_t last = P.d[nfl - 1];
    for (int j = n_runs + threadIdx.x; j < R; j += blockDim.x) {
      out[j] = 0;
      out[R + j] = 0;
      out[2 * R + j] = 0;
      out[3 * R + j] = last;
      out[4 * R + j] = 0;
    }
  }
}

// the status buffer: the ticket, then a flag, an aggregate and an inclusive
// prefix for each row
constexpr size_t kFlagsAt = 16;
size_t aggregates_at(long long rows) { return kFlagsAt + ((4 * static_cast<size_t>(rows) + 15) & ~size_t{15}); }

// one launch for the n profiles of desc (9 long longs each) whose first
// row is call row row_off; *rows gets their rows
cudaError_t launch(const ArgsHead& h, const long long* desc, int n, long long row_off, long long* rows, size_t smem,
                   cudaStream_t s) {
  thread_local Args a;  // 32 KB: off the stack; the launch copies it
  a.h = h;
  a.h.m = n;
  *rows = 0;
  for (int i = 0; i < n; ++i) {
    const long long* x = desc + 9 * static_cast<long long>(i);
    Profile& P = a.p[i];
    P.d = reinterpret_cast<const int32_t*>(x[0]);
    P.starts = reinterpret_cast<const long long*>(x[1]);
    P.nvr = reinterpret_cast<const int32_t*>(x[2]);
    P.out = reinterpret_cast<int32_t*>(x[3]);
    P.nw = x[4];
    P.mi = x[5];
    P.thr = static_cast<int>(x[6]);
    P.R = static_cast<int>(x[7]);
    P.n_rows = static_cast<int>(x[8]);
    P.row_off = static_cast<int>(row_off + *rows);
    *rows += P.n_rows;
  }
  run_reduce_kernel<<<static_cast<int>(*rows), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Bytes of R1's status buffer for calls of up to `rows` region rows; the
// wrapper keeps one a device and stream, zeroed when made.
extern "C" long long kmg_run_reduce_state_bytes(long long rows) {
  return static_cast<long long>(aggregates_at(rows) + 2 * sizeof(Seg) * static_cast<size_t>(rows));
}

// The run reduce of m >= 1 profiles: one launch for each kMaxProfiles.
// desc: 9 long longs a profile (d, starts, nvr, out, nw, mi, thr, R,
// n_rows).  state: the status buffer, for at least the call's rows, whose
// flags hold epochs below `epoch` (1 <= epoch < 2^30) and whose ticket is
// 0.  *launches gets the kernel launches made, counted as each is issued.
// Returns cudaGetLastError() (or cudaErrorInvalidValue).
extern "C" int kmg_run_reduce(int m, int rspan, const long long* desc, void* state, long long state_rows, int epoch,
                              void* stream, int* launches) {
  *launches = 0;
  if (m < 1 || rspan < 1 || rspan > 8192 || epoch < 1 || epoch >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  long long total = 0;
  for (int i = 0; i < m; ++i) {
    if (desc[9 * i + 7] < 1 || desc[9 * i + 8] < 1) return static_cast<int>(cudaErrorInvalidValue);
    total += desc[9 * i + 8];
  }
  if (total > 0x7fffffffLL || total > state_rows) return static_cast<int>(cudaErrorInvalidValue);
  char* st = static_cast<char*>(state);
  ArgsHead h{};
  h.ticket = reinterpret_cast<unsigned*>(st);
  h.flags = reinterpret_cast<unsigned*>(st + kFlagsAt);
  h.agg = reinterpret_cast<Seg*>(st + aggregates_at(state_rows));
  h.inc = h.agg + state_rows;
  h.rspan = rspan;
  h.epoch = static_cast<unsigned>(epoch);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(rspan) * sizeof(int32_t) + rspan + 2;
  long long row_off = 0;
  for (int g0 = 0; g0 < m; g0 += kMaxProfiles) {
    const int n = m - g0 < kMaxProfiles ? m - g0 : kMaxProfiles;
    const long long* x = desc + 9 * static_cast<long long>(g0);
    long long rows = 0;
    const cudaError_t err = launch(h, x, n, row_off, &rows, smem, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    row_off += rows;
  }
  return static_cast<int>(cudaSuccess);
}
