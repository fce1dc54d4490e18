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
// argument.  Three launches for all profiles at once:
//   (a) one block a region row: the row's fold (its rise count and the
//       (min, argmin) from its last rise on), from the row's flags and the
//       one flag on each side of it;
//   (b) one block a profile: the exclusive scan of the row folds, a block
//       of rows at a time with a running carry, which gives each row its
//       first run id and the (min, argmin) of a run entering it; the
//       header and the slots past n_runs;
//   (c) one block a region row: the row's scan again from its carry,
//       each run written at its fall, in its global slot when below R.
// What bounds it on an H100: device memory, d read twice and the row
// folds once each way; a run's slots are written once.  The per-profile
// pointers and scalars travel in the launch parameters (at most 32
// profiles, about 2 KB), not through a device copy.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxProfiles = 32;
constexpr int kRowThreads = 256;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Profile {
  const int32_t* d;
  const long long* starts;
  const int32_t* nvr;
  int32_t* out;
  long long nw, mi;
  int thr, R, n_rows, row_off;
};

struct Args {
  Profile p[kMaxProfiles];
  int m, rspan;
};

// the scan's carry: rises so far, the running minimum and its first index
struct Seg {
  long long arg;
  int cnt, mn;
};

__device__ __forceinline__ Seg seg_identity() { return Seg{0, 0, INT_MAX}; }

// a then b: b restarts the segment when it holds a rise
__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  const bool take_b = b.cnt > 0 || b.mn < a.mn;
  return Seg{take_b ? b.arg : a.arg, a.cnt + b.cnt, take_b ? b.mn : a.mn};
}

__device__ __forceinline__ Seg shfl_up(const Seg& v, int o) {
  return Seg{__shfl_up_sync(kFull, v.arg, o), __shfl_up_sync(kFull, v.cnt, o), __shfl_up_sync(kFull, v.mn, o)};
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

__device__ __forceinline__ int find_profile(const Args& a, int block) {
  int i = 0;
  while (i + 1 < a.m && block >= a.p[i + 1].row_off) ++i;
  return i;
}

// region row `row` continues row - 1 in the record
__device__ __forceinline__ bool adjacent(const Profile& P, int rspan, int row) {
  return row > 0 && P.starts[row] == P.starts[row - 1] + rspan;
}

// the flag of one element: below the threshold, inside the record, up to
// the last stream index, on a planned row, and not window 0
__device__ __forceinline__ bool flag_of(const Profile& P, int nvr, int rspan, int row, int col, int dv) {
  const long long win = P.starts[row] + col;
  return row < nvr && win < P.nw && win <= P.mi && (row | col) != 0 && dv < P.thr;
}

__device__ __forceinline__ bool flag_at(const Profile& P, int nvr, int rspan, int row, int col) {
  return flag_of(P, nvr, rspan, row, col, P.d[static_cast<long long>(row) * rspan + col]);
}

// a row's flags into fl[1 .. rspan] with fl[0] the previous element's
// flag where it continues into this row, fl[rspan + 1] the next one's;
// the masked values (INT_MAX off the flags) into val
__device__ void stage_row(const Profile& P, int nvr, int rspan, int row, int32_t* val, uint8_t* fl) {
  const int32_t* d = P.d + static_cast<long long>(row) * rspan;
  for (int c = threadIdx.x; c < rspan; c += blockDim.x) {
    const int dv = d[c];
    const bool f = flag_of(P, nvr, rspan, row, c, dv);
    fl[c + 1] = f;
    val[c] = f ? dv : INT_MAX;
  }
  if (threadIdx.x == 0) fl[0] = adjacent(P, rspan, row) && flag_at(P, nvr, rspan, row - 1, rspan - 1);
  if (threadIdx.x == blockDim.x - 1)
    fl[rspan + 1] = row + 1 < P.n_rows && adjacent(P, rspan, row + 1) && flag_at(P, nvr, rspan, row + 1, 0);
  __syncthreads();
}

__device__ __forceinline__ Seg element(const int32_t* val, const uint8_t* fl, long long base, int c) {
  return Seg{base + c, fl[c + 1] && !fl[c] ? 1 : 0, val[c]};
}

// (a) each row's fold
__global__ void __launch_bounds__(kRowThreads) row_folds_kernel(const __grid_constant__ Args a, Seg* rows) {
  extern __shared__ int32_t smem[];
  const int rspan = a.rspan;
  int32_t* val = smem;
  uint8_t* fl = reinterpret_cast<uint8_t*>(smem + rspan);
  const Profile& P = a.p[find_profile(a, blockIdx.x)];
  const int row = blockIdx.x - P.row_off;
  stage_row(P, *P.nvr, rspan, row, val, fl);
  const int per = (rspan + blockDim.x - 1) / blockDim.x;
  const int c0 = threadIdx.x * per, c1 = min(c0 + per, rspan);
  const long long base = static_cast<long long>(row) * rspan;
  Seg s = seg_identity();
  for (int c = c0; c < c1; ++c) s = combine(s, element(val, fl, base, c));
  Seg total;
  block_exclusive(s, &total);
  if (threadIdx.x == 0) rows[blockIdx.x] = total;
}

// (b) each profile's rows scanned: rows[j] becomes the fold of the rows
// before j; then the header and the slots no run fills
__global__ void __launch_bounds__(kScanThreads) row_carries_kernel(const __grid_constant__ Args a, Seg* rows) {
  const Profile& P = a.p[blockIdx.x];
  Seg carry = seg_identity();
  for (int r0 = 0; r0 < P.n_rows; r0 += blockDim.x) {
    const int r = r0 + threadIdx.x;
    const Seg v = r < P.n_rows ? rows[P.row_off + r] : seg_identity();
    Seg total;
    const Seg ex = block_exclusive(v, &total);
    if (r < P.n_rows) rows[P.row_off + r] = combine(carry, ex);
    carry = combine(carry, total);
  }
  const int n_runs = carry.cnt;
  const int R = P.R;
  int32_t* out = P.out;
  if (threadIdx.x == 0) {
    out[0] = *P.nvr;
    out[1] = P.d[0];
    out[2] = n_runs;
  }
  // past n_runs the plain version's searchsorted lands on the last element
  const int32_t last = P.d[static_cast<long long>(P.n_rows) * a.rspan - 1];
  for (int j = n_runs + threadIdx.x; j < R; j += blockDim.x) {
    out[3 + j] = 0;
    out[3 + R + j] = 0;
    out[3 + 2 * R + j] = 0;
    out[3 + 3 * R + j] = last;
    out[3 + 4 * R + j] = 0;
  }
}

// (c) each row's runs, written at their falls
__global__ void __launch_bounds__(kRowThreads) row_runs_kernel(const __grid_constant__ Args a, const Seg* rows) {
  extern __shared__ int32_t smem[];
  const int rspan = a.rspan;
  int32_t* val = smem;
  uint8_t* fl = reinterpret_cast<uint8_t*>(smem + rspan);
  const Profile& P = a.p[find_profile(a, blockIdx.x)];
  const int row = blockIdx.x - P.row_off;
  stage_row(P, *P.nvr, rspan, row, val, fl);
  const int per = (rspan + blockDim.x - 1) / blockDim.x;
  const int c0 = threadIdx.x * per, c1 = min(c0 + per, rspan);
  const long long base = static_cast<long long>(row) * rspan;
  Seg s = seg_identity();
  for (int c = c0; c < c1; ++c) s = combine(s, element(val, fl, base, c));
  Seg total;
  s = combine(rows[blockIdx.x], block_exclusive(s, &total));
  const int R = P.R;
  const long long nfl = static_cast<long long>(P.n_rows) * rspan;
  const long long start = P.starts[row];
  for (int c = c0; c < c1; ++c) {
    s = combine(s, element(val, fl, base, c));
    if (!fl[c + 1] || fl[c + 2]) continue;  // not a fall
    const int id = s.cnt - 1;
    if (id >= R) continue;
    const long long arg_row = s.arg / rspan;
    const long long win = start + c;
    const bool next_contig = c + 1 < rspan || (row + 1 < P.n_rows && adjacent(P, rspan, row + 1));
    const long long next = base + c + 1 < nfl ? base + c + 1 : nfl - 1;
    int32_t* out = P.out + 3;
    out[id] = static_cast<int32_t>(P.starts[arg_row] + (s.arg - arg_row * rspan));
    out[R + id] = s.mn;
    out[2 * R + id] = static_cast<int32_t>(win + 1);
    out[3 * R + id] = P.d[next];
    out[4 * R + id] = next_contig && win + 1 <= P.mi;
  }
}

}  // namespace

// The run reduce of m profiles (1 <= m <= 32) in three launches.
// ptrs: 4 a profile (d, starts, nvr, out); wins: 2 (nw, mi); ints: 3
// (thr, R, n_rows).  scratch: one 16-byte Seg for each row of every
// profile.  Returns cudaGetLastError().
extern "C" int kmg_run_reduce(int m, int rspan, const long long* ptrs, const long long* wins, const int* ints,
                              void* scratch, void* stream) {
  if (m < 1 || m > kMaxProfiles || rspan < 1 || rspan > 8192) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.m = m;
  a.rspan = rspan;
  long long total = 0;
  for (int i = 0; i < m; ++i) {
    Profile& P = a.p[i];
    P.d = reinterpret_cast<const int32_t*>(ptrs[4 * i]);
    P.starts = reinterpret_cast<const long long*>(ptrs[4 * i + 1]);
    P.nvr = reinterpret_cast<const int32_t*>(ptrs[4 * i + 2]);
    P.out = reinterpret_cast<int32_t*>(ptrs[4 * i + 3]);
    P.nw = wins[2 * i];
    P.mi = wins[2 * i + 1];
    P.thr = ints[3 * i];
    P.R = ints[3 * i + 1];
    P.n_rows = ints[3 * i + 2];
    P.row_off = static_cast<int>(total);
    if (P.n_rows < 1 || P.R < 1) return static_cast<int>(cudaErrorInvalidValue);
    total += P.n_rows;
  }
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  Seg* rows = static_cast<Seg*>(scratch);
  const size_t smem = static_cast<size_t>(rspan) * sizeof(int32_t) + rspan + 2;
  row_folds_kernel<<<static_cast<int>(total), kRowThreads, smem, s>>>(a, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_carries_kernel<<<m, kScanThreads, 0, s>>>(a, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_runs_kernel<<<static_cast<int>(total), kRowThreads, smem, s>>>(a, rows);
  return static_cast<int>(cudaGetLastError());
}
