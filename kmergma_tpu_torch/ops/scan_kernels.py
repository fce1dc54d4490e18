"""K2, the full-depth match-count kernel (counterpart of
``kmergma_tpu.ops.scan_pallas.match_counts``), its plain twin, and the
whole-record distance scan built on it; K5, the multi-windowsize pair
kernel of the cluster split pass (counterpart of ``codes_pair_multi`` and
``codes_pair_roll_multi``), and its plain twin; K4/K4r and K6, the pair
kernel at one width and any depth (counterpart of ``codes_pair_ab_kcodes``,
``codes_pair_roll`` and ``pair_ab_from_kcodes``), its plain twins, and the
lower bounds built on it (``scan_window_lower_bounds_codes``); R1, the
planned record's run reduce of every profile in one call
(``run_reduce_multi``), and its plain twin.

``match_counts``, ``codes_pair_multi``, ``codes_pair_ab_kcodes``,
``pair_ab_from_kcodes`` and ``run_reduce_multi`` launch the hand-written
CUDA kernels ``csrc/match_counts.cu``, ``csrc/pair_multi.cu``,
``csrc/pair_depth.cu`` and ``csrc/run_reduce.cu`` on CUDA tensors and run
their plain PyTorch twins on CPU tensors; any other device raises.

Source note (K2).  Replaces ``kmergma_tpu/ops/scan_pallas.py::_match_counts_kernel``.
K2 is the net pair delta at depth w - 1 plus [K[p] == K[p+w]] - 1, so it
runs the register-blocked routine of ``csrc/pair_counts.cuh`` with that
term in its epilogue: a thread owns 16 consecutive positions, keeps their
targets in registers and streams each of the w + 14 columns of its two
runs from a staged tile once (one pad word per 16, so no bank conflicts),
about 37 shared loads a position at ws = 289, k = 6 instead of 568.  The
2 (w - 1) compares a position remain, two to an XOR and a DPX halfword
minimum when a tile's codes fit 16 bits: integer issue bounds it on the
H100.  Rows may overlap in memory (a row stride), so the whole-record
scan tiles K without a copy.

Source note (K5).  Replaces ``_codes_pair_roll_multi_kernel`` (K5r) and
``_codes_pair_multi_kernel`` (K5) of ``kmergma_tpu/ops/scan_pallas.py``,
bit-identical variants that differ only in how Mosaic kept VMEM, so one
kernel serves both contracts.  ab_g[p] = Lc[p + w_g] - Rc[p] with left
and right pair counts shared by every group, and each equal pair (a, a +
j) counted once for both (``csrc/pair_counts.cuh``): a thread owns 16
left ends with their K codes in registers (built from the codes packed
two bits each), compares two 16-bit codes at once, and hands the left
counts of the next 16 positions to the next lane by a warp shuffle, about
d compares a position instead of 2 d.  The tile is chosen from the
record's length (``_pair_multi_tile``: 256 positions on short records,
so a 60 kb record gives every SM of an H100 a block, up to 2048 on long
ones).  The 4 (G + 1) bytes written a position bound it on long records,
the launch on short ones.

Source note (K4, K4r, K6).  Replace ``_codes_pair_kernel`` (K4),
``_codes_pair_roll_kernel`` (K4r) and ``_pair_counts_kernel`` (K6) of
``kmergma_tpu/ops/scan_pallas.py``: one function, the net pair delta at one
width and a run-time depth, with codes in (K4 and K4r, which also return
the K codes; K4r only kept Mosaic's VMEM O(1) in depth) or K codes in (K6),
so one source with two entry points serves all three.  Routes are chosen
by shape in the C entry: byte codes at k = 1 and depth w - 1 (the strobe
engine's s = 2 exact pass, K4r's main shape) take a sliding histogram,
ab[p] = H_p[K[p+w]] - H_p[K[p]] with H_p the histogram of K[p+1 .. p+w-1],
one thread a segment of positions with its own 256 bins in shared memory,
O(1) work a position; every other shape takes K2's register-blocked
routine (``csrc/pair_counts.cuh``), 16 positions a thread with their
targets in registers: at depth <= 16 (K6's split pass, K4) all of a
thread's codes sit in registers, about 4 shared loads a position; deeper,
the columns stream from the staged tile.  Instruction issue binds at every
depth, above the device-memory bytes even at depth 16.

Source note (R1).  Replaces the below mask of ``_below_and_words`` and the
segmented (flag, min, first-argmin) scan of ``_device_run_reduce`` in
``kmergma_tpu/ops/scan.py`` (jitted XLA, no Pallas), which the JAX planned
dispatch runs for all of a record's profiles at once.  One launch for
every profile of the call (up to 510; more take one launch for each 510):
a block a region row, its row taken from an atomic ticket so rows start
in order, stages the row in shared memory once, folds it, publishes the
fold, looks back over the profile's earlier rows' published folds and
prefixes (a single-pass chained scan with decoupled look-back), publishes
its prefix and writes each run at its fall.  The status words persist in
a buffer a device and stream, tagged with the call's epoch.  The launch
and the look-back's chain bound it at the main path's sizes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import scan
from .scan import _cumsum32, _first_window_d0, _lower_bound_base, _lower_bounds_from, _pair_ab, profile_lookup, rolling_kmer_codes


def _match_counts_plain(tiles_k: torch.Tensor, w: int, t: int) -> torch.Tensor:
    """AB[:, p] = sum_{d=1..w} [K[p+w-d] == K[p+w]] - [K[p+d-1] == K[p]]
    per row: the plain PyTorch twin of K2.

    Both sums count one code among the row's columns [p, p + w): the
    entering code K[p+w] and the leaving code K[p].  They are read off each
    row's sorted (code, column) keys v * L + c: the count of code v among
    columns [lo, hi) is the number of keys in [v L + lo, v L + hi), two
    binary searches instead of 2w passes over the row (cluster mode runs
    this twin m times per record on the CPU)."""
    n_cols = tiles_k.shape[1]
    cols = torch.arange(n_cols, device=tiles_k.device)
    keys = torch.sort(tiles_k.to(torch.int64) * n_cols + cols, dim=1).values
    p = cols[:t]

    def in_window(v: torch.Tensor) -> torch.Tensor:
        lo = v * n_cols + p
        return torch.searchsorted(keys, lo + w) - torch.searchsorted(keys, lo)

    return (in_window(tiles_k[:, w : w + t].to(torch.int64)) - in_window(tiles_k[:, :t].to(torch.int64))).to(torch.int32)


def match_counts(tiles_k: torch.Tensor, w: int, t: int) -> torch.Tensor:
    """Entering-minus-leaving window counts per transition, per row.

    tiles_k: int32[n, t + w] K codes; rows may be a strided view (row
    stride >= 1, unit column stride), e.g. ``unfold`` over a flat record.
    Returns int32[n, t].  Launches K2 on a CUDA tensor, the plain twin on
    a CPU tensor."""
    if tiles_k.dim() != 2 or tiles_k.shape[1] != t + w or tiles_k.dtype != torch.int32:
        raise ValueError(f"match_counts wants int32[n, t + w = {t + w}], got {tiles_k.dtype}{tuple(tiles_k.shape)}")
    if tiles_k.device.type == "cpu":
        return _match_counts_plain(tiles_k, w, t)
    if tiles_k.device.type != "cuda":
        raise ValueError(f"match_counts: unsupported device {tiles_k.device}")
    if tiles_k.stride(1) != 1:
        raise ValueError("match_counts: K codes need a unit column stride")
    from .._kernels import check, load

    lib = load()
    n = tiles_k.shape[0]
    out = torch.empty((n, t), dtype=torch.int32, device=tiles_k.device)
    if n == 0:
        return out
    with torch.cuda.device(tiles_k.device):
        stream = torch.cuda.current_stream(tiles_k.device).cuda_stream
        check(
            lib.kmg_match_counts(
                tiles_k.data_ptr(), tiles_k.stride(0), n, t, w, out.data_ptr(), stream
            ),
            "match_counts",
        )
    match_counts.launches += 1
    return out


#: K2 launches since the count was last set to 0
match_counts.launches = 0


def scan_window_distances_kernel(codes: torch.Tensor, s_profile: torch.Tensor, k: int, ws: int, r: int, tile_windows: int = 2048) -> torch.Tensor:
    """``scan_window_distances`` with the depth-W match counts from K2
    (counterpart of ``scan_window_distances_pallas``): the record's K codes
    are tiled by t = ``tile_windows`` transitions with a w halo, as a
    strided view without a copy.  Returns int32[n - ws + 1], bit-identical
    to ``scan.scan_window_distances``."""
    n = codes.shape[0]
    w = ws - k + 1
    nw = n - ws + 1
    t = tile_windows
    kcodes = rolling_kmer_codes(codes, k)
    g = profile_lookup(kcodes, s_profile)
    n_tiles = -(-nw // t)
    kcodes_pad = torch.nn.functional.pad(kcodes, (0, n_tiles * t + w - kcodes.shape[0]))
    tiles = kcodes_pad.unfold(0, t + w, t)  # tile i = K[i*t : i*t + t + w]
    ab = match_counts(tiles, w, t).reshape(-1)

    kl = kcodes[: nw - 1]
    kr = kcodes[w : w + nw - 1]
    r2 = 2 * r * r
    delta = r2 * (kl != kr).to(torch.int32) + r2 * ab[: nw - 1] + (2 * r) * (g[: nw - 1] - g[w : w + nw - 1])
    d0 = _first_window_d0(kcodes, s_profile, w, r)
    return torch.cat([d0.view(1), d0 + _cumsum32(delta)])


#: windowsize groups one K5 call takes (the widths ride its launch)
MAX_PAIR_GROUPS = 32

#: K5's tiles, positions per CUDA block, and the SMs of an H100: a record
#: takes the largest tile that still gives every SM a block, so short
#: records fill the card and long ones keep the w_max halo a small share
#: (14% at 2048; 4096-position tiles, two resident blocks an SM, were
#: slower on a 4 Mbp record; PERF.md)
_PAIR_MULTI_TILES = (256, 512, 1024, 2048)
_PAIR_MULTI_SMS = 132
#: positions of a K5 unit (one thread), and threads a block at most
_PAIR_UNIT = 16
_PAIR_MULTI_THREADS = 512


def _pair_multi_tile(n: int) -> int:
    """K5's tile for ``n`` = max(nt, nkc) positions."""
    for t in reversed(_PAIR_MULTI_TILES):
        if -(-n // t) >= _PAIR_MULTI_SMS:
            return t
    return _PAIR_MULTI_TILES[0]


def _pair_multi_need(ws_tuple: tuple, nt: int, nkc: int) -> tuple[int, int]:
    """(tiles, codes the kernel reads) of ``codes_pair_multi``: each tile
    builds t + w_max K codes, from t + max(ws) codes (the kernel reads
    zeros past the codes it is given; callers pad to this to share the
    buffer with other passes)."""
    n = max(nt, nkc)
    t = _pair_multi_tile(n)
    n_tiles = max(1, -(-n // t))
    return n_tiles, n_tiles * t + max(ws_tuple)


def pair_multi_launch_shape(k: int, ws_tuple: tuple, nt: int, nkc: int) -> dict:
    """K5's launch: positions a tile, blocks, threads a block and units (16
    left ends each) a tile, from the record alone."""
    t = _pair_multi_tile(max(nt, nkc))
    units = -(-(t + max(ws_tuple) - k + 1) // _PAIR_UNIT)
    return {"tile": t, "grid": _pair_multi_need(ws_tuple, nt, nkc)[0],
            "threads": min(-(-units // 32) * 32, _PAIR_MULTI_THREADS), "units": units}


@functools.lru_cache(maxsize=256)
def _pair_multi_widths(k: int, ws_tuple: tuple):
    """The groups' window widths as a host C int array, built once per (k,
    ws_tuple) (the cache keeps it alive for the C call)."""
    from .._kernels import int_array

    return int_array(ws - k + 1 for ws in ws_tuple)


def _codes_pair_multi_plain(codes: torch.Tensor, k: int, ws_tuple: tuple, nt: int, nkc: int, depth: int):
    """The plain PyTorch twin of K5: (ab int32[G, nt], kcodes int32[nkc])
    with ab[g] = ``_pair_ab(K, ws_g - k + 1, nt, depth)``; codes past the
    end read as zeros."""
    need = max(nt + max(ws_tuple) - k + 1, nkc) + k - 1
    codes = torch.nn.functional.pad(codes[:need], (0, max(0, need - codes.shape[0])))
    kc = rolling_kmer_codes(codes, k)
    ab = torch.stack([_pair_ab(kc, ws - k + 1, nt, depth) for ws in ws_tuple])
    return ab, kc[:nkc]


def codes_pair_multi(codes: torch.Tensor, k: int, ws_tuple: tuple, nt: int, nkc: int, depth: int):
    """Net pair deltas of every windowsize group plus the K codes, one pass.

    codes: int8[n] 2-bit codes (read as zeros past their end); ws_tuple:
    the G group windowsizes; one pair ``depth`` < every window width and
    at most ``MAX_BITMAP_DEPTH`` (K5 keeps its pair counts as bytes; the
    cluster engine routes deeper sets to K4 and K6 before any launch).
    Returns (ab int32[G, nt], kcodes int32[nkc]), ab[g] bit-identical to
    ``_pair_ab(K, ws_tuple[g] - k + 1, nt, depth)``.  Launches K5 on a CUDA
    tensor, the plain twin on a CPU tensor; K5's ab is a view of rows
    padded to a multiple of four (each row 16-byte aligned), its K codes a
    prefix of a buffer so padded."""
    ws_tuple = tuple(int(ws) for ws in ws_tuple)
    w_min = min(ws_tuple) - k + 1
    if codes.dim() != 1 or codes.dtype != torch.int8:
        raise ValueError(f"codes_pair_multi wants int8[n] codes, got {codes.dtype}{tuple(codes.shape)}")
    if not 1 <= len(ws_tuple) <= MAX_PAIR_GROUPS or not 0 <= depth < w_min or depth > scan.MAX_BITMAP_DEPTH:
        raise ValueError(
            f"codes_pair_multi: need 1..{MAX_PAIR_GROUPS} groups, 0 <= depth < min(w) and depth <= {scan.MAX_BITMAP_DEPTH} "
            f"(groups={len(ws_tuple)}, depth={depth}, w_min={w_min})"
        )
    if codes.device.type == "cpu":
        return _codes_pair_multi_plain(codes, k, ws_tuple, nt, nkc, depth)
    if codes.device.type != "cuda":
        raise ValueError(f"codes_pair_multi: unsupported device {codes.device}")
    from .._kernels import check, load

    lib = load()
    shape = pair_multi_launch_shape(k, ws_tuple, nt, nkc)
    codes = codes.contiguous()
    dev = codes.device
    ab_stride, kc_stride = -(-nt // 4) * 4, -(-nkc // 4) * 4
    ab = torch.empty((len(ws_tuple), ab_stride), dtype=torch.int32, device=dev)
    kc = torch.empty(kc_stride, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(
            lib.kmg_pair_multi(
                codes.data_ptr(), codes.shape[0], k, len(ws_tuple), _pair_multi_widths(k, ws_tuple), depth,
                shape["tile"], shape["grid"], shape["threads"], ab_stride, kc_stride,
                ab.data_ptr(), kc.data_ptr(), stream,
            ),
            "codes_pair_multi",
        )
    codes_pair_multi.launches += 1
    return ab[:, :nt], kc[:nkc]


#: K5 launches since the count was last set to 0
codes_pair_multi.launches = 0


#: K4's and K6's tile: positions per CUDA block
_PAIR_DEPTH_T = 2048

#: code dtypes K4 reads: 2-bit genome codes, and the strobemer span
#: engine's k = 1 strobe codes (uint8 at s = 2, int32 at s = 3)
_PAIR_CODE_DTYPES = (torch.int8, torch.uint8, torch.int32)


def _pair_depth_need(k: int, w: int, nt: int, nkc: int) -> tuple[int, int]:
    """(tiles, codes the kernel reads) of ``codes_pair_ab_kcodes``: each
    tile builds _PAIR_DEPTH_T + w K codes from _PAIR_DEPTH_T + w + k - 1
    codes."""
    n_tiles = max(1, -(-max(nt, nkc) // _PAIR_DEPTH_T))
    return n_tiles, n_tiles * _PAIR_DEPTH_T + w + k - 1


def _check_pair_depth(what: str, w: int, nt: int, depth: int) -> None:
    if not 0 <= depth < w or nt < 0:
        raise ValueError(f"{what}: need 0 <= depth < w and nt >= 0 (depth={depth}, w={w}, nt={nt})")


def _codes_pair_ab_kcodes_plain(codes: torch.Tensor, k: int, w: int, nt: int, nkc: int, depth: int):
    """The plain PyTorch twin of K4 and K4r: (``_pair_ab(K, w, nt, depth)``,
    K[:nkc]) with K the rolling codes; codes past the end read as zeros."""
    need = max(nt + w, nkc) + k - 1
    codes = torch.nn.functional.pad(codes[:need], (0, max(0, need - codes.shape[0])))
    kc = rolling_kmer_codes(codes, k)
    return _pair_ab(kc, w, nt, depth), kc[:nkc]


def codes_pair_ab_kcodes(codes: torch.Tensor, k: int, w: int, nt: int, nkc: int, depth: int):
    """Net pair deltas at one window width plus the K codes, one pass.

    codes: int8, uint8 or int32 [n] (zero-padded when shorter than the
    tiles read); w: the window width; 0 <= depth < w.  Returns (ab
    int32[nt], kcodes int32[nkc]) with ab bit-identical to ``_pair_ab(K, w,
    nt, depth)``.  Launches K4 on a CUDA tensor, the plain twin on a CPU
    tensor."""
    if codes.dim() != 1 or codes.dtype not in _PAIR_CODE_DTYPES:
        raise ValueError(f"codes_pair_ab_kcodes wants int8, uint8 or int32 [n] codes, got {codes.dtype}{tuple(codes.shape)}")
    _check_pair_depth("codes_pair_ab_kcodes", w, nt, depth)
    if codes.device.type == "cpu":
        return _codes_pair_ab_kcodes_plain(codes, k, w, nt, nkc, depth)
    if codes.device.type != "cuda":
        raise ValueError(f"codes_pair_ab_kcodes: unsupported device {codes.device}")
    from .._kernels import check, load

    lib = load()
    n_tiles, need = _pair_depth_need(k, w, nt, nkc)
    if codes.shape[0] < need:
        codes = torch.nn.functional.pad(codes, (0, need - codes.shape[0]))
    codes = codes.contiguous()
    dev = codes.device
    ab = torch.empty(nt, dtype=torch.int32, device=dev)
    kc = torch.empty(nkc, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(
            lib.kmg_pair_depth_codes(
                codes.data_ptr(), codes.element_size(), k, w, depth, _PAIR_DEPTH_T, n_tiles, nt, nkc,
                ab.data_ptr(), kc.data_ptr(), stream,
            ),
            "codes_pair_ab_kcodes",
        )
    codes_pair_ab_kcodes.launches += 1
    return ab, kc


#: K4 launches since the count was last set to 0
codes_pair_ab_kcodes.launches = 0


def pair_ab_from_kcodes(kcodes: torch.Tensor, w: int, nt: int, depth: int) -> torch.Tensor:
    """Net pair deltas ab[0:nt] at window width w and 0 <= depth < w from
    K codes (int32, at least nt + w of them), bit-identical to
    ``_pair_ab(K, w, nt, depth)``.  Launches K6 on a CUDA tensor, its plain
    twin ``_pair_ab`` on a CPU tensor."""
    if kcodes.dim() != 1 or kcodes.dtype != torch.int32 or kcodes.shape[0] < nt + w:
        raise ValueError(f"pair_ab_from_kcodes wants int32[>= nt + w = {nt + w}] K codes, got {kcodes.dtype}{tuple(kcodes.shape)}")
    _check_pair_depth("pair_ab_from_kcodes", w, nt, depth)
    if kcodes.device.type == "cpu":
        return _pair_ab(kcodes, w, nt, depth)
    if kcodes.device.type != "cuda":
        raise ValueError(f"pair_ab_from_kcodes: unsupported device {kcodes.device}")
    from .._kernels import check, load

    lib = load()
    kcodes = kcodes.contiguous()
    dev = kcodes.device
    ab = torch.empty(nt, dtype=torch.int32, device=dev)
    n_tiles = max(1, -(-nt // _PAIR_DEPTH_T))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(
            lib.kmg_pair_depth_kcodes(
                kcodes.data_ptr(), kcodes.shape[0], w, depth, _PAIR_DEPTH_T, n_tiles, nt, ab.data_ptr(), stream,
            ),
            "pair_ab_from_kcodes",
        )
    pair_ab_from_kcodes.launches += 1
    return ab


#: K6 launches since the count was last set to 0
pair_ab_from_kcodes.launches = 0


def scan_window_lower_bounds_codes(codes: torch.Tensor, s_profile: torch.Tensor, k: int, ws: int, r: int, depth: int, nw: int | None = None) -> torch.Tensor:
    """Certified lower bounds L[p] <= D[p] of every window at pair
    ``depth`` (counterpart of ``scan_window_lower_bounds_codes``), the
    pair deltas and K codes from one K4 call; at depth ws - k (K4r's use)
    they are the exact distances.  ``codes`` may carry zero padding past
    the record, whose window count ``nw`` then says where it ends.
    int32[nw], bit-identical to ``scan.scan_window_lower_bounds``."""
    w = ws - k + 1
    if nw is None:
        nw = codes.shape[0] - ws + 1
    nt = max(nw - 1, 1)
    ab, kc = codes_pair_ab_kcodes(codes, k, w, nt, nw + w - 1, depth)
    g = profile_lookup(kc, s_profile)
    l0 = _lower_bound_base(kc, g, s_profile, w, r, depth)
    return _lower_bounds_from(kc, g, l0, w, r, depth, nw, ab=ab)


#: the widest region row R1's block stages in shared memory
RUN_REDUCE_MAX_RSPAN = 8192
#: R1's flags carry the call's epoch below this; the status buffer is
#: made anew (zeroed) when its epochs run out
_R1_EPOCHS = 1 << 30


def run_reduce_size(run_bucket: int) -> int:
    """int32 words of one profile's part of ``run_reduce_multi``'s output."""
    return 3 + 5 * run_bucket


def _run_reduce_multi_plain(ds, starts, nvrs, thrs, nws, mis, run_buckets) -> torch.Tensor:
    """The plain PyTorch twin of R1: per profile the below mask
    (``scan._below_mask``) and the run reduce (``scan._device_run_reduce``),
    each profile's part [nvr, d[0, 0], reduce] joined in order."""
    parts = []
    for d, st, nvr, thr, nw, mi, R in zip(ds, starts, nvrs, thrs, nws, mis, run_buckets):
        below = scan._below_mask(d, st, thr, nw, nvr)
        red = scan._device_run_reduce(d, below, st, d.shape[1], mi, R)
        parts.append(torch.cat([nvr.view(1), d[0, :1], red]))
    return torch.cat(parts)


#: R1's status buffers, one a (device index, stream): [uint8 tensor, rows
#: it holds, the last call's epoch]; the look-back's flags and prefixes
#: live there across calls, so no call clears them
_R1_STATE: dict = {}


def _r1_state(lib, dev: torch.device, stream: int, n_rows: int) -> list:
    """The status buffer for a call of ``n_rows`` rows on ``stream``, its
    epoch advanced for the call; made (zeroed) on first use, when the call
    outgrows it and when its epochs run out."""
    st = _R1_STATE.get((dev.index, stream))
    if st is None or st[1] < n_rows or st[2] + 1 >= _R1_EPOCHS:
        rows = max(1024, 1 << (n_rows - 1).bit_length())
        st = [torch.zeros(lib.kmg_run_reduce_state_bytes(rows), dtype=torch.uint8, device=dev), rows, 0]
        _R1_STATE[(dev.index, stream)] = st
    st[2] += 1
    return st


def _r1_descriptors(ds, starts, nvrs, thrs, nws, mis, run_buckets) -> tuple:
    """R1's launch descriptors: (int64[m, 9] rows of d, starts and nvr
    pointers, the part's byte offset in the output (the caller adds the
    output's address), nw, mi, thr, R and the rows; the contiguous tensors
    the pointers point into, which must outlive the launch call; the
    output's int32 words; the call's rows)."""
    kept = [(d.contiguous(), st.contiguous()) for d, st in zip(ds, starts)]
    desc, size = [], 0
    for (d, st), nvr, thr, nw, mi, R in zip(kept, nvrs, thrs, nws, mis, run_buckets):
        desc.append((d.data_ptr(), st.data_ptr(), nvr.data_ptr(), 4 * size, nw, mi, thr, R, d.shape[0]))
        size += run_reduce_size(int(R))
    return np.array(desc, dtype=np.int64), kept, size, sum(d.shape[0] for d, _st in kept)


def run_reduce_multi(ds: list, starts: list, nvrs: list, thrs: list, nws: list, mis: list, run_buckets: list) -> torch.Tensor:
    """The planned record's below mask and run reduce for all its profiles
    in one call.

    Per profile i: ``ds[i]`` int32[n_i, rspan] exact region distances (K2),
    ``starts[i]`` int64[n_i] region start windows, ``nvrs[i]`` the 0-dim
    int32 true region count on the device, ``thrs[i]`` the exact integer
    threshold, ``nws[i]`` the record's windows, ``mis[i]`` the last stream
    index and ``run_buckets[i]`` its run bucket R_i.  Any number of
    profiles.  Returns int32[sum of ``run_reduce_size(R_i)``], profile i's
    part [nvr, d[0, 0], n_runs, run_arg_win[R], run_min[R], edge_win[R],
    edge_val[R], edge_ok[R]] at the sum of the sizes before it.  Launches
    R1 on CUDA tensors (one kernel launch for up to 510 profiles; the count
    of launches is ``run_reduce_multi.kernel_launches``), the plain twin on
    CPU tensors."""
    m = len(ds)
    if m < 1 or not all(len(x) == m for x in (starts, nvrs, thrs, nws, mis, run_buckets)):
        raise ValueError(f"run_reduce_multi takes at least one profile with one of each argument, got {m}")
    rspan = ds[0].shape[1] if ds[0].dim() == 2 else -1
    for d, st, nvr, R in zip(ds, starts, nvrs, run_buckets):
        if (d.dim() != 2 or d.dtype != torch.int32 or d.shape[0] < 1 or d.shape[1] != rspan
                or st.dtype != torch.int64 or st.shape != (d.shape[0],) or nvr.dtype != torch.int32 or nvr.numel() != 1
                or int(R) < 1):
            raise ValueError(
                f"run_reduce_multi wants int32[n >= 1, {rspan}] distances, int64[n] starts, a one-element int32 region "
                f"count and R >= 1 a profile, got {d.dtype}{tuple(d.shape)}, {st.dtype}{tuple(st.shape)}, "
                f"{nvr.dtype}{tuple(nvr.shape)}, R {R}"
            )
    if not all(-(2**31) <= int(t) < 2**31 for t in thrs):
        raise ValueError(f"run_reduce_multi: thresholds must fit int32, got {thrs}")
    dev = ds[0].device
    if any(t.device != dev for t in (*ds, *starts, *nvrs)):
        raise ValueError("run_reduce_multi: every tensor must be on one device")
    if dev.type == "cpu":
        return _run_reduce_multi_plain(ds, starts, nvrs, thrs, nws, mis, run_buckets)
    if dev.type != "cuda":
        raise ValueError(f"run_reduce_multi: unsupported device {dev}")
    if not 1 <= rspan <= RUN_REDUCE_MAX_RSPAN:
        raise ValueError(f"run_reduce_multi: region rows of 1..{RUN_REDUCE_MAX_RSPAN} windows, got {rspan}")
    from .._kernels import check, load
    from .scan_cluster_fused import _on_device, _raw_stream

    lib = load()
    desc, kept, size, n_rows = _r1_descriptors(ds, starts, nvrs, thrs, nws, mis, run_buckets)
    out = torch.empty(size, dtype=torch.int32, device=dev)
    desc[:, 3] += out.data_ptr()
    n_launched = ctypes.c_int(0)
    with _on_device(dev):
        stream = _raw_stream(dev)
        state, state_rows, epoch = _r1_state(lib, dev, stream, n_rows)
        err = lib.kmg_run_reduce(m, rspan, desc.ctypes.data, state.data_ptr(), state_rows, epoch, stream,
                                 ctypes.byref(n_launched))
    del kept  # the launch is queued: later work on this stream may reuse the copies' memory
    check(err, "run_reduce_multi")
    _R1.launches += 1
    _R1.kernel_launches += n_launched.value
    return out


#: R1 wrapper calls since the count was last set to 0
run_reduce_multi.launches = 0
#: R1 kernel launches since the count was last set to 0, as the C entry
#: point counts them when it issues them (one a call for up to 510 profiles)
run_reduce_multi.kernel_launches = 0
#: the wrapper itself: it counts on this name, which a spy that stands in
#: for ``run_reduce_multi`` in this module (the planned pass imports it at
#: each call) leaves in place
_R1 = run_reduce_multi
